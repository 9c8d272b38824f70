"""Plain PyTorch reference of the no-MLP direct solve in 2-D (kr4b/pigs
``test_no_mlp.py``): a dynamics timestep's Adam iterations on the raw
Gaussian parameters against the Burgers residual between the frozen
previous mixture and the current one, and the rule that ends a timestep.

Written from the equations, in dense tensor operations that run in any
float dtype on any device (the benchmark runs it in float64, TF32 off),
with nothing cached, batched or fused.  In float32 with TF32 allowed (the
benchmark's control) every contraction's operands are rounded to TF32, as
the tensor cores would round them: at these shapes (a sum over the
Gaussians against one channel) the library would otherwise pick kernels
that leave TF32 unused, and the control would read as float32.  It
imports nothing of the program under test.  Raw parameters are a dict of ``raw_means (N, 2)``, ``values
(N, c)``, ``raw_scaling (N, 2)`` and ``transforms (N, 1)``, beside an
``active (N,)`` mask; inactive Gaussians add nothing to any field.

* ``concrete``: means ``tanh(raw_means) * scale``, variances
  ``exp(raw_scaling)``, the covariance's off-diagonal ``tanh(t) sqrt(s_x
  s_y)``, the conic its closed-form inverse;
* the mixture ``u = sum_i v_i exp(-d^T C_i d / 2)``, ``d = x - mu_i``, its
  gradient ``-sum P g v`` and Hessian ``sum (P P^T - C) g v``, ``P = C d``,
  in blocks of samples;
* the residual at samples ``x`` uniform on ``[-scale, scale]^2`` and times
  ``s`` uniform on ``[0, 1)``: ``u_t = (u - u_prev) / dt`` and the Burgers
  right-hand side ``nu lap(w) - w dw/dx`` of the convex combination ``w =
  s u_prev + (1 - s) u`` (and of its derivatives); the loss is the mean
  squared residual;
* Adam as optax's ``adam`` (count first, bias-corrected moments, ``eps``
  outside the root) at the learning rate of optax's
  ``cosine_decay_schedule(lr, max_iters, alpha=lr_min / lr)`` taken at the
  pre-step count, which restarts every timestep;
* the rule: a timestep ends once the mean of the last five block means is
  at most ``tol``, or at ``max_iters`` iterations.

Departures from ``test_no_mlp.py``, as the committed 2-D recipe
(``results_no_mlp_2d_burgers``) runs it:

* the stopping rule reads the mean of the last five means of 100-iteration
  blocks, where the script reads a running mean of single iterations;
* the learning rate decays from 1e-2 to 1e-4 over the 5,000 iterations
  (the script keeps 1e-2), and a fresh Adam state starts every timestep;
* the initial log-variance is -5 and the grid 20 x 20 of 1024 slots;
* densification is left out: the recipe waits 300 blocks before it, more
  than a timestep's 50, so it never fires;
* only dynamics timesteps: the initial condition's fit is not followed;
* the script's CUDA mixture evaluation is a dense sum here.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

Raw = Dict[str, torch.Tensor]

B1, B2, EPS = 0.9, 0.999, 1e-8
LEAVES = ("raw_means", "values", "raw_scaling", "transforms")


class Recipe:
    """What the equations need of a configuration's ``recipe``."""

    def __init__(self, recipe: dict):
        self.scale = float(recipe["scale"])
        self.dt = float(recipe["dt"])
        self.nu = float(recipe["nu"])
        self.lr = float(recipe["lr"])
        self.lr_min = recipe["lr_min"]
        self.max_iters = int(recipe["max_iters"])
        self.tol = float(recipe["tol"])
        self.block_iters = int(recipe["block_iters"])


# ---------------------------------------------------------------- mixture --

def concrete(raw: Raw, scale: float):
    """``(means (N, 2), conics (N, 2, 2), values (N, c))``."""
    means = torch.tanh(raw["raw_means"]) * scale
    var = torch.exp(raw["raw_scaling"])
    a, c = var[:, 0], var[:, 1]
    off = torch.tanh(raw["transforms"][:, 0]) * torch.sqrt(a * c)
    det = a * c - off * off
    conics = torch.stack([torch.stack([c / det, -off / det], -1),
                          torch.stack([-off / det, a / det], -1)], -2)
    return means, conics, raw["values"]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 stored mantissa bits, to nearest), as the
    tensor cores round a float32 matmul's operands when TF32 is allowed;
    the gradient passes through the rounding unchanged."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return x + (rounded - x).detach()


def operands(dtype):
    """How a contraction's operands enter it: rounded to TF32 in float32
    when ``torch.backends.cuda.matmul.allow_tf32`` is set (whichever kernel
    the library would pick for the shape), as they are otherwise."""
    if dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        return tf32
    return lambda x: x


def mixture(means, conics, values, samples, mask: Optional[torch.Tensor]
            = None, chunk: int = 256):
    """``u (m, c)``, ``ux (m, 2, c)`` and ``uxx (m, 2, 2, c)`` over the
    Gaussians where ``mask`` holds, in blocks of ``chunk`` samples; each
    sum of products is a contraction (:func:`operands`)."""
    w = values if mask is None else values * mask.to(values.dtype)[:, None]
    op = operands(values.dtype)
    us, uxs, uxxs = [], [], []
    for x in torch.split(samples, chunk):
        d = x[:, None, :] - means[None, :, :]                     # (b, n, 2)
        p = torch.einsum("nab,mnb->mna", op(conics), op(d))
        g = torch.exp(-0.5 * (d * p).sum(-1))
        gv = op(g[:, :, None] * w[None])                           # (b, n, c)
        us.append(torch.einsum("mn,nc->mc", op(g), op(w)))
        uxs.append(-torch.einsum("mna,mnc->mac", op(p), gv))
        h = p[..., :, None] * p[..., None, :] - conics[None]
        uxxs.append(torch.einsum("mnab,mnc->mabc", op(h), gv))
    return torch.cat(us), torch.cat(uxs), torch.cat(uxxs)


# ------------------------------------------------------------------- loss --

def samples_of(base: torch.Tensor, scale: float) -> torch.Tensor:
    """Collocation points from uniform ``[0, 1)`` draws."""
    return (base * 2.0 - 1.0) * scale


def burgers_loss(recipe: Recipe, cur, prev, times) -> torch.Tensor:
    """The mean squared Burgers residual, ``cur`` and ``prev`` each ``(u,
    ux, uxx)``."""
    u1, ux1, uxx1 = cur
    u0, ux0, uxx0 = prev
    s = times[:, None]
    u = s * u0 + (1 - s) * u1
    ux = s[..., None] * ux0 + (1 - s[..., None]) * ux1
    uxx = s[..., None, None] * uxx0 + (1 - s[..., None, None]) * uxx1
    ut = (u1 - u0) / recipe.dt
    lap = uxx[:, 0, 0, 0] + uxx[:, 1, 1, 0]
    rhs = recipe.nu * lap - u[:, 0] * ux[:, 0, 0]
    return torch.mean((ut[:, 0] - rhs) ** 2)


def loss_and_grads(recipe: Recipe, raw: Raw, active, prev_fields, base,
                   times):
    """One iteration's loss and its gradient by leaf."""
    leaves = {k: raw[k].detach().requires_grad_() for k in LEAVES}
    samples = samples_of(base, recipe.scale)
    cur = mixture(*concrete(leaves, recipe.scale), samples, active)
    loss = burgers_loss(recipe, cur, prev_fields(samples), times)
    grads = torch.autograd.grad(loss, [leaves[k] for k in LEAVES])
    return loss.detach(), dict(zip(LEAVES, grads))


# ------------------------------------------------------------------- Adam --

def learning_rate(recipe: Recipe, count: int) -> float:
    """optax's ``cosine_decay_schedule(lr, max_iters, alpha=lr_min / lr)``
    at the pre-step count (``lr`` throughout without ``lr_min``)."""
    if recipe.lr_min is None:
        return recipe.lr
    alpha = recipe.lr_min / recipe.lr
    t = min(count, recipe.max_iters)
    cosine = 0.5 * (1 + math.cos(math.pi * t / recipe.max_iters))
    return recipe.lr * ((1 - alpha) * cosine + alpha)


def adam_init(raw: Raw) -> dict:
    return {"mu": {k: torch.zeros_like(raw[k]) for k in LEAVES},
            "nu": {k: torch.zeros_like(raw[k]) for k in LEAVES},
            "count": 0}


def adam(raw: Raw, grads: Raw, opt: dict, lr: float):
    """optax's Adam step: the new parameters and state."""
    count = opt["count"] + 1
    c1, c2 = 1 - B1 ** count, 1 - B2 ** count
    new, mu, nu = {}, {}, {}
    for k in LEAVES:
        g = grads[k]
        mu[k] = (1 - B1) * g + B1 * opt["mu"][k]
        nu[k] = (1 - B2) * g * g + B2 * opt["nu"][k]
        new[k] = raw[k] - lr * (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + EPS)
    return new, {"mu": mu, "nu": nu, "count": count}


# ------------------------------------------------------------------ block --

def block(recipe: Recipe, raw: Raw, active, prev_raw: Raw, prev_active,
          opt: dict, iters: int, base, times) -> dict:
    """``len(base)`` Adam iterations from the pre-step count ``iters`` on
    the injected draws (``base (k, m, 2)`` uniform, ``times (k, m)``), the
    previous mixture frozen.  Returns the parameters, Adam's state, each
    iteration's loss and gradient, and the block's mean loss."""
    pm, pc, pv = concrete(prev_raw, recipe.scale)

    def prev_fields(samples):
        with torch.no_grad():
            return mixture(pm, pc, pv, samples, prev_active)
    raw = {k: raw[k].detach() for k in LEAVES}
    losses: List[torch.Tensor] = []
    grads: List[Raw] = []
    for i in range(base.shape[0]):
        loss, g = loss_and_grads(recipe, raw, active, prev_fields, base[i],
                                 times[i])
        raw, opt = adam(raw, g, opt, learning_rate(recipe, iters + i))
        losses.append(loss)
        grads.append(g)
    return {"raw": raw, "opt": opt, "losses": losses, "grads": grads,
            "mean_loss": float(torch.stack(losses).mean())}


def stops(recipe: Recipe, block_losses: Sequence[float], iters: int) -> str:
    """Why a dynamics timestep ends after these block means and
    iterations: ``"tol"``, ``"max_iters"``, or ``""`` (it goes on)."""
    window = list(block_losses[-5:])
    if window and sum(window) / len(window) <= recipe.tol:
        return "tol"
    return "max_iters" if iters >= recipe.max_iters else ""
