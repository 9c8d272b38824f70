"""Fit-to-target initialization: optimize a mixture to match a target field
(port of :mod:`pigs_tpu.train.fit`).

Adam fits raw Gaussian parameters (:class:`pigs_tpu_torch.train.no_mlp.
RawParams`) to a target: an analytic function, an image, or, for FNO
vorticity frames, the curl of a 2-channel field with a divergence penalty.
Optional periodic mean wrapping, densification jitter and an
eigendecomposition split, as in the JAX package.

On CUDA tensors every iteration launches one K1 (the mixture at order 0, or
order 1 for the curl) and one K2 (its Gaussian-side backward); the samples
carry no gradient, so K3 never runs.  A block draws its uniforms up front
(:func:`block_draws`) and makes no host sync; :func:`fit` syncs once a
block, reading the block's mean loss.  The four Adams (one per RawParams
field, each with its own learning rate and count, as JAX's
``optax.multi_transform``) update the parameters in place.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pigs_tpu_torch import gaussians
from pigs_tpu_torch.models.state import _scatter_rows, compact_scatter
from pigs_tpu_torch.ops.mixture import eval_mixture
from pigs_tpu_torch.train.no_mlp import RawParams
from pigs_tpu_torch.train.optim import AdamState, adam_init, adam_update

__all__ = ["FitConfig", "FitOptState", "fit", "gaussian_pair_target",
           "sinusoid_target", "image_target", "block_draws"]


class FitConfig(NamedTuple):
    """The JAX package's ``FitConfig`` with the same defaults, the dtype a
    torch dtype.  ``split_every_blocks`` and ``jitter_every_blocks``: the
    cadence of the split and of the jitter in blocks (0 = off);
    ``tanh_means``: means are ``tanh(raw)``, else raw; ``curl``: fit the
    curl of a 2-channel field (FNO mode); ``periodic``: evaluate on the
    period-2 torus and wrap the raw means into [-1, 1)."""

    d: int = 2
    nx: int = 50
    capacity: int = 4096
    n_samples: int = 1024
    scale: float = 1.0
    lr_means: float = 5e-3
    lr_values: float = 1e-3
    lr_scaling: float = 5e-2
    lr_transforms: float = 5e-2
    init_raw_scaling: float = -5.0
    block_iters: int = 100
    iters: int = 6000
    split_every_blocks: int = 0
    jitter_every_blocks: int = 0
    tanh_means: bool = True
    curl: bool = False
    periodic: bool = False
    dtype: torch.dtype = torch.float32

    @property
    def c(self) -> int:
        return 2 if self.curl else 1


class FitOptState(NamedTuple):
    """``optax.multi_transform``'s state of the four Adams, one per
    RawParams field and in its order, each an :class:`AdamState` over that
    one tensor with its own count."""

    means: AdamState
    values: AdamState
    scaling: AdamState
    transforms: AdamState


def gaussian_pair_target(cfg: FitConfig):
    """Two anisotropic bumps."""
    def f(samples):
        m1 = samples.new_tensor([0.2, 0.0])
        m2 = samples.new_tensor([-0.6, 0.0])
        d1 = samples - m1
        p1 = -0.5 * torch.sum(d1 * d1, dim=-1) / 0.1
        d2 = samples - m2
        p2 = -0.5 * (d2[:, 0] ** 2 / 0.025 + d2[:, 1] ** 2 / 0.1)
        return torch.exp(p1) * 0.5 + torch.exp(p2)

    return f


def sinusoid_target(frequency: float = 1.5 * np.pi):
    """cos(fx) cos(fy)."""
    def f(samples):
        return (torch.cos(frequency * samples[:, 0])
                * torch.cos(frequency * samples[:, 1]))
    return f


def image_target(image: torch.Tensor):
    """Nearest-pixel lookup of a (res, res) image over [-1, 1]^2: the pixel
    index truncates toward zero and is clipped, and the image is read at
    ``[y, x]``."""
    res = image.shape[0]

    def f(samples):
        coords = torch.clamp(((samples + 1.0) / 2.0 * res).to(torch.int32),
                             0, res - 1).long()
        return image[coords[:, 1], coords[:, 0]]

    return f


def _init(cfg: FitConfig, device=None) -> Tuple[RawParams, torch.Tensor]:
    """A grid of ``nx`` (d=1) or ``nx * nx`` Gaussians on [-1, 1]^d, padded
    to capacity, and the active mask, on ``device``."""
    d, dt = cfg.d, cfg.dtype
    if d == 1:
        n = cfg.nx
        means = torch.linspace(-1, 1, n, dtype=dt, device=device).reshape(-1, 1)
    else:
        n = cfg.nx * cfg.nx
        t = torch.linspace(-1, 1, cfg.nx, dtype=dt, device=device)
        gx, gy = torch.meshgrid(t, t, indexing="ij")
        means = torch.stack([gx, gy], dim=-1).reshape(-1, d)
    pad = cfg.capacity - n
    params = RawParams(
        raw_means=torch.cat([means, means.new_zeros((pad, d))]),
        values=torch.zeros((cfg.capacity, cfg.c), dtype=dt, device=device),
        raw_scaling=torch.full((cfg.capacity, d), cfg.init_raw_scaling,
                               dtype=dt, device=device),
        transforms=torch.zeros((cfg.capacity, d * (d - 1) // 2), dtype=dt,
                               device=device),
    )
    return params, torch.arange(cfg.capacity, device=device) < n


def _concrete(cfg: FitConfig, params: RawParams):
    """Raw parameters -> (means, conics, values)."""
    means = (torch.tanh(params.raw_means) if cfg.tanh_means
             else params.raw_means) * 1.0
    scaling = torch.exp(params.raw_scaling)
    if cfg.d == 1:
        conics = (1.0 / scaling)[..., None]
    else:
        _, conics = gaussians.build_full_covariances(scaling, params.transforms)
    return means, conics, params.values


def _render(cfg: FitConfig, params: RawParams, active, samples):
    """The fitted field at ``samples``: ``(value, None)``, or for the curl
    ``(d(u_y)/dx - d(u_x)/dy, div u)``.  A periodic fit also evaluates on
    the torus (period 2): wrapping only the raw means while evaluating in
    free space trains a mixture that scores ~7x worse once the NS pipeline
    evaluates it periodically (t=0 vorticity rel-L2 0.467 against 0.068,
    the JAX package's round-3 NS validation)."""
    means, conics, values = _concrete(cfg, params)
    period = 2.0 if cfg.periodic else None
    if cfg.curl:
        out = eval_mixture(means, conics, values, samples, order=1,
                           mask=active, diff_samples=False, period=period)
        img = out.ux[:, 0, 1] - out.ux[:, 1, 0]
        div = out.ux[:, 0, 0] + out.ux[:, 1, 1]
        return img, div
    out = eval_mixture(means, conics, values, samples, order=0, mask=active,
                       diff_samples=False, period=period)
    return out.u[:, 0], None


def _learning_rates(cfg: FitConfig) -> Tuple[float, float, float, float]:
    """The four Adams' learning rates, in RawParams field order."""
    return cfg.lr_means, cfg.lr_values, cfg.lr_scaling, cfg.lr_transforms


def _opt_init(params: RawParams) -> FitOptState:
    return FitOptState(*(adam_init([p]) for p in params))


def block_draws(cfg: FitConfig, generator: torch.Generator, device=None,
                iters: Optional[int] = None) -> torch.Tensor:
    """A block's U[0, 1) draws, ``(iters, n_samples, d)`` (``block_iters``
    by default), drawn at once on the generator's device and moved to
    ``device``."""
    iters = cfg.block_iters if iters is None else iters
    return torch.rand((iters, cfg.n_samples, cfg.d), generator=generator,
                      dtype=cfg.dtype, device=generator.device).to(device)


def jitter_draws(cfg: FitConfig, generator: torch.Generator,
                 device=None) -> torch.Tensor:
    """The jitter's standard normal draws, ``(capacity, d)``."""
    return torch.randn((cfg.capacity, cfg.d), generator=generator,
                       dtype=cfg.dtype, device=generator.device).to(device)


def _fit_block(cfg: FitConfig, target_fn: Callable, params: RawParams,
               opt_state: FitOptState, active: torch.Tensor,
               draws: torch.Tensor):
    """One Adam iteration per row of ``draws`` (``(iters, n, d)`` U[0, 1),
    mapped to [-1, 1]^d): the squared error to the target (plus the mean
    squared divergence for the curl), the four Adam steps, then the
    periodic wrap of the raw means.  Updates ``params`` in place, makes no
    host sync, and returns ``(params, opt_state, mean loss, the last
    iteration's raw_means gradient)``."""
    lrs = _learning_rates(cfg)
    losses = []
    mean_grad = None
    for u in draws:
        samples = u * 2.0 - 1.0
        img, div = _render(cfg, params, active, samples)
        loss = torch.mean((img - target_fn(samples)) ** 2)
        if div is not None:
            loss = loss + torch.mean(div ** 2)
        grads = torch.autograd.grad(loss, list(params), allow_unused=True)
        # d=1 has no transforms: an empty tensor no loss reaches.
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        opt_state = FitOptState(*(
            adam_update([p], [g], s, lr)
            for p, g, s, lr in zip(params, grads, opt_state, lrs)))
        if cfg.periodic:
            with torch.no_grad():
                # A floored modulo, as jnp.mod: the result takes the
                # divisor's sign.
                params.raw_means.copy_(
                    torch.remainder(params.raw_means + 1.0, 2.0) - 1.0)
        losses.append(loss.detach())
        mean_grad = grads[0]
    return params, opt_state, torch.stack(losses).mean(), mean_grad


@torch.no_grad()
def _eig_split(cfg: FitConfig, params: RawParams, opt_state: FitOptState,
               active: torch.Tensor, last_mean_grad: torch.Tensor):
    """Eigendecomposition split: Gaussians with ``|v| > 0.01`` and a summed
    variance under 0.2 are kept, the others dropped; kept ones whose last
    raw_means gradient exceeds 5e-4 in norm split into a parent displaced
    by ``-pc`` and a child at ``+pc`` (``pc`` = 0.2 x the principal axis),
    both with halved values, the child in the next free (inactive or
    dropped) slot; children beyond the free slots are dropped.  The Adam
    moments of fresh rows (children and dropped slots) are zeroed; each
    group's count is kept.  Returns ``(params, opt_state, active)``."""
    grad_norm = torch.linalg.vector_norm(last_mean_grad, dim=-1)
    keep = ((torch.linalg.vector_norm(params.values, dim=-1) > 0.01)
            & (torch.sum(torch.exp(params.raw_scaling), dim=-1) < 0.2)
            & active)
    want = (grad_norm > 5e-4) & keep

    scaling = torch.exp(params.raw_scaling)
    cov, _ = gaussians.build_full_covariances(scaling, params.transforms)
    pc = gaussians.principal_axis(cov) * 0.2

    parent_means = torch.where(want[:, None], params.raw_means - pc,
                               params.raw_means)
    half_values = torch.where(want[:, None], params.values * 0.5,
                              params.values)
    base = params._replace(raw_means=parent_means, values=half_values)

    dest = compact_scatter(~active | ~keep, want)
    child = base._replace(raw_means=parent_means + 2.0 * pc)
    new_params = RawParams(*[_scatter_rows(b, dest, cb)
                             for b, cb in zip(base, child)])
    landed = _scatter_rows(torch.zeros_like(active), dest, want)
    fresh = (landed | (active & ~keep))[:, None]

    def zero_rows(moments: List[torch.Tensor]) -> List[torch.Tensor]:
        return [torch.where(fresh, torch.zeros_like(m), m) for m in moments]

    new_opt = FitOptState(*(s._replace(mu=zero_rows(s.mu), nu=zero_rows(s.nu))
                            for s in opt_state))
    return new_params, new_opt, keep | landed


@torch.no_grad()
def _jitter(params: RawParams, normals: torch.Tensor) -> RawParams:
    """Densification jitter: the raw means move by ``clip(normals, -1, 1)
    * 0.01``, and the values are zeroed (``values * 0.0``), as in the JAX
    package."""
    return params._replace(
        raw_means=params.raw_means + torch.clamp(normals, -1, 1) * 0.01,
        values=params.values * 0.0)


def fit(cfg: FitConfig, target_fn: Callable, generator: torch.Generator,
        device=None):
    """Run the full fitting loop on ``device``, every draw from
    ``generator``: ``iters // block_iters`` blocks, the split and the
    jitter at their cadences after a block.  Returns ``(params, active,
    loss_history)``, one mean loss a block (the loop's one host sync a
    block)."""
    params, active = _init(cfg, device)
    params = RawParams(*(p.requires_grad_() for p in params))
    opt_state = _opt_init(params)
    losses = []
    for b in range(cfg.iters // cfg.block_iters):
        params, opt_state, loss, last_grad = _fit_block(
            cfg, target_fn, params, opt_state, active,
            block_draws(cfg, generator, device))
        losses.append(float(loss))
        if cfg.split_every_blocks and (b + 1) % cfg.split_every_blocks == 0:
            params, opt_state, active = _eig_split(cfg, params, opt_state,
                                                   active, last_grad)
        if cfg.jitter_every_blocks and (b + 1) % cfg.jitter_every_blocks == 0:
            params = _jitter(params, jitter_draws(cfg, generator, device))
        params = RawParams(*(p.detach().requires_grad_() for p in params))
    return RawParams(*(p.detach() for p in params)), active, losses
