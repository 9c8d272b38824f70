"""Direct ("no-MLP") PDE solving by optimizing Gaussian parameters per
timestep (port of :mod:`pigs_tpu.train.no_mlp`).

Per timestep, Adam optimizes raw Gaussian parameters against the PDE
residual between the frozen previous mixture and the current one; every few
blocks of iterations weak Gaussians are pruned and high-gradient ones split.
Parameters live in fixed-capacity padded buffers with an active mask, as in
the JAX package.

On CUDA tensors every iteration of a dynamics step launches two order-2
K1s (the previous mixture, without a gradient, and the current one) and one
K2 for the current one's backward.  The samples never carry a gradient, so
K3 never runs.  A block draws its random numbers up front
(:func:`block_draws`) and makes no host sync; the only sync is reading the
block's mean loss, which the convergence rule needs.  The Adam step updates
the parameters in place.

:func:`timestep_blocks` runs one timestep as a generator over its blocks,
so a caller sees each block's end; :func:`solve_timestep` and
:func:`solve` consume it.  Spans (``utils.profiling.span``, recorded only
inside ``tracing()``): ``solve`` (one :func:`solve_timestep`), and below it
``solve.block``, with ``solve.draws`` (:func:`block_draws`), the block's
iterations, ``solve.read`` (the block loss's host read and the convergence
rule) and ``solve.densify``; an iteration is a ``step`` with
``step.fields`` (the samples and the previous mixture's fields),
``step.loss`` (the current mixture and the residual), ``step.backward``
(K2) and ``step.adam`` (K6).  The module's counters, read across spans as
the kernels' launch counters are: :data:`iterations`, :data:`blocks`,
:data:`stopped_tol` and :data:`stopped_cap` (timesteps ended by the
convergence rule and by ``max_iters``) and :data:`densify_calls`.
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pigs_tpu_torch import gaussians
from pigs_tpu_torch.models.state import _scatter_rows, compact_scatter
from pigs_tpu_torch.ops.mixture import eval_mixture
from pigs_tpu_torch.pde import Problem
from pigs_tpu_torch.train.optim import AdamState, adam_init, adam_update
from pigs_tpu_torch.utils.profiling import span

__all__ = ["NoMLPConfig", "RawParams", "BlockState", "init_params",
           "concrete", "solve", "solve_timestep", "timestep_blocks",
           "densify", "draw_samples"]

# Process-wide counters (host integers, whatever the device): Adam
# iterations, blocks, timesteps stopped by the convergence rule (the window
# mean under ``tol``; the IC fit's plateau) and by ``max_iters``, and
# densify calls.
iterations = 0
blocks = 0
stopped_tol = 0
stopped_cap = 0
densify_calls = 0


class RawParams(NamedTuple):
    """Optimizable raw parameters (padded to capacity).

    ``raw_means`` map to domain means via ``tanh(raw) * scale``;
    ``raw_scaling`` to variances via ``exp``; ``transforms`` are raw
    off-diagonals (empty for d=1).
    """

    raw_means: torch.Tensor    # (N, d)
    values: torch.Tensor       # (N, c)
    raw_scaling: torch.Tensor  # (N, d)
    transforms: torch.Tensor   # (N, T)


class NoMLPConfig(NamedTuple):
    """The JAX package's ``NoMLPConfig``; its docstrings there explain each
    knob.  ``warm_up_blocks``: blocks before densification may fire within
    a timestep.  ``min_keep``: pruning never leaves fewer active Gaussians
    (0 = the reference's criterion).  ``active_sampling``: the fraction of
    collocation samples drawn around the active Gaussians.  ``lr_min``:
    cosine-decay the learning rate from ``lr`` to it over ``max_iters``
    (None = constant)."""

    problem: Problem
    d: int
    scale: float = 2.5
    n_init: int = 25          # initial grid edge (d=1: count; d=2: nx=ny)
    capacity: int = 1024
    n_samples: int = 128
    dt: float = 0.05
    nu: float = 1.0 / (100.0 * np.pi)
    lr: float = 1e-2
    block_iters: int = 100
    max_iters: int = 5000
    tol: float = 1e-4
    init_raw_scaling: float = -4.0
    dtype: torch.dtype = torch.float32
    warm_up_blocks: int = 0
    min_keep: int = 0
    active_sampling: float = 0.0
    sampling_inflate: float = 3.0
    lr_min: Optional[float] = None

    @property
    def c(self) -> int:
        return 2 if self.problem == Problem.WAVE else 1


def init_params(cfg: NoMLPConfig, device=None
                ) -> Tuple[RawParams, torch.Tensor]:
    """Initial grid of Gaussians, padded to capacity, with the active mask,
    on ``device``."""
    d, dt = cfg.d, cfg.dtype
    if d == 1:
        n = cfg.n_init
        means = torch.linspace(-1, 1, n, dtype=dt, device=device).reshape(-1, 1)
    else:
        n = cfg.n_init * cfg.n_init
        t = torch.linspace(-1, 1, cfg.n_init, dtype=dt, device=device) * 0.1
        gx, gy = torch.meshgrid(t, t, indexing="ij")
        means = torch.atanh(torch.stack([gx, gy], dim=-1).reshape(-1, d))
    pad = cfg.capacity - n
    params = RawParams(
        raw_means=torch.cat([means, means.new_zeros((pad, d))]),
        values=torch.zeros((cfg.capacity, cfg.c), dtype=dt, device=device),
        raw_scaling=torch.full((cfg.capacity, d), cfg.init_raw_scaling,
                               dtype=dt, device=device),
        transforms=torch.zeros((cfg.capacity, d * (d - 1) // 2), dtype=dt,
                               device=device),
    )
    active = torch.arange(cfg.capacity, device=device) < n
    return params, active


def concrete(cfg: NoMLPConfig, params: RawParams):
    """Raw parameters -> (means, conics, values) full matrices."""
    means = torch.tanh(params.raw_means) * cfg.scale
    scaling = torch.exp(params.raw_scaling)
    if cfg.d == 1:
        conics = (1.0 / scaling)[..., None]  # (N, 1, 1)
    else:
        _, conics = gaussians.build_full_covariances(scaling,
                                                     params.transforms)
    return means, conics, params.values


class BlockDraws(NamedTuple):
    """The random numbers of one block, each with the iteration leading.

    ``base`` (iters, n, d): U[0, 1) draws of the uniform samples (standard
    normal draws for the WAVE d=2 IC fit); ``idx`` (iters, n_act) and ``z``
    (iters, n_act, d): the active Gaussians picked and the normal offsets of
    the ``active_sampling`` draw (None without it); ``time`` (iters, n):
    the time samples."""

    base: torch.Tensor
    idx: Optional[torch.Tensor]
    z: Optional[torch.Tensor]
    time: torch.Tensor


def _wave_ic_path(cfg: NoMLPConfig, first_step: bool) -> bool:
    return first_step and cfg.problem == Problem.WAVE and cfg.d == 2


def _n_active_samples(cfg: NoMLPConfig) -> int:
    return int(round(cfg.n_samples * cfg.active_sampling))


def block_draws(cfg: NoMLPConfig, generator: torch.Generator,
                active: torch.Tensor, first_step: bool) -> BlockDraws:
    """Draw a block's random numbers at once, on the generator's device,
    and move them to ``active``'s.  The categorical draw of active
    Gaussians (uniform over the active slots) inverts the mask's cumulative
    sum on the device, so nothing waits for the device."""
    iters, n, d = cfg.block_iters, cfg.n_samples, cfg.d
    device = active.device
    kw = dict(generator=generator, dtype=cfg.dtype, device=generator.device)
    wave_ic = _wave_ic_path(cfg, first_step)
    base = (torch.randn if wave_ic else torch.rand)((iters, n, d), **kw)
    n_act = _n_active_samples(cfg)
    idx = z = None
    if n_act and not wave_ic:
        cdf = torch.cumsum(active.to(cfg.dtype), 0)
        picks = torch.rand((iters, n_act), **kw).to(device)
        idx = torch.clamp(torch.searchsorted(cdf, picks * cdf[-1], right=True),
                          max=cfg.capacity - 1)
        z = torch.randn((iters, n_act, d), **kw).to(device)
    time = torch.rand((iters, n), **kw)
    return BlockDraws(base.to(device), idx, z, time.to(device))


def draw_samples(cfg: NoMLPConfig, base: torch.Tensor, params: RawParams,
                 idx: Optional[torch.Tensor] = None,
                 z: Optional[torch.Tensor] = None,
                 first_step: bool = False) -> torch.Tensor:
    """Collocation points from one iteration's draws (:class:`BlockDraws`
    sliced at the iteration): uniform over the domain, the first
    ``round(n_samples * active_sampling)`` replaced by draws around the
    active Gaussians ``idx`` (``mean + inflate * sqrt(var) * z``, clipped to
    the domain).  The WAVE d=2 IC fit concentrates the samples near the
    bump instead: ``clip(normal / 2, -1, 1) * scale``.  The samples carry no
    gradient."""
    if _wave_ic_path(cfg, first_step):
        return torch.clamp(base / 2.0, -1.0, 1.0) * cfg.scale
    samples = (base * 2.0 - 1.0) * cfg.scale
    n_act = _n_active_samples(cfg)
    if n_act == 0:
        return samples
    with torch.no_grad():
        means = torch.tanh(params.raw_means) * cfg.scale
        sigma = torch.sqrt(torch.exp(params.raw_scaling)) * cfg.sampling_inflate
        pts = torch.clamp(means[idx] + sigma[idx] * z, -cfg.scale, cfg.scale)
    return torch.cat([pts, samples[n_act:]], dim=0)


def _initial_target(cfg: NoMLPConfig, samples: torch.Tensor) -> torch.Tensor:
    """The initial conditions: exp(-2 x^2) in 1D, a centred bump of variance
    0.01 * scale (WAVE) or 0.1 * scale in 2D."""
    if cfg.d == 1:
        return torch.exp(-2.0 * samples[:, 0] ** 2)
    var = (0.01 if cfg.problem == Problem.WAVE else 0.1) * cfg.scale
    power = -0.5 * torch.sum(samples * samples, dim=-1) / var
    return torch.exp(power)


def _pde_residual_loss(cfg: NoMLPConfig, u, ux, uxx, ut):
    """Per-problem mean squared residual."""
    p = cfg.problem
    if cfg.d == 1:
        lap = uxx[:, 0, 0, 0]
    else:
        lap = uxx[:, 0, 0, 0] + uxx[:, 1, 1, 0]
    if p == Problem.WAVE:
        loss1 = torch.mean((ut[:, 1] - (10.0 * lap - 0.1 * u[:, 1])) ** 2)
        loss2 = torch.mean((ut[:, 0] - u[:, 1]) ** 2)
        w1 = 0.1 if cfg.d == 1 else 0.01
        return w1 * loss1 + loss2
    if p == Problem.BURGERS:
        return torch.mean((ut[:, 0] - (cfg.nu * lap
                                       - u[:, 0] * ux[:, 0, 0])) ** 2)
    if p == Problem.DIFFUSION:
        return torch.mean((ut[:, 0] - lap) ** 2)
    raise ValueError(f"no-MLP solver does not support {p}")


def _loss_fn(cfg: NoMLPConfig, params: RawParams, active, prev, samples,
             time_samples, first_step: bool):
    means, conics, values = concrete(cfg, params)
    if first_step:
        out = eval_mixture(means, conics, values, samples, order=0,
                           mask=active)
        desired = _initial_target(cfg, samples)
        if cfg.problem == Problem.WAVE:
            if cfg.d == 1:
                return (torch.mean((out.u[:, 0] - desired) ** 2)
                        + torch.mean((out.u[:, 1] - desired) ** 2))
            return (torch.mean((out.u[:, 1] - desired) ** 2)
                    + torch.mean(out.u[:, 0] ** 2))
        return torch.mean((out.u[:, 0] - desired) ** 2)

    prev_u, prev_ux, prev_uxx = prev
    out = eval_mixture(means, conics, values, samples, order=2, mask=active)
    ut = (out.u - prev_u) / cfg.dt
    ts = time_samples
    u = ts[:, None] * prev_u + (1 - ts[:, None]) * out.u
    ux = ts[:, None, None] * prev_ux + (1 - ts[:, None, None]) * out.ux
    uxx = (ts[:, None, None, None] * prev_uxx
           + (1 - ts[:, None, None, None]) * out.uxx)
    return _pde_residual_loss(cfg, u, ux, uxx, ut)


def _make_opt(cfg: NoMLPConfig) -> Callable[[int], float]:
    """The learning rate of the iteration whose pre-step Adam count is
    ``count``: ``lr``, or with ``lr_min`` optax's
    ``cosine_decay_schedule(lr, max_iters, alpha=lr_min / lr)``, which holds
    ``lr_min`` past ``max_iters``.  The count restarts every timestep, as
    the JAX package re-inits its optimizer."""
    if cfg.lr_min is None:
        return lambda count: cfg.lr
    alpha = cfg.lr_min / cfg.lr

    def schedule(count: int) -> float:
        t = min(count, cfg.max_iters)
        cosine = 0.5 * (1 + math.cos(math.pi * t / cfg.max_iters))
        return cfg.lr * ((1 - alpha) * cosine + alpha)
    return schedule


def _run_block(cfg: NoMLPConfig, params: RawParams, opt_state: AdamState,
               active, prev_mixture, first_step: bool, draws: BlockDraws,
               count: int):
    """``block_iters`` Adam iterations from the pre-step Adam count
    ``count``, on the draws given.  Updates ``params`` in place; returns
    ``(params, opt_state, grad_acc, mean loss)``, ``grad_acc`` the sum of
    the block's gradients (a :class:`RawParams`)."""
    global iterations
    schedule = _make_opt(cfg)
    grad_acc = [torch.zeros_like(p) for p in params]
    losses = []
    for i in range(cfg.block_iters):
        with span("step"):
            with span("step.fields"):
                samples = draw_samples(
                    cfg, draws.base[i], params,
                    None if draws.idx is None else draws.idx[i],
                    None if draws.z is None else draws.z[i], first_step)
                prev = None
                if not first_step:
                    pm, pc, pv, pa = prev_mixture
                    with torch.no_grad():
                        pout = eval_mixture(pm, pc, pv, samples, order=2,
                                            mask=pa)
                    prev = (pout.u, pout.ux, pout.uxx)
            with span("step.loss"):
                loss = _loss_fn(cfg, params, active, prev, samples,
                                draws.time[i], first_step)
            with span("step.backward"):
                grads = torch.autograd.grad(loss, list(params),
                                            allow_unused=True)
                # d=1 has no transforms: an empty tensor no loss reaches.
                grads = [torch.zeros_like(p) if g is None else g
                         for p, g in zip(params, grads)]
            with span("step.adam"):
                opt_state = adam_update(params, grads, opt_state,
                                        schedule(count + i))
            torch._foreach_add_(grad_acc, grads)
            losses.append(loss.detach())
            iterations += 1
    return params, opt_state, RawParams(*grad_acc), torch.stack(losses).mean()


@torch.no_grad()
def densify(cfg: NoMLPConfig, params: RawParams, opt_state: AdamState,
            active: torch.Tensor, mean_grad_acc: torch.Tensor):
    """Prune + split with Adam-moment surgery.

    keep:   ||v|| > 0.01  and  sum(exp(raw_scaling)) < 0.5 (with
            ``min_keep``, the top ``min_keep`` active slots by value norm
            when fewer would survive);
    split:  mean-grad norm above mean + 1.6 * (population) std over the
            active slots, the child displaced along the accumulated
            mean-gradient into a free slot.
    The moments of fresh slots (children, and pruned slots) are zeroed; the
    count is kept.  Returns ``(params, opt_state, active)``.
    """
    global densify_calls
    densify_calls += 1
    grad_norm = torch.linalg.vector_norm(mean_grad_acc, dim=-1)
    value_norm = torch.linalg.vector_norm(params.values, dim=-1)
    keep = ((value_norm > 0.01)
            & (torch.sum(torch.exp(params.raw_scaling), dim=-1) < 0.5))
    keep = keep & active
    if cfg.min_keep > 0:
        # Fewer than min_keep active slots make the kth value -inf, and the
        # fallback then keeps every active slot.
        vnorm = torch.where(active, value_norm, -math.inf)
        kth = torch.sort(vnorm).values[-cfg.min_keep]
        fallback = active & (vnorm >= kth)
        keep = torch.where(torch.sum(keep) >= cfg.min_keep, keep, fallback)

    g = torch.where(active, grad_norm, math.nan)
    mu = torch.nanmean(g)
    sd = torch.sqrt(torch.nanmean((g - mu) ** 2))
    want = (grad_norm > mu + 1.6 * sd) & keep

    # Splitting into a slot that was just pruned is fine: pruned slots are
    # free.
    dest = compact_scatter(~active | ~keep, want)
    landed = _scatter_rows(torch.zeros_like(active), dest, want)
    child = params._replace(raw_means=params.raw_means + mean_grad_acc)
    new_params = RawParams(*[_scatter_rows(b, dest, cb)
                             for b, cb in zip(params, child)])

    fresh = (landed | (active & ~keep))[:, None]

    def zero_rows(moments: List[torch.Tensor]) -> List[torch.Tensor]:
        return [torch.where(fresh, torch.zeros_like(m), m) for m in moments]

    return (new_params, opt_state._replace(mu=zero_rows(opt_state.mu),
                                           nu=zero_rows(opt_state.nu)),
            keep | landed)


class BlockState(NamedTuple):
    """What :func:`timestep_blocks` yields after each block: the live
    ``params`` (Adam updates them in place), ``opt_state``, ``active``, the
    block's mean ``loss`` as read on the host, ``iters`` (the iterations the
    timestep has run, which is the next block's pre-step Adam count) and
    ``done`` (the timestep ends with this block)."""

    params: RawParams
    opt_state: AdamState
    active: torch.Tensor
    loss: float
    iters: int
    done: bool


def timestep_blocks(cfg: NoMLPConfig, params: RawParams, active,
                    prev_mixture, generator: torch.Generator,
                    first_step: bool, densify_every: Optional[int] = None):
    """Optimize one timestep, yielding a :class:`BlockState` after each
    block's host read of its mean loss (and the densify that follows it).

    Block losses (means over ``block_iters`` iterations) feed a 5-block
    window; the IC fit (``first_step``) runs until the window's relative
    std drops to 0.1 (a plateau), dynamics steps until the window mean
    drops to ``tol``; both cap at ``max_iters`` iterations.  Densification
    waits out ``cfg.warm_up_blocks``.  ``params`` are copied, not changed;
    a fresh Adam state starts at count 0.  A caller may stop between
    blocks.
    """
    global blocks, stopped_tol, stopped_cap
    params = RawParams(*(p.detach().clone().requires_grad_()
                         for p in params))
    opt_state = adam_init(params)
    mean_grad_acc = torch.zeros_like(params.raw_means)
    it = 0
    block = 0
    block_losses = []

    def converged() -> bool:
        window = block_losses[-5:]
        if first_step:
            if len(window) < 2:
                return False
            mean = float(np.mean(window))
            rel_std = float(np.std(window, ddof=1)) / mean if mean else 0.0
            return not np.isnan(rel_std) and rel_std <= 0.1
        return bool(window) and float(np.mean(window)) <= cfg.tol

    done = it >= cfg.max_iters or converged()
    while not done:
        with span("solve.block"):
            blocks += 1
            with span("solve.draws"):
                draws = block_draws(cfg, generator, active, first_step)
            params, opt_state, grad_acc, loss_b = _run_block(
                cfg, params, opt_state, active, prev_mixture, first_step,
                draws, it)
            mean_grad_acc = (mean_grad_acc
                             + grad_acc.raw_means / cfg.block_iters)
            with span("solve.read"):
                loss = float(loss_b)
                block_losses.append(loss)
                it += cfg.block_iters
                block += 1
                stop = converged()
                done = stop or it >= cfg.max_iters
                if stop:
                    stopped_tol += 1
                elif done:
                    stopped_cap += 1
            if (densify_every and block % densify_every == 0
                    and block > cfg.warm_up_blocks and not first_step):
                with span("solve.densify"):
                    params, opt_state, active = densify(
                        cfg, params, opt_state, active, mean_grad_acc)
                    params = RawParams(*(p.requires_grad_() for p in params))
                    mean_grad_acc = torch.zeros_like(params.raw_means)
        yield BlockState(params, opt_state, active, loss, it, done)


def solve_timestep(cfg: NoMLPConfig, params: RawParams, active,
                   prev_mixture, generator: torch.Generator,
                   first_step: bool, densify_every: Optional[int] = None):
    """Optimize one timestep to convergence: every block of
    :func:`timestep_blocks`.  ``params`` are copied, not changed.  Returns
    ``(params, active, loss, iterations run)``, ``loss`` the mean of the
    last five block losses."""
    state, losses = None, []
    with span("solve"):
        for state in timestep_blocks(cfg, params, active, prev_mixture,
                                     generator, first_step, densify_every):
            losses.append(state.loss)
    if state is None:
        return (RawParams(*(p.detach().clone() for p in params)), active,
                np.inf, 0)
    return (RawParams(*(p.detach() for p in state.params)), state.active,
            float(np.mean(losses[-5:])), state.iters)


def solve(cfg: NoMLPConfig, generator: torch.Generator, n_timesteps: int,
          densify_every: Optional[int] = None, device=None):
    """Full outer loop over timesteps on ``device``, every draw from
    ``generator``; returns the trajectory of mixtures (dicts of ``params``,
    ``active``, ``loss`` and ``iters``, the iterations the timestep ran)."""
    params, active = init_params(cfg, device)
    trajectory = []
    prev_mixture = None
    for i in range(n_timesteps):
        params, active, loss, iters = solve_timestep(
            cfg, params, active, prev_mixture, generator,
            first_step=(i == 0), densify_every=densify_every)
        with torch.no_grad():
            means, conics, values = concrete(cfg, params)
        prev_mixture = (means, conics, values, active)
        trajectory.append({"params": params, "active": active, "loss": loss,
                           "iters": iters})
    return trajectory
