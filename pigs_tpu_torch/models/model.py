"""Initial conditions, the dynamics timestep, adaptive splitting and the
physics losses (port of :mod:`pigs_tpu.models.model`).

``forward_step`` samples the full mixture at the Gaussian centres (order 2,
mask = active) without autograd, as the JAX code's ``stop_gradient`` does,
feeds the network, and applies boundary-masked Euler increments.
``sample_fields`` samples the interior mixture at the collocation and
boundary points with autograd (its backward is K2 on the GPU), and
``compute_loss`` turns two consecutive samplings into the losses.

``ModelConfig.mixture_impl`` picks the mixture path of every call here:
``"auto"`` (the kernels on CUDA, their plain twins on the CPU) or
``"plain"`` (the blockwise dense oracle, differentiated by torch autograd).
Random initial conditions draw from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from pigs_tpu_torch.models.dynamics import Deltas, DynamicsNetwork
from pigs_tpu_torch.models.state import (MixtureState, covariance_of,
                                         init_state, prune, split)
from pigs_tpu_torch.ops.aggregate import neighbor_mask
from pigs_tpu_torch.ops.mixture import eval_mixture
from pigs_tpu_torch.pde import (IntegrationRule, PDECoefficients, Problem,
                                channels, pde_rhs, pde_size, time_integrate)
from pigs_tpu_torch.utils.profiling import span

__all__ = ["LossWeights", "ModelConfig", "StepFields", "Losses",
           "make_network", "make_initial_state", "grid_state_dynamic",
           "randomize_state", "randomize_state_dynamic", "sample_fields", "network_inputs",
           "forward_step",
           "adaptive_split", "peak_vorticity_contribution", "compute_loss"]


class LossWeights(NamedTuple):
    """Per-problem loss weights."""

    pde: float
    bc: float
    conservation: float
    initial: float
    du: float
    dmean: float
    dtransform: float
    dscale: float

    @staticmethod
    def default(problem: Problem) -> "LossWeights":
        if problem == Problem.TEST:
            return LossWeights(pde=10.0, bc=2.0, conservation=0.5, initial=1.0,
                               du=4.0, dmean=4.0, dtransform=1.0, dscale=1.0)
        return LossWeights(pde=1.0, bc=1.0, conservation=0.1, initial=2.0,
                           du=1.0, dmean=2.0, dtransform=2.0, dscale=2.0)


class ModelConfig(NamedTuple):
    problem: Problem
    rule: IntegrationRule
    nx: int
    ny: int
    d: int
    scale: float
    capacity: int
    weights: LossWeights
    coeff: PDECoefficients
    dtype: torch.dtype = torch.float32
    width_mult: int = 1
    split_criteria: str = "value"  # "value" (Burgers) or "vorticity" (NS)
    mixture_impl: str = "auto"     # eval_mixture's impl on every call

    @property
    def channels(self) -> int:
        return channels(self.problem)

    @property
    def pde_size(self) -> int:
        return pde_size(self.problem)

    @property
    def period(self) -> Optional[float]:
        """Torus period for periodic problems (Navier-Stokes)."""
        return 2.0 if self.problem == Problem.NAVIER_STOKES else None

    @staticmethod
    def create(problem: Problem,
               rule: IntegrationRule = IntegrationRule.TRAPEZOID,
               nx: int = 20, ny: int = 20, d: int = 2, scale: float = 1.0,
               capacity: Optional[int] = None,
               dtype=torch.float32, width_mult: int = 1,
               split_criteria: str = "value",
               mixture_impl: str = "auto") -> "ModelConfig":
        if capacity is None:
            # Covers the training-time randomized ICs (grid edge up to 39),
            # the <= 100 boundary Gaussians and split margin.
            capacity = max(2 * nx * ny + 128, 1664 if d == 2 else 2 * 40 + 128)
        return ModelConfig(problem=problem, rule=rule, nx=nx, ny=ny, d=d,
                           scale=scale, capacity=capacity,
                           weights=LossWeights.default(problem),
                           coeff=PDECoefficients.default(problem), dtype=dtype,
                           width_mult=width_mult, split_criteria=split_criteria,
                           mixture_impl=mixture_impl)


def make_network(cfg: ModelConfig, frequencies: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 device=None) -> DynamicsNetwork:
    """The dynamics network for ``cfg``, in ``cfg.dtype`` on ``device``."""
    net = DynamicsNetwork(c=cfg.channels, d=cfg.d, pde_size=cfg.pde_size,
                          width_mult=cfg.width_mult, frequencies=frequencies,
                          generator=generator)
    return net.to(device=device, dtype=cfg.dtype)


def _linspace(n, cfg, device):
    return torch.linspace(-1, 1, n, dtype=cfg.dtype, device=device) * cfg.scale


def _boundary_gaussians(cfg: ModelConfig, device=None):
    """Fixed boundary Gaussians per problem."""
    d, scale, c, dt = cfg.d, cfg.scale, cfg.channels, cfg.dtype
    T = d * (d - 1) // 2
    kw = dict(dtype=dt, device=device)
    if cfg.problem == Problem.NAVIER_STOKES:
        return (torch.zeros((0, d), **kw), torch.zeros((0, d), **kw),
                torch.zeros((0, T), **kw), torch.zeros((0, c), **kw))
    if cfg.problem == Problem.TEST:
        nb = 50
        ones = torch.ones(nb // 2, **kw) * scale
        rng = _linspace(nb // 2, cfg, device)
        means = torch.cat([torch.stack([rng, ones], dim=-1),
                           torch.stack([rng, -ones], dim=-1)])
        u = torch.cat([-torch.ones((nb // 2, c), **kw),
                       torch.ones((nb // 2, c), **kw)])
        scaling = torch.ones((nb, d), **kw) / nb * scale * 1.5
        return means, scaling, torch.zeros((nb, T), **kw), u
    nb = 100
    ones = torch.ones(nb // 4, **kw) * scale
    rng = _linspace(nb // 4, cfg, device)
    means = torch.cat([
        torch.stack([-ones, rng], dim=-1),
        torch.stack([ones, rng], dim=-1),
        torch.stack([rng, -ones], dim=-1),
        torch.stack([rng, ones], dim=-1),
    ])
    scaling = torch.ones((nb, d), **kw) / nb * scale
    return (means, scaling, torch.zeros((nb, T), **kw),
            torch.zeros((nb, c), **kw))


def _interior_grid(cfg: ModelConfig, n: int, device=None):
    """Regular n x n interior grid with the Gaussian-bump initial field."""
    d, scale, c, dt = cfg.d, cfg.scale, cfg.channels, cfg.dtype
    kw = dict(dtype=dt, device=device)
    t = _linspace(n, cfg, device)
    gx, gy = torch.meshgrid(t, t, indexing="ij")
    means = torch.stack([gx, gy], dim=-1).reshape(-1, d)
    scaling = torch.exp(torch.full((n * n, d), -4.0, **kw)) * scale / (n / 20.0)
    transforms = torch.zeros((n * n, d * (d - 1) // 2), **kw)
    if cfg.problem in (Problem.BURGERS, Problem.DIFFUSION):
        var = 0.1 * scale
        power = -0.5 * torch.sum(means * means, dim=-1) / var
        u = (torch.exp(power) / 3.0)[:, None]
    elif cfg.problem == Problem.WAVE:
        u = torch.zeros((n * n, c), **kw)
        idx = [(n // 2 + i) * n + n // 2 + j
               for i in range(-2, 3) for j in range(-2, 3)]
        u[idx] = torch.tensor([0.2, 0.2 / cfg.coeff.wave_psi_scale], **kw)
    else:
        u = torch.zeros((n * n, c), **kw)
    return means, scaling, transforms, u


def make_initial_state(cfg: ModelConfig, n: Optional[int] = None,
                       device=None) -> MixtureState:
    """Initial padded state with boundary and interior Gaussians on
    ``device``; ``Problem.TEST`` places 6 unit-value Gaussians in a line."""
    n = n if n is not None else cfg.nx
    bm, bs, bt, bu = _boundary_gaussians(cfg, device)
    if cfg.problem == Problem.TEST:
        kw = dict(dtype=cfg.dtype, device=device)
        nx, ny, d = cfg.nx, cfg.ny, cfg.d
        t = _linspace(nx, cfg, device)
        gx, gy = torch.meshgrid(t, t, indexing="ij")
        grid = torch.stack([gx, gy], dim=-1).reshape(-1, d)
        means = grid[(nx // 2 - 3) * ny + ny // 2:
                     (nx // 2 + 3) * ny + ny // 2:ny]
        scaling = torch.exp(torch.full((6, d), -4.0, **kw)) * cfg.scale
        transforms = torch.zeros((6, d * (d - 1) // 2), **kw)
        u = torch.ones((6, cfg.channels), **kw)
    else:
        means, scaling, transforms, u = _interior_grid(cfg, n, device)
    return init_state(cfg.capacity, means, scaling, transforms, u,
                      bm, bs, bt, bu)


def _apply_ic_noise(cfg: ModelConfig, state: MixtureState,
                    draws: Sequence[torch.Tensor]) -> MixtureState:
    """The IC noise on the interior slots, given four standard-normal draws
    shaped like ``(means, u, scaling, transforms)``."""
    interior = state.interior
    gate = interior[:, None].to(cfg.dtype)
    n_means, n_u, n_scaling, n_transforms = draws
    means = state.means + n_means * 0.2 * gate
    means = torch.where(interior[:, None],
                        torch.tanh(means / cfg.scale) * cfg.scale * 0.95, means)
    u = state.u + n_u * 0.1 * gate
    scaling = torch.where(interior[:, None],
                          state.scaling * torch.exp(n_scaling * 0.5),
                          state.scaling)
    transforms = torch.where(interior[:, None], torch.tanh(n_transforms * 0.3),
                             state.transforms)
    return state._replace(means=means, u=u, scaling=scaling,
                          transforms=transforms)


def _randomize_test(cfg: ModelConfig, draws: Sequence[float],
                    device=None) -> MixtureState:
    """TEST randomization from five U[0, 1) draws: the 6-Gaussian line moves
    to a random height (near an edge one time in four) with a random
    value."""
    state = make_initial_state(cfg, device=device)
    edge = draws[0] > 0.75
    y_edge = (0.9 + draws[1] * 0.1) * (1.0 if draws[2] > 0.5 else -1.0)
    y = y_edge if edge else (draws[3] * 2.0 - 1.0) * 0.9
    val = draws[4] * 2.0 - 1.0
    interior = state.interior[:, None]
    means = torch.where(interior, torch.stack(
        [state.means[:, 0], torch.full_like(state.means[:, 1], y)], dim=-1),
        state.means)
    u = state.u.clone()
    u[:, 0] = torch.where(state.interior, torch.full_like(u[:, 0], val),
                          u[:, 0])
    return state._replace(means=means, u=u)


def _test_draws(generator: torch.Generator) -> list:
    """TEST's five U[0, 1) draws, on the generator's device."""
    return torch.rand(5, generator=generator, dtype=torch.float64,
                      device=generator.device).tolist()


def _ic_noise_draws(cfg: ModelConfig, generator: torch.Generator,
                    state: MixtureState) -> list:
    """Four standard-normal tensors shaped like ``(means, u, scaling,
    transforms)``, drawn on the generator's device and moved to the
    state's."""
    return [torch.randn(x.shape, generator=generator, dtype=cfg.dtype,
                        device=generator.device).to(state.means.device)
            for x in (state.means, state.u, state.scaling, state.transforms)]


def randomize_state(cfg: ModelConfig, generator: Optional[torch.Generator],
                    n: int, draws: Optional[Sequence] = None,
                    device=None) -> MixtureState:
    """Domain-randomized IC: the ``n x n`` grid of
    ``make_initial_state(cfg, n)`` with noise on means, values, scalings and
    transforms (TEST: the 6-Gaussian line moved, with a random value).

    The draws come from ``generator`` unless given: four standard-normal
    tensors shaped like ``(means, u, scaling, transforms)`` (TEST: five
    U[0, 1) numbers), so that tests can hand in the JAX package's."""
    if cfg.problem == Problem.TEST:
        return _randomize_test(
            cfg, _test_draws(generator) if draws is None else draws, device)
    state = make_initial_state(cfg, n=n, device=device)
    if draws is None:
        draws = _ic_noise_draws(cfg, generator, state)
    return _apply_ic_noise(cfg, state, [
        torch.as_tensor(x, dtype=cfg.dtype, device=state.means.device)
        for x in draws])


def grid_state_dynamic(cfg: ModelConfig, n: int, n_max: int,
                       device=None) -> MixtureState:
    """Noise-free ``n x n`` grid IC laid out over ``n_max^2`` interior slots:
    slots past ``n^2`` are inactive, so every grid edge gives the same
    shapes.  Port of the JAX function with the same arithmetic (the grid is
    ``-1 + i * step``, not a linspace)."""
    d, scale, c, dt = cfg.d, cfg.scale, cfg.channels, cfg.dtype
    kw = dict(dtype=dt, device=device)
    bm, bs, bt, bu = _boundary_gaussians(cfg, device)
    nb = bm.shape[0]
    if nb + n_max * n_max > cfg.capacity:
        raise ValueError(f"capacity {cfg.capacity} < boundary {nb} + n_max^2 "
                         f"{n_max * n_max}")
    s = torch.arange(n_max * n_max, device=device)
    gi = torch.clamp(torch.div(s, n, rounding_mode="floor"), max=n - 1)
    gj = torch.clamp(s % n, max=n - 1)
    nf = float(n)
    step = 2.0 / max(nf - 1.0, 1.0)
    gx = (-1.0 + gi.to(dt) * step) * scale
    gy = (-1.0 + gj.to(dt) * step) * scale
    means = torch.stack([gx, gy], dim=-1)
    scaling = torch.exp(torch.full((n_max * n_max, d), -4.0, **kw)) * (
        scale / (nf / 20.0))
    transforms = torch.zeros((n_max * n_max, d * (d - 1) // 2), **kw)
    if cfg.problem in (Problem.BURGERS, Problem.DIFFUSION):
        power = -0.5 * torch.sum(means * means, dim=-1) / (0.1 * scale)
        u = (torch.exp(power) / 3.0)[:, None].repeat(1, c)
    elif cfg.problem == Problem.WAVE:
        center = ((gi - n // 2).abs() <= 2) & ((gj - n // 2).abs() <= 2)
        amp = torch.tensor([0.2, 0.2 / cfg.coeff.wave_psi_scale], **kw)
        u = torch.where(center[:, None], amp[None, :],
                        torch.zeros((n_max * n_max, c), **kw))
    else:
        u = torch.zeros((n_max * n_max, c), **kw)

    cap = cfg.capacity
    pad = cap - nb - n_max * n_max
    active = torch.cat([torch.ones(nb, dtype=torch.bool, device=device),
                        s < n * n,
                        torch.zeros(pad, dtype=torch.bool, device=device)])

    def assemble(b, x, fill=0.0):
        return torch.cat([b, x, torch.full((pad,) + tuple(x.shape[1:]), fill,
                                           **kw)])

    return MixtureState(
        means=assemble(bm, means),
        scaling=torch.where(active[:, None], assemble(bs, scaling, 1.0),
                            torch.ones((cap, d), **kw)),
        transforms=assemble(bt, transforms),
        u=assemble(bu, u),
        active=active,
        boundary=torch.arange(cap, device=device) < nb)


def randomize_state_dynamic(cfg: ModelConfig, generator: torch.Generator,
                            n: int, n_max: int, device=None) -> MixtureState:
    """Domain-randomized IC: the ``n x n`` grid of :func:`grid_state_dynamic`
    with noise on means, values, scalings and transforms (TEST: the moved
    6-Gaussian line), drawn from ``generator``."""
    if cfg.problem == Problem.TEST:
        return _randomize_test(cfg, _test_draws(generator), device)
    state = grid_state_dynamic(cfg, n, n_max, device)
    return _apply_ic_noise(cfg, state, _ic_noise_draws(cfg, generator, state))


class StepFields(NamedTuple):
    """Field samples at the collocation points for one timestep."""

    u: torch.Tensor                       # (m, c)
    ux: torch.Tensor                      # (m, d, c)
    uxx: torch.Tensor                     # (m, d, d, c)
    bc_u: torch.Tensor                    # (mb, c)
    w: Optional[torch.Tensor] = None      # (m,)       NS vorticity
    wx: Optional[torch.Tensor] = None     # (m, d)
    wxx: Optional[torch.Tensor] = None    # (m, d, d)

    def detach(self) -> "StepFields":
        return StepFields(*(None if x is None else x.detach() for x in self))


def sample_fields(cfg: ModelConfig, state: MixtureState, samples: torch.Tensor,
                  bc_samples: torch.Tensor) -> StepFields:
    """Sample the interior mixture at the collocation points (order 2, 3 for
    NS) and at the boundary points (order 0)."""
    ns = cfg.problem == Problem.NAVIER_STOKES
    _, conics = covariance_of(state)
    mask = state.interior
    out = eval_mixture(state.means, conics, state.u, samples,
                       order=3 if ns else 2, mask=mask, period=cfg.period,
                       impl=cfg.mixture_impl)
    bc = eval_mixture(state.means, conics, state.u, bc_samples, order=0,
                      mask=mask, period=cfg.period, impl=cfg.mixture_impl)
    w = wx = wxx = None
    if ns:
        w = out.ux[:, 0, 1] - out.ux[:, 1, 0]
        wx = out.uxx[..., 0, 1] - out.uxx[..., 1, 0]
        wxx = out.uxxx[..., 0, 1] - out.uxxx[..., 1, 0]
    return StepFields(u=out.u, ux=out.ux, uxx=out.uxx, bc_u=bc.u, w=w, wx=wx,
                      wxx=wxx)


def network_inputs(cfg: ModelConfig, state: MixtureState, t: float = 0.0
                   ) -> tuple:
    """The dynamics network's arguments at ``state``, as
    :func:`forward_step` passes them: ``(means, full_cov, u, boundaries,
    sample_u, sample_ux, sample_uxx, sample_pde, active, nbr_mask)``.  The
    mixture is sampled at the means (order 2, 3 for NS, mask = active)
    without autograd; the neighbourhood is :func:`neighbor_mask`."""
    ns = cfg.problem == Problem.NAVIER_STOKES
    full_cov, conics = covariance_of(state)
    n = state.capacity

    with torch.no_grad():
        fields = eval_mixture(state.means, conics, state.u, state.means,
                              order=3 if ns else 2, mask=state.active,
                              period=cfg.period, impl=cfg.mixture_impl)
        if ns:
            wx = fields.uxx[..., 0, 1] - fields.uxx[..., 1, 0]
            wxx = fields.uxxx[..., 0, 1] - fields.uxxx[..., 1, 0]
            sample_pde = pde_rhs(cfg.problem, cfg.coeff, state.means, fields.u,
                                 fields.ux, fields.uxx, wx, wxx, t=t)
        else:
            sample_pde = pde_rhs(cfg.problem, cfg.coeff, state.means, fields.u,
                                 fields.ux, fields.uxx, t=t)
        sample_pde = sample_pde.reshape(n, -1)
        sample_ux = fields.ux.reshape(n, -1)
        # Hessian diagonal only, per-dimension concatenated.
        diag = torch.stack([fields.uxx[:, a, a, :] for a in range(cfg.d)],
                           dim=1)
        sample_uxx = diag.reshape(n, -1)

    nbr = neighbor_mask(state.means, full_cov, active=state.active,
                        period=cfg.period)
    return (state.means, full_cov, state.u, state.boundary.to(cfg.dtype),
            fields.u, sample_ux, sample_uxx, sample_pde, state.active, nbr)


def forward_step(cfg: ModelConfig, network: DynamicsNetwork,
                 state: MixtureState, t: float = 0.0
                 ) -> Tuple[MixtureState, Deltas]:
    """One dynamics timestep: sample the mixture at the means, predict the
    deltas, and apply them to the interior Gaussians."""
    with span("network"):
        with span("network.inputs"):
            inputs = network_inputs(cfg, state, t)
        with span("network.forward"):
            deltas = network(*inputs, cfg.period)

        gate = state.interior[:, None].to(cfg.dtype)
        means = state.means + deltas.dmeans * gate
        scaling = state.scaling * torch.exp(deltas.dscaling * gate)
        transforms = state.transforms + deltas.dtransforms * gate
        u = state.u + deltas.du * gate
        if cfg.period is not None:
            # Keep interior means inside the fundamental domain.
            means = torch.where(
                state.interior[:, None],
                means - cfg.period * torch.round(means / cfg.period), means)
        return state._replace(means=means, scaling=scaling,
                              transforms=transforms, u=u), deltas


def _density_rank(cfg: ModelConfig, state: MixtureState, conics):
    """Rank-normalized mixture density at the means, inverted so sparse
    regions weigh more."""
    ones = torch.ones((state.capacity, 1), dtype=cfg.dtype,
                      device=state.means.device)
    density = eval_mixture(state.means, conics, ones, state.means, order=0,
                           mask=state.active, period=cfg.period,
                           impl=cfg.mixture_impl).u
    act = state.active[:, None]
    d_min = torch.min(torch.where(act, density, torch.inf))
    d_max = torch.max(torch.where(act, density, -torch.inf))
    return 1.0 - (density - d_min) / torch.clamp(d_max, min=1e-30)


def peak_vorticity_contribution(conics, u):
    """Closed-form peak ``|curl|`` of each Gaussian's own velocity term,
    ``e^{-1/2} sqrt(c^T A c)`` with ``c = (u_y, -u_x)``; ``conics`` full
    ``(n, 2, 2)``."""
    cx, cy = u[:, 1], -u[:, 0]
    quad = (conics[:, 0, 0] * cx * cx + 2.0 * conics[:, 0, 1] * cx * cy
            + conics[:, 1, 1] * cy * cy)
    return math.exp(-0.5) * torch.sqrt(torch.clamp(quad, min=0.0))


def adaptive_split(cfg: ModelConfig, state: MixtureState,
                   prev_state: MixtureState,
                   quantile: float = 0.98) -> MixtureState:
    """Prune weak Gaussians and split the fastest-changing ones.

    ``"value"`` criteria: prune ``|u| < 0.01``; split where the
    density-weighted squared change of the value since ``prev_state``
    exceeds its 98th percentile over the interior.  ``"vorticity"`` (d=2,
    c=2): prune below 1 % of the strongest peak vorticity contribution;
    split on the change of the rendered vorticity.  Runs without autograd.
    """
    if cfg.split_criteria not in ("value", "vorticity"):
        raise ValueError(f"unknown split_criteria {cfg.split_criteria!r}")
    if cfg.split_criteria == "vorticity" and (cfg.d != 2 or cfg.channels != 2):
        raise ValueError("split_criteria='vorticity' needs a d=2 two-channel "
                         "velocity field (NS); got "
                         f"d={cfg.d}, c={cfg.channels}")
    with torch.no_grad():
        _, conics0 = covariance_of(state)
        if cfg.split_criteria == "vorticity":
            p = peak_vorticity_contribution(conics0, state.u)
            p_max = torch.max(torch.where(state.active, p, -torch.inf))
            keep = p > 0.01 * p_max
        else:
            keep = torch.linalg.vector_norm(torch.abs(state.u), dim=-1) > 0.01
        state = prune(state, keep)

        _, conics = covariance_of(state)
        _, prev_conics = covariance_of(prev_state)
        density = _density_rank(cfg, state, conics)
        args = dict(period=cfg.period, impl=cfg.mixture_impl)
        if cfg.split_criteria == "vorticity":
            now = eval_mixture(state.means, conics, state.u, state.means,
                               order=1, mask=state.active, **args)
            prev = eval_mixture(prev_state.means, prev_conics, prev_state.u,
                                state.means, order=1, mask=prev_state.active,
                                **args)
            w_now = now.ux[:, 0, 1] - now.ux[:, 1, 0]
            w_prev = prev.ux[:, 0, 1] - prev.ux[:, 1, 0]
            metric = ((w_now - w_prev) ** 2)[:, None] * density
        else:
            u_now = eval_mixture(state.means, conics, state.u, state.means,
                                 order=0, mask=state.active, **args).u
            u_prev = eval_mixture(prev_state.means, prev_conics, prev_state.u,
                                  state.means, order=0, mask=prev_state.active,
                                  **args).u
            metric = ((u_now - u_prev) ** 2) * density

        flat = torch.where(state.interior[:, None], metric, torch.nan)
        q = torch.nanquantile(flat, quantile)
        indices = torch.any(metric > q, dim=-1) & state.interior
        return split(state, indices)


class Losses(NamedTuple):
    pde: torch.Tensor
    bc: torch.Tensor
    conservation: torch.Tensor
    initial: torch.Tensor
    magnitude: torch.Tensor

    @property
    def total(self) -> torch.Tensor:
        """The optimized loss: the magnitude term is reported, not added."""
        return self.pde + self.bc + self.conservation + self.initial


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over rows where mask is True; 0 if no row qualifies."""
    w = mask.to(x.dtype)
    while w.dim() < x.dim():
        w = w[..., None]
    denom = torch.sum(torch.broadcast_to(w, x.shape))
    return torch.sum(x * w) / torch.clamp(denom, min=1.0)


def compute_loss(cfg: ModelConfig, state: MixtureState, deltas: Deltas,
                 prev: StepFields, curr: StepFields, samples: torch.Tensor,
                 time_samples: torch.Tensor, t: float, dt: float,
                 initial_fields: Optional[torch.Tensor] = None) -> Losses:
    """Physics-informed losses for one timestep: the PDE residual of the
    time-integrated fields, the boundary value, the conservation
    regularizers on the deltas, the optional IC term and the attention
    magnitude."""
    w = cfg.weights
    problem = cfg.problem
    ns = problem == Problem.NAVIER_STOKES

    u_s, ux, uxx = time_integrate(cfg.rule, time_samples,
                                  (prev.u, prev.ux, prev.uxx),
                                  (curr.u, curr.ux, curr.uxx))
    if ns:
        wx, wxx = time_integrate(cfg.rule, time_samples, (prev.wx, prev.wxx),
                                 (curr.wx, curr.wxx))
        rhs = dt * pde_rhs(problem, cfg.coeff, samples, u_s, ux, uxx, wx, wxx,
                           t=t)
        wt = curr.w - prev.w
    else:
        rhs = dt * pde_rhs(problem, cfg.coeff, samples, u_s, ux, uxx, t=t)
        ut = curr.u - prev.u

    interior = state.interior
    zero = torch.zeros((), dtype=cfg.dtype, device=samples.device)
    pde_loss = bc_loss = conservation_loss = initial_loss = zero

    if problem in (Problem.DIFFUSION, Problem.BURGERS):
        pde_loss = pde_loss + torch.mean((ut - rhs) ** 2)
    elif problem == Problem.POISSON:
        pde_loss = pde_loss + torch.mean(rhs ** 2)
    elif problem == Problem.WAVE:
        pde_loss = pde_loss + 0.01 * torch.mean((ut[..., 0] - rhs[..., 0]) ** 2)
        pde_loss = pde_loss + torch.mean((ut[..., 1] - rhs[..., 1]) ** 2)
    elif ns:
        pde_loss = pde_loss + torch.mean((ux[:, 0, 0] + ux[:, 1, 1]) ** 2)
        pde_loss = pde_loss + torch.mean((wt - rhs) ** 2)
    elif problem == Problem.TEST:
        pde_loss = pde_loss + _masked_mean(
            (deltas.dmeans[:, 1] - state.u[:, 0] / 5.0) ** 2, interior)

    if problem == Problem.TEST:
        negative = interior & (state.means[:, 1] < -0.8)
        bc_loss = bc_loss + _masked_mean((state.u[:, 0] - 1.0) ** 2, negative)
        positive = interior & (state.means[:, 1] > 0.8)
        bc_loss = bc_loss + _masked_mean((state.u[:, 0] + 1.0) ** 2, positive)
    elif not ns:
        bc_loss = bc_loss + torch.mean(curr.bc_u ** 2)

    count = torch.clamp(torch.sum(interior), min=1)
    if problem == Problem.TEST:
        conservation_loss = conservation_loss + w.dmean * _masked_mean(
            deltas.dmeans[:, 0] ** 2, interior)
        dmean_bar = torch.sum(deltas.dmeans * interior[:, None], dim=0) / count
        conservation_loss = conservation_loss + w.dmean * _masked_mean(
            (deltas.dmeans - dmean_bar[None, :]) ** 2, interior)
        y_bar = torch.sum(state.means[:, 1] * interior) / count
        conservation_loss = conservation_loss + w.dmean * _masked_mean(
            (state.means[:, 1] - y_bar) ** 2, interior)
        in_range = interior & (torch.abs(state.means[:, 1]) < 0.8)
        conservation_loss = conservation_loss + w.du * _masked_mean(
            (torch.abs(state.u[:, 0]) - 1.0) ** 2, in_range)
        conservation_loss = conservation_loss + w.du * _masked_mean(
            deltas.du ** 2, in_range)
    else:
        conservation_loss = conservation_loss + w.dmean * _masked_mean(
            deltas.dmeans ** 2, interior)
        conservation_loss = conservation_loss + w.du * _masked_mean(
            deltas.du ** 2, interior)
    conservation_loss = conservation_loss + w.dscale * _masked_mean(
        deltas.dscaling ** 2, interior)
    conservation_loss = conservation_loss + w.dtransform * _masked_mean(
        deltas.dtransforms ** 2, interior)

    if initial_fields is not None:
        initial_loss = initial_loss + torch.mean((prev.u - initial_fields) ** 2)

    magnitude_loss = torch.mean((deltas.head_magnitudes - 1.0) ** 2)
    return Losses(pde=w.pde * pde_loss, bc=w.bc * bc_loss,
                  conservation=w.conservation * conservation_loss,
                  initial=w.initial * initial_loss, magnitude=magnitude_loss)
