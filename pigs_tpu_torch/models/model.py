"""Initial conditions and the dynamics timestep (port of
:mod:`pigs_tpu.models.model`).

``forward_step`` samples the full mixture at the Gaussian centres (order 2,
mask = active) without autograd, as the JAX code's ``stop_gradient`` does,
feeds the network, and applies boundary-masked Euler increments.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from pigs_tpu_torch.models.dynamics import Deltas, DynamicsNetwork
from pigs_tpu_torch.models.state import MixtureState, covariance_of, init_state
from pigs_tpu_torch.ops.aggregate import neighbor_mask
from pigs_tpu_torch.ops.mixture import eval_mixture
from pigs_tpu_torch.pde import (IntegrationRule, PDECoefficients, Problem,
                                channels, pde_rhs, pde_size)

__all__ = ["LossWeights", "ModelConfig", "make_network", "make_initial_state",
           "forward_step"]


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
               dtype=torch.float32, width_mult: int = 1) -> "ModelConfig":
        if capacity is None:
            # Covers the training-time randomized ICs (grid edge up to 39),
            # the <= 100 boundary Gaussians and split margin.
            capacity = max(2 * nx * ny + 128, 1664 if d == 2 else 2 * 40 + 128)
        return ModelConfig(problem=problem, rule=rule, nx=nx, ny=ny, d=d,
                           scale=scale, capacity=capacity,
                           weights=LossWeights.default(problem),
                           coeff=PDECoefficients.default(problem), dtype=dtype,
                           width_mult=width_mult)


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


def forward_step(cfg: ModelConfig, network: DynamicsNetwork,
                 state: MixtureState, t: float = 0.0
                 ) -> Tuple[MixtureState, Deltas]:
    """One dynamics timestep: sample the mixture at the means, predict the
    deltas, and apply them to the interior Gaussians."""
    ns = cfg.problem == Problem.NAVIER_STOKES
    full_cov, conics = covariance_of(state)
    n = state.capacity

    with torch.no_grad():
        fields = eval_mixture(state.means, conics, state.u, state.means,
                              order=3 if ns else 2, mask=state.active,
                              period=cfg.period)
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
    deltas = network(state.means, full_cov, state.u,
                     state.boundary.to(cfg.dtype), fields.u, sample_ux,
                     sample_uxx, sample_pde, state.active, nbr, cfg.period)

    gate = state.interior[:, None].to(cfg.dtype)
    means = state.means + deltas.dmeans * gate
    scaling = state.scaling * torch.exp(deltas.dscaling * gate)
    transforms = state.transforms + deltas.dtransforms * gate
    u = state.u + deltas.du * gate
    if cfg.period is not None:
        # Keep interior means inside the fundamental domain.
        means = torch.where(state.interior[:, None],
                            means - cfg.period * torch.round(means / cfg.period),
                            means)
    return state._replace(means=means, scaling=scaling, transforms=transforms,
                          u=u), deltas
