"""PDE right-hand sides and problem registry (port of :mod:`pigs_tpu.pde`).

Shapes follow the JAX package: ``u (m, c)``, ``ux (m, d, c)``,
``uxx (m, d, d, c)``; Navier-Stokes also takes the vorticity derivatives
``wx (m, d)`` and ``wxx (m, d, d)``.
"""

from __future__ import annotations

import enum
import math
from typing import NamedTuple, Optional, Sequence

import torch

__all__ = ["Problem", "IntegrationRule", "PDECoefficients", "pde_rhs",
           "pde_size", "channels", "time_integrate"]


class Problem(enum.Enum):
    DIFFUSION = enum.auto()
    POISSON = enum.auto()
    BURGERS = enum.auto()
    WAVE = enum.auto()
    NAVIER_STOKES = enum.auto()
    TEST = enum.auto()


class IntegrationRule(enum.Enum):
    TRAPEZOID = enum.auto()
    FORWARD = enum.auto()
    BACKWARD = enum.auto()


class PDECoefficients(NamedTuple):
    """Physical constants per problem."""

    nu: float = 0.0
    wave_psi_scale: float = 1.0  # WAVE: channel 1 stores psi/s (1.0 = raw psi)

    @staticmethod
    def default(problem: Problem) -> "PDECoefficients":
        if problem == Problem.BURGERS:
            return PDECoefficients(nu=1.0 / (10.0 * math.pi))
        if problem == Problem.NAVIER_STOKES:
            return PDECoefficients(nu=1e-3)
        return PDECoefficients()


def channels(problem: Problem) -> int:
    """Field channel count c per problem."""
    return 2 if problem in (Problem.WAVE, Problem.NAVIER_STOKES) else 1


def pde_size(problem: Problem) -> int:
    """Width of the PDE-residual feature fed to the dynamics net."""
    return 1 if problem == Problem.NAVIER_STOKES else channels(problem)


def pde_rhs(
    problem: Problem,
    coeff: PDECoefficients,
    samples: torch.Tensor,
    u: torch.Tensor,
    ux: torch.Tensor,
    uxx: torch.Tensor,
    wx: Optional[torch.Tensor] = None,
    wxx: Optional[torch.Tensor] = None,
    t: float = 0.0,
) -> torch.Tensor:
    """Spatial right-hand side of du/dt = rhs."""
    if problem == Problem.DIFFUSION:
        return uxx[:, 0, 0] + uxx[:, 1, 1]

    if problem == Problem.BURGERS:
        return coeff.nu * (uxx[:, 0, 0] + uxx[:, 1, 1]) - u * ux[:, 0]

    if problem == Problem.POISSON:
        x = samples[..., 0]
        return (100.0 * t * torch.sin(math.pi * (x + 1.0)))[:, None] - uxx[:, 0, 0]

    if problem == Problem.WAVE:
        s = coeff.wave_psi_scale
        return torch.stack(
            (
                s * u[..., 1],
                (10.0 / s) * (uxx[..., 0, 0, 0] + uxx[..., 1, 1, 0])
                - 0.1 * u[..., 1],
            ),
            dim=-1,
        )

    if problem == Problem.NAVIER_STOKES:
        return (coeff.nu * (wxx[:, 0, 0] + wxx[:, 1, 1])
                - (u[:, 0] * wx[:, 0] + u[:, 1] * wx[:, 1]))

    if problem == Problem.TEST:
        return torch.zeros_like(u)

    raise ValueError(f"Unexpected PDE problem: {problem}")


def time_integrate(rule: IntegrationRule, time_samples: torch.Tensor,
                   prev: Sequence[Optional[torch.Tensor]],
                   curr: Sequence[Optional[torch.Tensor]]):
    """Mix two consecutive sample sets per the integration rule.

    TRAPEZOID takes a random convex combination per collocation point,
    ``ts * curr + (1 - ts) * prev``; FORWARD and BACKWARD pick an endpoint.
    ``prev`` and ``curr`` are tuples of tensors (or None) with the sample
    axis leading.
    """
    if rule == IntegrationRule.FORWARD:
        return prev
    if rule == IntegrationRule.BACKWARD:
        return curr

    def mix(a, b):
        if a is None or b is None:
            return None
        ts = time_samples.reshape((-1,) + (1,) * (a.dim() - 1)).to(a.dtype)
        return ts * b + (1.0 - ts) * a

    return tuple(mix(a, b) for a, b in zip(prev, curr))
