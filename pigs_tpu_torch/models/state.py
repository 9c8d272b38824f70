"""Fixed-capacity padded Gaussian state (port of :mod:`pigs_tpu.models.state`).

Every per-Gaussian tensor has ``capacity`` rows and an ``active`` mask, so
shapes never change during a rollout (and a step can later be captured as a
CUDA graph).  Boundary Gaussians come first, then the interior, then free
slots.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from pigs_tpu_torch import gaussians

__all__ = ["MixtureState", "init_state", "covariance_of"]


class MixtureState(NamedTuple):
    """Padded Gaussian mixture state; ``scaling`` holds positive variances."""

    means: torch.Tensor        # (N, d)
    scaling: torch.Tensor      # (N, d)
    transforms: torch.Tensor   # (N, T), T = d*(d-1)//2
    u: torch.Tensor            # (N, c)
    active: torch.Tensor       # (N,) bool
    boundary: torch.Tensor     # (N,) bool

    @property
    def capacity(self) -> int:
        return self.means.shape[0]

    @property
    def d(self) -> int:
        return self.means.shape[1]

    @property
    def c(self) -> int:
        return self.u.shape[1]

    @property
    def interior(self) -> torch.Tensor:
        """Active non-boundary slots."""
        return self.active & ~self.boundary


def init_state(
    capacity: int,
    means: torch.Tensor,
    scaling: torch.Tensor,
    transforms: torch.Tensor,
    u: torch.Tensor,
    boundary_means: Optional[torch.Tensor] = None,
    boundary_scaling: Optional[torch.Tensor] = None,
    boundary_transforms: Optional[torch.Tensor] = None,
    boundary_u: Optional[torch.Tensor] = None,
) -> MixtureState:
    """Build a padded state: boundary rows, interior rows, then free slots.

    The tensors' device is the state's device.
    """
    parts = [(means, scaling, transforms, u)]
    n_boundary = 0
    if boundary_means is not None and boundary_means.shape[0] > 0:
        n_boundary = boundary_means.shape[0]
        parts.insert(0, (boundary_means, boundary_scaling,
                         boundary_transforms, boundary_u))
    cat = [torch.cat(list(xs), dim=0) for xs in zip(*parts)]
    n = cat[0].shape[0]
    if n > capacity:
        raise ValueError(f"capacity {capacity} < initial Gaussian count {n}")
    pad = capacity - n

    def pad0(x, fill=0.0):
        return torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])

    idx = torch.arange(capacity, device=means.device)
    # Inactive scaling stays 1 so the conic of a free slot is finite.
    return MixtureState(
        means=pad0(cat[0]),
        scaling=pad0(cat[1], 1.0),
        transforms=pad0(cat[2]),
        u=pad0(cat[3]),
        active=idx < n,
        boundary=idx < n_boundary,
    )


def covariance_of(state: MixtureState) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full ``(N, d, d)`` covariances and conics of the current state."""
    return gaussians.build_full_covariances(state.scaling, state.transforms)
