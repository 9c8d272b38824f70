"""Fixed-capacity padded Gaussian state (port of :mod:`pigs_tpu.models.state`).

Every per-Gaussian tensor has ``capacity`` rows and an ``active`` mask, so
shapes never change during a rollout (and a step can later be captured as a
CUDA graph).  Boundary Gaussians come first, then the interior, then free
slots.  Pruning clears mask bits; splitting writes the second child into a
free slot.  Neither reads a value back to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from pigs_tpu_torch import gaussians

__all__ = ["MixtureState", "init_state", "covariance_of", "prune", "split",
           "active_count", "compact_scatter"]


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


def active_count(state: MixtureState) -> torch.Tensor:
    return torch.sum(state.active)


def prune(state: MixtureState, keep: torch.Tensor) -> MixtureState:
    """Deactivate interior slots where ``keep`` is False; boundary slots are
    always kept."""
    return state._replace(active=state.active & (keep | state.boundary))


def compact_scatter(free_slots: torch.Tensor, want: torch.Tensor
                    ) -> torch.Tensor:
    """Send the k-th True of ``want`` to the k-th True of ``free_slots``.

    Returns ``(N,)`` int64 destinations: the slot for each wanting index, and
    ``N`` (one past the end) for the others and for wants beyond the free
    slots.  Ranks come from cumulative sums and the k-th free slot from a
    scatter into a buffer with one spare row, so nothing syncs with the host.
    """
    n = free_slots.shape[0]
    idx = torch.arange(n, device=free_slots.device)
    free_rank = torch.cumsum(free_slots.to(torch.int64), 0) - 1
    free_idx = torch.full((n + 1,), n, dtype=torch.int64,
                          device=free_slots.device)
    # Row n absorbs the writes of occupied slots and is sliced off.
    free_idx = free_idx.scatter(0, torch.where(free_slots, free_rank, n), idx)
    want_rank = torch.cumsum(want.to(torch.int64), 0) - 1
    return torch.where(want, free_idx[:n][want_rank.clamp(0, n - 1)], n)


def _scatter_rows(buf: torch.Tensor, dest: torch.Tensor, rows: torch.Tensor
                  ) -> torch.Tensor:
    """``buf`` with ``rows[i]`` written to row ``dest[i]`` where
    ``dest[i] < N``; destination ``N`` lands in a spare row that is dropped
    (JAX's ``.at[dest].set(rows, mode="drop")``)."""
    spare = torch.cat([buf, buf[:1]])
    return spare.index_copy(0, dest, rows)[:-1]


def split(state: MixtureState, indices: torch.Tensor,
          split_scale: float = 1.0) -> MixtureState:
    """Split the flagged interior Gaussians along their principal axis.

    Each flagged Gaussian becomes two copies displaced by
    ``+-|lambda_max| v_max`` with halved values: the first child overwrites
    the parent slot, the second goes to a free slot.  Splits beyond the free
    capacity are dropped (the parent is still moved and halved, as in the JAX
    package).
    """
    want = indices & state.interior
    cov, _ = covariance_of(state)
    if state.d == 2:
        axis = gaussians.principal_axis(cov)
    elif state.d == 1:
        axis = cov[..., 0]
    else:
        raise ValueError(f"split supports d in {{1, 2}}, got {state.d}")
    axis = axis * split_scale

    half_u = torch.where(want[:, None], state.u * 0.5, state.u)
    parent_means = torch.where(want[:, None], state.means - axis, state.means)
    dest = compact_scatter(~state.active, want)
    landed = _scatter_rows(torch.zeros_like(state.active), dest, want)
    return state._replace(
        means=_scatter_rows(parent_means, dest, state.means + axis),
        scaling=_scatter_rows(state.scaling, dest, state.scaling),
        transforms=_scatter_rows(state.transforms, dest, state.transforms),
        u=_scatter_rows(half_u, dest, half_u),
        active=state.active | landed)
