"""Covariance and conic construction (port of :mod:`pigs_tpu.gaussians`).

``scaling`` holds positive per-axis variances, ``transforms`` the raw
off-diagonal parameters, bounded through ``tanh(t) * sqrt(prod(scaling))`` so
the matrix stays positive definite.  The conics (inverse covariances) are
closed form for d <= 3, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["build_full_covariances", "sym_inverse"]


def _tril_indices(d: int):
    """Strictly-lower entries in row-major order (the ``transforms`` layout)."""
    return [(i, j) for i in range(1, d) for j in range(i)]


def build_full_covariances(scaling: torch.Tensor, transforms: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full symmetric covariances and their conics, each ``(..., d, d)``.

    Args:
      scaling: ``(..., d)`` positive per-axis variances (already exp'd).
      transforms: ``(..., d*(d-1)//2)`` unbounded off-diagonal parameters.
    """
    d = scaling.shape[-1]
    t = torch.tanh(transforms) * torch.sqrt(
        torch.prod(scaling, dim=-1, keepdim=True))
    rows = []
    for i in range(d):
        row = []
        for j in range(d):
            if i == j:
                row.append(scaling[..., i])
            else:
                k = _tril_indices(d).index((max(i, j), min(i, j)))
                row.append(t[..., k])
        rows.append(torch.stack(row, dim=-1))
    cov = torch.stack(rows, dim=-2)
    return cov, sym_inverse(cov)


def sym_inverse(a: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of symmetric ``(..., d, d)`` matrices, d <= 3."""
    d = a.shape[-1]
    if d == 1:
        return 1.0 / a
    # The same operations in the same order as the JAX package, so f32
    # results agree to the last bit where the backends' arithmetic does.
    if d == 2:
        p, q, r = a[..., 0, 0], a[..., 0, 1], a[..., 1, 1]
        inv_det = 1.0 / (p * r - q * q)
        return torch.stack([
            torch.stack([r * inv_det, -q * inv_det], dim=-1),
            torch.stack([-q * inv_det, p * inv_det], dim=-1),
        ], dim=-2)
    if d == 3:
        p, q, r = a[..., 0, 0], a[..., 0, 1], a[..., 0, 2]
        e, f, i = a[..., 1, 1], a[..., 1, 2], a[..., 2, 2]
        A = e * i - f * f
        B = -(q * i - f * r)
        C = q * f - e * r
        E = p * i - r * r
        F = -(p * f - q * r)
        I = p * e - q * q
        inv_det = 1.0 / (p * A + q * B + r * C)
        return torch.stack([
            torch.stack([A, B, C], dim=-1),
            torch.stack([B, E, F], dim=-1),
            torch.stack([C, F, I], dim=-1),
        ], dim=-2) * inv_det[..., None, None]
    raise ValueError(f"sym_inverse supports d <= 3, got d={d}")
