"""Covariance and conic construction (port of :mod:`pigs_tpu.gaussians`).

``scaling`` holds positive per-axis variances, ``transforms`` the raw
off-diagonal parameters, bounded through ``tanh(t) * sqrt(prod(scaling))`` so
the matrix stays positive definite.  The conics (inverse covariances) are
closed form for d <= 3, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["tri_size", "off_diag_size", "build_full_covariances",
           "build_covariances", "flatten_covariances", "sym_inverse",
           "pack_symmetric", "unpack_symmetric", "sym_eig2x2",
           "principal_axis"]


def tri_size(d: int) -> int:
    """Number of independent entries of a symmetric (d, d) matrix."""
    return d * (d + 1) // 2


def off_diag_size(d: int) -> int:
    """Number of strictly-lower-triangular entries (the ``transforms``
    size)."""
    return d * (d - 1) // 2


def _tril_indices(d: int):
    """Strictly-lower entries in row-major order (the ``transforms`` layout)."""
    return [(i, j) for i in range(1, d) for j in range(i)]


def _triu_indices(d: int):
    """Upper-triangular entries, diagonal included, in row-major order."""
    return [(i, j) for i in range(d) for j in range(i, d)]


def pack_symmetric(mat: torch.Tensor) -> torch.Tensor:
    """Symmetric ``(..., d, d)`` -> ``(..., d*(d+1)//2)``, row-major upper
    triangle (``[xx, xy, yy]`` for d=2)."""
    d = mat.shape[-1]
    return torch.stack([mat[..., i, j] for i, j in _triu_indices(d)], dim=-1)


def unpack_symmetric(packed: torch.Tensor, d: int) -> torch.Tensor:
    """Inverse of :func:`pack_symmetric`."""
    index = {}
    for k, (i, j) in enumerate(_triu_indices(d)):
        index[(i, j)] = index[(j, i)] = k
    return torch.stack([
        torch.stack([packed[..., index[(i, j)]] for j in range(d)], dim=-1)
        for i in range(d)], dim=-2)


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


def flatten_covariances(covariances: torch.Tensor, conics: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full covariances and conics -> their :func:`pack_symmetric`
    triangles, ``(..., d*(d+1)//2)`` each."""
    return pack_symmetric(covariances), pack_symmetric(conics)


def build_covariances(scaling: torch.Tensor, transforms: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`build_full_covariances`, packed by
    :func:`flatten_covariances`."""
    return flatten_covariances(*build_full_covariances(scaling, transforms))


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


def sym_eig2x2(mat: torch.Tensor):
    """Closed-form eigendecomposition of symmetric ``(..., 2, 2)`` matrices.

    Returns ``(eigvals (..., 2), eigvecs (..., 2, 2))``: ``lam1 >= lam2`` and
    the rows of ``eigvecs`` the unit eigenvectors.  The eigenvector of
    ``lam1`` is the longer of two candidate forms, and ``(1, 0)`` when the
    matrix is isotropic (both candidates vanish).
    """
    a, b, c = mat[..., 0, 0], mat[..., 0, 1], mat[..., 1, 1]
    half_tr = 0.5 * (a + c)
    half_diff = 0.5 * (a - c)
    disc = torch.sqrt(half_diff * half_diff + b * b)
    lam1 = half_tr + disc
    lam2 = half_tr - disc
    v1a = torch.stack([b, lam1 - a], dim=-1)
    v1b = torch.stack([lam1 - c, b], dim=-1)
    isotropic = torch.abs(half_diff) + torch.abs(b) == 0.0
    pick = (torch.linalg.vector_norm(v1a, dim=-1, keepdim=True)
            >= torch.linalg.vector_norm(v1b, dim=-1, keepdim=True))
    v1 = torch.where(pick, v1a, v1b)
    v1 = torch.where(isotropic[..., None],
                     torch.stack([torch.ones_like(a), torch.zeros_like(a)],
                                 dim=-1), v1)
    v1 = v1 / torch.clamp(torch.linalg.vector_norm(v1, dim=-1, keepdim=True),
                          min=1e-30)
    v2 = torch.stack([-v1[..., 1], v1[..., 0]], dim=-1)
    return torch.stack([lam1, lam2], dim=-1), torch.stack([v1, v2], dim=-2)


def principal_axis(cov: torch.Tensor) -> torch.Tensor:
    """``|lambda_max| * v_max`` of symmetric ``(..., d, d)`` covariances,
    d in {1, 2}: the displacement of a split."""
    d = cov.shape[-1]
    if d == 1:
        return cov[..., 0]
    if d == 2:
        eigvals, eigvecs = sym_eig2x2(cov)
        idx = torch.argmax(torch.abs(eigvals), dim=-1, keepdim=True)
        lam = torch.gather(eigvals, -1, idx)
        vec = torch.gather(eigvecs, -2,
                           idx[..., None].expand(*idx.shape[:-1], 1, 2))
        return torch.abs(lam) * vec[..., 0, :]
    raise ValueError(f"principal_axis supports d in {{1, 2}}, got d={d}")
