"""Regular sample grids (port of :mod:`pigs_tpu.utils.sampling`)."""

from __future__ import annotations

import torch

__all__ = ["grid_samples", "image_samples"]


def grid_samples(res: int, d: int, scale: float = 1.0,
                 dtype=torch.float32, device=None) -> torch.Tensor:
    """Regular ``res^d`` grid over ``[-scale, scale]^d``, ``(res^d, d)``,
    with ``ij`` indexing."""
    axes = [torch.linspace(-1.0, 1.0, res, dtype=dtype, device=device) * scale
            for _ in range(d)]
    mesh = torch.meshgrid(*axes, indexing="ij")
    return torch.stack(mesh, dim=-1).reshape(-1, d)


def image_samples(res: int, scale: float = 1.0, dtype=torch.float32,
                  device=None) -> torch.Tensor:
    """Image-layout 2D grid, ``(res*res, 2)``: ``xy`` indexing with the y axis
    flipped, so row r of the image is y = +scale at r = 0."""
    tx = torch.linspace(-1.0, 1.0, res, dtype=dtype, device=device) * scale
    ty = torch.flip(torch.linspace(-1.0, 1.0, res, dtype=dtype,
                                   device=device), dims=(0,)) * scale
    gx, gy = torch.meshgrid(tx, ty, indexing="xy")
    return torch.stack((gx, gy), dim=-1).reshape(res * res, 2)
