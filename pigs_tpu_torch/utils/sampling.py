"""Regular sample grids and random collocation samplers (port of
:mod:`pigs_tpu.utils.sampling`).

The random samplers draw from an explicit ``torch.Generator`` on the
generator's own device and move the result to ``device``, so one CPU
generator gives the same numbers whichever device the samples go to.
"""

from __future__ import annotations

import torch

__all__ = ["grid_samples", "image_samples", "region_kernel",
           "collocation_samples", "boundary_band_samples"]


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


def region_kernel(size: int, dx: float, d: int, dtype=torch.float32,
                  device=None) -> torch.Tensor:
    """A ``size^d`` grid of offsets centred at zero, spacing ``dx``,
    ``(size^d, d)``, with ``xy`` indexing."""
    half = (size - 1) / 2.0
    t = torch.linspace(-half, half, size, dtype=dtype, device=device) * dx
    mesh = torch.meshgrid(*[t] * d, indexing="xy")
    return torch.stack(mesh, dim=-1).reshape(-1, d)


def _uniform(generator: torch.Generator, shape, dtype, device):
    return torch.rand(shape, generator=generator, dtype=dtype,
                      device=generator.device).to(device)


def collocation_samples(generator: torch.Generator, n: int, d: int,
                        scale: float = 1.0, dtype=torch.float32,
                        device=None) -> torch.Tensor:
    """Uniform random interior collocation points over
    ``[-scale, scale]^d``, ``(n, d)``."""
    return (_uniform(generator, (n, d), dtype, device) * 2.0 - 1.0) * scale


def boundary_band_samples(generator: torch.Generator, n: int,
                          scale: float = 1.0, dtype=torch.float32,
                          device=None) -> torch.Tensor:
    """Samples on the ``+-(1..1.5) * scale`` band around the domain, for the
    boundary loss; 2D, ``(n, 2)``.  The first half lies left and right (x in
    the band, y tangential), the second half below and above."""
    if n % 4 != 0:
        raise ValueError(f"boundary_band_samples needs n divisible by 4, "
                         f"got {n}")
    half, quarter = n // 2, n // 4
    r1 = _uniform(generator, (quarter,), dtype, device)
    r2 = _uniform(generator, (quarter,), dtype, device)
    r3 = _uniform(generator, (n,), dtype, device)
    ones = torch.ones(quarter, dtype=dtype, device=device)
    bands = torch.cat([-ones - r1 * 0.5, ones + r2 * 0.5]) * scale
    tang = (r3 * 2.0 - 1.0) * 1.5 * scale
    return torch.cat([torch.stack([bands, tang[:half]], dim=-1),
                      torch.stack([tang[half:], bands], dim=-1)])
