"""Finite-difference and spectral reference solvers (port of
:mod:`pigs_tpu.utils.fd`).

The ground truth the Gaussian-mixture solvers are validated against:
explicit RK4 on a regular grid with second-order central differences and
Dirichlet (zero) or periodic boundaries, and a pseudo-spectral
Navier-Stokes solver on the torus.  The substeps are a Python loop over
tensor operations on the input's device; every expression keeps the JAX
package's order of operations.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["solve_fd_1d", "solve_fd_2d", "solve_ns_2d", "random_vorticity",
           "vorticity_from_noise"]


def _dx1(u, h, periodic):
    if periodic:
        return (torch.roll(u, -1, 0) - torch.roll(u, 1, 0)) / (2 * h)
    du = torch.zeros_like(u)
    du[1:-1] = (u[2:] - u[:-2]) / (2 * h)
    return du


def _dxx1(u, h, periodic):
    if periodic:
        return (torch.roll(u, -1, 0) - 2 * u + torch.roll(u, 1, 0)) / (h * h)
    du = torch.zeros_like(u)
    du[1:-1] = (u[2:] - 2 * u[1:-1] + u[:-2]) / (h * h)
    return du


def _rhs_1d(problem: str, u, h, nu, periodic):
    if problem == "diffusion":
        return _dxx1(u, h, periodic)
    if problem == "burgers":
        return nu * _dxx1(u, h, periodic) - u * _dx1(u, h, periodic)
    if problem == "wave":
        # u = (phi, psi): phi_t = psi; psi_t = 10 lap(phi) - 0.1 psi
        phi, psi = u[..., 0], u[..., 1]
        return torch.stack([psi, 10.0 * _dxx1(phi, h, periodic) - 0.1 * psi],
                           dim=-1)
    raise ValueError(problem)


def _rk4_trajectory(rhs, u0, dt_in, steps, substeps, zero_boundary):
    """``steps`` outer steps of ``substeps`` RK4 substeps each; the snapshot
    after every outer step, the initial one first."""
    u, traj = u0, [u0]
    for _ in range(steps):
        for _ in range(substeps):
            k1 = rhs(u)
            k2 = rhs(u + 0.5 * dt_in * k1)
            k3 = rhs(u + 0.5 * dt_in * k2)
            k4 = rhs(u + dt_in * k3)
            u = u + dt_in / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
            if zero_boundary is not None:
                zero_boundary(u)
        traj.append(u)
    return torch.stack(traj)


def _zero_ends(u):
    u[0] = 0.0
    u[-1] = 0.0


def _zero_edges(u):
    u[0, :] = 0.0
    u[-1, :] = 0.0
    u[:, 0] = 0.0
    u[:, -1] = 0.0


def solve_fd_1d(u0: torch.Tensor, scale: float, dt: float, steps: int,
                problem: str = "burgers", nu: float = 0.00318,
                substeps: int = 200, periodic: bool = False) -> torch.Tensor:
    """Integrate ``steps`` outer steps of size ``dt`` (RK4, ``substeps`` inner
    steps each).  ``u0``: (res,) or (res, 2) for wave.  Returns
    ``(steps+1, ...)`` snapshots including the initial condition."""
    res = u0.shape[0]
    h = 2.0 * scale / (res - 1)
    return _rk4_trajectory(lambda u: _rhs_1d(problem, u, h, nu, periodic), u0,
                           dt / substeps, steps, substeps,
                           None if periodic else _zero_ends)


def _lap2(u, h, periodic):
    if periodic:
        return ((torch.roll(u, -1, 0) - 2 * u + torch.roll(u, 1, 0))
                + (torch.roll(u, -1, 1) - 2 * u + torch.roll(u, 1, 1))) / (h * h)
    du = torch.zeros_like(u)
    du[1:-1, 1:-1] = ((u[2:, 1:-1] - 2 * u[1:-1, 1:-1] + u[:-2, 1:-1])
                      + (u[1:-1, 2:] - 2 * u[1:-1, 1:-1] + u[1:-1, :-2])
                      ) / (h * h)
    return du


def _dx2(u, h, axis, periodic):
    if periodic:
        return (torch.roll(u, -1, axis) - torch.roll(u, 1, axis)) / (2 * h)
    du = torch.zeros_like(u)
    n = u.shape[axis]
    du.narrow(axis, 1, n - 2).copy_(
        (u.narrow(axis, 2, n - 2) - u.narrow(axis, 0, n - 2)) / (2 * h))
    return du


def solve_fd_2d(u0: torch.Tensor, scale: float, dt: float, steps: int,
                problem: str = "burgers", nu: float = 0.0318,
                substeps: int = 400, periodic: bool = False) -> torch.Tensor:
    """2D analog of :func:`solve_fd_1d`.  ``u0``: (res, res) with axis 0 = x,
    or (res, res, 2) for wave.

    Burgers advects along x only (``u_t = nu lap(u) - u u_x``), as the JAX
    package's 2D reference does.
    """
    res = u0.shape[0]
    h = 2.0 * scale / (res - 1)

    def rhs(u):
        if problem == "diffusion":
            return _lap2(u, h, periodic)
        if problem == "burgers":
            return nu * _lap2(u, h, periodic) - u * _dx2(u, h, 0, periodic)
        if problem == "wave":
            # u = (phi, psi): phi_t = psi; psi_t = 10 lap(phi) - 0.1 psi
            phi, psi = u[..., 0], u[..., 1]
            return torch.stack(
                [psi, 10.0 * _lap2(phi, h, periodic) - 0.1 * psi], dim=-1)
        raise ValueError(problem)

    return _rk4_trajectory(rhs, u0, dt / substeps, steps, substeps,
                           None if periodic else _zero_edges)


# --------------------------------------------------------------------------
# 2D incompressible Navier-Stokes, vorticity form, periodic pseudo-spectral:
# w_t = nu lap(w) - u . grad(w), unforced.


def _ns_wavenumbers(res: int, period: float, dtype, device):
    k = 2.0 * math.pi * torch.fft.fftfreq(res, d=period / res, dtype=dtype,
                                          device=device)
    kx = k[:, None]
    ky = k[None, :]
    k2 = kx * kx + ky * ky
    inv_k2 = torch.where(k2 == 0.0, 0.0,
                         1.0 / torch.where(k2 == 0.0, 1.0, k2))
    # 2/3-rule dealiasing mask for the quadratic advection term.
    kmax = torch.max(torch.abs(k))
    dealias = ((torch.abs(kx) <= (2.0 / 3.0) * kmax)
               & (torch.abs(ky) <= (2.0 / 3.0) * kmax))
    return kx, ky, k2, inv_k2, dealias


def solve_ns_2d(w0: torch.Tensor, scale: float, dt: float, steps: int,
                nu: float = 1e-3, substeps: int = 20,
                res_out: Optional[int] = None) -> torch.Tensor:
    """Pseudo-spectral solve of ``w_t = nu lap(w) - u . grad(w)`` on the
    period-``2*scale`` torus.

    ``w0``: (res, res) vorticity with axis 0 = x, axis 1 = y ascending.
    Velocity from the stream function ``lap(psi) = -w``,
    ``u = (psi_y, -psi_x)``.  RK4 with integrating factor for the viscous
    term; 2/3-rule dealiased advection.  Returns ``(steps+1, res, res)``
    including the initial frame, or on the ``res_out`` grid (even, below
    ``res``) by spectral truncation.
    """
    res = w0.shape[0]
    if res_out is not None and res_out != res:
        if not 0 < res_out < res:
            raise ValueError(f"res_out {res_out} must be in (0, {res})")
        if res_out % 2:
            # The [:h] + [-h:] truncation keeps 2h rows; an odd res_out has
            # no unambiguous Nyquist row on the coarse grid.
            raise ValueError(f"res_out must be even, got {res_out}")
    period = 2.0 * scale
    kx, ky, k2, inv_k2, dealias = _ns_wavenumbers(res, period, w0.dtype,
                                                  w0.device)
    dt_in = dt / substeps

    def advection_hat(w_hat):
        psi_hat = w_hat * inv_k2          # lap(psi) = -w  =>  psi_hat = w/k2
        ux = torch.fft.ifft2(1j * ky * psi_hat).real
        uy = torch.fft.ifft2(-1j * kx * psi_hat).real
        wx = torch.fft.ifft2(1j * kx * w_hat).real
        wy = torch.fft.ifft2(1j * ky * w_hat).real
        return -torch.fft.fft2(ux * wx + uy * wy) * dealias

    # Integrating factor e^{-nu k^2 t} handles viscosity exactly; RK4 on the
    # advection term in the transformed variable.
    e_half = torch.exp(-nu * k2 * dt_in * 0.5)
    e_full = e_half * e_half

    w_hat = torch.fft.fft2(w0)
    traj = [w0]
    for _ in range(steps):
        for _ in range(substeps):
            k1 = advection_hat(w_hat)
            k2_ = advection_hat(e_half * (w_hat + 0.5 * dt_in * k1))
            k3 = advection_hat(e_half * w_hat + 0.5 * dt_in * k2_)
            k4 = advection_hat(e_full * w_hat + dt_in * e_half * k3)
            w_hat = (e_full * w_hat
                     + dt_in / 6.0 * (e_full * k1 + 2.0 * e_half * (k2_ + k3)
                                      + k4))
        traj.append(torch.fft.ifft2(w_hat).real)
    out = torch.stack(traj)
    if res_out is not None and res_out != res:
        # Spectrally-exact downsampling: truncate to the coarse grid's modes
        # then inverse-transform (a plain stride would alias the dealiased
        # band k in (res_out/2, res/3] back onto low wavenumbers).
        h = res_out // 2
        hat = torch.fft.fft2(out) * (res_out / res) ** 2
        rows = torch.cat([hat[:, :h], hat[:, -h:]], dim=1)
        coarse = torch.cat([rows[:, :, :h], rows[:, :, -h:]], dim=2)
        out = torch.fft.ifft2(coarse).real
    return out


def vorticity_from_noise(noise: torch.Tensor, scale: float = 1.0,
                         peak_k: float = 3.0,
                         amplitude: float = 1.0) -> torch.Tensor:
    """Shape a ``(res, res)`` white-noise draw into :func:`random_vorticity`'s
    field: spectrum ``exp(-(|k|/k0 - 1)^2)`` band-centred at ``peak_k``
    domain wavenumbers, no k=0 component, unit max-abs times
    ``amplitude``."""
    res = noise.shape[0]
    period = 2.0 * scale
    k = 2.0 * math.pi * torch.fft.fftfreq(res, d=period / res,
                                          dtype=noise.dtype,
                                          device=noise.device)
    k2 = k[:, None] ** 2 + k[None, :] ** 2
    k0 = 2.0 * math.pi * peak_k / period
    spectrum = torch.exp(-((torch.sqrt(k2) / k0) - 1.0) ** 2 * 4.0)
    spectrum[0, 0] = 0.0
    w = torch.fft.ifft2(torch.fft.fft2(noise) * spectrum).real
    return amplitude * w / torch.max(torch.abs(w))


def random_vorticity(generator: torch.Generator, res: int, scale: float = 1.0,
                     peak_k: float = 3.0, amplitude: float = 1.0,
                     dtype=torch.float32, device=None) -> torch.Tensor:
    """Random smooth initial vorticity: a Gaussian random field (the normal
    draw from ``generator``, on its device, shaped by
    :func:`vorticity_from_noise`), on ``device``."""
    noise = torch.randn((res, res), generator=generator, dtype=dtype,
                        device=generator.device).to(device)
    return vorticity_from_noise(noise, scale, peak_k, amplitude)
