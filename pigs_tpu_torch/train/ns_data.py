"""Navier-Stokes data pipeline: FNO dataset -> curl-fitted NSDataset (port
of :mod:`pigs_tpu.train.ns_data`).

:func:`generate_fno` solves the unforced NS equations with the spectral
solver from random band-limited vorticity and writes an FNO-format ``.npy``
(layout ``(T, res, res, N)``); :func:`convert_fno` curl-fits frame 0 of
each trajectory (:func:`fit_fno_trajectory`: a 2-channel velocity mixture
whose curl matches the frame, with a divergence penalty, on the period-2
torus) and writes the stacked ``.npz`` that
:meth:`pigs_tpu_torch.train.pn.NSDataset.load` reads.

Each fit iteration launches one K1 (order 1, c=2, periodic) and one K2 on
CUDA tensors; the spectral solver runs on torch's FFTs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pigs_tpu_torch.train.fit import FitConfig, fit, image_target

__all__ = ["load_fno", "fit_config", "fit_fno_trajectory", "convert_fno",
           "generate_trajectories", "generate_fno"]


def load_fno(path: str) -> np.ndarray:
    """Load an FNO-format ``.npy`` and return ``(N, res, res, T)``, the
    transpose of the stored ``(T, res, res, N)``.  Reads through the native
    mmap reader when it builds."""
    from pigs_tpu_torch.native import NpyFile
    f = NpyFile(path)
    # Copy out of the mmap: the view must not outlive the NpyFile handle.
    arr = np.array(f.array, copy=True)
    f.close()
    if arr.ndim != 4:
        raise ValueError(f"FNO dataset must be 4D (T, res, res, N), "
                         f"got {arr.shape}")
    return np.transpose(arr, (3, 1, 2, 0))


def fit_config(nx: int = 20, iters: int = 2000,
               block_iters: int = 100) -> FitConfig:
    """The curl fit's config: ``nx * nx`` Gaussians at capacity, periodic,
    raw means."""
    return FitConfig(nx=nx, capacity=nx * nx, iters=iters,
                     block_iters=min(block_iters, iters), curl=True,
                     periodic=True, tanh_means=False)


def fit_fno_trajectory(frame, nx: int = 20, iters: int = 2000,
                       seed: int = 0, block_iters: int = 100, device=None):
    """Curl-fit one vorticity frame (``(res, res)``, [y, x]) on ``device``
    from a generator seeded ``seed``.  Returns ``(means, u, scaling,
    transforms, final block loss)``, the arrays numpy, each ``(nx*nx,
    ...)``, with ``scaling = exp(raw_scaling)``."""
    cfg = fit_config(nx, iters, block_iters)
    target = image_target(torch.as_tensor(np.asarray(frame),
                                          dtype=torch.float32, device=device))
    generator = torch.Generator(device=device).manual_seed(seed)
    params, _, losses = fit(cfg, target, generator, device)
    means = params.raw_means.cpu().numpy()   # periodic: raw IS the mean
    u = params.values.cpu().numpy()
    scaling = torch.exp(params.raw_scaling).cpu().numpy()
    transforms = params.transforms.cpu().numpy()
    return means, u, scaling, transforms, losses[-1]


def convert_fno(path: str, out: str, count: Optional[int] = None,
                nx: int = 20, iters: int = 2000, seed: int = 0,
                log_fn=print, device=None) -> str:
    """FNO ``.npy`` -> ``NSDataset`` ``.npz``: curl-fit frame 0 of the first
    ``count`` trajectories (trajectory i from a generator seeded
    ``seed + i``) and stack the fits with the vorticity frames (float32)."""
    data = load_fno(path)                          # (N, res, res, T)
    k = data.shape[0] if count is None else min(count, data.shape[0])
    means, u, scaling, transforms = [], [], [], []
    for i in range(k):
        m, v, s, t, loss = fit_fno_trajectory(
            data[i, :, :, 0], nx=nx, iters=iters, seed=seed + i,
            device=device)
        means.append(m)
        u.append(v)
        scaling.append(s)
        transforms.append(t)
        log_fn(f"trajectory {i}: curl-fit final loss {loss:.6f}")
    np.savez(out,
             means=np.stack(means), u=np.stack(u),
             scaling=np.stack(scaling), transforms=np.stack(transforms),
             frames=data[:k].astype(np.float32))
    log_fn(f"wrote {k} trajectories to {out}")
    return out


def generate_trajectories(noise: torch.Tensor, res: int = 64,
                          steps: int = 50, dt: float = 0.1,
                          nu: float = 1e-3) -> torch.Tensor:
    """Solve one trajectory per ``(gen_res, gen_res)`` white-noise draw of
    ``noise`` (``(N, gen_res, gen_res)``, on the device and in the dtype
    the solve runs in): the initial vorticity is the noise shaped by
    :func:`pigs_tpu_torch.utils.fd.vorticity_from_noise`, solved at
    ``gen_res`` and truncated spectrally to ``res``.  Returns ``(T + 1,
    res, res, N)`` with the frames in [y, x] order."""
    from pigs_tpu_torch.utils.fd import solve_ns_2d, vorticity_from_noise
    frames = []
    for draw in noise:
        w0 = vorticity_from_noise(draw, scale=1.0)
        traj = solve_ns_2d(w0, 1.0, dt, steps, nu=nu,
                           substeps=max(20, int(200 * dt)), res_out=res)
        # solver layout [x, y] -> stored layout [y, x]
        frames.append(traj.transpose(1, 2))
    return torch.stack(frames, dim=-1)


def generate_fno(out: str, n_traj: int = 5, res: int = 64, steps: int = 50,
                 dt: float = 0.1, nu: float = 1e-3, seed: int = 0,
                 gen_res: int = 128, log_fn=print, device=None,
                 noise=None) -> str:
    """Generate an FNO-format NS dataset with the spectral solver
    (:func:`generate_trajectories`) and save it as ``(T + 1, res, res, N)``
    float32.  The white noise is ``noise`` (``(n_traj, gen_res, gen_res)``;
    the dtype it comes in is the one the solve runs in) or, without it,
    float32 normal draws from a generator seeded ``seed`` on ``device``."""
    if noise is None:
        generator = torch.Generator(device=device).manual_seed(seed)
        noise = torch.randn((n_traj, gen_res, gen_res), generator=generator,
                            dtype=torch.float32, device=generator.device)
    noise = torch.as_tensor(noise, device=device)
    if tuple(noise.shape) != (n_traj, gen_res, gen_res):
        raise ValueError(f"noise of shape {tuple(noise.shape)}, expected "
                         f"{(n_traj, gen_res, gen_res)}")
    data = generate_trajectories(noise, res, steps, dt, nu)
    for i in range(data.shape[-1]):
        log_fn(f"trajectory {i}: |w| max "
               f"{float(data[..., i].abs().max()):.3f}")
    data = data.cpu().numpy().astype(np.float32)
    np.save(out, data)
    log_fn(f"wrote FNO-format dataset {data.shape} to {out}")
    return out
