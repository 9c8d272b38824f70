"""Inference rollout of the PN dynamics model and its metrics (port of
``pigs_tpu.train.pn.rollout`` / ``rollout_metrics``)."""

from __future__ import annotations

import time
from typing import Optional, Union

import numpy as np
import torch

from pigs_tpu_torch.models.model import (ModelConfig, forward_step,
                                         make_initial_state)
from pigs_tpu_torch.models.state import MixtureState, covariance_of
from pigs_tpu_torch.ops.mixture import eval_mixture
from pigs_tpu_torch.pde import Problem
from pigs_tpu_torch.utils.sampling import image_samples

__all__ = ["rollout", "rollout_frames", "rollout_metrics"]


def rollout_frames(cfg: ModelConfig, network, state: MixtureState,
                   n_steps: int, res: int, dt: float) -> torch.Tensor:
    """``n_steps`` of render-then-evolve from ``state``: frames
    ``(n_steps, c, res, res)`` on the state's device.  Each step renders
    order 0 on the image grid with mask = interior, then calls
    :func:`forward_step` at ``t = i * dt``."""
    samples = image_samples(res, cfg.scale, cfg.dtype, state.means.device)
    frames = []
    with torch.inference_mode():
        for i in range(n_steps):
            _, conics = covariance_of(state)
            out = eval_mixture(state.means, conics, state.u, samples, order=0,
                               mask=state.interior, period=cfg.period)
            frames.append(out.u.T.reshape(-1, res, res))
            state, _ = forward_step(cfg, network, state, t=i * dt)
        return torch.stack(frames)


def rollout(cfg: ModelConfig, network, n_steps: int = 50, res: int = 64,
            state: Optional[MixtureState] = None,
            densify: Union[bool, int] = False, dt: Optional[float] = None,
            device=None):
    """Rollout producing frames and its wall-clock time.

    Returns ``(frames (n_steps, c, res, res) as numpy, evo_time seconds)``.
    The rollout runs once to warm up (the kernels' build and first launches)
    and is then timed, synchronising the device on both sides.  ``dt``
    threads physical time into the steps; POISSON needs it explicitly.
    ``device`` places the default initial state (``state`` keeps its own).
    """
    if densify is not False:
        raise NotImplementedError(
            "rollout(densify=...) needs adaptive_split, which is ported with "
            "the split PR; the parity default is densify=False")
    if dt is None:
        if cfg.problem == Problem.POISSON:
            raise ValueError("rollout(dt=...) is required for POISSON: its "
                             "forcing is time-dependent and the implicit "
                             "default would freeze t=0")
        dt = 0.0
    if state is None:
        state = make_initial_state(cfg, device=device)
    cuda = state.means.is_cuda

    def sync():
        if cuda:
            torch.cuda.synchronize(state.means.device)

    rollout_frames(cfg, network, state, n_steps, res, dt)
    sync()
    start = time.perf_counter()
    frames = rollout_frames(cfg, network, state, n_steps, res, dt)
    sync()
    evo_time = time.perf_counter() - start
    return frames.cpu().numpy(), evo_time


def rollout_metrics(frames: np.ndarray, ground_truth: np.ndarray):
    """Per-step relative L2 error against a ground-truth trajectory and its
    mean; also the error relative to the initial frame's norm."""
    frames = np.asarray(frames)
    gt = np.asarray(ground_truth)
    n = min(frames.shape[0], gt.shape[0])
    denom0 = float(np.linalg.norm(gt[0].reshape(-1))) or 1.0
    norms, norms0 = [], []
    for i in range(n):
        a = frames[i].reshape(-1)
        b = gt[i].reshape(-1)
        err = float(np.linalg.norm(a - b))
        denom = float(np.linalg.norm(b))
        norms.append(float(err / (denom if denom else 1.0)))
        norms0.append(float(err / denom0))
    return {"per_step_rel_norm": norms,
            "mean_rel_norm": float(np.mean(norms)),
            "per_step_rel_initial_norm": norms0,
            "mean_rel_initial_norm": float(np.mean(norms0))}
