"""Visualization: Gaussian ellipse plots and field renders (a copy of
:mod:`pigs_tpu.utils.plotting`, which the port may not import).

Equivalent of the reference's ``plot_gaussians`` (gaussians.py:13-46) and the
frame-dump loops (main_pn.py:461-479); pure host-side matplotlib on numpy
copies.  matplotlib is imported inside each function, so the module imports
where matplotlib is missing; the functions then raise ImportError.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["plot_gaussians", "save_field_frames", "render_rollout_artifacts",
           "matplotlib_available"]


def matplotlib_available() -> bool:
    """Whether matplotlib can be imported here (the card's machine has
    none; the functions below need it)."""
    import importlib.util
    return importlib.util.find_spec("matplotlib") is not None


def plot_gaussians(means, covariances_packed, values, scale: float = 1.0,
                   active=None):
    """Ellipse plot of a 2D mixture colored by value channel 0.

    ``covariances_packed`` is ``(n, 3)`` [xx, xy, yy] packed storage.  Each
    Gaussian is drawn as the unit circle mapped linearly by its covariance
    matrix (the reference's visual convention, gaussians.py:13-46), realized
    here as one vectorized eigendecomposition feeding a single
    ``EllipseCollection`` instead of a per-patch affine loop.  Returns the
    matplotlib figure.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.collections import EllipseCollection

    means = np.asarray(means, dtype=np.float64)[..., :2]
    values = np.asarray(values, dtype=np.float64)
    cov = np.asarray(covariances_packed, dtype=np.float64)
    if active is not None:
        sel = np.asarray(active)
        means, values, cov = means[sel], values[sel], cov[sel]
    n = means.shape[0]

    fig, ax = plt.subplots()
    if n:
        # Sigma = R diag(l1, l2) R^T: axis lengths are the eigenvalues (the
        # linear-map convention: diameter 10*lambda, like the reference's
        # width-10 unit circle under the covariance affine).
        mats = np.empty((n, 2, 2))
        mats[:, 0, 0], mats[:, 1, 1] = cov[:, 0], cov[:, 2]
        mats[:, 0, 1] = mats[:, 1, 0] = cov[:, 1]
        lam, vecs = np.linalg.eigh(mats)          # ascending eigenvalues
        angles = np.degrees(np.arctan2(vecs[:, 1, 1], vecs[:, 0, 1]))
        ells = EllipseCollection(10.0 * lam[:, 1], 10.0 * lam[:, 0], angles,
                                 units="xy", offsets=means,
                                 offset_transform=ax.transData, alpha=0.25)
        ells.set_array(values[:, 0])
        ax.add_collection(ells)
    lim = 1.25 * scale
    ax.set(xlim=(-lim, lim), ylim=(-lim, lim))
    ax.set_aspect("equal", adjustable="box")
    return fig


def save_field_frames(frames: np.ndarray, directory: str,
                      prefix: str = "frame",
                      vmin: Optional[float] = None,
                      vmax: Optional[float] = None) -> None:
    """Dump ``(t, c, h, w)`` field frames as PNGs (main_pn.py:461-479)."""
    import os

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(directory, exist_ok=True)
    frames = np.asarray(frames)
    vmin = float(frames.min()) if vmin is None else vmin
    vmax = float(frames.max()) if vmax is None else vmax
    for i, frame in enumerate(frames):
        fig = plt.figure()
        if frame.shape[0] == 2:
            axes = fig.subplots(1, 2)
            for ch in range(2):
                im = axes[ch].imshow(frame[ch], vmin=vmin, vmax=vmax)
                plt.colorbar(im, ax=axes[ch])
                axes[ch].axis("off")
        else:
            plt.imshow(frame[0], vmin=vmin, vmax=vmax)
            plt.colorbar()
            plt.axis("off")
        fig.savefig(os.path.join(directory, f"{prefix}{i}.png"),
                    bbox_inches="tight")
        plt.close(fig)


def render_rollout_artifacts(results_dir: str, channel: int = 0,
                             steps=None) -> list:
    """Render ``rollout_panel.png`` (prediction / ground truth / |difference|
    at a handful of timesteps) and ``rollout_rel_norm.png`` (per-step
    relative-L2 curve) into a validate_pn_torch/validate_ns_torch results directory.
    Returns the list of files written; silently skips whatever inputs are
    missing — callers invoke it best-effort after training runs."""
    import json
    import os

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    d = results_dir
    written = []
    if os.path.exists(os.path.join(d, "rollout_w.npy")):        # NS layout
        pred = np.load(os.path.join(d, "rollout_w.npy"))
        gt_path = os.path.join(d, "gt_w.npy")
        field = "vorticity"
        signed = True
    else:
        pred_path = os.path.join(d, "rollout_frames.npy")
        if not os.path.exists(pred_path):
            return written
        pred = np.load(pred_path)
        gt_path = os.path.join(d, "fd_gt_frames.npy")
        field = "u"
        signed = None
    summary = {}
    spath = os.path.join(d, "summary.json")
    if os.path.exists(spath):
        with open(spath) as f:
            summary = json.load(f)
    rel = summary.get("per_step_rel_norm")

    if os.path.exists(gt_path):
        gt = np.load(gt_path)
        if pred.ndim == 4:
            pred = pred[:, channel]
        if gt.ndim == 4:
            gt = gt[:, channel]
        if signed is None:
            signed = bool(np.min(gt) < -0.05 * np.max(np.abs(gt)))
        n = min(pred.shape[0], gt.shape[0])
        pred, gt = pred[:n], gt[:n]
        steps = [s for s in (steps or []) if s < n] or \
            [int(round(i * (n - 1) / 5)) for i in range(6)]
        vmax = float(np.max(np.abs(gt)))
        fkw = (dict(cmap="RdBu_r", vmin=-vmax, vmax=vmax) if signed
               else dict(cmap="Blues", vmin=0.0, vmax=vmax))
        ncol = len(steps)
        fig, axes = plt.subplots(3, ncol, figsize=(1.9 * ncol, 6.4),
                                 constrained_layout=True)
        axes = axes.reshape(3, ncol)
        emax = float(np.max(np.abs(pred[steps] - gt[steps])))
        for j, s in enumerate(steps):
            im0 = axes[0, j].imshow(pred[s], **fkw)
            axes[1, j].imshow(gt[s], **fkw)
            im2 = axes[2, j].imshow(np.abs(pred[s] - gt[s]), cmap="Oranges",
                                    vmin=0.0, vmax=max(emax, 1e-12))
            axes[0, j].set_title(f"step {s}", fontsize=10)
            for i in range(3):
                axes[i, j].set_xticks([])
                axes[i, j].set_yticks([])
        axes[0, 0].set_ylabel("PN rollout", fontsize=10)
        axes[1, 0].set_ylabel("ground truth", fontsize=10)
        axes[2, 0].set_ylabel("|difference|", fontsize=10)
        fig.colorbar(im0, ax=axes[:2, -1], shrink=0.8, label=field)
        fig.colorbar(im2, ax=axes[2, -1], shrink=0.8, label="abs err")
        title = f"{summary.get('problem', os.path.basename(d))}"
        if rel:
            title += (" — mean rel-L2 "
                      f"{summary.get('mean_rel_norm', float('nan')):.3f}")
        fig.suptitle(title)
        out = os.path.join(d, "rollout_panel.png")
        fig.savefig(out, dpi=130)
        plt.close(fig)
        written.append(out)

    if rel:
        fig = plt.figure(figsize=(5.2, 3.2), constrained_layout=True)
        ax = fig.add_subplot()
        ax.plot(rel, lw=2, color="#3b6fb6")
        extra = summary.get("per_step_rel_norm_psi")
        if extra:
            ax.plot(extra, lw=2, color="#b6713b", label="psi channel")
            ax.plot([], [], lw=2, color="#3b6fb6", label="phi channel")
            ax.legend(frameon=False)
        ax.set_xlabel("rollout step")
        ax.set_ylabel("relative L2 vs ground truth")
        ax.spines[["top", "right"]].set_visible(False)
        ax.grid(alpha=0.25, lw=0.5)
        out = os.path.join(d, "rollout_rel_norm.png")
        fig.savefig(out, dpi=130)
        plt.close(fig)
        written.append(out)
    return written
