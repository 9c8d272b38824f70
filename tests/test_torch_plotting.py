"""The port's plotting module (pigs_tpu_torch/utils/plotting.py, a copy of
pigs_tpu/utils/plotting.py) on the cases of tests/test_plotting.py, and
against the JAX package's module on the same input (CPU, matplotlib)."""

import json
import os

import numpy as np
import pytest

from pigs_tpu.utils import plotting as jplot
from pigs_tpu_torch.utils import plotting as tplot


def test_plot_gaussians_ellipse_geometry(tmp_path):
    """Axis-aligned covariance -> ellipse axes = 10*eigenvalues at angle 0;
    the active mask filters rows; n=0 renders an empty figure."""
    means = np.array([[0.2, -0.3], [5.0, 5.0]])
    cov = np.array([[0.4, 0.0, 0.1], [1.0, 0.0, 1.0]])
    vals = np.array([[1.0], [2.0]])
    fig = tplot.plot_gaussians(means, cov, vals, scale=1.0,
                               active=np.array([True, False]))
    coll = fig.gca().collections[0]
    assert coll.get_offsets().shape == (1, 2)
    np.testing.assert_allclose(coll.get_offsets()[0], means[0])
    w = np.asarray(coll._widths).ravel() * 2
    h = np.asarray(coll._heights).ravel() * 2
    np.testing.assert_allclose(sorted([w[0], h[0]]), [1.0, 4.0], atol=1e-12)
    fig.savefig(os.path.join(tmp_path, "ellipses.png"))

    empty = tplot.plot_gaussians(np.zeros((0, 2)), np.zeros((0, 3)),
                                 np.zeros((0, 1)))
    assert empty.gca().get_xlim() == (-1.25, 1.25)


def test_plot_gaussians_matches_jax_module():
    rng = np.random.default_rng(3)
    means = rng.uniform(-1, 1, (7, 2))
    a = rng.normal(size=(7, 2, 2)) * 0.1
    cov = np.einsum("nij,nkj->nik", a, a) + 0.01 * np.eye(2)
    packed = np.stack([cov[:, 0, 0], cov[:, 0, 1], cov[:, 1, 1]], -1)
    vals = rng.normal(size=(7, 1))
    got = tplot.plot_gaussians(means, packed, vals).gca().collections[0]
    want = jplot.plot_gaussians(means, packed, vals).gca().collections[0]
    for attr in ("_widths", "_heights", "_angles"):
        np.testing.assert_array_equal(getattr(got, attr), getattr(want, attr))
    np.testing.assert_array_equal(got.get_offsets(), want.get_offsets())


@pytest.mark.parametrize("channels", [1, 2])
def test_save_field_frames_and_rollout_artifacts(tmp_path, channels):
    frames = np.random.default_rng(0).normal(size=(3, channels, 8, 8))
    tplot.save_field_frames(frames, str(tmp_path / "frames"))
    assert sorted(os.listdir(tmp_path / "frames")) == [
        f"frame{i}.png" for i in range(3)]

    d = tmp_path / "results"
    os.makedirs(d)
    np.save(d / "rollout_frames.npy", frames)
    np.save(d / "fd_gt_frames.npy", frames + 0.1)
    with open(d / "summary.json", "w") as f:
        json.dump({"problem": "burgers", "mean_rel_norm": 0.1,
                   "per_step_rel_norm": [0.0, 0.1, 0.2],
                   "per_step_rel_norm_psi": [0.0, 0.2, 0.3]}, f)
    written = tplot.render_rollout_artifacts(str(d), channel=channels - 1)
    assert sorted(os.path.basename(w) for w in written) == [
        "rollout_panel.png", "rollout_rel_norm.png"]
    assert tplot.render_rollout_artifacts(str(tmp_path / "missing")) == []
