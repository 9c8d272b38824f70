"""The port's PN validation driver (scripts/validate_pn_torch.py), its
training and plotting entry points, against the JAX package (CPU).

* ``score`` for all five problems on the same fixed frames in float64
  against the JAX package's code path, as scripts/validate_pn.py:169-247
  calls it (``pigs_tpu.utils.fd.solve_fd_2d`` from the rendered t=0 field,
  ``pigs_tpu.train.pn.rollout_metrics``, the analytic targets; TEST through
  ``forward_step`` of a small JAX network carried across by
  ``pigs_tpu_torch.convert``): every score and ground-truth frame within
  1e-8.
* The stored flagship frames: ``score`` of the rollout fixture's JAX-CPU
  frames, in float32 as the export ran it, reproduces the fixture's FD
  frames within 1e-4 max abs and its JAX-CPU score within 1e-4.
* One whole CPU run of validate_pn_torch (TEST, nx 6, 2 epochs, 3 rollout
  steps, res 16) writing validate_pn.py's summary keys and files; then
  plot_rollout_torch on its directory, and one train_pn_torch run.
* scripts/select_split_stop_torch.py at one held-out IC, stops 0 and 8 and
  5 steps, against select_split_stop.py's JAX-CPU scores stored in
  artifacts/select_split_torch.npz (within 1e-4).
"""

import importlib.util
import json
import pathlib
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigs_tpu.models import model as jmodel
from pigs_tpu.pde import IntegrationRule as JRule
from pigs_tpu.pde import Problem as JProblem
from pigs_tpu.train import pn as jpn
from pigs_tpu.utils.fd import solve_fd_2d as j_fd
from pigs_tpu_torch import convert
from pigs_tpu_torch.models import model as tmodel
from pigs_tpu_torch.pde import IntegrationRule, Problem

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "artifacts" / "burgers_ns4096_ema2_torch.npz"
F64_TOL = 1e-8
STORED_TOL = 1e-4
STEPS, RES, DT = 3, 16, 0.05
# validate_pn.py's summary keys before scoring.
BASE_KEYS = {"problem", "epochs", "capacity", "train_s", "evo_time_s",
             "rollout_split", "dt", "n_samples", "ema_decay",
             "wave_psi_scale", "final_loss"}
TEST_KEYS = {"mean_abs_dy_minus_u_over_5", "per_step_dy_err",
             "mean_y_trajectory", "mean_u_trajectory"}


def load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def vpn():
    return load_script("validate_pn_torch")


def jax_score(problem, cfg, frames, dt, steps, res, network=None,
              params=None):
    """scripts/validate_pn.py:169-247, returning (summary keys, gt)."""
    summary = {}
    gt_frames = None
    if problem in (JProblem.BURGERS, JProblem.DIFFUSION, JProblem.WAVE):
        if problem == JProblem.WAVE:
            s = cfg.coeff.wave_psi_scale
            frames = frames.copy()
            frames[:, 1] *= s
            u0_fd = jnp.stack(
                [jnp.asarray(np.flipud(frames[0, ch]).T) for ch in range(2)],
                axis=-1)
            gt = np.asarray(j_fd(u0_fd, cfg.scale, dt, steps,
                                 problem="wave"))
            gt_frames = np.stack(
                [np.stack([np.flipud(g[..., ch].T) for ch in range(2)])
                 for g in gt])
            m = jpn.rollout_metrics(frames[:, 0], gt_frames[:, 0])
            m_psi = jpn.rollout_metrics(frames[:, 1], gt_frames[:, 1])
            summary.update(m)
            summary["mean_rel_norm_psi"] = m_psi["mean_rel_norm"]
            summary["per_step_rel_norm_psi"] = m_psi["per_step_rel_norm"]
        else:
            u0_fd = jnp.asarray(np.flipud(frames[0, 0]).T)
            gt = np.asarray(j_fd(u0_fd, cfg.scale, dt, steps,
                                 problem=problem.name.lower(),
                                 nu=cfg.coeff.nu))
            gt_frames = np.stack([np.flipud(g.T) for g in gt])
            summary.update(jpn.rollout_metrics(frames[:, 0], gt_frames))
    elif problem == JProblem.POISSON:
        tx = np.linspace(-1.0, 1.0, res) * cfg.scale
        profile = np.tile(np.sin(np.pi * (tx + 1.0))[None, :], (res, 1))

        def gt_at(times):
            amp = -(100.0 * np.asarray(times) / np.pi ** 2)
            return amp[:, None, None] * profile[None]

        k = np.arange(steps)
        gt_frames = gt_at(np.maximum(k - 0.5, 0.0) * dt)
        gt_end = gt_at(k * dt)
        summary.update(jpn.rollout_metrics(frames[1:, 0], gt_frames[1:]))
        m_end = jpn.rollout_metrics(frames[1:, 0], gt_end[1:])
        summary["mean_rel_norm_t_end"] = m_end["mean_rel_norm"]
        summary["per_step_rel_norm_t_end"] = m_end["per_step_rel_norm"]
    else:
        state = jmodel.make_initial_state(cfg)
        step = jax.jit(partial(jmodel.forward_step, cfg, network))
        dy_err, ys, us = [], [], []
        for _ in range(steps):
            new_state, deltas = step(params, state)
            mask = np.asarray(state.interior)
            dy = np.asarray(deltas.dmeans)[mask, 1]
            u = np.asarray(state.u)[mask, 0]
            dy_err.append(float(np.mean(np.abs(dy - u / 5.0))))
            ys.append(float(np.mean(np.asarray(state.means)[mask, 1])))
            us.append(float(np.mean(u)))
            state = new_state
        summary.update({"mean_abs_dy_minus_u_over_5": float(np.mean(dy_err)),
                        "per_step_dy_err": dy_err, "mean_y_trajectory": ys,
                        "mean_u_trajectory": us})
    return summary, gt_frames


def configs(name, **kw):
    """Small configs; TEST's line of six Gaussians needs nx >= 6."""
    jcfg = jmodel.ModelConfig.create(JProblem[name], JRule.TRAPEZOID, nx=6,
                                     ny=6, capacity=256, dtype=jnp.float64)
    tcfg = tmodel.ModelConfig.create(Problem[name], IntegrationRule.TRAPEZOID,
                                     nx=6, ny=6, capacity=256,
                                     dtype=torch.float64)
    if kw:
        jcfg = jcfg._replace(coeff=jcfg.coeff._replace(**kw))
        tcfg = tcfg._replace(coeff=tcfg.coeff._replace(**kw))
    return jcfg, tcfg


def fixed_frames(seed, channels):
    """Smooth float64 frames (STEPS, c, RES, RES) in image layout: a bump
    off the centre plus a little noise, so that a wrong layout turn moves
    the score."""
    rng = np.random.default_rng(seed)
    x = np.linspace(-1.0, 1.0, RES)
    yy, xx = np.meshgrid(x[::-1], x, indexing="ij")
    bump = np.exp(-((xx - 0.3) ** 2 + (yy + 0.2) ** 2) / 0.1)
    frames = bump[None, None] * (1.0 + 0.1 * np.arange(STEPS))[:, None, None,
                                                                None]
    frames = np.repeat(frames, channels, axis=1)
    return frames + 0.01 * rng.normal(size=frames.shape)


def assert_same(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=F64_TOL, err_msg=k)


@pytest.mark.parametrize("name,kw", [("BURGERS", {}), ("DIFFUSION", {}),
                                     ("WAVE", {"wave_psi_scale": 30.0}),
                                     ("POISSON", {})])
def test_score_matches_validate_pn_f64(vpn, name, kw):
    jcfg, tcfg = configs(name, **kw)
    frames = fixed_frames(1, 2 if name == "WAVE" else 1)
    want, want_gt = jax_score(JProblem[name], jcfg, frames, DT, STEPS, RES)
    got, got_gt = vpn.score(name.lower(), tcfg, frames, DT, STEPS, RES,
                            device=torch.device("cpu"), log_fn=lambda m: None)
    assert_same(got, want)
    assert got_gt.shape == want_gt.shape
    np.testing.assert_allclose(got_gt, want_gt, rtol=0, atol=F64_TOL)
    if name == "BURGERS":   # a transposed field scores otherwise
        turned, _ = vpn.score("burgers", tcfg, frames.swapaxes(-1, -2), DT,
                              STEPS, RES, device=torch.device("cpu"),
                              log_fn=lambda m: None)
        assert abs(turned["mean_rel_norm"] - got["mean_rel_norm"]) > 1e-4


def test_score_test_problem_matches_validate_pn_f64(vpn):
    jcfg, tcfg = configs("TEST")
    network, params, _, _ = jpn.init_training(jcfg, jpn.TrainConfig(
        n_epochs=1, seed=5))
    freqs = np.array(jax.random.normal(jax.random.PRNGKey(42), (6,)) * 10.0)
    net = tmodel.make_network(tcfg, frequencies=torch.from_numpy(freqs))
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    net.load_state_dict(convert.params_from_flax(flat))
    want, _ = jax_score(JProblem.TEST, jcfg, None, DT, STEPS, RES, network,
                        params)
    got, gt = vpn.score("test", tcfg, None, DT, STEPS, RES, net,
                        torch.device("cpu"), log_fn=lambda m: None)
    assert gt is None and set(got) == TEST_KEYS
    assert_same(got, want)
    assert got["mean_abs_dy_minus_u_over_5"] > 0.0


def test_score_of_the_stored_flagship_frames(vpn):
    cfg, _, data = convert.load_fixture(str(FIXTURE))
    frames = data["jax_frames"]
    assert frames.dtype == np.float32
    got, gt = vpn.score("burgers", cfg, frames, float(data["config_dt"]),
                        int(data["config_steps"]), int(data["config_res"]),
                        device=torch.device("cpu"), log_fn=lambda m: None)
    assert gt.shape == data["fd_frames"].shape
    assert np.abs(gt - data["fd_frames"]).max() <= STORED_TOL
    assert abs(got["mean_rel_norm"]
               - float(data["jax_mean_rel_l2"])) <= STORED_TOL


def test_whole_cpu_run_writes_validate_pn_outputs(vpn, tmp_path):
    out = tmp_path / "run"
    summary = vpn.main(["--problem", "test", "--nx", "6", "--capacity", "256",
                        "--epochs", "2", "--n-samples", "64",
                        "--train-timesteps", "2", "--rollout-steps", "3",
                        "--res", "16", "--device", "cpu", "--out", str(out)])
    on_disk = json.loads((out / "summary.json").read_text())
    assert BASE_KEYS | TEST_KEYS <= set(on_disk)
    assert on_disk["device"] == "cpu" and on_disk["card"] is None
    assert on_disk["epochs"] == 2 and summary["problem"] == "test"
    assert np.isfinite(on_disk["mean_abs_dy_minus_u_over_5"])
    frames = np.load(out / "rollout_frames.npy")
    assert frames.shape == (3, 1, 16, 16) and np.isfinite(frames).all()
    assert "training wall-clock" in (out / "train.log").read_text()

    # plot_rollout_torch on a scored directory: the two panels.
    np.save(out / "fd_gt_frames.npy", frames + 0.1)
    on_disk["per_step_rel_norm"] = [0.0, 0.1, 0.2]
    (out / "summary.json").write_text(json.dumps(on_disk))
    written = load_script("plot_rollout_torch").main([str(out)])
    assert sorted(pathlib.Path(w).name for w in written) == [
        "rollout_panel.png", "rollout_rel_norm.png"]


def test_train_pn_torch_run_scores_against_gt(tmp_path):
    out = tmp_path / "train"
    np.save(tmp_path / "gt.npy", np.zeros((3, 16, 16)))
    summary = load_script("train_pn_torch").main([
        "--problem", "diffusion", "--nx", "4", "--ny", "4", "--capacity",
        "160", "--epochs", "1", "--n-samples", "64", "--train-timesteps",
        "2", "--rollout-steps", "3", "--rollout-res", "16", "--gt",
        str(tmp_path / "gt.npy"), "--device", "cpu", "--out", str(out)])
    assert summary["rollout_steps"] == 3 and len(
        summary["per_step_rel_norm"]) == 3
    assert sorted(p.name for p in out.glob("frame*.png")) == [
        f"frame{i}.png" for i in range(3)]
    assert json.loads((out / "summary.json").read_text())["device"] == "cpu"


def test_select_split_stop_torch_matches_jax(tmp_path):
    """scripts/select_split_stop_torch.py on one of JAX's held-out ICs at
    stops 0 and 8 over 5 steps: every selection and evaluation score within
    1e-4 of select_split_stop.py's JAX-CPU scores at the same arguments
    (artifacts/select_split_torch.npz), and its summary keys."""
    fixture = ROOT / "artifacts" / "select_split_torch.npz"
    with np.load(fixture) as z:
        stops, steps = z["test_stops"].tolist(), int(z["test_steps"])
        selection, evaluation = z["test_selection"], z["test_eval"]
    summary = load_script("select_split_stop_torch").main([
        "--device", "cpu", "--ic-fixture", str(fixture), "--n-select", "1",
        "--stops", ",".join(map(str, stops)), "--rollout-steps", str(steps),
        "--out", str(tmp_path)])
    assert json.loads((tmp_path / "summary.json").read_text()) == summary
    assert {"problem", "ckpt", "stops", "selection_mean_rel_l2",
            "heldout_stop", "eval_mean_rel_l2", "parity", "heldout",
            "oracle_stop", "oracle", "wall_s"} <= set(summary)
    for k, stop in enumerate(stops):
        assert abs(summary["selection_mean_rel_l2"][str(stop)]
                   - selection[k]) <= STORED_TOL
        assert abs(summary["eval_mean_rel_l2"][str(stop)]
                   - evaluation[k]) <= STORED_TOL
    assert summary["parity"] == summary["eval_mean_rel_l2"]["0"]
    assert summary["heldout_stop"] == stops[int(np.argmin(selection))]
