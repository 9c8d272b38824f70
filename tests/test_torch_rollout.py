"""Parity of the port's rollout with the JAX package, and the flagship
fixture the port is held to on the GPU.

* A 3-step rollout at res 16, capacity 160, against JAX's ``rollout`` in
  float64: rtol 1e-9 of the frame scale (float64 through three steps); the
  same with the first two steps densified by the training-time split.
* A 2-step CPU rollout of the exported Burgers flagship against the first
  two JAX frames stored in the fixture, norm-relative 1e-4: float32 on both
  sides, the port on the CPU against JAX on the CPU.
* The fixture's parameters against a fresh orbax restore of the checkpoint:
  exact.
* The dt=0.1 checkpoint's raw parameters (artifacts/burgers_dt01_torch.npz,
  exported with ``--params raw``: the checkpoint has no EMA): its first 5
  CPU rollout steps against the stored JAX frames, norm-relative 1e-4.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pigs_tpu.models import model as jmodel
from pigs_tpu.pde import IntegrationRule as JRule
from pigs_tpu.pde import Problem as JProblem
from pigs_tpu.train import pn as jpn
from pigs_tpu_torch import convert
from pigs_tpu_torch.models import model as tmodel
from pigs_tpu_torch.pde import IntegrationRule, Problem
from pigs_tpu_torch.train import pn as tpn

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "artifacts" / "burgers_ns4096_ema2_torch.npz"
CKPT = ROOT / "artifacts" / "burgers_ns4096_ema2_ckpt_30000"
DT01_FIXTURE = ROOT / "artifacts" / "burgers_dt01_torch.npz"
DT01_CKPT = ROOT / "artifacts" / "burgers_dt01_ckpt_30000"


def flatten(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def exporter():
    spec = importlib.util.spec_from_file_location(
        "export_torch_fixture", ROOT / "scripts" / "export_torch_fixture.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def small_models():
    jcfg = jmodel.ModelConfig.create(JProblem.BURGERS, JRule.TRAPEZOID, nx=6,
                                     ny=6, capacity=160, dtype=jnp.float64)
    tcfg = tmodel.ModelConfig.create(Problem.BURGERS,
                                     IntegrationRule.TRAPEZOID, nx=6, ny=6,
                                     capacity=160, dtype=torch.float64)
    network, params, _, _ = jpn.init_training(jcfg, jpn.TrainConfig(
        n_epochs=1, seed=5))
    freqs = np.array(jax.random.normal(jax.random.PRNGKey(42), (6,)) * 10.0)
    net = tmodel.make_network(tcfg, frequencies=torch.from_numpy(freqs))
    net.load_state_dict(convert.params_from_flax(flatten(params)))
    return jcfg, network, params, tcfg, net


def test_rollout_matches_jax_f64():
    jcfg, network, params, tcfg, net = small_models()
    want, _ = jpn.rollout(jcfg, network, params, n_steps=3, res=16)
    got, evo_time = tpn.rollout(tcfg, net, n_steps=3, res=16)
    assert got.shape == (3, 1, 16, 16) and got.dtype == np.float64
    assert evo_time > 0.0
    np.testing.assert_allclose(got, want, rtol=1e-9,
                               atol=1e-9 * np.abs(want).max())
    assert np.abs(got[2] - got[0]).max() > 1e-6  # the field does evolve


def test_densified_rollout_matches_jax_f64():
    jcfg, network, params, tcfg, net = small_models()
    want, _ = jpn.rollout(jcfg, network, params, n_steps=3, res=16,
                          densify=2)
    got, _ = tpn.rollout(tcfg, net, n_steps=3, res=16, densify=2)
    np.testing.assert_allclose(got, want, rtol=1e-9,
                               atol=1e-9 * np.abs(want).max())
    # The split changed the trajectory.
    plain, _ = tpn.rollout(tcfg, net, n_steps=3, res=16)
    assert np.abs(plain[2] - got[2]).max() > 1e-9


def test_fixture_rollout_matches_stored_jax_frames():
    cfg, net, data = convert.load_fixture(str(FIXTURE))
    assert (cfg.capacity, cfg.nx, int(data["config_steps"]),
            int(data["config_res"])) == (1664, 20, 50, 64)
    state = tmodel.make_initial_state(cfg)
    assert int(state.interior.sum()) == 400 and int(state.boundary.sum()) == 100
    frames = tpn.rollout_frames(cfg, net, state, 2, 64,
                                float(data["config_dt"])).numpy()
    jax_frames = data["jax_frames"]
    for i in range(2):
        err = (np.linalg.norm(frames[i] - jax_frames[i])
               / np.linalg.norm(jax_frames[i]))
        assert err <= 1e-4, (i, err)
    # The stored JAX-CPU score is the one its own frames give.
    m = tpn.rollout_metrics(jax_frames[:, 0], data["fd_frames"])
    assert m["mean_rel_norm"] == pytest.approx(float(data["jax_mean_rel_l2"]),
                                               rel=1e-12)


def test_dt01_fixture_rollout_matches_stored_jax_frames():
    cfg, net, data = convert.load_fixture(str(DT01_FIXTURE))
    assert str(data["config_params"]) == "raw"
    assert (cfg.capacity, cfg.nx, float(data["config_dt"])) == (1664, 20, 0.1)
    frames = tpn.rollout_frames(cfg, net, tmodel.make_initial_state(cfg), 5,
                                64, float(data["config_dt"])).numpy()
    jax_frames = data["jax_frames"]
    for i in range(5):
        err = (np.linalg.norm(frames[i] - jax_frames[i])
               / np.linalg.norm(jax_frames[i]))
        assert err <= 1e-4, (i, err)
    m = tpn.rollout_metrics(jax_frames[:, 0], data["fd_frames"])
    assert m["mean_rel_norm"] == pytest.approx(float(data["jax_mean_rel_l2"]),
                                               rel=1e-12)
    # The raw parameters, as a fresh orbax restore gives them.
    ex = exporter()
    _, params = ex.restore_params(str(DT01_CKPT), ex.flagship_config(),
                                      "raw")
    with np.load(DT01_FIXTURE) as z:
        for key, value in ex.flatten_params(params).items():
            np.testing.assert_array_equal(z[key], value)


def test_fixture_params_equal_a_fresh_orbax_restore():
    ex = exporter()
    _, params = ex.restore_params(str(CKPT), ex.flagship_config())
    fresh = ex.flatten_params(params)
    with np.load(FIXTURE) as z:
        stored = {k: z[k] for k in z.files if k.startswith("params/")}
    assert stored.keys() == fresh.keys() and len(stored) == 92
    assert sum(v.size for v in stored.values()) == 28228
    for key in fresh:
        np.testing.assert_array_equal(stored[key], fresh[key])


def test_rollout_metrics_match_jax():
    rng = np.random.default_rng(0)
    frames = rng.normal(size=(5, 8, 8))
    gt = rng.normal(size=(6, 8, 8))
    assert tpn.rollout_metrics(frames, gt) == jpn.rollout_metrics(frames, gt)


def test_rollout_guards():
    cfg = tmodel.ModelConfig.create(Problem.POISSON, nx=4, ny=4, capacity=140)
    net = tmodel.make_network(cfg)
    with pytest.raises(ValueError, match="dt=...\\) is required for POISSON"):
        tpn.rollout(cfg, net, n_steps=1, res=4)
