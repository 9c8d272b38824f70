"""Parity of the port's Navier-Stokes pieces with the JAX package, on the
committed NS dataset (artifacts/ns_data_8traj.npz) and the NS fixture
(artifacts/ns_vorttrain_torch.npz, exported from
artifacts/ns_vorttrain_ckpt_20000 by scripts/export_torch_fixture.py
--kind ns).

Tolerances: exact for the dataset's arrays and lookups; rtol 1e-10 of each
output's scale for float64 renders and steps (both sides compute the same
sums in other orders); 1e-5 norm-relative for float32 frames against the
fixture's JAX-CPU frames (measured ~2e-7 on the CPU).
"""

import pathlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from pigs_tpu.models import model as jmodel
from pigs_tpu.ops.mixture import eval_mixture as jeval
from pigs_tpu.pde import IntegrationRule as JRule
from pigs_tpu.pde import Problem as JProblem
from pigs_tpu.train import pn as jpn
from pigs_tpu_torch import convert
from pigs_tpu_torch.models import model as tmodel
from pigs_tpu_torch.ops.aggregate import aggregate_neighbors_factored
from pigs_tpu_torch.pde import IntegrationRule, Problem
from pigs_tpu_torch.train import pn as tpn

ROOT = pathlib.Path(__file__).resolve().parents[1]
NS_DATA = ROOT / "artifacts" / "ns_data_8traj.npz"
NS_FIXTURE = ROOT / "artifacts" / "ns_vorttrain_torch.npz"
RTOL = 1e-10
FRAME_TOL = 1e-5
HELD_OUT = 7


def close(got, want):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL,
                                   atol=RTOL * max(np.abs(want).max(), 1.0))


def configs(dtype=torch.float64):
    jcfg = jmodel.ModelConfig.create(
        JProblem.NAVIER_STOKES, JRule.TRAPEZOID, nx=20, ny=20, capacity=640,
        split_criteria="vorticity",
        dtype=jnp.float64 if dtype == torch.float64 else jnp.float32)
    tcfg = tmodel.ModelConfig.create(
        Problem.NAVIER_STOKES, IntegrationRule.TRAPEZOID, nx=20, ny=20,
        capacity=640, split_criteria="vorticity", dtype=dtype)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def datasets():
    return (jpn.NSDataset.load(str(NS_DATA)),
            tpn.NSDataset.load(str(NS_DATA)))


def f64_states(jdata, tdata, index=HELD_OUT):
    jcfg, tcfg = configs()
    js = jdata.state_for(jcfg, index)
    js = js._replace(**{f: getattr(js, f).astype(jnp.float64)
                        for f in ("means", "scaling", "transforms", "u")})
    return jcfg, tcfg, js, tdata.state_for(tcfg, index)


def test_dataset_load_state_and_target(datasets):
    jdata, tdata = datasets
    for j, t in zip(jdata, tdata):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert tuple(tdata.frames.shape) == (8, 64, 64, 51)
    jcfg, tcfg = configs(torch.float32)
    js, ts = jdata.state_for(jcfg, 3), tdata.state_for(tcfg, 3)
    for field in js._fields:
        np.testing.assert_array_equal(getattr(ts, field).numpy(),
                                      np.asarray(getattr(js, field)))
    assert ts.capacity == 640 and int(ts.active.sum()) == 400
    samples = np.random.default_rng(0).uniform(-1.0, 1.0, (500, 2))
    samples[:4] = [[-1.0, -1.0], [1.0, 1.0], [0.999, -0.999], [0.0, 0.0]]
    for timestep in (0, 17, 50, 80):
        want = jdata.recon_target(HELD_OUT, timestep, jnp.asarray(samples))
        got = tdata.recon_target(HELD_OUT, timestep,
                                 torch.from_numpy(samples))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_vorticity_render_matches_jax(datasets):
    jcfg, tcfg, js, ts = f64_states(*datasets)
    res = 64
    centers = (jnp.arange(res) + 0.5) / res * 2.0 - 1.0
    gx, gy = jnp.meshgrid(centers, centers, indexing="ij")
    jsamples = jnp.stack([gx, gy], axis=-1).reshape(-1, 2)
    _, conics = jmodel.covariance_of(js)
    out = jeval(js.means, conics, js.u, jsamples, order=1, mask=js.active,
                period=jcfg.period, diff_samples=False)
    want = (out.ux[:, 0, 1] - out.ux[:, 1, 0]).reshape(res, res).T
    samples = tpn.vorticity_samples(res, torch.float64)
    close(samples, jsamples)
    got = tpn.render_vorticity(tcfg, ts, samples, res)
    assert got.shape == (res, res)
    close(got, want)


NORMAL = jax.random.normal


def f32_normal(key, shape=(), dtype=None):
    """jax.random.normal drawing float32 unless told otherwise: the NS
    network was trained without x64, so its fixed frequencies are the
    float32 draw (scripts/export_torch_fixture.py::float32_default_normal)."""
    return NORMAL(key, shape, jnp.float32 if dtype is None else dtype)


def test_forward_step_full_width_f64(datasets):
    """The converted NS network's forward_step on the held-out state (640
    slots, 400 active, order 3, c=2, period 2.0) in float64."""
    jcfg, tcfg, js, ts = f64_states(*datasets)
    with np.load(NS_FIXTURE) as z:
        flat = {k: z[k] for k in z.files if k.startswith("params/")}
        freqs = z["frequencies"]
    params = traverse_util.unflatten_dict(
        {tuple(k.split("/")): jnp.asarray(v, jnp.float64)
         for k, v in flat.items()})
    with mock.patch.object(jax.random, "normal", f32_normal):
        jnew, jdeltas = jmodel.forward_step(jcfg, jmodel.make_network(jcfg),
                                            params, js)
    net = tmodel.make_network(tcfg, frequencies=torch.from_numpy(freqs))
    net.load_state_dict({k: v.double() for k, v in
                         convert.params_from_flax(flat).items()})
    tnew, tdeltas = tmodel.forward_step(tcfg, net, ts)
    for field in jnew._fields:
        close(getattr(tnew, field), getattr(jnew, field))
    for got, want in zip(tdeltas, jdeltas):
        close(got, want)
    assert float(torch.abs(tdeltas.du.detach()).max()) > 0


def test_rollout_first_steps_match_fixture(datasets):
    """The first 5 steps of scripts/validate_ns_torch.py's rollout (float32)
    against the JAX-CPU frames stored in the fixture."""
    cfg, network, fix = convert.load_fixture(str(NS_FIXTURE))
    assert (cfg.capacity, cfg.period, cfg.split_criteria, cfg.channels) == (
        640, 2.0, "vorticity", 2)
    index = int(fix["config_held_out"])
    assert index == HELD_OUT
    state = datasets[1].state_for(cfg, index)
    frames = tpn.rollout_vorticity(cfg, network, state, 5,
                                   int(fix["config_res"])).numpy()
    want = fix["jax_frames"][:6]
    errs = [np.linalg.norm(a - b) / np.linalg.norm(b)
            for a, b in zip(frames, want)]
    assert frames.shape == want.shape and max(errs) <= FRAME_TOL, errs
    gt = datasets[1].frames[index].permute(2, 0, 1).numpy()
    t0 = tpn.rollout_metrics(frames[:1], gt[:1])["mean_rel_norm"]
    assert abs(t0 - float(fix["jax_t0_rel_l2"])) <= 1e-6


def test_aggregation_inputs_leave_deltas_unchanged(datasets):
    """DynamicsNetwork.forward aggregates exactly what aggregation_inputs
    returns, and composing the network by hand from its submodules gives the
    same Deltas bit for bit."""
    _, tcfg, _, ts = f64_states(*datasets)
    net = tmodel.make_network(tcfg, generator=torch.Generator().manual_seed(5))
    args = tmodel.network_inputs(tcfg, ts)
    deltas = net(*args, tcfg.period)
    features, heads = net.aggregation_inputs(*args[:9])

    it = net.input_transform(*args[:9])
    t_params = torch.cat([it[1], it[2], args[3][:, None], *it[3:]], dim=-1)
    assert torch.equal(features, net.input_projection(t_params))
    aggs = []
    for h, head in enumerate(heads):
        assert torch.equal(head.queries, net.query[h](features))
        assert torch.equal(head.keys, net.key[h](features))
        assert torch.equal(head.transform,
                           getattr(net, f"transform_{h}") - 1.0)
        assert torch.equal(head.distance_transform,
                           getattr(net, f"distance_transform_{h}") - 1.0)
        aggs.append(aggregate_neighbors_factored(
            features, getattr(net, f"transform_{h}") - 1.0,
            net.query[h](features), net.key[h](features),
            net.frequencies.double(),
            getattr(net, f"distance_transform_{h}") - 1.0, means=args[0],
            mask=args[9], period=tcfg.period))
    out = net.delta_net(torch.cat([features] + aggs, dim=-1))
    gate = args[8].double()[:, None]
    # d=2, one transform parameter, c=2: [dmeans 2, dscaling 2, dtransforms
    # 1, du 2].
    for got, cols in zip(deltas[:4], (slice(0, 2), slice(2, 4), slice(4, 5),
                                      slice(5, 7))):
        assert torch.equal(got, out[:, cols] * gate)
    assert torch.equal(deltas.head_magnitudes,
                       torch.stack([torch.mean(a ** 2) for a in aggs]))
