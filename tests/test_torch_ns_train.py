"""Parity of the port's Navier-Stokes training and of the training options
``noise_std`` and ``adaptive_sampling`` with the JAX package (float64, CPU).

* ``pn_step`` with the vorticity-reconstruction target on a small NS model
  (capacity 48, 64 samples, order 3, c=2, period 2.0, the recipe's clip and
  skip) against JAX's ``pn_step``: parameters, Adam moments, losses, total
  and loss weight within rtol 1e-8 of each tensor's scale.  The same with a
  non-finite target (the term counts 0, the update is skipped) and with
  ``initial_fields`` at gate 1 and 0.
* A 3-step split-regime epoch (vorticity criteria) with per-step targets
  and the robustness noise against ``pn_epoch_scan``, the noise injected as
  JAX draws it: per-step losses and parameters rtol 1e-8, active masks
  equal, the boundary Gaussians' values untouched.
* ``importance_weights`` against JAX's weights on fixed candidates (rtol
  1e-10); ``importance_samples`` by structure.
* ``train_epoch``'s NS branch and ``train(ns_data=...)`` by structure on a
  small synthetic dataset.
* The exported NS training fixture (artifacts/ns_vorttrain_train_torch.npz,
  scripts/export_torch_fixture.py --kind ns-train): one full-width
  ``pn_step`` of the port reproduces the stored JAX float64 step (losses
  rtol 1e-9, gradient and update norm-relative 1e-9).

The JAX network is initialised at random and converted; its frequencies are
drawn as the JAX package draws them in this (x64) process.  Inputs come
from numpy seeds.
"""

import pathlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pigs_tpu.models import model as jmodel
from pigs_tpu.models.state import init_state as jinit_state
from pigs_tpu.ops.mixture import eval_mixture as jeval
from pigs_tpu.pde import IntegrationRule as JRule
from pigs_tpu.pde import Problem as JProblem
from pigs_tpu.train import pn as jpn
from pigs_tpu_torch import convert
from pigs_tpu_torch.models import model as tmodel
from pigs_tpu_torch.models.state import MixtureState
from pigs_tpu_torch.pde import IntegrationRule, Problem
from pigs_tpu_torch.train import checkpoint as tckpt
from pigs_tpu_torch.train import pn as tpn

ROOT = pathlib.Path(__file__).resolve().parents[1]
NS_TRAIN_FIXTURE = ROOT / "artifacts" / "ns_vorttrain_train_torch.npz"
RTOL = 1e-8
CAP, NX, M, NB = 48, 4, 64, 4
BASE_LR, EPS, DT, FLOOR, CLIP = 3e-3, 1.0, 0.1, 0.05, 1.0


def flatten(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def close(got, want, rtol=RTOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def adam_of(opt_state):
    return [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]


def ns_state(rng, boundary: int):
    """25 interior Gaussians on a jittered 5x5 grid with random velocities
    and, for ``boundary`` > 0, that many fixed Gaussians in the boundary
    slots (NS has none of its own; they show what the noise leaves)."""
    g = np.linspace(-0.8, 0.8, 5)
    gx, gy = np.meshgrid(g, g, indexing="ij")
    means = np.stack([gx, gy], -1).reshape(-1, 2) + rng.normal(0, 0.03,
                                                               (25, 2))
    scaling = np.exp(rng.normal(-1.7, 0.15, (25, 2)))
    transforms = rng.normal(0, 0.3, (25, 1))
    u = rng.normal(0, 0.5, (25, 2))
    b = (np.stack([rng.uniform(-1, 1, boundary), np.full(boundary, 0.95)], -1),
         np.full((boundary, 2), 0.2), np.zeros((boundary, 1)),
         rng.normal(0, 0.5, (boundary, 2)))
    return jinit_state(CAP, *(jnp.asarray(x) for x in
                              (means, scaling, transforms, u)),
                       *(jnp.asarray(x) for x in b) if boundary else
                       (None,) * 4)


class NSSetup:
    """A small NS model on both sides (vorticity criteria, the recipe's
    clip), its state, samples, targets and an Adam state one step in."""

    def __init__(self):
        self.jcfg = jmodel.ModelConfig.create(
            JProblem.NAVIER_STOKES, JRule.TRAPEZOID, nx=NX, ny=NX,
            capacity=CAP, dtype=jnp.float64, split_criteria="vorticity")
        self.tcfg = tmodel.ModelConfig.create(
            Problem.NAVIER_STOKES, IntegrationRule.TRAPEZOID, nx=NX, ny=NX,
            capacity=CAP, dtype=torch.float64, split_criteria="vorticity")
        self.network, params, self.opt, _ = jpn.init_training(
            self.jcfg, jpn.TrainConfig(n_epochs=1, seed=7, clip_norm=CLIP))
        # float64 parameters make optax's constants float64 (ROADMAP §3).
        self.params = jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float64), params)
        opt_state = self.opt.init(self.params)
        rng = np.random.default_rng(21)
        inner = opt_state.inner_state
        adam = adam_of(inner)
        new_adam = adam._replace(
            mu=jax.tree_util.tree_map(
                lambda p: jnp.asarray(rng.normal(size=p.shape) * 1e-3),
                self.params),
            nu=jax.tree_util.tree_map(
                lambda p: jnp.asarray(rng.uniform(1e-8, 1e-6, p.shape)),
                self.params),
            count=jnp.asarray(5, jnp.int32))
        self.opt_state = opt_state._replace(inner_state=jax.tree_util.tree_map(
            lambda s: new_adam if isinstance(s, optax.ScaleByAdamState) else s,
            inner, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState)))
        self.adam = new_adam
        self.state = ns_state(rng, 0)
        self.bstate = ns_state(rng, NB)
        self.samples = rng.uniform(-1, 1, (M, 2))
        self.time_samples = rng.uniform(0, 1, M)
        self.bc = rng.uniform(-1.5, 1.5, (M, 2))
        self.targets = rng.normal(0, 1.0, (3, M))
        self.initial = rng.normal(0, 0.3, (M, 2))

    def torch_side(self, state):
        freqs = np.array(jax.random.normal(jax.random.PRNGKey(42), (6,)) * 10.)
        net = tmodel.make_network(self.tcfg,
                                  frequencies=torch.from_numpy(freqs))
        net.load_state_dict(convert.params_from_flax(flatten(self.params)))
        names = [k for k, _ in net.named_parameters()]
        opt = convert.adam_from_flax(names, flatten(self.adam.mu),
                                     flatten(self.adam.nu), self.adam.count)
        return net, names, opt, MixtureState(
            *(torch.from_numpy(np.array(x)) for x in state))

    def inputs(self):
        return tuple(jnp.asarray(x) for x in
                     (self.samples, self.time_samples, self.bc))

    def tinputs(self):
        return tuple(torch.from_numpy(x) for x in
                     (self.samples, self.time_samples, self.bc))


@pytest.fixture(scope="module")
def ns():
    return NSSetup()


def compare_opt(net, names, opt, jparams, jopt):
    want = convert.params_from_flax(flatten(jparams))
    for k, p in net.named_parameters():
        close(p, want[k])
    adam = adam_of(jopt)
    mu = convert.params_from_flax(flatten(adam.mu))
    nu = convert.params_from_flax(flatten(adam.nu))
    for k, m, v in zip(names, opt.mu, opt.nu):
        close(m, mu[k])
        close(v, nu[k])
    assert int(opt.count) == int(adam.count)


def run_steps(s, recon, **kw):
    """One pn_step on both sides: the JAX outputs and the torch ones."""
    smp, ts, bc = s.inputs()
    tsmp, tts, tbc = s.tinputs()
    jprev = jmodel.sample_fields(s.jcfg, s.state, smp, bc)
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    jout = jpn.pn_step(s.jcfg, s.network, s.opt, s.params, s.opt_state,
                       s.state, jprev, smp, ts, bc, jnp.asarray(0.7),
                       jnp.asarray(BASE_LR), EPS, jnp.asarray(0.0), DT,
                       recon_target=None if recon is None else
                       jnp.asarray(recon),
                       loss_weight_floor=jnp.asarray(FLOOR),
                       skip_nonfinite=True, **jkw)
    net, names, opt, state = s.torch_side(s.state)
    with torch.no_grad():
        prev = tmodel.sample_fields(s.tcfg, state, tsmp, tbc)
    tkw = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in kw.items()}
    tout = tpn.pn_step(
        s.tcfg, net, opt, state, prev, tsmp, tts, tbc,
        torch.tensor(0.7, dtype=torch.float64), BASE_LR, EPS, 0.0, DT,
        loss_weight_floor=FLOOR, clip_norm=CLIP, skip_nonfinite=True,
        recon_target=None if recon is None else torch.from_numpy(recon),
        **tkw)
    return jout, tout, net, names


def compare_step(s, jout, tout, net, names):
    jparams, jopt, jstate, _, jlosses, jtotal, jlw = jout
    opt, tstate, _, losses, total, lw = tout
    compare_opt(net, names, opt, jparams, jopt)
    close(lw, jlw)
    close(total, jtotal)
    for got, want in zip(losses, jlosses):
        close(got, want)
    for got, want in zip(tstate, jstate):
        close(got, want) if got.is_floating_point() else \
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ns_pn_step_with_reconstruction_matches_jax_f64(ns):
    jout, tout, net, names = run_steps(ns, ns.targets[0])
    compare_step(ns, jout, tout, net, names)
    losses, total = tout[3], tout[4]
    # The term is in the total (and so in the loss weight), not the losses.
    recon = float(total - losses.total)
    assert recon > 0.1 and float(losses.initial) == 0.0
    assert int(tout[0].count) == int(ns.adam.count) + 1


def test_nonfinite_reconstruction_counts_zero(ns):
    target = ns.targets[0].copy()
    target[3] = np.nan
    jout, tout, net, names = run_steps(ns, target)
    compare_step(ns, jout, tout, net, names)
    opt, _, _, losses, total, _ = tout
    assert float(total) == float(losses.total) and np.isfinite(float(total))
    # Its gradient is NaN (as under jax.grad), so the update is skipped.
    assert int(opt.count) == int(ns.adam.count)


@pytest.mark.parametrize("gate", [1.0, 0.0])
def test_initial_fields_gate_matches_jax_f64(ns, gate):
    jout, tout, net, names = run_steps(ns, None, initial_fields=ns.initial,
                                       initial_gate=gate)
    compare_step(ns, jout, tout, net, names)
    initial = float(tout[3].initial)
    assert (initial > 0.0) if gate else (initial == 0.0)


def test_ns_split_epoch_with_noise_matches_pn_epoch_scan(ns):
    """Three split-regime steps with per-step targets and the noise, the
    noise injected as JAX's ``run_step`` draws it (fold_in of the key)."""
    s = ns
    smp, ts, bc = s.inputs()
    tsmp, tts, tbc = s.tinputs()
    key, std = jax.random.PRNGKey(5), 0.05
    jprev = jmodel.sample_fields(s.jcfg, s.bstate, smp, bc)
    jparams, jopt, jstate, _, jper = jpn.pn_epoch_scan(
        s.jcfg, s.network, s.opt, s.params, s.opt_state, s.bstate, jprev,
        smp, ts, bc, jnp.asarray(BASE_LR), EPS, DT, 3,
        recon_targets=jnp.asarray(s.targets),
        loss_weight_floor=jnp.asarray(FLOOR), noise_std=jnp.asarray(std),
        noise_key=key, do_split=jnp.asarray(True), skip_nonfinite=True)
    draws = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), (CAP, 2), jnp.float64)) for i in range(3)])

    net, names, opt, state = s.torch_side(s.bstate)
    with torch.no_grad():
        prev = tmodel.sample_fields(s.tcfg, state, tsmp, tbc)
    with mock.patch.object(tpn, "_noise_draws",
                           return_value=torch.from_numpy(draws)) as patched:
        res = tpn.pn_epoch(s.tcfg, net, opt, state, prev, tsmp, tts, tbc,
                           BASE_LR, EPS, DT, 3, loss_weight_floor=FLOOR,
                           do_split=True, clip_norm=CLIP, skip_nonfinite=True,
                           recon_targets=torch.from_numpy(s.targets),
                           noise_std=std, generator=torch.Generator())
    assert patched.call_args.args[1:3] == (3, (CAP, 2))
    close(res.per_step, jper)
    compare_opt(net, names, res.opt_state, jparams, jopt)
    for got, want in zip(res.state, jstate):
        close(got, want) if got.is_floating_point() else \
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(res.active[-1].numpy(),
                                  np.asarray(jstate.active))
    boundary = state.boundary
    assert int(boundary.sum()) == NB
    assert torch.equal(res.state.u[boundary], state.u[boundary])
    assert int(res.state.active.sum()) > int(state.active.sum())  # it split
    # Column 5 is the total with the reconstruction term, 0-4 the terms.
    assert bool((res.per_step[:, 5] > res.per_step[:, :4].sum(1) + 0.1).all())


def test_noise_needs_a_generator(ns):
    net, _, opt, state = ns.torch_side(ns.state)
    tsmp, tts, tbc = ns.tinputs()
    with pytest.raises(ValueError, match="generator"):
        tpn.pn_epoch(ns.tcfg, net, opt, state, None, tsmp, tts, tbc, BASE_LR,
                     EPS, DT, 1, noise_std=0.1)


def test_importance_weights_match_jax(ns):
    cand = np.random.default_rng(4).uniform(-1, 1, (200, 2))
    for jstate, problem in ((ns.state, "ns"), (ns.bstate, "ns+boundary")):
        _, conics = jmodel.covariance_of(jstate)
        out = jeval(jstate.means, conics, jstate.u, jnp.asarray(cand),
                    order=1, mask=jstate.interior, period=ns.jcfg.period,
                    diff_samples=False)
        want = jnp.sqrt(jnp.sum(out.ux ** 2, axis=(1, 2))) + 1e-6
        state = MixtureState(*(torch.from_numpy(np.array(x)) for x in jstate))
        got = tpn.importance_weights(ns.tcfg, state, torch.from_numpy(cand))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                                   err_msg=problem)


def test_importance_samples_structure(ns):
    state = MixtureState(*(torch.from_numpy(np.array(x)) for x in ns.state))
    gen = torch.Generator().manual_seed(9)
    twin = torch.Generator().set_state(gen.get_state())
    n, frac = 100, 0.3
    got = tpn.importance_samples(ns.tcfg, gen, n, state, frac)
    assert got.shape == (n, 2) and got.dtype == torch.float64
    # The candidates are the generator's first draw.
    cand = tpn.collocation_samples(twin, 4 * n, 2, 1.0, torch.float64)
    picked, rest = got[:30], got[30:]
    hits = (picked[:, None, :] == cand[None]).all(-1)
    assert bool(hits.any(1).all())
    assert bool((rest.abs() <= 1.0).all())
    assert not bool((rest[:, None, :] == cand[None]).all(-1).any())
    # The picks favour the steep candidates.
    w = tpn.importance_weights(ns.tcfg, state, cand)
    assert float(w[hits.any(0)].mean()) > float(w.mean())
    assert tpn.importance_samples(ns.tcfg, gen, n, state, 1.0).shape == (n, 2)
    for bad in (-0.1, 1.5):
        with pytest.raises(ValueError, match=r"\[0, 1\]"):
            tpn.importance_samples(ns.tcfg, gen, n, state, bad)


def synthetic_dataset(rng, k=3, n0=9, res=8, frames=6):
    """A small NSDataset: ``k`` trajectories of ``n0`` Gaussians and
    ``frames`` vorticity frames at ``res`` x ``res``."""
    g = np.linspace(-0.6, 0.6, 3)
    gx, gy = np.meshgrid(g, g, indexing="ij")
    base = np.stack([gx, gy], -1).reshape(-1, 2)
    means = base[None] + rng.normal(0, 0.05, (k, n0, 2))
    return tpn.NSDataset(*(torch.from_numpy(x) for x in (
        means, rng.normal(0, 0.5, (k, n0, 2)),
        np.exp(rng.normal(-1.5, 0.1, (k, n0, 2))),
        rng.normal(0, 0.2, (k, n0, 1)),
        rng.normal(0, 1.0, (k, res, res, frames)).astype(np.float32))))


def small_ns_config():
    return tmodel.ModelConfig.create(
        Problem.NAVIER_STOKES, IntegrationRule.TRAPEZOID, nx=3, ny=3,
        capacity=24, split_criteria="vorticity")


def test_train_epoch_ns_branch():
    cfg = small_ns_config()
    data = synthetic_dataset(np.random.default_rng(2))
    net, opt = tpn.init_training(cfg, tpn.TrainConfig(seed=3))
    tcfg = tpn.TrainConfig(n_samples=32, train_timesteps=3, dt=0.1)
    seen = []
    real = tpn.pn_epoch

    def spy(*args, **kw):
        seen.append((args, kw))
        return real(*args, **kw)

    indices = set()
    with mock.patch.object(tpn, "pn_epoch", side_effect=spy):
        for seed in range(6):
            gen = torch.Generator().manual_seed(seed)
            out = tpn.train_epoch(cfg, tcfg, net, opt, gen, 120, 20,
                                  ns_data=data)
            args, kw = seen[-1]
            state, samples, n_steps = args[3], args[5], args[11]
            assert n_steps == out[3] == 3
            match = [k for k in range(3) if all(
                torch.equal(a, b) for a, b in zip(data.state_for(cfg, k),
                                                  state))]
            assert len(match) == 1
            indices.add(match[0])
            targets = kw["recon_targets"]
            assert targets.shape == (3, 32)
            for i in range(3):
                assert torch.equal(targets[i], data.recon_target(
                    match[0], i + 1, samples).float())
            assert np.all(np.isfinite(out[1]))
    assert len(indices) > 1     # the index is drawn


def test_train_ns_resumes_and_round_trips(tmp_path):
    cfg = small_ns_config()
    data = synthetic_dataset(np.random.default_rng(6))
    tcfg = tpn.TrainConfig(n_epochs=2, n_samples=32, log_step=1, save_step=1,
                           ema_decay=0.9, clip_norm=1.0, dt=0.1,
                           skip_nonfinite_updates=True, train_timesteps=2,
                           split_epoch=0)
    log = []
    first = tpn.train(cfg, tcfg, checkpoint_dir=str(tmp_path),
                      log_fn=log.append, ns_data=data)
    assert len(first.training_loss) == 2 and all(
        np.isfinite(first.training_loss))
    more = tpn.train(cfg, tcfg._replace(n_epochs=3), checkpoint_dir=str(
        tmp_path), resume=True, log_fn=log.append, ns_data=data)
    assert any("Resumed" in line and "epoch 2" in line for line in log)
    assert more.training_loss[:2] == [float(x) for x in first.training_loss]
    names = [k for k, _ in more.network.named_parameters()]
    back = tckpt.restore_checkpoint(str(tmp_path))
    assert back.epoch == 3
    for k, p in more.network.named_parameters():
        assert torch.equal(back.params[k], p.detach())
    for k, e in zip(names, more.ema):
        assert torch.equal(back.ema[k], e)
    for a, b in zip(back.opt.mu + back.opt.nu, more.opt_state.mu
                    + more.opt_state.nu):
        assert torch.equal(a, b)


def test_ns_fixture_step_matches_stored_jax_f64():
    cfg, net, opt, ema, data = convert.load_train_fixture(
        str(NS_TRAIN_FIXTURE), dtype=torch.float64)
    assert (cfg.capacity, cfg.period, cfg.split_criteria, cfg.channels) == (
        640, 2.0, "vorticity", 2)
    assert int(data["train_epoch"]) == 20000 and int(data["train_n_steps"]) \
        == 20
    assert len(opt.mu) == len(ema) == len(list(net.parameters()))
    assert not all(torch.equal(e, p) for e, p in zip(ema, net.parameters()))

    def t(k):
        x = torch.from_numpy(data[k])
        return x.double() if x.is_floating_point() else x
    state = MixtureState(*(t("input_" + f) for f in MixtureState._fields))
    smp, ts, bc = t("input_samples"), t("input_time_samples"), t(
        "input_bc_samples")
    targets = t("input_recon_targets")
    assert smp.shape == bc.shape == (2048, 2) and targets.shape == (30, 2048)
    index = int(data["input_data_index"])
    assert 0 <= index < 7 and int(state.active.sum()) == 400
    ns_data = tpn.NSDataset.load(str(ROOT / "artifacts" / "ns_data_8traj.npz"))
    assert torch.equal(targets[4], ns_data.recon_target(
        index, 5, smp.float()).double())
    with torch.no_grad():
        prev = tmodel.sample_fields(cfg, state, smp, bc)
    names = [k for k, _ in net.named_parameters()]

    def jax_flat(prefix):
        tree = convert.params_from_flax(
            {"params" + k[len(prefix):]: v for k, v in data.items()
             if k.startswith(prefix + "/")})
        return torch.cat([tree[k].flatten() for k in names])

    _, _, losses, total, grads = tpn.pn_loss_grads(
        cfg, net, state, prev, smp, ts, bc, 0.0, float(data["train_dt"]),
        recon_target=targets[0])
    close(torch.stack([*losses, total]), data["step_losses"], rtol=1e-9)
    close(total - losses.total, data["step_recon"], rtol=1e-9)
    want = jax_flat("step_grads")
    got = torch.cat([g.flatten() for g in grads])
    assert float((got - want).norm() / want.norm()) <= 1e-9
    before = torch.cat([p.detach().flatten() for p in net.parameters()])
    tpn.pn_step(cfg, net, opt, state, prev, smp, ts, bc,
                torch.ones((), dtype=torch.float64),
                float(data["train_base_lr"]), float(data["train_epsilon"]),
                0.0, float(data["train_dt"]),
                loss_weight_floor=float(data["train_loss_weight_floor"]),
                clip_norm=float(data["train_clip_norm"]), skip_nonfinite=True,
                recon_target=targets[0])
    after = torch.cat([p.detach().flatten() for p in net.parameters()])
    step = jax_flat("step_params") - before
    assert float(((after - before) - step).norm() / step.norm()) <= 1e-9
