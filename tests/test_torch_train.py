"""Parity of the port's training with the JAX package (float64, CPU).

* ``pn_step`` against JAX's ``pn_step`` at capacity 192 with 64 samples:
  parameters, Adam mu/nu/count and the loss weight within rtol 1e-8 of each
  tensor's scale, plain, with clip-by-global-norm, and with a non-finite
  step that is skipped.  float64 through the network, the mixture and
  Adam; the differences are summation order only.
* A 3-step split-regime epoch (``pn_epoch``) against ``pn_epoch_scan``:
  per-step losses and final parameters rtol 1e-8, active masks equal.
* The optimizer alone against optax on random trees (rtol 1e-12).
* Checkpoints and the optax Adam-state conversion round-trip exactly.
* The exported flagship training fixture: one full-width ``pn_step`` of the
  port reproduces the stored JAX float64 step (losses rtol 1e-9, gradient
  and updated parameters norm-relative 1e-9).

The JAX network is initialised at random and converted; its frequencies are
drawn as the JAX package draws them in this (x64) process.  Inputs come
from numpy seeds.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pigs_tpu.models import model as jmodel
from pigs_tpu.pde import IntegrationRule as JRule
from pigs_tpu.pde import Problem as JProblem
from pigs_tpu.train import pn as jpn
from pigs_tpu_torch import convert
from pigs_tpu_torch.models import model as tmodel
from pigs_tpu_torch.models.state import MixtureState
from pigs_tpu_torch.pde import IntegrationRule, Problem
from pigs_tpu_torch.train import checkpoint as tckpt
from pigs_tpu_torch.train import optim as toptim
from pigs_tpu_torch.train import pn as tpn

ROOT = pathlib.Path(__file__).resolve().parents[1]
TRAIN_FIXTURE = ROOT / "artifacts" / "burgers_ns4096_ema2_train_torch.npz"
RTOL = 1e-8
CAP, NX, M = 192, 6, 64
BASE_LR, EPS, DT, FLOOR = 3e-3, 1.0, 0.1, 0.05


def flatten(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def close(got, want, rtol=RTOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


class Setup:
    """A small BURGERS model on both sides, its randomized IC, samples and
    an Adam state one step in (non-zero moments)."""

    def __init__(self, clip_norm=None):
        self.jcfg = jmodel.ModelConfig.create(
            JProblem.BURGERS, JRule.TRAPEZOID, nx=NX, ny=NX, capacity=CAP,
            dtype=jnp.float64)
        self.tcfg = tmodel.ModelConfig.create(
            Problem.BURGERS, IntegrationRule.TRAPEZOID, nx=NX, ny=NX,
            capacity=CAP, dtype=torch.float64)
        self.network, params, self.opt, _ = jpn.init_training(
            self.jcfg, jpn.TrainConfig(n_epochs=1, seed=7,
                                       clip_norm=clip_norm))
        # flax keeps parameters in float32 whatever the inputs, and
        # inject_hyperparams stores b1, b2 and eps in the dtype of the
        # parameters it is initialised with: float64 parameters make the
        # JAX side's gradients, constants and update float64.
        self.params = jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float64), params)
        opt_state = self.opt.init(self.params)
        rng = np.random.default_rng(11)
        # Non-zero moments and count, as in a run that has trained a while.
        inner = opt_state.inner_state
        adam = [s for s in jax.tree_util.tree_leaves(
            inner, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)][0]
        mu = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.normal(size=p.shape) * 1e-3), self.params)
        nu = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.uniform(1e-8, 1e-6, p.shape)),
            self.params)
        new_adam = adam._replace(mu=mu, nu=nu, count=jnp.asarray(5, jnp.int32))
        self.opt_state = opt_state._replace(inner_state=jax.tree_util.tree_map(
            lambda s: new_adam if isinstance(s, optax.ScaleByAdamState) else s,
            inner, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState)))
        self.adam = new_adam

        self.state = jmodel.randomize_state_dynamic(
            self.jcfg, jax.random.PRNGKey(3), 8, n_max=9)
        self.samples = rng.uniform(-1, 1, (M, 2))
        self.time_samples = rng.uniform(0, 1, M)
        self.bc = np.concatenate([
            np.stack([rng.choice([-1, 1], M // 2) * rng.uniform(1, 1.5, M // 2),
                      rng.uniform(-1.5, 1.5, M // 2)], -1),
            np.stack([rng.uniform(-1.5, 1.5, M // 2),
                      rng.choice([-1, 1], M // 2) * rng.uniform(1, 1.5,
                                                                M // 2)], -1)])

    def torch_side(self):
        freqs = np.array(jax.random.normal(jax.random.PRNGKey(42), (6,)) * 10.)
        net = tmodel.make_network(self.tcfg,
                                  frequencies=torch.from_numpy(freqs))
        net.load_state_dict(convert.params_from_flax(flatten(self.params)))
        names = [k for k, _ in net.named_parameters()]
        opt = convert.adam_from_flax(names, flatten(self.adam.mu),
                                     flatten(self.adam.nu), self.adam.count)
        state = MixtureState(*(torch.from_numpy(np.array(x))
                               for x in self.state))
        return net, names, opt, state

    def inputs(self):
        return (jnp.asarray(self.samples), jnp.asarray(self.time_samples),
                jnp.asarray(self.bc))

    def tinputs(self):
        return tuple(torch.from_numpy(x) for x in
                     (self.samples, self.time_samples, self.bc))


@pytest.fixture(scope="module")
def setups():
    return {None: Setup(), 1e-3: Setup(clip_norm=1e-3)}


def adam_of(opt_state):
    return [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]


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


@pytest.mark.parametrize("clip,poison", [(None, False), (1e-3, False),
                                         (1e-3, True)])
def test_pn_step_matches_jax_f64(setups, clip, poison):
    s = setups[clip]
    smp, ts, bc = s.inputs()
    tsmp, tts, tbc = s.tinputs()
    if poison:
        # A non-finite collocation time: the PDE term is filtered to 0 but
        # its gradient is NaN, so the update must be skipped entirely.
        ts = ts.at[0].set(jnp.nan)
        tts = tts.clone()
        tts[0] = float("nan")
    jprev = jmodel.sample_fields(s.jcfg, s.state, smp, bc)
    jout = jpn.pn_step(s.jcfg, s.network, s.opt, s.params, s.opt_state,
                       s.state, jprev, smp, ts, bc, jnp.asarray(0.7),
                       jnp.asarray(BASE_LR), EPS, jnp.asarray(0.0), DT,
                       loss_weight_floor=jnp.asarray(FLOOR),
                       skip_nonfinite=poison)
    jparams, jopt, jstate, _, jlosses, jtotal, jlw = jout

    net, names, opt, state = s.torch_side()
    with torch.no_grad():
        prev = tmodel.sample_fields(s.tcfg, state, tsmp, tbc)
    opt, tstate, _, losses, total, lw = tpn.pn_step(
        s.tcfg, net, opt, state, prev, tsmp, tts, tbc,
        torch.tensor(0.7, dtype=torch.float64), BASE_LR, EPS, 0.0, DT,
        loss_weight_floor=FLOOR, clip_norm=clip, skip_nonfinite=poison)
    compare_opt(net, names, opt, jparams, jopt)
    close(lw, jlw)
    close(total, jtotal)
    for got, want in zip(losses, jlosses):
        close(got, want)
    for got, want in zip(tstate, jstate):
        close(got, want) if got.is_floating_point() else \
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if poison:
        assert int(opt.count) == int(s.adam.count)
        for k, p in net.named_parameters():
            close(p, convert.params_from_flax(flatten(s.params))[k], rtol=0)


def test_split_regime_epoch_matches_pn_epoch_scan(setups):
    s = setups[None]
    smp, ts, bc = s.inputs()
    tsmp, tts, tbc = s.tinputs()
    jprev = jmodel.sample_fields(s.jcfg, s.state, smp, bc)
    jparams, jopt, jstate, _, jper = jpn.pn_epoch_scan(
        s.jcfg, s.network, s.opt, s.params, s.opt_state, s.state, jprev,
        smp, ts, bc, jnp.asarray(BASE_LR), EPS, DT, 3,
        loss_weight_floor=jnp.asarray(FLOOR), do_split=jnp.asarray(True))

    net, names, opt, state = s.torch_side()
    with torch.no_grad():
        prev = tmodel.sample_fields(s.tcfg, state, tsmp, tbc)
    res = tpn.pn_epoch(s.tcfg, net, opt, state, prev, tsmp, tts, tbc, BASE_LR,
                       EPS, DT, 3, loss_weight_floor=FLOOR, do_split=True)
    close(res.per_step, jper)
    compare_opt(net, names, res.opt_state, jparams, jopt)
    np.testing.assert_array_equal(res.state.active.numpy(),
                                  np.asarray(jstate.active))
    np.testing.assert_array_equal(res.active[-1].numpy(),
                                  np.asarray(jstate.active))
    # The split regime really split: more active slots than the IC had.
    assert int(res.state.active.sum()) != int(np.asarray(s.state.active).sum())


def optax_tree(rng, shapes):
    return {f"p{i}": jnp.asarray(rng.normal(size=sh))
            for i, sh in enumerate(shapes)}


@pytest.mark.parametrize("clip", [None, 0.5, 100.0])
def test_adam_update_matches_optax(clip):
    rng = np.random.default_rng(3)
    shapes = [(3, 4), (5,), (2, 2, 2)]
    params = optax_tree(rng, shapes)
    if clip is None:
        opt = optax.inject_hyperparams(optax.adam)(learning_rate=1e-2)
    else:
        opt = optax.inject_hyperparams(
            lambda learning_rate: optax.chain(optax.clip_by_global_norm(clip),
                                              optax.adam(learning_rate)))(
            learning_rate=1e-2)
    jstate = opt.init(params)
    tparams = [torch.from_numpy(np.asarray(params[k])).clone()
               for k in sorted(params)]
    tstate = toptim.adam_init(tparams)
    for step in range(4):
        grads = optax_tree(rng, shapes)
        lr = 1e-2 * (0.5 + step)
        jstate.hyperparams["learning_rate"] = jnp.asarray(lr)
        updates, jstate = opt.update(grads, jstate)
        params = optax.apply_updates(params, updates)
        tstate = toptim.adam_update(
            tparams, [torch.from_numpy(np.asarray(grads[k]))
                      for k in sorted(grads)], tstate,
            torch.tensor(lr, dtype=torch.float64), clip_norm=clip)
    adam = adam_of(jstate)
    for i, k in enumerate(sorted(params)):
        close(tparams[i], params[k], rtol=1e-12)
        close(tstate.mu[i], adam.mu[k], rtol=1e-12)
        close(tstate.nu[i], adam.nu[k], rtol=1e-12)
    assert int(tstate.count) == int(adam.count) == 4


def test_skip_nonfinite_keeps_everything():
    p = [torch.ones(3, dtype=torch.float64), torch.zeros(2, dtype=torch.float64)]
    state = toptim.adam_init(p)
    state = toptim.adam_update(p, [torch.full((3,), 0.1, dtype=torch.float64),
                                   torch.ones(2, dtype=torch.float64)], state,
                               torch.tensor(0.1, dtype=torch.float64))
    before = [x.clone() for x in p], state
    for bad in (float("nan"), float("inf")):
        new = toptim.adam_update(
            p, [torch.tensor([1.0, bad, 0.0], dtype=torch.float64),
                torch.ones(2, dtype=torch.float64)], state,
            torch.tensor(0.1, dtype=torch.float64), clip_norm=1.0,
            skip_nonfinite=True)
        assert int(new.count) == int(state.count) == 1
        for a, b in zip(p + new.mu + new.nu,
                        before[0] + before[1].mu + before[1].nu):
            assert torch.equal(a, b)


def test_global_norm_clip_is_optax_not_clip_grad_norm():
    g = [torch.tensor([3.0, 4.0], dtype=torch.float64)]
    assert float(toptim.global_norm(g)) == 5.0
    p = [torch.zeros(2, dtype=torch.float64)]
    toptim.adam_update(p, g, toptim.adam_init(p),
                       torch.tensor(1.0, dtype=torch.float64), clip_norm=5.0)
    # ||g|| == clip is clipped by optax's rule (g / ||g|| * clip == g) and
    # the first Adam step moves each coordinate by -lr * sign(g).
    np.testing.assert_allclose(p[0].numpy(), [-1.0, -1.0], rtol=1e-7)


def test_checkpoint_round_trip(tmp_path):
    net = tmodel.make_network(tmodel.ModelConfig.create(
        Problem.BURGERS, nx=4, ny=4, capacity=140),
        generator=torch.Generator().manual_seed(0))
    names = [k for k, _ in net.named_parameters()]
    opt = toptim.adam_init(net.parameters())
    opt = toptim.adam_update(list(net.parameters()),
                             [torch.randn_like(p) for p in net.parameters()],
                             opt, torch.tensor(1e-3))
    ema = {k: p.detach() * 0.5 for k, p in net.named_parameters()}
    for epoch in (100, 200, 300, 400):
        tckpt.save_checkpoint(str(tmp_path), epoch,
                              dict(net.named_parameters()), opt, [1.5, 0.25],
                              ema=ema)
    assert tckpt.latest_epoch(str(tmp_path)) == 400
    assert len(list(tmp_path.iterdir())) == tckpt.KEEP
    back = tckpt.restore_checkpoint(str(tmp_path))
    assert back.epoch == 400 and back.training_loss == [1.5, 0.25]
    for k, p in net.named_parameters():
        assert torch.equal(back.params[k], p.detach())
        assert torch.equal(back.ema[k], ema[k])
    for a, b in zip(back.opt.mu + back.opt.nu, opt.mu + opt.nu):
        assert torch.equal(a, b)
    assert back.opt.count.dtype == torch.int32 and int(back.opt.count) == 1
    assert tckpt.restore_checkpoint(str(tmp_path / "none")) is None


def test_adam_state_conversion_round_trip(setups):
    s = setups[1e-3]
    net, names, opt, _ = s.torch_side()
    mu, nu, count = convert.adam_to_flax(names, opt)
    assert count == 5
    for flat, tree in ((mu, s.adam.mu), (nu, s.adam.nu)):
        want = flatten(tree)
        assert flat.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(flat[k], want[k])


def test_train_resumes_and_logs(tmp_path):
    cfg = tmodel.ModelConfig.create(Problem.TEST, nx=10, ny=10, capacity=160)
    tcfg = tpn.TrainConfig(n_epochs=2, n_samples=32, log_step=1, save_step=1,
                           ema_decay=0.9, clip_norm=1.0,
                           skip_nonfinite_updates=True, train_timesteps=2)
    log = []
    first = tpn.train(cfg, tcfg, checkpoint_dir=str(tmp_path),
                      log_fn=log.append)
    assert len(first.training_loss) == 2 and all(
        np.isfinite(first.training_loss))
    assert tckpt.latest_epoch(str(tmp_path)) == 2
    assert int(first.opt_state.count) == 2  # one step per epoch below 50
    more = tpn.train(cfg, tcfg._replace(n_epochs=3), checkpoint_dir=str(
        tmp_path), resume=True, log_fn=log.append)
    assert any("Resumed" in line and "epoch 2" in line for line in log)
    assert len(more.training_loss) == 3
    assert more.training_loss[:2] == [float(x) for x in first.training_loss]
    # The EMA moved toward the parameters from its restored value.
    for e, p in zip(more.ema, more.network.parameters()):
        assert torch.isfinite(e).all() and e.shape == p.shape


@pytest.mark.parametrize("option", ["noise_std", "adaptive_sampling",
                                    "ns_data"])
def test_training_options_run(option):
    """Each training option beyond the defaults trains: two epochs with
    finite losses (their parity is in tests/test_torch_ns_train.py)."""
    tcfg = tpn.TrainConfig(n_epochs=2, n_samples=32, log_step=1,
                           train_timesteps=2, dt=0.1)
    ns_data = None
    if option == "ns_data":
        cfg = tmodel.ModelConfig.create(Problem.NAVIER_STOKES, nx=3, ny=3,
                                        capacity=16,
                                        split_criteria="vorticity")
        rng = np.random.default_rng(0)
        ns_data = tpn.NSDataset(*(torch.from_numpy(x) for x in (
            rng.uniform(-0.8, 0.8, (2, 9, 2)), rng.normal(0, 0.5, (2, 9, 2)),
            np.exp(rng.normal(-1.5, 0.1, (2, 9, 2))),
            rng.normal(0, 0.2, (2, 9, 1)), rng.normal(0, 1, (2, 8, 8, 4)))))
    else:
        cfg = tmodel.ModelConfig.create(Problem.BURGERS, nx=4, ny=4,
                                        capacity=140)
        tcfg = tcfg._replace(**{option: 0.5})
    result = tpn.train(cfg, tcfg, log_fn=lambda _: None, ns_data=ns_data)
    assert len(result.training_loss) == 2 and all(
        np.isfinite(result.training_loss))
    assert int(result.opt_state.count) == 2


def test_flagship_fixture_step_matches_stored_jax_f64():
    cfg, net, opt, ema, data = convert.load_train_fixture(
        str(TRAIN_FIXTURE), dtype=torch.float64)
    assert (cfg.capacity, int(data["train_epoch"]), int(opt.count)) == (
        1664, 30000, 1438739)
    assert len(opt.mu) == len(ema) == len(list(net.parameters())) == 92
    assert not all(torch.equal(e, p) for e, p in zip(ema, net.parameters()))

    def t(k):
        x = torch.from_numpy(data[k])
        return x.double() if x.is_floating_point() else x
    state = MixtureState(*(t("input_" + f) for f in MixtureState._fields))
    n = int(data["input_grid_n"])
    assert int(state.interior.sum()) == n * n and 15 <= n < 40
    smp, ts, bc = t("input_samples"), t("input_time_samples"), t(
        "input_bc_samples")
    assert smp.shape == bc.shape == (4096, 2) and ts.shape == (4096,)
    with torch.no_grad():
        prev = tmodel.sample_fields(cfg, state, smp, bc)
    names = [k for k, _ in net.named_parameters()]

    def jax_flat(prefix):
        tree = convert.params_from_flax(
            {"params" + k[len(prefix):]: v for k, v in data.items()
             if k.startswith(prefix + "/")})
        return torch.cat([tree[k].flatten() for k in names])

    _, _, losses, total, grads = tpn.pn_loss_grads(
        cfg, net, state, prev, smp, ts, bc, 0.0, float(data["train_dt"]))
    close(torch.stack([*losses, total]), data["step_losses"], rtol=1e-9)
    want = jax_flat("step_grads")
    got = torch.cat([g.flatten() for g in grads])
    assert float((got - want).norm() / want.norm()) <= 1e-9
    before = torch.cat([p.detach().flatten() for p in net.parameters()])
    tpn.pn_step(cfg, net, opt, state, prev, smp, ts, bc,
                torch.ones((), dtype=torch.float64),
                float(data["train_base_lr"]), float(data["train_epsilon"]),
                0.0, float(data["train_dt"]),
                loss_weight_floor=float(data["train_loss_weight_floor"]),
                clip_norm=float(data["train_clip_norm"]), skip_nonfinite=True)
    after = torch.cat([p.detach().flatten() for p in net.parameters()])
    step = jax_flat("step_params") - before
    assert float(((after - before) - step).norm() / step.norm()) <= 1e-9
