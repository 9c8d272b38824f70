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
* The Adam step is functional on its state, the CPU and float64 take the
  plain path (no K6 launch), K6's flat moments read as per-parameter
  tensors through the conversion and a checkpoint, and K6's wrapper
  (``ops/optim_kernel.py``) against a stand-in library that computes as
  ``csrc/adam.cu`` does, from the addresses the wrapper hands it.
* The exported flagship training fixture: one full-width ``pn_step`` of the
  port reproduces the stored JAX float64 step (losses rtol 1e-9, gradient
  and updated parameters norm-relative 1e-9).

The JAX network is initialised at random and converted; its frequencies are
drawn as the JAX package draws them in this (x64) process.  Inputs come
from numpy seeds.
"""

import ctypes
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
from pigs_tpu_torch.ops import optim_kernel
from pigs_tpu_torch.pde import IntegrationRule, Problem
from pigs_tpu_torch.train import checkpoint as tckpt
from pigs_tpu_torch.train import optim as toptim
from pigs_tpu_torch.train import pn as tpn
from pigs_tpu_torch.utils import profiling

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


# ---------------------------------------------------- the Adam step, K6 ----


def adam_inputs(dtype=torch.float32, shapes=((3, 4), (5,), (2, 2, 2), (6,)),
                seed=0, count=3):
    """Parameters, gradients and a per-tensor Adam state of ``shapes``."""
    gen = torch.Generator().manual_seed(seed)

    def draw(scale):
        return [scale * torch.randn(sh, generator=gen, dtype=dtype)
                for sh in shapes]
    state = toptim.AdamState(draw(1e-3), [x * x for x in draw(1e-2)],
                             torch.tensor(count, dtype=torch.int32))
    return draw(1.0), draw(0.1), state


def flat_of(ts):
    return torch.cat([t.reshape(-1) for t in ts])


def as_flat_moments(ts):
    """The flat form of a per-tensor moment list, as K6 returns it."""
    ends = tuple(int(e) for e in np.cumsum([t.numel() for t in ts]))
    return optim_kernel.FlatMoments(flat_of(ts).clone(),
                                    tuple(t.shape for t in ts), ends)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("clip,skip", [(None, False), (0.5, True)])
def test_adam_update_leaves_the_old_state_unchanged(dtype, clip, skip):
    """The update is functional on the state (a caller may keep the old one to
    rewind): only the parameters are written."""
    params, grads, state = adam_inputs(dtype)
    before = ([m.clone() for m in state.mu], [v.clone() for v in state.nu],
              state.count.clone())
    new = toptim.adam_update(params, grads, state, torch.tensor(
        1e-2, dtype=dtype), clip_norm=clip, skip_nonfinite=skip)
    assert int(new.count) == 4
    for a, b in zip(state.mu + state.nu + [state.count],
                    before[0] + before[1] + [before[2]]):
        assert torch.equal(a, b)
    assert all(not torch.equal(a, b) for a, b in zip(new.mu, state.mu)
               if a.numel())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lr", [2e-2, "tensor"])
def test_cpu_and_float64_take_the_plain_twin(dtype, lr):
    """Off the card (and in float64) adam_update is adam_update_plain, bit
    for bit, and counts no K6 launch; a state of flat moments is read as
    the per-tensor one."""
    lr = torch.tensor(2e-2, dtype=dtype) if lr == "tensor" else lr
    params, grads, state = adam_inputs(dtype)
    launches, copies = optim_kernel.launches, optim_kernel.layout_copies
    p_a = [p.clone() for p in params]
    got = toptim.adam_update(p_a, grads, state, lr, clip_norm=0.5,
                             skip_nonfinite=True)
    p_b = [p.clone() for p in params]
    want = toptim.adam_update_plain(p_b, grads, state, lr, clip_norm=0.5,
                                    skip_nonfinite=True)
    p_c = [p.clone() for p in params]
    flat_state = state._replace(mu=as_flat_moments(state.mu),
                                nu=as_flat_moments(state.nu))
    from_flat = toptim.adam_update(p_c, grads, flat_state, lr, clip_norm=0.5,
                                   skip_nonfinite=True)
    assert optim_kernel.launches == launches
    assert optim_kernel.layout_copies == copies
    for new, p in ((got, p_a), (from_flat, p_c)):
        assert isinstance(new.mu, list) and isinstance(new.nu, list)
        for a, b in zip(p + new.mu + new.nu, p_b + want.mu + want.nu):
            assert a.dtype == dtype and torch.equal(a, b)
        assert int(new.count) == int(want.count)


def test_profiling_counts_k6_launches():
    assert ("k6", "optim_kernel", "launches") in profiling.LAUNCHES


def test_flat_moments_read_per_parameter(tmp_path):
    """K6's moments iterate per parameter in network order with the
    parameters' shapes, and go through the optax conversion and a
    checkpoint as the per-tensor lists do."""
    net = tmodel.make_network(tmodel.ModelConfig.create(
        Problem.BURGERS, nx=4, ny=4, capacity=140),
        generator=torch.Generator().manual_seed(0))
    names = [k for k, _ in net.named_parameters()]
    params = list(net.parameters())
    opt = toptim.adam_update(params, [torch.randn_like(p) for p in params],
                             toptim.adam_init(params), torch.tensor(1e-3))
    flat = opt._replace(mu=as_flat_moments(opt.mu),
                        nu=as_flat_moments(opt.nu))
    assert len(flat.mu) == len(params) == len(names)
    assert [m.shape for m in flat.mu] == [p.shape for p in params]
    for a, b in zip(list(flat.mu) + list(flat.nu), opt.mu + opt.nu):
        assert torch.equal(a, b)
    assert torch.equal(flat.mu[-1], opt.mu[-1])
    assert [m.shape for m in flat.mu[1:3]] == [p.shape for p in params[1:3]]
    with pytest.raises(IndexError):
        flat.mu[len(params)]
    # A view reads the flat buffer: no copy per parameter.
    assert flat.mu[2].data_ptr() == (flat.mu.flat.data_ptr()
                                     + 4 * flat.mu.ends[1])
    for a, b in zip(convert.adam_to_flax(names, flat)[:2],
                    convert.adam_to_flax(names, opt)[:2]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    back = convert.adam_from_flax(names, *convert.adam_to_flax(names, flat))
    tckpt.save_checkpoint(str(tmp_path), 7, dict(net.named_parameters()),
                          flat, [0.5])
    restored = tckpt.restore_checkpoint(str(tmp_path)).opt
    for state in (back, restored):
        assert [m.shape for m in state.mu] == [p.shape for p in params]
        for a, b in zip(state.mu + state.nu, opt.mu + opt.nu):
            assert torch.equal(a, b)
        assert int(state.count) == 1


class _StandInK6:
    """K6's library on the CPU: reads the addresses the wrapper hands over
    and computes as csrc/adam.cu does (float32, the norm's sum in float64),
    or returns ``rc`` without touching anything."""

    def __init__(self, rc=0):
        self.rc = rc
        self.calls = []

    @staticmethod
    def view(addr, n, ctype=ctypes.c_float):
        if n == 0:
            return np.zeros(0, np.float32)
        return np.ctypeslib.as_array((ctype * n).from_address(addr))

    def pigs_adam(self, n, table, mu_out, nu_out, count_in, count_out, lr,
                  lr_value, has_clip, clip, skip, b1, b2, omb1, omb2, eps,
                  stream):
        self.calls.append({"n": n, "table": list(table), "lr": lr})
        if self.rc:
            return self.rc
        f = np.float32
        rows = [list(table[5 * i:5 * i + 5]) for i in range(n)]
        total = sum(r[4] for r in rows)
        mo, no = self.view(mu_out, total), self.view(nu_out, total)
        g_all = np.concatenate([self.view(r[1], r[4]) for r in rows])
        norm = f(np.sqrt(np.sum(g_all.astype(np.float64) ** 2)))
        keep = not has_clip or norm < f(clip)
        apply = not (skip and not np.all(np.isfinite(g_all)))
        count = int(self.view(count_in, 1, ctypes.c_int)[0])
        self.view(count_out, 1, ctypes.c_int)[0] = count + int(apply)
        steps = f(count + 1)
        bias1, bias2 = f(1) - f(b1) ** steps, f(1) - f(b2) ** steps
        neg_lr = -(self.view(lr, 1)[0] if lr else f(lr_value))
        e = 0
        for r in rows:
            k = r[4]
            p, g, m0, v0 = (self.view(a, k) for a in r[:4])
            m, v = m0, v0
            if apply:
                gc = g if keep else (g / norm) * f(clip)
                m = gc * f(omb1) + m0 * f(b1)
                v = (gc * gc) * f(omb2) + v0 * f(b2)
                p[:] = p + ((m / bias1) / (np.sqrt(v / bias2) + f(eps))) \
                    * neg_lr
            mo[e:e + k], no[e:e + k] = m, v
            e += k
        return 0


@pytest.fixture
def stand_in(monkeypatch):
    lib = _StandInK6()
    monkeypatch.setattr(optim_kernel, "_library", lambda: (lib, None))
    monkeypatch.setattr(optim_kernel, "_stream", lambda dev: 0)
    return lib


def k6_step(params, grads, state, lr, clip, skip):
    return toptim.AdamState(*optim_kernel.adam_step(
        params, grads, state.mu, state.nu, state.count, lr, clip, skip, 0.9,
        0.999, 1e-8))


@pytest.mark.parametrize("clip,skip,lr,bad", [
    (None, False, 1e-2, None), (0.5, True, "tensor", None),
    (100.0, True, 3e-3, None), (0.5, True, "tensor", float("nan")),
    (0.5, True, 1e-2, float("inf"))])
def test_k6_wrapper_against_the_twin(stand_in, clip, skip, lr, bad):
    """Through the wrapper and the stand-in: the twin's step to float32
    round-off (the skip exactly), one launch counted, the old state kept,
    the moments' flat layout, and a second step from K6's own state that
    reads its flat buffers (no layout copy)."""
    lr = torch.tensor(1e-2) if lr == "tensor" else lr
    params, grads, state = adam_inputs()
    if bad is not None:
        grads[2].view(-1)[5] = bad
    p_t = [p.clone() for p in params]
    s_t = toptim.adam_update_plain(p_t, grads, state, lr, clip, skip)
    p_k = [p.clone() for p in params]
    old = flat_of(state.mu + state.nu).clone()
    launches = optim_kernel.launches
    s_k = k6_step(p_k, grads, state, lr, clip, skip)
    assert optim_kernel.launches == launches + 1
    assert torch.equal(flat_of(state.mu + state.nu), old)
    assert int(s_k.count) == int(s_t.count) == (3 if bad else 4)
    call = stand_in.calls[-1]
    assert call["n"] == 4
    assert call["table"][0::5] == [p.data_ptr() for p in p_k]
    assert call["table"][4::5] == [p.numel() for p in params]
    assert (call["lr"] is None) == (not isinstance(lr, torch.Tensor))
    assert isinstance(s_k.mu, optim_kernel.FlatMoments)
    assert s_k.nu.flat.data_ptr() == s_k.mu.flat.data_ptr() + 4 * 31
    assert [m.shape for m in s_k.mu] == [p.shape for p in params]
    if bad is not None:
        for a, b in zip(p_k + list(s_k.mu) + list(s_k.nu),
                        params + state.mu + state.nu):
            assert torch.equal(a, b)
        return
    for a, b in ((p_k, p_t), (s_k.mu, s_t.mu), (s_k.nu, s_t.nu)):
        np.testing.assert_allclose(flat_of(list(a)), flat_of(b), rtol=1e-6,
                                   atol=1e-9)
    copies = optim_kernel.layout_copies
    s_k2 = k6_step(p_k, grads, s_k, lr, clip, skip)
    s_t2 = toptim.adam_update_plain(p_t, grads, s_t, lr, clip, skip)
    assert optim_kernel.layout_copies == copies
    assert stand_in.calls[-1]["table"][2::5] == [
        s_k.mu.flat.data_ptr() + 4 * e for e in (0, 12, 17, 25)]
    # An empty tensor (a 1-D no-MLP solve's transforms) takes no elements.
    params, grads, state = adam_inputs(shapes=((3,), (6, 0), (2,)))
    p_e = [p.clone() for p in params]
    s_e = k6_step(p_e, grads, state, lr, None, False)
    assert stand_in.calls[-1]["table"][4::5] == [3, 0, 2]
    assert [m.shape for m in s_e.nu] == [(3,), (6, 0), (2,)]
    want = toptim.adam_update_plain(params, grads, state, lr)
    np.testing.assert_allclose(flat_of(p_e), flat_of(params), rtol=1e-6)
    np.testing.assert_allclose(s_e.mu.flat, flat_of(want.mu), rtol=1e-6)
    np.testing.assert_allclose(flat_of(p_k), flat_of(p_t), rtol=1e-6)
    np.testing.assert_allclose(flat_of(list(s_k2.nu)), flat_of(s_t2.nu),
                               rtol=1e-6, atol=1e-12)


def test_k6_wrapper_copies_other_layouts_first(stand_in):
    """A transposed gradient or moment is made contiguous (counted) and
    gives the contiguous one's result."""
    params, grads, state = adam_inputs()
    p_a = [p.clone() for p in params]
    want = k6_step(p_a, grads, state, 1e-2, 0.5, True)
    copies = optim_kernel.layout_copies
    g = list(grads)
    g[0] = grads[0].t().contiguous().t()
    mu = list(state.mu)
    mu[0] = state.mu[0].t().contiguous().t()
    p_b = [p.clone() for p in params]
    got = k6_step(p_b, g, state._replace(mu=mu), 1e-2, 0.5, True)
    assert optim_kernel.layout_copies == copies + 2
    assert torch.equal(flat_of(p_a), flat_of(p_b))
    assert torch.equal(got.mu.flat, want.mu.flat)


@pytest.mark.parametrize("total", [1, 2, 29_344, 65_537, 300_000])
def test_k6_one_launch_for_any_total(stand_in, total):
    """One launch (one cluster) whatever the element count, with the
    table's count and the twin's step to float32 round-off."""
    params, grads, state = adam_inputs(shapes=((total,),))
    p0 = flat_of(params).double()
    p_t = [p.clone() for p in params]
    want = toptim.adam_update_plain(p_t, grads, state, 1e-3, 1.0, True)
    calls, launches = len(stand_in.calls), optim_kernel.launches
    got = k6_step(params, grads, state, 1e-3, 1.0, True)
    assert len(stand_in.calls) == calls + 1
    assert optim_kernel.launches == launches + 1
    assert stand_in.calls[-1]["table"][4::5] == [total]

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())
    # Norm-relative, as the card's check: one element of the change may
    # round differently near zero.
    assert rel(flat_of(params) - p0, flat_of(p_t) - p0) <= 1e-5
    assert rel(got.mu.flat, flat_of(want.mu)) <= 1e-5
    assert rel(got.nu.flat, flat_of(want.nu)) <= 1e-5
    assert int(got.count) == int(want.count) == 4


def test_flat_moments_join_as_lists():
    """``+`` joins flat moments with lists or each other as the per-tensor
    lists join, so callers that write ``mu + nu`` keep working."""
    params, _, state = adam_inputs()
    mu, nu = as_flat_moments(state.mu), as_flat_moments(state.nu)
    for joined, want in ((mu + nu, state.mu + state.nu),
                         (mu + [state.count], state.mu + [state.count]),
                         ([state.count] + nu, [state.count] + state.nu),
                         (state.mu + nu, state.mu + state.nu)):
        assert isinstance(joined, list) and len(joined) == len(want)
        for a, b in zip(joined, want):
            assert torch.equal(a, b)
    with pytest.raises(TypeError):
        mu + 1


def test_k6_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    """Too many tensors, a float64 or strided parameter, a gradient of
    another shape: ValueError before any launch; a failed launch raises
    and counts nothing."""
    lib = _StandInK6(rc=1)
    monkeypatch.setattr(optim_kernel, "_library", lambda: (lib, None))
    monkeypatch.setattr(optim_kernel, "_stream", lambda dev: 0)
    n = optim_kernel.MAX_TENSORS + 1
    many = adam_inputs(shapes=((2,),) * n)
    params, grads, state = adam_inputs()
    bad = [many,
           ([p.double() for p in params], grads, state),
           ([params[0].t()] + params[1:], grads, state),
           (params, [grads[1]] + grads[1:], state)]
    for p, g, s in bad:
        with pytest.raises(ValueError, match="K6"):
            k6_step(p, g, s, 1e-3, None, False)
    assert lib.calls == []
    launches = optim_kernel.launches
    with pytest.raises(RuntimeError, match="adam launch failed"):
        k6_step(params, grads, state, 1e-3, None, False)
    assert optim_kernel.launches == launches and len(lib.calls) == 1
