"""Parity of the port's no-MLP direct solver (``pigs_tpu_torch.train.no_mlp``)
with ``pigs_tpu.train.no_mlp`` on the CPU.

At small sizes (capacity 64, n_init 5 in 2D and 25 in 1D, 64 samples,
``block_iters`` 5), in float64, against the JAX functions of the same name:

* ``init_params`` and ``concrete`` (d = 1, 2), ``_initial_target``,
  ``_pde_residual_loss`` for the three problems in both dimensions, and
  ``_loss_fn``'s value and gradients against ``jax.value_and_grad`` on first
  and later steps: norm-relative <= 1e-9;
* the cosine learning rate against optax's schedule;
* ``_run_block`` on JAX's draws (split from the block's key as JAX splits
  it): parameters, summed gradients, Adam moments and count and the mean
  loss <= 1e-8, WAVE with ``active_sampling`` 0.5 and two consecutive
  blocks under the cosine schedule included;
* ``densify``: masks equal, parameters and moments <= 1e-12, with and
  without ``min_keep`` and with nothing active; the Adam state carried
  over by ``convert.no_mlp_adam_from_optax``;
* ``draw_samples``' structure, that a block never runs the sample-side
  backward (K3's twin) and runs one forward pair and one Gaussian-side
  backward an iteration, and ``solve_timestep``'s convergence rule on
  stubbed block losses.

At full width, from the exported fixture (artifacts/no_mlp_torch.npz,
``scripts/export_torch_fixture.py --kind no-mlp``): the fixture's
100-iteration block run by the port in float32 on the CPU against the JAX
float64 block, within ``chip_smoke.py``'s tolerances for the card (twice
the errors this run printed with 8 threads; it now uses 2, whose sums give
1.1-1.3x those), and ``densify`` on the fixture's input with masks equal
to JAX's.
"""

import importlib.util
import pathlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pigs_tpu.pde import Problem as JProblem
from pigs_tpu.train import no_mlp as jno
from pigs_tpu_torch import convert
from pigs_tpu_torch.ops import mixture_kernel as mk
from pigs_tpu_torch.pde import Problem
from pigs_tpu_torch.train import no_mlp as tno

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "artifacts" / "no_mlp_torch.npz"
TOL = 1e-9
BLOCK_TOL = 1e-8


def load_module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def exporter():
    return load_module("export_torch_fixture",
                       ROOT / "scripts" / "export_torch_fixture.py")


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    denom = np.linalg.norm(b)
    return float(np.linalg.norm(a - b) / (denom if denom else 1.0))


def configs(problem: str, d: int, **kw):
    base = dict(scale=2.5, n_init=5 if d == 2 else 25, capacity=64,
                n_samples=64, block_iters=5, max_iters=50, dt=0.05)
    base.update(kw)
    return (jno.NoMLPConfig(problem=JProblem[problem], d=d,
                            dtype=jnp.float64, **base),
            tno.NoMLPConfig(problem=Problem[problem], d=d,
                            dtype=torch.float64, **base))


def random_params(jcfg, seed):
    """Init params perturbed by numpy draws (inactive slots keep their
    padding scalings), as numpy arrays, and the active mask."""
    rng = np.random.default_rng(seed)
    params, active = jno.init_params(jcfg)
    p = [np.array(x) for x in params]
    p[0] = p[0] + 0.05 * rng.standard_normal(p[0].shape)
    p[1] = 0.3 * rng.standard_normal(p[1].shape)
    p[2] = p[2] + 0.5 + 0.2 * rng.standard_normal(p[2].shape)
    p[3] = 0.3 * rng.standard_normal(p[3].shape)
    return p, np.asarray(active)


def jparams(p):
    return jno.RawParams(*(jnp.asarray(x) for x in p))


def tparams(p, grad=False):
    return tno.RawParams(*(torch.tensor(x).requires_grad_(grad) for x in p))


def prev_mixtures(jcfg, tcfg, seed):
    """The previous mixture as each solver takes it, from one draw."""
    p, active = random_params(jcfg, seed)
    jm = jno.concrete(jcfg, jparams(p)) + (jnp.asarray(active),)
    with torch.no_grad():
        tm = tno.concrete(tcfg, tparams(p)) + (torch.tensor(active),)
    return jm, tm


@pytest.mark.parametrize("d", [1, 2])
def test_init_params_and_concrete(d):
    jcfg, tcfg = configs("BURGERS", d)
    jp, ja = jno.init_params(jcfg)
    tp, ta = tno.init_params(tcfg)
    assert np.array_equal(np.asarray(ja), ta.numpy())
    for a, b in zip(tp, jp):
        assert a.shape == b.shape and a.dtype == torch.float64
        assert rel(a.numpy(), b) <= TOL
    p, _ = random_params(jcfg, 1)
    for a, b in zip(tno.concrete(tcfg, tparams(p)),
                    jno.concrete(jcfg, jparams(p))):
        assert a.shape == b.shape
        assert rel(a.numpy(), b) <= TOL


@pytest.mark.parametrize("problem,d", [("BURGERS", 1), ("BURGERS", 2),
                                       ("WAVE", 2)])
def test_initial_target(problem, d):
    jcfg, tcfg = configs(problem, d)
    x = np.random.default_rng(2).uniform(-2.5, 2.5, (50, d))
    assert rel(tno._initial_target(tcfg, torch.tensor(x)).numpy(),
               jno._initial_target(jcfg, jnp.asarray(x))) <= TOL


PROBLEMS = [(p, d) for p in ("DIFFUSION", "BURGERS", "WAVE") for d in (1, 2)]


@pytest.mark.parametrize("problem,d", PROBLEMS)
def test_pde_residual_loss(problem, d):
    jcfg, tcfg = configs(problem, d)
    rng = np.random.default_rng(3)
    m, c = 40, jcfg.c
    arrays = [rng.standard_normal(s) for s in
              ((m, c), (m, d, c), (m, d, d, c), (m, c))]
    want = jno._pde_residual_loss(jcfg, *map(jnp.asarray, arrays))
    got = tno._pde_residual_loss(tcfg, *map(torch.tensor, arrays))
    assert rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("first_step", [True, False])
@pytest.mark.parametrize("problem,d", PROBLEMS)
def test_loss_fn_value_and_grads(problem, d, first_step):
    jcfg, tcfg = configs(problem, d)
    p, active = random_params(jcfg, 4)
    rng = np.random.default_rng(5)
    samples = rng.uniform(-2.5, 2.5, (jcfg.n_samples, d))
    ts = rng.uniform(0.0, 1.0, jcfg.n_samples)
    jprev = tprev = None
    if not first_step:
        jm, tm = prev_mixtures(jcfg, tcfg, 6)
        from pigs_tpu.ops.mixture import eval_mixture as jeval
        out = jeval(*jm[:3], jnp.asarray(samples), order=2, mask=jm[3])
        jprev = (out.u, out.ux, out.uxx)
        tprev = tuple(torch.tensor(np.asarray(x)) for x in jprev)
    loss, grads = jax.value_and_grad(
        lambda q: jno._loss_fn(jcfg, q, jnp.asarray(active), jprev,
                               jnp.asarray(samples), jnp.asarray(ts),
                               first_step))(jparams(p))
    tp = tparams(p, grad=True)
    tloss = tno._loss_fn(tcfg, tp, torch.tensor(active), tprev,
                         torch.tensor(samples), torch.tensor(ts), first_step)
    tgrads = torch.autograd.grad(tloss, list(tp), allow_unused=True)
    assert rel(tloss.item(), float(loss)) <= TOL
    for g, want in zip(tgrads, grads):
        got = np.zeros(want.shape) if g is None else g.numpy()
        assert rel(got, want) <= TOL


def test_cosine_learning_rate_matches_optax():
    _, tcfg = configs("BURGERS", 2, lr_min=1e-4, max_iters=5000)
    sched = optax.cosine_decay_schedule(1e-2, 5000, alpha=1e-4 / 1e-2)
    lr = tno._make_opt(tcfg)
    for i in (0, 1, 2500, 4999, 5000, 5100):
        assert lr(i) == pytest.approx(float(sched(i)), rel=1e-12)
    assert lr(5100) == pytest.approx(1e-4, rel=1e-12)
    assert tno._make_opt(tcfg._replace(lr_min=None))(123) == 1e-2


def torch_draws(draws):
    base, idx, z, time = draws
    return tno.BlockDraws(
        torch.tensor(base), None if idx is None else
        torch.tensor(idx, dtype=torch.int64),
        None if z is None else torch.tensor(z), torch.tensor(time))


def torch_adam(state):
    adam = [s for s in state if isinstance(s, optax.ScaleByAdamState)][0]
    return adam, convert.no_mlp_adam_from_optax(adam.mu, adam.nu, adam.count)


BLOCK_CASES = {
    "burgers-2d-two-blocks": ("BURGERS", 2, False, dict(lr_min=1e-4)),
    "wave-2d-active-sampling": ("WAVE", 2, False,
                                dict(active_sampling=0.5, dt=0.01)),
    "wave-2d-ic-fit": ("WAVE", 2, True, {}),
    "burgers-1d-ic-fit": ("BURGERS", 1, True, {}),
}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_run_block_matches_jax_on_its_draws(case, exporter):
    problem, d, first_step, kw = BLOCK_CASES[case]
    jcfg, tcfg = configs(problem, d, **kw)
    p, active = random_params(jcfg, 7)
    jm, tm = (None, None) if first_step else prev_mixtures(jcfg, tcfg, 8)
    opt_state = jno._make_opt(jcfg).init(jparams(p))
    tp = tparams(p, grad=True)
    _, topt = torch_adam(opt_state)
    ja, ta = jnp.asarray(active), torch.tensor(active)
    jp, count = jparams(p), 0
    for key in jax.random.split(jax.random.PRNGKey(9),
                                2 if case.endswith("two-blocks") else 1):
        jp, opt_state, jgrad, jloss = jno._run_block(
            jcfg, jp, opt_state, ja, jm, key, first_step)
        draws = torch_draws(exporter.jax_block_draws(jcfg, key, ja,
                                                     first_step))
        tp, topt, tgrad, tloss = tno._run_block(tcfg, tp, topt, ta, tm,
                                                first_step, draws, count)
        count += tcfg.block_iters
        adam, _ = torch_adam(opt_state)
        assert rel(tloss.item(), float(jloss)) <= BLOCK_TOL
        assert int(topt.count) == int(adam.count) == count
        for got, want in [(tp, jp), (tgrad, jgrad), (topt.mu, adam.mu),
                          (topt.nu, adam.nu)]:
            for a, b in zip(got, want):
                assert rel(a.detach().numpy(), b) <= BLOCK_TOL


def densify_inputs(jcfg, seed, all_inactive=False):
    """A state in which densify both prunes and splits, and an Adam state
    with non-zero moments."""
    rng = np.random.default_rng(seed)
    p, active = random_params(jcfg, seed)
    p[1][::7] *= 1e-3                      # pruned: |v| < 0.01
    p[2][5] = 0.0                          # pruned: sum(var) >= 0.5
    if all_inactive:
        active = np.zeros_like(active)
    grad = 0.01 * rng.standard_normal(p[0].shape)
    grad[[3, 11]] *= 50.0                  # split
    opt = jno._make_opt(jcfg).init(jparams(p))
    adam = opt[0]._replace(
        mu=jno.RawParams(*(jnp.asarray(rng.standard_normal(x.shape))
                           for x in p)),
        nu=jno.RawParams(*(jnp.asarray(rng.uniform(0, 1, x.shape))
                           for x in p)),
        count=jnp.asarray(37, jnp.int32))
    return p, active, grad, (adam,) + tuple(opt[1:])


@pytest.mark.parametrize("min_keep,all_inactive", [(0, False), (20, False),
                                                   (60, False), (5, True)])
def test_densify_matches_jax(min_keep, all_inactive):
    jcfg, tcfg = configs("BURGERS", 2, min_keep=min_keep)
    p, active, grad, opt = densify_inputs(jcfg, 10, all_inactive)
    want_p, want_opt, want_a = jno.densify(jcfg, jparams(p), opt,
                                           jnp.asarray(active),
                                           jnp.asarray(grad))
    adam, topt = torch_adam(opt)
    got_p, got_opt, got_a = tno.densify(tcfg, tparams(p), topt,
                                        torch.tensor(active),
                                        torch.tensor(grad))
    want_a = np.asarray(want_a)
    assert np.array_equal(got_a.numpy(), want_a)
    if not all_inactive and min_keep == 0:
        # Pruned, and two children written (into pruned slots first).
        assert (active & ~want_a).any()
        assert (np.asarray(want_p.raw_means) != p[0]).any(-1).sum() == 2
    want_adam, _ = torch_adam(want_opt)
    assert int(got_opt.count) == 37
    for got, want in [(got_p, want_p), (got_opt.mu, want_adam.mu),
                      (got_opt.nu, want_adam.nu)]:
        for a, b in zip(got, want):
            assert rel(a.numpy(), b) <= 1e-12


def test_draw_samples_structure():
    _, tcfg = configs("WAVE", 2, n_samples=256, active_sampling=0.5)
    params, active = tno.init_params(tcfg)
    params = tno.RawParams(*(x.requires_grad_() for x in params))
    gen = torch.Generator().manual_seed(0)
    draws = tno.block_draws(tcfg, gen, active, first_step=False)
    assert draws.base.shape == (5, 256, 2) and draws.time.shape == (5, 256)
    assert draws.idx.shape == (5, 128) and draws.z.shape == (5, 128, 2)
    assert bool(active[draws.idx].all())           # only active slots
    pts = tno.draw_samples(tcfg, draws.base[0], params, draws.idx[0],
                           draws.z[0])
    assert pts.shape == (256, 2) and not pts.requires_grad
    assert bool((pts.abs() <= tcfg.scale).all())
    # Active Gaussians sit within |x| <= 0.25; sigma ~ 0.25 here.
    assert float((pts[:128].abs() < 1.5).all(-1).double().mean()) > 0.95
    assert float(pts[128:].abs().mean()) > 0.9     # the uniform half
    # The WAVE d=2 IC fit: clipped normals near the bump, no active draw.
    ic = tno.block_draws(tcfg, gen, active, first_step=True)
    assert ic.idx is None and ic.z is None
    pts = tno.draw_samples(tcfg, ic.base[0], params, first_step=True)
    assert torch.equal(pts, torch.clamp(ic.base[0] / 2.0, -1.0, 1.0) * 2.5)
    # Without active sampling: uniform over the domain.
    cfg0 = tcfg._replace(active_sampling=0.0)
    uni = tno.block_draws(cfg0, gen, active, first_step=False)
    assert uni.idx is None
    assert torch.equal(tno.draw_samples(cfg0, uni.base[0], params),
                       (uni.base[0] * 2.0 - 1.0) * 2.5)


@pytest.mark.parametrize("first_step", [False, True])
def test_block_runs_no_sample_backward(first_step):
    """Per dynamics iteration two forward evaluations and one Gaussian-side
    backward (K1, K1, K2 on the card); never the sample-side one (K3), the
    WAVE recipe's active sampling included.  The IC fit: one each."""
    _, tcfg = configs("WAVE", 2, active_sampling=0.5)
    p, active = random_params(configs("WAVE", 2)[0], 11)
    _, tm = prev_mixtures(*configs("WAVE", 2), 12)
    calls = {"fwd": 0, "gauss": 0, "sample": 0}

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped
    ta = torch.tensor(active)
    draws = tno.block_draws(tcfg, torch.Generator().manual_seed(1), ta,
                            first_step)
    with mock.patch.object(mk, "mixture_forward_plain",
                           spy("fwd", mk.mixture_forward_plain)), \
            mock.patch.object(mk, "mixture_backward_gauss",
                              spy("gauss", mk.mixture_backward_gauss)), \
            mock.patch.object(mk, "mixture_backward_sample",
                              spy("sample", mk.mixture_backward_sample)):
        tno._run_block(tcfg, tparams(p, grad=True),
                       tno.adam_init(tparams(p)), ta, tm, first_step, draws,
                       0)
    n = tcfg.block_iters
    assert calls == {"fwd": n * (1 if first_step else 2), "gauss": n,
                     "sample": 0}
    assert mk.bwd_sample_launches == 0


def stub_blocks(losses):
    """A stand-in for _run_block returning the given block losses."""
    it = iter(losses)

    def run(cfg, params, opt_state, *args):
        grad = tno.RawParams(*(torch.zeros_like(x) for x in params))
        return params, opt_state, grad, torch.tensor(next(it))
    return run


@pytest.mark.parametrize("first_step,losses,blocks", [
    # IC fit: stop once the 5-block window's relative std is <= 0.1.
    (True, [1.0, 0.5, 0.3, 0.29, 0.3, 0.3, 0.3, 0.3, 0.3], 7),
    (True, [0.2, 0.2], 2),
    # dynamics: stop once the window mean is <= tol (1e-4)...
    (False, [1e-3, 1e-5, 1e-5, 1e-5, 1e-5, 1e-5, 1e-5, 1e-5, 1e-5], 6),
    (False, [5e-5], 1),
    # ... or at max_iters (50 = 10 blocks of 5).
    (False, [1e-3] * 12, 10),
])
def test_solve_timestep_convergence_rule(first_step, losses, blocks):
    _, tcfg = configs("BURGERS", 2)
    params, active = tno.init_params(tcfg)
    with mock.patch.object(tno, "_run_block", stub_blocks(losses)):
        _, _, loss, iters = tno.solve_timestep(
            tcfg, params, active, None, torch.Generator().manual_seed(0),
            first_step)
    assert iters == blocks * tcfg.block_iters
    assert loss == pytest.approx(float(np.mean(losses[:blocks][-5:])))


def test_solve_timestep_densifies_after_warm_up():
    _, tcfg = configs("BURGERS", 2, warm_up_blocks=4)
    params, active = tno.init_params(tcfg)
    with mock.patch.object(tno, "_run_block", stub_blocks([1.0] * 10)), \
            mock.patch.object(tno, "densify", side_effect=lambda c, p, o, a,
                              g: (p, o, a)) as dens:
        tno.solve_timestep(tcfg, params, active, None,
                           torch.Generator().manual_seed(0), False,
                           densify_every=3)
    assert dens.call_count == 2          # after blocks 6 and 9


def test_solve_runs_and_records_iterations():
    _, tcfg = configs("BURGERS", 1, max_iters=10)
    tcfg = tcfg._replace(dtype=torch.float32)
    traj = tno.solve(tcfg, torch.Generator().manual_seed(0), 2)
    assert [s["iters"] for s in traj] == [10, 10]
    assert all(np.isfinite(s["loss"]) for s in traj)
    assert traj[0]["params"].raw_means.dtype == torch.float32
    assert not traj[1]["params"].values.requires_grad


def test_convert_no_mlp_params():
    jcfg, _ = configs("WAVE", 2)
    p, _ = random_params(jcfg, 13)
    tp = convert.no_mlp_params_from_jax(jparams(p), dtype=torch.float32)
    assert isinstance(tp, tno.RawParams)
    assert all(a.dtype == torch.float32 and a.shape == b.shape
               for a, b in zip(tp, p))


# ------------------------------------------------------ the fixture ----


@pytest.fixture(scope="module")
def fixture():
    cfg, densify_every, data = convert.load_no_mlp_fixture(str(FIXTURE))
    return cfg, densify_every, data


def test_fixture_recipe_is_the_committed_run(fixture):
    import json
    cfg, densify_every, data = fixture
    with open(ROOT / "results_no_mlp_2d_burgers" / "summary.json") as f:
        args = json.load(f)["args"]
    assert cfg.problem == Problem.BURGERS and cfg.d == 2
    for k in ("scale", "n_init", "capacity", "n_samples", "dt", "max_iters",
              "warm_up_blocks", "min_keep", "active_sampling", "lr_min",
              "init_raw_scaling"):
        assert getattr(cfg, k) == args[k], k
    assert densify_every == args["densify_every"]
    assert int(data["ic_active"].sum()) == 400
    assert FIXTURE.stat().st_size < 5 * 2 ** 20


def test_fixture_block_float32_within_chip_tolerances(fixture):
    cfg, _, data = fixture
    smoke = load_module("chip_smoke", ROOT / "chip_smoke.py")
    # Two threads: the block is ~20 s that way, parallel test workers
    # sharing the cores do not oversubscribe them, and the float32 sums,
    # whose order follows the thread count, are the same on every host.
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        block = smoke.no_mlp_block_inputs(cfg, data, torch.device("cpu"))
        params, opt, grad, loss = tno._run_block(cfg, *block[:4], False,
                                                 *block[4:])
    finally:
        torch.set_num_threads(threads)
    arr = convert.no_mlp_arrays
    errs = {"loss": rel(loss.item(), data["block_loss"]),
            "params": max(rel(a.detach().numpy(), b) for a, b in
                          zip(params, arr(data, "block"))),
            "grad_acc": max(rel(a.numpy(), b) for a, b in
                            zip(grad, arr(data, "block_grad_acc"))),
            "mu": max(rel(a.numpy(), b) for a, b in
                      zip(opt.mu, arr(data, "block_adam_mu"))),
            "nu": max(rel(a.numpy(), b) for a, b in
                      zip(opt.nu, arr(data, "block_adam_nu")))}
    print("float32 plain block vs JAX float64:", errs)
    assert int(opt.count) == int(data["block_adam_count"])
    for k, e in errs.items():
        assert e <= smoke.NO_MLP_BLOCK_TOL[k], (k, e)


@pytest.mark.parametrize("tag", ["densify0", "densifyk"])
def test_fixture_densify_masks_equal_jax(fixture, tag):
    cfg, _, data = fixture
    arr = convert.no_mlp_arrays
    if tag == "densifyk":
        cfg = cfg._replace(min_keep=int(data["densify_min_keep"]))
    opt = convert.no_mlp_adam_from_optax(
        arr(data, "start_adam_mu"), arr(data, "start_adam_nu"),
        data["start_adam_count"])
    active = torch.tensor(data["densify_in_active"])
    params, opt, new_active = tno.densify(
        cfg, convert.no_mlp_params_from_jax(arr(data, "densify_in")), opt,
        active, torch.tensor(data["densify_mean_grad"]))
    assert np.array_equal(new_active.numpy(), data[f"{tag}_active"])
    fresh = (new_active & ~active) | (active & ~new_active)
    assert bool(fresh.any())
    for m in opt.mu + opt.nu:
        assert bool((m[fresh] == 0).all())
    for a, b in zip(params, arr(data, tag)):
        assert rel(a.numpy(), b) <= 1e-6


def test_card_description_is_none_off_cuda():
    from pigs_tpu_torch.utils.card import card_description
    assert card_description(torch.device("cpu")) is None
