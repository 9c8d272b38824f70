"""The no-MLP solver's block entry (``timestep_blocks``), its spans and
counters, and the port against the benchmark's plain reference
(``portbench/reference/no_mlp.py``) on the CPU.

With seeded random raw parameters at capacity 64 (48 active), 128 samples
and blocks of 3 iterations, in 2-D Burgers:

* one iteration's loss and gradients, one block's parameters, Adam moments
  and losses, and the rule that ends a timestep, against the reference:
  float64 within 1e-9 (norm-relative), float32 within 1e-4 (a block of 3
  Adam steps moves a parameter by up to 3 lr; float32 round-off in the
  sums over 48 Gaussians and 128 samples reads ~1e-6 on the loss and
  ~1e-5 on a gradient, and Adam's division by the root of the second
  moment can amplify a relative error ten-fold on the smallest entries);
* the block entry against the timestep loop as it was before the entry
  existed (kept here, :func:`loop_before_blocks`): the same parameters,
  active mask, loss and iterations bit for bit on the same draws, for a
  timestep ended by ``max_iters``, one ended by ``tol``, the IC fit, and
  one that densifies; ``solve`` over three timesteps likewise;
* the spans: traced and untraced runs give the same results and run the
  same operations; every span nests in its parent, one ``step`` an
  iteration with its four children, and (the plain twins counting as the
  card's kernels would) 2 K1, 1 K2 and 1 K6 a dynamics ``step``; the
  solver's counters count iterations, blocks, the stop and densify; off
  the card nothing counts a launch and, outside ``tracing()``, nothing is
  recorded.
"""

import collections
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pigs_tpu_torch.ops import mixture_kernel as mk
from pigs_tpu_torch.ops import optim_kernel
from pigs_tpu_torch.pde import Problem
from pigs_tpu_torch.train import no_mlp as tno
from pigs_tpu_torch.train import optim
from pigs_tpu_torch.utils import profiling
from pigs_tpu_torch.utils.profiling import tracing
from portbench.reference import no_mlp as ref

CAP, ACTIVE, M, ITERS = 64, 48, 128, 3
LEAVES = ref.LEAVES
TOL64, TOL32 = 1e-9, 1e-4


def config(dtype=torch.float64, **kw):
    base = dict(problem=Problem.BURGERS, d=2, n_init=6, capacity=CAP,
                n_samples=M, dt=0.1, block_iters=ITERS, max_iters=30,
                tol=1e-4, init_raw_scaling=-5.0, lr_min=1e-4, dtype=dtype)
    base.update(kw)
    return tno.NoMLPConfig(**base)


def random_state(seed, dtype=torch.float64):
    """Raw parameters of ``ACTIVE`` Gaussians spread over the domain (the
    others padded), as a solve's state holds them."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.rand(shape, generator=g, dtype=torch.float64)
    params = tno.RawParams(
        raw_means=torch.atanh((r(CAP, 2) * 2 - 1) * 0.5),
        values=(r(CAP, 1) - 0.3) * 0.8,
        raw_scaling=-3.0 + r(CAP, 2) * 1.5,
        transforms=(r(CAP, 1) - 0.5) * 2.0)
    active = torch.arange(CAP) < ACTIVE
    return tno.RawParams(*(p.to(dtype) for p in params)), active


def prev_mixture(cfg, seed):
    params, active = random_state(seed, cfg.dtype)
    with torch.no_grad():
        return (*tno.concrete(cfg, params), active), params, active


def raw_dict(params):
    return {k: v.detach().double() for k, v in zip(LEAVES, params)}


def recipe(cfg):
    return ref.Recipe({"scale": cfg.scale, "dt": cfg.dt, "nu": cfg.nu,
                       "lr": cfg.lr, "lr_min": cfg.lr_min,
                       "max_iters": cfg.max_iters, "tol": cfg.tol,
                       "block_iters": cfg.block_iters})


def rel(a, b) -> float:
    a, b = (torch.as_tensor(x, dtype=torch.float64).detach() for x in (a, b))
    return float(torch.linalg.vector_norm(a - b)
                 / max(float(torch.linalg.vector_norm(b)), 1e-300))


def reference_block(cfg, params, active, prev_params, prev_active, draws,
                    count=0, opt=None):
    r = recipe(cfg)
    raw = raw_dict(params)
    return ref.block(r, raw, active, raw_dict(prev_params), prev_active,
                     opt or ref.adam_init(raw), count, draws.base.double(),
                     draws.time.double())


# ------------------------------------------------------ port vs reference --
@pytest.mark.parametrize("dtype,tol", [(torch.float64, TOL64),
                                       (torch.float32, TOL32)])
def test_loss_and_gradients_match_the_reference(dtype, tol):
    cfg = config(dtype)
    params, active = random_state(1, dtype)
    prev, prev_params, prev_active = prev_mixture(cfg, 2)
    draws = tno.block_draws(cfg, torch.Generator().manual_seed(3), active,
                            False)
    samples = tno.draw_samples(cfg, draws.base[0], params)
    leaves = tno.RawParams(*(p.clone().requires_grad_() for p in params))
    with torch.no_grad():
        pout = tno.eval_mixture(*prev[:3], samples, order=2, mask=prev[3])
    loss = tno._loss_fn(cfg, leaves, active, (pout.u, pout.ux, pout.uxx),
                        samples, draws.time[0], False)
    grads = torch.autograd.grad(loss, list(leaves))

    r = recipe(cfg)
    pm, pc, pv = ref.concrete(raw_dict(prev_params), cfg.scale)
    want_loss, want_grads = ref.loss_and_grads(
        r, raw_dict(params), active,
        lambda x: ref.mixture(pm, pc, pv, x, prev_active),
        draws.base[0].double(), draws.time[0].double())
    assert rel(loss.detach(), want_loss) <= tol
    for k, g in zip(LEAVES, grads):
        assert rel(g, want_grads[k]) <= tol, k
    # Inactive slots get no gradient in either.
    assert float(want_grads["values"][ACTIVE:].abs().max()) == 0.0
    assert float(grads[1][ACTIVE:].abs().max()) == 0.0


@pytest.mark.parametrize("dtype,tol", [(torch.float64, TOL64),
                                       (torch.float32, TOL32)])
@pytest.mark.parametrize("count", [0, 7])
def test_block_matches_the_reference(dtype, tol, count):
    """One block from the pre-step count ``count`` (the schedule's), the
    Adam state carried in."""
    cfg = config(dtype)
    params, active = random_state(4, dtype)
    prev, prev_params, prev_active = prev_mixture(cfg, 5)
    draws = tno.block_draws(cfg, torch.Generator().manual_seed(6), active,
                            False)
    g = torch.Generator().manual_seed(7)
    mu = [torch.randn(p.shape, generator=g, dtype=torch.float64) * 1e-3
          for p in params]
    nu = [torch.rand(p.shape, generator=g, dtype=torch.float64) * 1e-5
          for p in params]
    opt = optim.AdamState([m.to(dtype) for m in mu], [v.to(dtype) for v in nu],
                          torch.tensor(count, dtype=torch.int32))
    live = tno.RawParams(*(p.clone().requires_grad_() for p in params))
    out, opt_out, _, loss = tno._run_block(cfg, live, opt, active, prev,
                                           False, draws, count)
    want = reference_block(cfg, params, active, prev_params, prev_active,
                           draws, count, {"mu": dict(zip(LEAVES, mu)),
                                          "nu": dict(zip(LEAVES, nu)),
                                          "count": count})
    assert rel(loss, want["mean_loss"]) <= tol
    for i, k in enumerate(LEAVES):
        assert rel(out[i] - params[i], want["raw"][k] - params[i].double()) \
            <= tol, k
        assert rel(opt_out.mu[i], want["opt"]["mu"][k]) <= tol, k
        assert rel(opt_out.nu[i], want["opt"]["nu"][k]) <= tol, k
    assert int(opt_out.count) == want["opt"]["count"] == count + ITERS


@pytest.mark.parametrize("tol,max_iters,blocks,why", [
    (1e9, 30, 1, "tol"),          # the first block's mean is under 1e9
    (0.0, 9, 3, "max_iters"),     # never under 0: the cap, 3 blocks of 3
])
def test_the_stopping_rule_matches_the_reference(tol, max_iters, blocks, why):
    cfg = config(tol=tol, max_iters=max_iters)
    params, active = random_state(8)
    prev, *_ = prev_mixture(cfg, 9)
    states = list(tno.timestep_blocks(cfg, params, active, prev,
                                      torch.Generator().manual_seed(10),
                                      False))
    r = recipe(cfg)
    losses = [s.loss for s in states]
    assert len(states) == blocks
    assert [s.done for s in states] == [False] * (blocks - 1) + [True]
    for i, s in enumerate(states):
        assert s.iters == (i + 1) * ITERS
        assert ref.stops(r, losses[:i + 1], s.iters) == (
            why if s.done else "")


# ------------------------------------------- the entry vs the loop before --
def loop_before_blocks(cfg, params, active, prev_mixture, generator,
                       first_step, densify_every=None):
    """``solve_timestep`` as it was before ``timestep_blocks``."""
    params = tno.RawParams(*(p.detach().clone().requires_grad_()
                             for p in params))
    opt_state = tno.adam_init(params)
    mean_grad_acc = torch.zeros_like(params.raw_means)
    it = block = 0
    block_losses = []

    def converged() -> bool:
        window = block_losses[-5:]
        if first_step:
            if len(window) < 2:
                return False
            mean = float(np.mean(window))
            rel_std = float(np.std(window, ddof=1)) / mean if mean else 0.0
            return not np.isnan(rel_std) and rel_std <= 0.1
        return bool(window) and float(np.mean(window)) <= cfg.tol

    while it < cfg.max_iters and not converged():
        draws = tno.block_draws(cfg, generator, active, first_step)
        params, opt_state, grad_acc, loss_b = tno._run_block(
            cfg, params, opt_state, active, prev_mixture, first_step, draws,
            it)
        mean_grad_acc = mean_grad_acc + grad_acc.raw_means / cfg.block_iters
        block_losses.append(float(loss_b))
        it += cfg.block_iters
        block += 1
        if (densify_every and block % densify_every == 0
                and block > cfg.warm_up_blocks and not first_step):
            params, opt_state, active = tno.densify(cfg, params, opt_state,
                                                    active, mean_grad_acc)
            params = tno.RawParams(*(p.requires_grad_() for p in params))
            mean_grad_acc = torch.zeros_like(params.raw_means)
    loss = float(np.mean(block_losses[-5:])) if block_losses else np.inf
    return tno.RawParams(*(p.detach() for p in params)), active, loss, it


CASES = {
    "max_iters": (dict(tol=0.0, max_iters=12), False, None),
    "tol": (dict(tol=1e9), False, None),
    "ic_fit": (dict(max_iters=60), True, None),
    "densify": (dict(tol=0.0, max_iters=12, warm_up_blocks=1), False, 2),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", list(CASES))
def test_block_entry_equals_the_loop_before(case, dtype):
    kw, first_step, densify_every = CASES[case]
    cfg = config(dtype, **kw)
    params, active = random_state(11, dtype)
    prev = None if first_step else prev_mixture(cfg, 12)[0]
    got = tno.solve_timestep(cfg, params, active, prev,
                             torch.Generator().manual_seed(13), first_step,
                             densify_every)
    want = loop_before_blocks(cfg, params, active, prev,
                              torch.Generator().manual_seed(13), first_step,
                              densify_every)
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    assert torch.equal(got[1], want[1])
    assert got[2:] == want[2:]
    assert not any(p.requires_grad for p in got[0])
    stopped = {"max_iters": 12, "tol": ITERS, "densify": 12}
    if case in stopped:
        assert got[3] == stopped[case]


def test_solve_equals_the_loop_before():
    cfg = config(torch.float32, n_init=4, tol=0.0, max_iters=6)
    got = tno.solve(cfg, torch.Generator().manual_seed(14), 3)
    with mock.patch.object(tno, "solve_timestep", loop_before_blocks):
        want = tno.solve(cfg, torch.Generator().manual_seed(14), 3)
    for g, w in zip(got, want):
        for a, b in zip(g["params"], w["params"]):
            assert torch.equal(a, b)
        assert torch.equal(g["active"], w["active"])
        assert (g["loss"], g["iters"]) == (w["loss"], w["iters"])


def test_block_entry_copies_its_input_and_may_stop_early():
    cfg = config(torch.float32, tol=0.0, max_iters=12)
    params, active = random_state(15, torch.float32)
    before = [p.clone() for p in params]
    prev = prev_mixture(cfg, 16)[0]
    blocks = tno.timestep_blocks(cfg, params, active, prev,
                                 torch.Generator().manual_seed(17), False)
    first = next(blocks)
    blocks.close()
    assert (first.iters, first.done) == (ITERS, False)
    assert int(first.opt_state.count) == ITERS
    for a, b in zip(params, before):
        assert torch.equal(a, b)


# ------------------------------------------------------- spans, counters --
SOLVER = ("solve_iters", "solve_blocks", "solve_stop_tol", "solve_stop_cap",
          "solve_densify")


def counting_twins():
    """The plain twins counting as the card's kernels do: K1 a forward,
    K2 a Gaussian-side backward, K6 an Adam step."""
    def bump(module, counter, fn):
        def wrapped(*a, **k):
            setattr(module, counter, getattr(module, counter) + 1)
            return fn(*a, **k)
        return wrapped
    return [mock.patch.object(mk, "mixture_forward_plain", bump(
                mk, "launches", mk.mixture_forward_plain)),
            mock.patch.object(mk, "mixture_backward_gauss_plain", bump(
                mk, "bwd_gauss_launches", mk.mixture_backward_gauss_plain)),
            mock.patch.object(optim, "adam_update_plain", bump(
                optim_kernel, "launches", optim.adam_update_plain))]


def aten_ops(prof):
    return collections.Counter(
        e.name() for e in prof.profiler.kineto_results.events()
        if e.name().startswith("aten::"))


def run_timestep(densify_every=None, **kw):
    cfg = config(torch.float32, **kw)
    params, active = random_state(18, torch.float32)
    prev = prev_mixture(cfg, 19)[0]
    return tno.solve_timestep(cfg, params, active, prev,
                              torch.Generator().manual_seed(20), False,
                              densify_every)


def test_spans_trace_the_same_solve():
    kw = dict(tol=0.0, max_iters=2 * ITERS, warm_up_blocks=1)
    out = []
    for on in (False, True):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            if on:
                with tracing() as records:
                    result = run_timestep(densify_every=2, **kw)
            else:
                result, records = run_timestep(densify_every=2, **kw), []
        out.append((result, records, aten_ops(prof)))
    (off, none, ops_off), (on, records, ops_on) = out
    for a, b in zip(off[0], on[0]):
        assert torch.equal(a, b)
    assert torch.equal(off[1], on[1]) and off[2:] == on[2:]
    assert none == [] and ops_off == ops_on
    names = collections.Counter(r.name for r in records)
    assert names == {"solve": 1, "solve.block": 2, "solve.draws": 2,
                     "solve.read": 2, "solve.densify": 1, "step": 2 * ITERS,
                     "step.fields": 2 * ITERS, "step.loss": 2 * ITERS,
                     "step.backward": 2 * ITERS, "step.adam": 2 * ITERS}


def test_spans_nest_and_count(monkeypatch):
    for module, counter in ((mk, "launches"), (mk, "bwd_gauss_launches"),
                            (mk, "bwd_sample_launches"),
                            (optim_kernel, "launches")):
        monkeypatch.setattr(module, counter, 0)
    patches = counting_twins()
    for p in patches:
        p.start()
    try:
        with tracing() as records:
            run_timestep(tol=0.0, max_iters=2 * ITERS)
    finally:
        for p in patches:
            p.stop()
    by_id = {r.id: r for r in records}
    parent_of = {"solve": None, "solve.block": "solve",
                 "solve.draws": "solve.block", "solve.read": "solve.block",
                 "step": "solve.block", "step.fields": "step",
                 "step.loss": "step", "step.backward": "step",
                 "step.adam": "step"}
    for r in records:
        want = parent_of[r.name]
        if want is None:
            assert r.parent is None
            continue
        p = by_id[r.parent]
        assert p.name == want
        assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
    (solve,) = [r for r in records if r.name == "solve"]
    assert solve.launches["k1"] == 2 * 2 * ITERS
    assert {k: solve.launches[k] for k in SOLVER} == {
        "solve_iters": 2 * ITERS, "solve_blocks": 2, "solve_stop_tol": 0,
        "solve_stop_cap": 1, "solve_densify": 0}
    for r in records:
        if r.name == "step":
            assert {k: r.launches[k] for k in ("k1", "k2", "k3", "k6",
                                               "solve_iters")} == {
                "k1": 2, "k2": 1, "k3": 0, "k6": 1, "solve_iters": 1}
        kernels = {"step.fields": {"k1": 1}, "step.loss": {"k1": 1},
                   "step.backward": {"k2": 1}, "step.adam": {"k6": 1}}
        if r.name in kernels:
            assert {k: v for k, v in r.launches.items() if v} == \
                kernels[r.name]
        if r.name == "solve.read":
            assert r.launches["solve_stop_cap"] in (0, 1)
            assert sum(r.launches.values()) == r.launches["solve_stop_cap"]


def test_counters_count_stops_and_densify():
    before = {k: getattr(tno, n) for k, _, n in profiling.SOLVER_COUNTERS}
    run_timestep(tol=1e9)
    run_timestep(tol=0.0, max_iters=2 * ITERS, warm_up_blocks=0,
                 densify_every=1)
    after = {k: getattr(tno, n) for k, _, n in profiling.SOLVER_COUNTERS}
    assert {k: after[k] - before[k] for k in after} == {
        "solve_iters": 3 * ITERS, "solve_blocks": 3, "solve_stop_tol": 1,
        "solve_stop_cap": 1, "solve_densify": 2}


def test_cpu_launches_nothing_and_records_nothing_outside_tracing():
    counters = [(mk, "launches"), (mk, "bwd_gauss_launches"),
                (mk, "bwd_sample_launches"), (optim_kernel, "launches")]
    before = [getattr(m, c) for m, c in counters]
    assert profiling._tracing is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_timestep(tol=0.0, max_iters=ITERS)
    assert [getattr(m, c) for m, c in counters] == before
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not {n for n in names if n.startswith(("solve", "step"))}
    assert profiling._tracing is None
