"""The port's timers and profiler traces (pigs_tpu_torch.utils.profiling)
against the JAX package's (CPU).

* ``Timer``: the same totals, means and report string as JAX's ``Timer``
  for the same recorded times, and ``sync`` takes tensors, nested sequences
  and ``None`` entries (CPU tensors need no wait).
* ``trace``: writes a Chrome-trace JSON under ``log_dir`` that loads and
  names the profiled op and the program's spans; ``None`` records nothing.
* ``span`` and ``tracing``: off, a span records nothing and leaves no
  annotation; on, records nest by parent id, carry the launch counters'
  changes and agree with the profiler's annotations on the clock; the
  training epoch and the rollouts trace the same results and run the same
  operations as untraced, with one span of each kind a step, each inside
  its parent.
"""

import collections
import json
import statistics

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from pigs_tpu.utils.profiling import Timer as JTimer
from pigs_tpu_torch.models import model as tmodel
from pigs_tpu_torch.ops import aggregate_kernel, mixture_kernel
from pigs_tpu_torch.pde import Problem
from pigs_tpu_torch.train import pn as tpn
from pigs_tpu_torch.train.optim import adam_init
from pigs_tpu_torch.utils import profiling
from pigs_tpu_torch.utils.profiling import Timer, span, trace, tracing
from pigs_tpu_torch.utils.sampling import (boundary_band_samples,
                                           collocation_samples)


def test_timer_accumulates():
    t = Timer()
    x = torch.ones(3)
    for _ in range(2):
        with t("op", sync=[x, (x, None)]):
            x = x + 1
    with t("other", sync=x):
        pass
    assert set(t.totals()) == {"op", "other"}
    assert all(v >= 0 for v in t.totals().values())
    assert t.means()["op"] == pytest.approx(t.totals()["op"] / 2)
    assert "op: " in t.report() and "(x2)" in t.report()


def test_timer_report_matches_jax():
    times = {"evolve": [0.0123, 0.004], "render": [0.5]}
    timers = [Timer(), JTimer()]
    for timer in timers:
        for name, values in times.items():
            timer._totals[name] = sum(values)
            timer._counts[name] = len(values)
    port, jax_timer = timers
    assert port.report() == jax_timer.report()
    assert port.totals() == jax_timer.totals()
    assert port.means() == jax_timer.means()


def test_trace_writes_chrome_json(tmp_path):
    a = torch.randn(64, 64)
    with trace(str(tmp_path / "trace")):
        torch.mm(a, a)
    files = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def test_trace_json_carries_the_spans(tmp_path):
    a = torch.randn(16, 16)
    with trace(str(tmp_path)):
        assert profiling._tracing is not None
        with span("outer"):
            with span("inner"):
                torch.mm(a, a)
    assert profiling._tracing is None
    (path,) = tmp_path.glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events
             if e.get("cat") == "user_annotation"}
    assert {"outer", "inner"} <= names


def test_trace_none_records_nothing(tmp_path):
    with trace(None):
        torch.ones(2) + 1
    assert not any(tmp_path.iterdir())


# ------------------------------------------------------------------ spans --
def annotations(prof):
    """The profile's user annotations by name, each ``(start, end)`` in ns,
    in the order they began."""
    out = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.activity_type() == "user_annotation":
            out[e.name()].append((e.start_ns(), e.end_ns()))
    return {k: sorted(v) for k, v in out.items()}


def aten_ops(prof):
    return collections.Counter(
        e.name() for e in prof.profiler.kineto_results.events()
        if e.name().startswith("aten::"))


def test_span_off_records_nothing():
    assert span("a") is span("b")          # one shared no-op context
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("off.outer"):
            with span("off.inner"):
                torch.ones(3) + 1
    assert not {"off.outer", "off.inner"} & set(annotations(prof))
    assert profiling._tracing is None


def test_span_records_nest_count_and_share_the_clock(monkeypatch):
    for module, name in (("mixture_kernel", "launches"),
                         ("mixture_kernel", "bwd_gauss_launches"),
                         ("aggregate_kernel", "fwd_launches")):
        monkeypatch.setattr(globals()[module], name, 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):      # a profile's first annotations are slow
            with record_function("warm-up"):
                pass
        with tracing() as records:
            for _ in range(5):
                with span("outer"):
                    aggregate_kernel.fwd_launches += 1
                    with span("inner"):
                        mixture_kernel.launches += 2
                        torch.ones(8) * 2
                    with span("inner2"):
                        mixture_kernel.bwd_gauss_launches += 1
                        with tracing() as same:    # nested: the same list
                            assert same is records
    assert profiling._tracing is None
    assert [r.name for r in records[:3]] == ["outer", "inner", "inner2"]
    assert len(records) == 15 and [r.id for r in records] == list(range(15))
    for r in records:
        if r.name == "outer":
            assert r.parent is None
            assert r.launches == {"k1": 2, "k2": 1, "k3": 0, "k4": 1,
                                  "k5": 0, "k6": 0, "solve_iters": 0,
                                  "solve_blocks": 0, "solve_stop_tol": 0,
                                  "solve_stop_cap": 0, "solve_densify": 0}
        else:
            parent = records[r.parent]
            assert parent.name == "outer" and r.id in (parent.id + 1,
                                                       parent.id + 2)
            assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns
            want = {"inner": {"k1": 2, "k2": 0}, "inner2": {"k1": 0, "k2": 1}}
            assert {k: r.launches[k] for k in ("k1", "k2")} == want[r.name]
            assert r.launches["k4"] == 0
    # Each record lies inside its profiler annotation (the span reads the
    # clock after entering it and before leaving it; 20 us for the
    # profiler's conversion of its clock) and, in the median, within 50 us
    # of its ends: one clock.
    found = annotations(prof)
    offsets = []
    for name in ("outer", "inner", "inner2"):
        mine = [(r.start_ns, r.end_ns) for r in records if r.name == name]
        assert len(found[name]) == len(mine)
        for (a0, a1), (r0, r1) in zip(found[name], mine):
            assert a0 - 20_000 <= r0 <= r1 <= a1 + 20_000
            offsets += [r0 - a0, a1 - r1]
    assert statistics.median(offsets) < 50_000, offsets


NX, CAP, M = 4, 160, 32


def tiny_burgers(seed=5):
    cfg = tmodel.ModelConfig.create(Problem.BURGERS, nx=NX, ny=NX,
                                    capacity=CAP, dtype=torch.float64)
    g = torch.Generator().manual_seed(seed)
    net = tmodel.make_network(cfg, generator=g)
    state = tmodel.randomize_state_dynamic(cfg, g, NX, NX)
    return cfg, net, state, g


def twice(fn):
    """``fn()`` untraced and traced, each under the profiler: the results,
    the traced run's records and each run's ``aten::`` operations."""
    out = []
    for on in (False, True):
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            if on:
                with tracing() as records:
                    result = fn()
            else:
                result, records = fn(), []
        out.append((result, records, aten_ops(prof), annotations(prof)))
    return out


def assert_equal(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_equal(x, y)
    else:
        assert a == b


def assert_steps(records, step_children, n_steps):
    """``n_steps`` ``step`` spans, each with exactly one of each child name
    below it (``network.*`` under ``network``), every child inside its
    parent's interval."""
    by_id = {r.id: r for r in records}
    for r in records:
        assert r.end_ns is not None
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
    steps = [r for r in records if r.name == "step"]
    assert len(steps) == n_steps

    def below(rid):
        kids = [r for r in records if r.parent == rid]
        return kids + [k for c in kids for k in below(c.id)]
    for step in steps:
        names = collections.Counter(r.name for r in below(step.id))
        assert names == collections.Counter(step_children), names
        net = [r for r in records if r.parent == step.id
               and r.name == "network"]
        assert sorted(r.name for r in records if r.parent == net[0].id) == \
            ["network.forward", "network.inputs"]


TRAIN_STEP = ["step.fields", "step.loss", "step.backward", "step.adam",
              "step.split", "network", "network.inputs", "network.forward"]


def test_pn_epoch_traced_equals_untraced():
    n_steps = 3

    def epoch():
        cfg, net, state, g = tiny_burgers()
        samples = collocation_samples(g, M, 2, cfg.scale, cfg.dtype)
        ts = torch.rand(M, generator=g, dtype=cfg.dtype)
        bc = boundary_band_samples(g, M, cfg.scale, cfg.dtype)
        with torch.no_grad():
            prev = tmodel.sample_fields(cfg, state, samples, bc)
        res = tpn.pn_epoch(cfg, net, adam_init(net.parameters()), state,
                           prev, samples, ts, bc, 1e-3, 0.1, 0.05, n_steps,
                           do_split=True)
        return (res.per_step, list(res.state), res.active,
                [p.detach() for p in net.parameters()],
                res.opt_state.mu, res.opt_state.nu)
    (off, none, ops_off, ann_off), (on, records, ops_on, ann_on) = \
        twice(epoch)
    assert none == [] and not ann_off
    assert_equal(off, on)
    assert ops_off == ops_on
    assert_steps(records, TRAIN_STEP, n_steps)
    assert {r.name for r in records} == set(TRAIN_STEP) | {"step"}
    assert sum(len(v) for v in ann_on.values()) == len(records)


def test_train_epoch_and_ema_spans():
    cfg = tmodel.ModelConfig.create(Problem.TEST, nx=10, ny=10, capacity=160)
    tcfg = tpn.TrainConfig(n_epochs=1, n_samples=32, train_timesteps=2,
                           split_epoch=0, ema_decay=0.9)
    net, opt = tpn.init_training(cfg, tcfg)
    ema = [p.detach().clone() for p in net.parameters()]
    with tracing() as records:
        _, _, _, n_steps = tpn.train_epoch(
            cfg, tcfg, net, opt, torch.Generator().manual_seed(1),
            2 * tcfg.bootstrap_rate, 2)
        tpn._ema_update(ema, net.parameters(), 0.9)
    assert n_steps == 2
    epoch, ema_span = [r for r in records if r.parent is None]
    assert (epoch.name, ema_span.name) == ("epoch", "ema")
    kids = [r.name for r in records if r.parent == epoch.id]
    assert kids == ["epoch.draws", "step", "step", "epoch.read"]
    assert_steps(records, TRAIN_STEP, n_steps)


@pytest.mark.parametrize("kind", ["frames", "frames_densify", "vorticity"])
def test_rollout_traced_equals_untraced(kind):
    n_steps = 3
    step = ["step.render", "network", "network.inputs", "network.forward"]

    def run():
        if kind == "vorticity":
            cfg = tmodel.ModelConfig.create(Problem.NAVIER_STOKES, nx=3,
                                            ny=3, capacity=16,
                                            dtype=torch.float64)
            net = tmodel.make_network(
                cfg, generator=torch.Generator().manual_seed(2))
            state = tmodel.make_initial_state(cfg)
            return tpn.rollout_vorticity(cfg, net, state, n_steps, 8)
        cfg, net, state, _ = tiny_burgers()
        return tpn.rollout_frames(cfg, net, state, n_steps, 8, 0.05,
                                  densify=2 if kind == "frames_densify"
                                  else 0)
    (off, _, ops_off, _), (on, records, ops_on, _) = twice(run)
    assert torch.equal(off, on) and np.isfinite(on.numpy()).all()
    assert ops_off == ops_on
    (top,) = [r for r in records if r.parent is None]
    assert top.name == "rollout"
    if kind == "frames_densify":
        steps = [r for r in records if r.name == "step"]
        split = [r for r in records if r.name == "step.split"]
        assert [r.parent for r in split] == [s.id for s in steps[:2]]
        records = [r for r in records if r.name != "step.split"]
    assert_steps(records, step, n_steps)
    renders = [r for r in records if r.name == "step.render"]
    assert len(renders) == n_steps + (kind == "vorticity")
