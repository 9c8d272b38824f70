#!/usr/bin/env python3
"""The program's spans in a profiled pass, and what they say per layer.

The program marks its layer boundaries with spans
(``pigs_tpu_torch.utils.profiling.span``: ``epoch``, ``epoch.draws``,
``epoch.read``, ``ema``, ``rollout``, ``step``, ``step.fields``,
``step.loss``, ``step.backward``, ``step.adam``, ``step.split``,
``step.render``, ``network``, ``network.inputs``, ``network.forward``),
recorded only inside ``tracing()``.  Each record carries its interval on
``time.time_ns``'s clock, which is the profiler's, and the change of the
kernels' launch counters (K1-K5) across it.

Pass.  :func:`spanned_profile` runs a callable under ``torch.profiler``
(CPU and CUDA) inside ``tracing()`` and keeps every device operation with
its correlation id, every runtime or driver launch by correlation id, the
user annotations, the span records and the pass's own interval.

Charging.  A device operation is charged to a span through its launch: the
launch event with its correlation id gives the time the host launched it,
and the innermost span open at that time on the thread that ran the spans
is charged.  A launch from autograd's device thread during
``torch.autograd.grad`` is charged to ``step.backward``, open on the
calling thread meanwhile.

Readings (:class:`Spanned`): host milliseconds a step by span, the device's
busy milliseconds a step of what was launched inside a span (the union of
the operations' intervals), the device's idle gaps by the innermost span
open at each gap's middle, device time by innermost span, coverage, launches
by span, and the agreement of the records with the profiler's annotations.
:data:`METRICS` names the per-layer readings a cell's ``--trace 1`` run can
take from such a pass; :func:`read` returns None where a run has none.

Command line, on a machine with a card, from the root of a checkout: one
cell's spans, and what ``tracing()`` costs off the profiler::

    python3 portbench/spans.py --workload burgers-train --seed 12345 \\
        --out build/spans

From one start (the cell's stretch of ``profile_epochs`` epochs or
``profile_rollouts`` rollouts after two warm-up ones), timed passes with
tracing off and on in turns (off, on, on, off, ...), the profiled pass the
traced run makes (``portbench.trace.profile``), and the spanned pass.  It
prints one JSON object and writes it to ``<out>/<workload>.json``.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import gc
import json
import os
import statistics
import sys
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, Optional

NO_SPAN = "host (no span)"


class Spanned:
    """A spanned pass: ``device_ops`` ``(name, start_ns, end_ns,
    correlation)``, ``launches`` (correlation -> the launch's start_ns),
    ``annotations`` ``(name, start_ns, end_ns)``, ``spans`` (the records of
    the thread that ran the pass, as ``tracing()`` gave them), the pass's
    ``t0_ns`` and ``t1_ns`` on the same clock, and ``steps``."""

    def __init__(self, device_ops, launches, annotations, spans, t0_ns,
                 t1_ns, steps):
        self.device_ops = sorted(device_ops, key=lambda o: o[1])
        self.launches = launches
        self.annotations = annotations
        self.spans = [s for s in spans if s.end_ns is not None]
        self.t0_ns = t0_ns
        self.t1_ns = t1_ns
        self.steps = steps
        self.by_id = {s.id: s for s in self.spans}
        self._chains: Dict[Optional[int], tuple] = {None: ()}
        self.bounds, self.labels = timeline(
            [(s.start_ns, s.end_ns, s.id) for s in self.spans])
        self.charged = [self.innermost(launches.get(corr))
                        for _, _, _, corr in self.device_ops]

    # ------------------------------------------------------------ charging --
    def innermost(self, t: Optional[int]) -> Optional[int]:
        """The id of the innermost span open at ``t`` (None: none, or no
        time)."""
        if t is None:
            return None
        i = bisect.bisect_right(self.bounds, t) - 1
        return self.labels[i] if i >= 0 else None

    def chain(self, span_id: Optional[int]) -> tuple:
        """The names of a span and of every span it lies in."""
        if span_id not in self._chains:
            s = self.by_id[span_id]
            self._chains[span_id] = (s.name,) + self.chain(s.parent)
        return self._chains[span_id]

    # ---------------------------------------------------------------- host --
    def host_ms(self, name: str) -> Optional[float]:
        """The summed duration of the spans named ``name`` a step."""
        if not self.spans or not self.steps:
            return None
        return 1e-6 * sum(s.end_ns - s.start_ns for s in self.spans
                          if s.name == name) / self.steps

    def own_ms(self, outer=("epoch", "ema"), inner="step") -> Optional[float]:
        """The ``outer`` spans' time outside the ``inner`` spans below
        them, a step: the loop's own time."""
        if not self.spans or not self.steps:
            return None
        total = 0
        for s in self.spans:
            if s.name in outer:
                total += s.end_ns - s.start_ns
            elif s.name == inner and set(self.chain(s.parent)) & set(outer):
                total -= s.end_ns - s.start_ns
        return 1e-6 * total / self.steps

    # -------------------------------------------------------------- device --
    def device_ms(self, name: str) -> Optional[float]:
        """The device's busy time a step in the operations launched inside
        a span named ``name`` (its children's included)."""
        if not self.spans or not self.device_ops or not self.steps:
            return None
        ops = [o for o, sid in zip(self.device_ops, self.charged)
               if name in self.chain(sid)]
        return 1e3 * union_s(ops) / self.steps

    def device_ms_by_span(self, k: int = 10):
        """Device time (ms, the whole pass) by the innermost span each
        operation was launched in, the ``k`` largest."""
        by = defaultdict(list)
        for op, sid in zip(self.device_ops, self.charged):
            by[NO_SPAN if sid is None else self.by_id[sid].name].append(op)
        return sorted(([n, 1e3 * union_s(ops)] for n, ops in by.items()),
                      key=lambda x: -x[1])[:k]

    def idle_gaps(self):
        """``(start_ns, end_ns)`` of each stretch of the pass with no
        device operation running."""
        gaps, end = [], self.t0_ns
        for _, s, e, _ in self.device_ops:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if end < self.t1_ns:
            gaps.append((end, self.t1_ns))
        return gaps

    def idle_gaps_by_span(self, k: int = 10):
        """Idle seconds summed by the innermost span open at each gap's
        middle, or ``host (no span)``, the ``k`` largest."""
        by = defaultdict(float)
        for a, b in self.idle_gaps():
            sid = self.innermost((a + b) // 2)
            by[NO_SPAN if sid is None else self.by_id[sid].name] += (
                b - a) * 1e-9
        return sorted(([n, t] for n, t in by.items()),
                      key=lambda x: -x[1])[:k]

    # ------------------------------------------------------------ coverage --
    def coverage(self) -> dict:
        """``host``: the share of the pass's time inside ``step`` spans;
        ``device``: the share of the device's busy time charged to a span;
        ``linked``: the share of device operations whose launch was
        found."""
        wall = self.t1_ns - self.t0_ns
        steps = sum(s.end_ns - s.start_ns for s in self.spans
                    if s.name == "step")
        busy = union_s(self.device_ops)
        charged = union_s([o for o, sid in zip(self.device_ops, self.charged)
                           if sid is not None])
        linked = sum(1 for o in self.device_ops if o[3] in self.launches)
        return {"host": steps / wall if wall > 0 else None,
                "device": charged / busy if busy > 0 else None,
                "linked": (linked / len(self.device_ops)
                           if self.device_ops else None)}

    def launches_by_span(self) -> Dict[str, Dict[str, float]]:
        """Kernel launches a step by the innermost span they were made in:
        each span's counter changes less its children's."""
        own = {s.id: dict(s.launches) for s in self.spans}
        for s in self.spans:
            if s.parent in own:
                for k, v in s.launches.items():
                    own[s.parent][k] -= v
        by = defaultdict(lambda: defaultdict(int))
        for s in self.spans:
            for k, v in own[s.id].items():
                by[s.name][k] += v
        steps = max(self.steps, 1)
        return {n: {k: v / steps for k, v in sorted(c.items()) if v}
                for n, c in sorted(by.items()) if any(c.values())}

    # --------------------------------------------------------------- clock --
    def clock(self) -> dict:
        """The records against the profiler's annotations of the same
        spans (matched by name, in order): each end's distance in µs
        (median, 90th percentile, largest), the spans matched, and the
        share of device time charged to the same span when the
        annotations' intervals stand in for the records'."""
        mine, theirs = defaultdict(list), defaultdict(list)
        for s in self.spans:
            mine[s.name].append(s)
        for name, a, b in self.annotations:
            if name in mine:
                theirs[name].append((a, b))
        offsets, pairs = [], []
        for name, spans in mine.items():
            found = sorted(theirs[name])
            if len(found) != len(spans):
                continue
            for s, (a, b) in zip(sorted(spans, key=lambda x: x.start_ns),
                                 found):
                offsets += [abs(s.start_ns - a) * 1e-3,
                            abs(b - s.end_ns) * 1e-3]
                pairs.append((a, b, s.id))
        if not offsets:
            return {"matched": 0}
        bounds, labels = timeline(pairs)
        same = total = 0
        for (_, s, e, corr), sid in zip(self.device_ops, self.charged):
            t = self.launches.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(bounds, t) - 1
            total += e - s
            if (labels[i] if i >= 0 else None) == sid:
                same += e - s
        q = sorted(offsets)
        return {"matched": len(pairs), "spans": len(self.spans),
                "median_us": statistics.median(q),
                "p90_us": q[int(0.9 * (len(q) - 1))], "max_us": q[-1],
                "same_charge": same / total if total else None}


def timeline(intervals):
    """``(bounds, labels)`` from properly nested ``(start, end, label)``
    intervals: the innermost one open at ``t`` is ``labels[i]`` for the
    last ``bounds[i] <= t`` (None: none open)."""
    events = []
    for a, b, label in intervals:
        events.append((a, 1, label))
        events.append((b, 0, label))
    # At one instant: closes first, then opens in the order they nest.
    order = sorted(range(len(events)), key=lambda i: (events[i][0],
                                                      events[i][1], i))
    stack, bounds, labels = [], [], []
    for i in order:
        t, opening, label = events[i]
        if opening:
            stack.append(label)
        elif stack and stack[-1] == label:
            stack.pop()
        else:
            stack.remove(label)
        top = stack[-1] if stack else None
        if bounds and bounds[-1] == t:
            labels[-1] = top
        else:
            bounds.append(t)
            labels.append(top)
    return bounds, labels


def union_s(ops) -> float:
    """The union of the operations' ``(name, start_ns, end_ns, ...)``
    intervals, in seconds."""
    busy, end = 0, None
    for op in sorted(ops, key=lambda o: o[1]):
        s, e = op[1], op[2]
        if end is not None and e <= end:
            continue
        busy += e - (s if end is None else max(s, end))
        end = e
    return busy * 1e-9


def _sync():
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def event_kind(e) -> str:
    """A Kineto event's kind: ``device`` (an operation on the card),
    ``launch`` (a CUDA runtime or driver call on the host: ``cuda*``,
    ``cu*``; its correlation id is its device operation's), ``annotation``
    (a span's host annotation), or ``other`` (a host operation, or the
    card's copy of an annotation, which spans the kernels under it and is
    no operation)."""
    cuda = "cuda" in str(e.device_type()).lower()
    if e.is_user_annotation():
        return "other" if cuda else "annotation"
    if cuda:
        return "device"
    return "launch" if e.name().startswith("cu") else "other"


def spanned_profile(fn: Callable[[], int]) -> Spanned:
    """Run ``fn`` (which returns how many steps it took) under the profiler
    (CPU and, with a card, CUDA) inside ``tracing()``."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from pigs_tpu_torch.utils.profiling import tracing
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    _sync()
    with torch_profile(activities=activities) as prof:
        with tracing() as records:
            t0 = time.time_ns()
            steps = fn()
            _sync()
            t1 = time.time_ns()
    me = threading.get_ident()
    dev, launches, annotations = [], {}, []
    for e in prof.profiler.kineto_results.events():
        kind = event_kind(e)
        if kind == "device" and e.end_ns() > e.start_ns():
            dev.append((e.name(), e.start_ns(), e.end_ns(),
                        e.correlation_id()))
        elif kind == "launch":
            launches[e.correlation_id()] = e.start_ns()
        elif kind == "annotation":
            annotations.append((e.name(), e.start_ns(), e.end_ns()))
    return Spanned(dev, launches, annotations,
                   [r for r in records if r.thread == me], t0, t1, steps)


# --------------------------------------------------------------- metrics --
# Per-layer readings of a cell's spanned pass: name -> (driver, reading).
METRICS = {
    "network_host_ms.train": ("train", lambda s: s.host_ms("network")),
    "backward_host_ms.train": ("train",
                               lambda s: s.host_ms("step.backward")),
    "split_host_ms.train": ("train", lambda s: s.host_ms("step.split")),
    "loop_host_ms.train": ("train", lambda s: s.own_ms()),
    "network_device_ms.train_device": ("train",
                                       lambda s: s.device_ms("network")),
    "backward_device_ms.train_device": (
        "train", lambda s: s.device_ms("step.backward")),
    "split_device_ms.train_device": ("train",
                                     lambda s: s.device_ms("step.split")),
    "network_host_ms.rollout": ("rollout", lambda s: s.host_ms("network")),
}


def read(name: str, run) -> Optional[float]:
    """The metric ``name`` of a traced run (``readings.TracedRun``) from
    its spanned pass (``run.result["spanned_profile"]``); None where the
    run has no spans, or the metric is not its driver's."""
    driver, reading = METRICS[name]
    spanned = run.result.get("spanned_profile")
    if run.driver != driver or spanned is None or not spanned.spans:
        return None
    return reading(spanned)


def breakdown(spanned: Spanned) -> dict:
    """The two breakdowns of a spanned pass."""
    return {"idle_gaps_by_span": spanned.idle_gaps_by_span(10),
            "device_ms_by_span": spanned.device_ms_by_span(10)}


# ----------------------------------------------------------- measurement --
def cell_stretch(cell, seed: int, device, overrides=None):
    """The cell's stretch from a warmed-up program: ``(fn, rewind)``;
    ``fn()`` runs it and returns its steps, ``rewind()`` puts the program
    and the draws back to the start."""
    import torch
    if cell.traffic["driver"] == "train":
        from portbench.drivers import train
        prog = train.Program(cell, device, overrides)
        length = prog.tcfg.train_timesteps
        g = torch.Generator().manual_seed(seed)
        epoch = train.first_epoch(cell) + len(cell.traffic["check_steps"])
        for i in range(2):
            prog.epoch(g, epoch + i, length)
        first = epoch + 2

        def fn():
            return sum(prog.epoch(g, first + i, length)[2]
                       for i in range(cell.traffic["profile_epochs"]))
        snap, g0 = prog.snapshot(), g.get_state()

        def rewind():
            prog.restore(snap)
            g.set_state(g0)
        return fn, rewind
    from portbench.drivers import rollout
    prog = rollout.Program(cell, device, overrides)
    requests = rollout.Requests(cell, seed, device)
    n = cell.traffic["profile_rollouts"]
    for i in range(2):
        prog(requests.state(i)).cpu()

    def fn():
        for j in range(n):
            prog(requests.state(2 + j)).cpu()
        return n * prog.steps
    return fn, lambda: None


def timed(fn, on: bool):
    """``fn``'s wall time and steps, the collector off, with or without
    ``tracing()``."""
    from pigs_tpu_torch.utils.profiling import tracing
    gc.collect()
    gc.disable()
    try:
        with tracing() if on else contextlib.nullcontext():
            _sync()
            t0 = time.perf_counter()
            steps = fn()
            _sync()
            wall = time.perf_counter() - t0
    finally:
        gc.enable()
    return wall, steps


def span_cost_us(n: int = 20000) -> dict:
    """Host microseconds an empty span costs, tracing off and on (no
    profiler)."""
    from pigs_tpu_torch.utils.profiling import span, tracing
    out = {}
    for on in (False, True):
        with tracing() if on else contextlib.nullcontext():
            t0 = time.perf_counter_ns()
            for _ in range(n):
                with span("cost"):
                    pass
            out["on" if on else "off"] = (time.perf_counter_ns() - t0) \
                * 1e-3 / n
    return out


def measure(cell, seed: int, device, overrides=None, pairs: int = 2) -> dict:
    """Tracing's cost off the profiler, the profiled and the spanned pass's
    wall times, and the spanned pass's readings, all from one start."""
    from portbench import trace
    fn, rewind = cell_stretch(cell, seed, device, overrides)
    ms = {"off": [], "on": []}
    for i in range(2 * pairs):
        on = (i % 4) in (1, 2)
        rewind()
        wall, steps = timed(fn, on)
        ms["on" if on else "off"].append(1e3 * wall / max(steps, 1))
    rewind()
    profiled = trace.profile(fn)
    rewind()
    t0 = time.perf_counter()
    spanned = spanned_profile(fn)
    spanned_wall = time.perf_counter() - t0
    metrics = {}
    for name, (driver, reading) in METRICS.items():
        value = reading(spanned) if driver == cell.traffic["driver"] else None
        if value is not None:
            metrics[name] = value
    names = sorted({s.name for s in spanned.spans})
    return {
        "workload": cell.name, "seed": seed, "steps": spanned.steps,
        "host_ms_per_step": ms,
        "tracing_cost": (statistics.median(ms["on"])
                         / statistics.median(ms["off"]) - 1.0),
        "span_cost_us": span_cost_us(),
        "spans_per_step": len(spanned.spans) / max(spanned.steps, 1),
        "profiled_wall_s": profiled.wall_s,
        "spanned_wall_s": (spanned.t1_ns - spanned.t0_ns) * 1e-9,
        "spanned_with_collection_s": spanned_wall,
        "spanned_step_ms": 1e-6 * (spanned.t1_ns - spanned.t0_ns)
        / max(spanned.steps, 1),
        "metrics": metrics,
        "breakdown": breakdown(spanned),
        "coverage": spanned.coverage(),
        "clock": spanned.clock(),
        "host_ms_by_span": {n: spanned.host_ms(n) for n in names},
        "device_ms_by_span_inclusive": {n: spanned.device_ms(n)
                                        for n in names},
        "launches_by_span": spanned.launches_by_span(),
        "device_ops_per_step": len(spanned.device_ops)
        / max(spanned.steps, 1),
        "profiled_device_ops_per_step": len(profiled.device_ops)
        / max(profiled.steps, 1),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--pairs", type=int, default=2,
                   help="pairs of timed passes, tracing off and on")
    p.add_argument("--out", default=None,
                   help="directory for <workload>.json")
    args = p.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from portbench import common
    from portbench.run import power_limit, set_environment
    set_environment()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: the spans are measured on the GPU",
              file=sys.stderr)
        return 2
    cell = common.Cell(common.load_benchmark(), args.workload)
    common.check_fixtures(cell.config)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.set_num_threads(1)
    out = measure(cell, args.seed, device, pairs=args.pairs)
    out["device"] = power_limit()
    text = json.dumps(out)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, args.workload + ".json"), "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
