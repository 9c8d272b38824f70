"""Tracing for ``--trace 1`` runs: per-call records at the layer boundaries,
a profiler window, and its reduction to the numbers the metric readers
take.

Records.  :class:`Recorder` wraps, while installed, the program's
kernel-layer entry points ``mixture_kernel.mixture_forward`` (K1) and
``mixture_kernel.mixture_backward_gauss`` (K2), and the network's
``DynamicsNetwork.forward``.  Each call appends its shapes and, as 0-d
device tensors read afterwards, its active Gaussians and neighbour pairs:
nothing waits for the device.

Profile.  :func:`profile` runs a callable under ``torch.profiler`` (CPU and
CUDA) and keeps, from the raw Kineto events, every device operation
(kernel, copy, set) with its interval and every host operation with its
interval on the calling thread.

Stretch.  :func:`stretch` runs the same work three times from the same
start: recorded (the Recorder installed, nothing profiled), profiled (no
Recorder: its counting kernels and host calls would read as the
program's), and timed on the host clock with neither.  Neither the window
nor the profile runs anything of the harness's.
"""

from __future__ import annotations

import bisect
import gc
import time
from collections import defaultdict
from typing import Callable, Dict, List

import numpy as np

# Device kernels of K1 and K2 by name: the main pass and its slice-combine.
FAMILIES = {"k1": ("mixture_fwd_kernel", "FwdStore"),
            "k2": ("bwd_gauss_partial_kernel", "GaussStore")}
MAIN_KERNEL = {"k1": "mixture_fwd_kernel", "k2": "bwd_gauss_partial_kernel"}


class Recorder:
    """Per-call records of K1, K2 and the network while installed."""

    def __init__(self):
        self.calls: Dict[str, list] = {"k1": [], "k2": [], "net": []}
        self._undo: List[Callable] = []

    def install(self):
        import torch
        from pigs_tpu_torch.models import dynamics
        from pigs_tpu_torch.ops import mixture_kernel as mk

        def active_rows(values):
            return (values != 0).any(dim=-1).sum()

        fwd, bwd = mk.mixture_forward, mk.mixture_backward_gauss
        net_forward = dynamics.DynamicsNetwork.forward

        def mixture_forward(means, conics_packed, values, samples, order,
                            period=None):
            same = samples.data_ptr() == means.data_ptr()
            self.calls["k1"].append(
                (None if same else samples.shape[0], active_rows(values),
                 order, values.shape[1], period is not None))
            return fwd(means, conics_packed, values, samples, order, period)

        def mixture_backward_gauss(means, conics_packed, values, samples,
                                   cots, order, period=None):
            self.calls["k2"].append(
                (samples.shape[0], active_rows(values), order,
                 values.shape[1], period is not None))
            return bwd(means, conics_packed, values, samples, cots, order,
                       period)

        def forward(net, *args, **kw):
            active, nbr = args[8], args[9]
            self.calls["net"].append((active.sum(), nbr.sum(),
                                      torch.is_grad_enabled()))
            return net_forward(net, *args, **kw)

        mk.mixture_forward = mixture_forward
        mk.mixture_backward_gauss = mixture_backward_gauss
        dynamics.DynamicsNetwork.forward = forward
        self._undo = [lambda: setattr(mk, "mixture_forward", fwd),
                      lambda: setattr(mk, "mixture_backward_gauss", bwd),
                      lambda: setattr(dynamics.DynamicsNetwork, "forward",
                                      net_forward)]

    def uninstall(self):
        for undo in self._undo:
            undo()
        self._undo = []

    def take(self) -> Dict[str, list]:
        """The records so far with their device counts read, and a fresh
        start."""
        import torch
        out = {}
        for key, rows in self.calls.items():
            counts = [x for r in rows for x in r if torch.is_tensor(x)]
            host = torch.stack(counts).cpu().tolist() if counts else []
            it = iter(host)
            out[key] = [tuple(next(it) if torch.is_tensor(x) else x
                              for x in r) for r in rows]
        self.calls = {k: [] for k in self.calls}
        return out


class Profile:
    """A profiled stretch: device operations ``(name, start, end)`` and
    host operations ``(name, start, end)`` in seconds from its start, its
    wall time, and what the caller counted in it (``steps``)."""

    def __init__(self, device_ops, host_ops, wall_s, steps):
        self.device_ops = device_ops
        self.host_ops = host_ops
        self.wall_s = wall_s
        self.steps = steps

    def busy_s(self) -> float:
        """The union of the device operations' intervals."""
        busy, end = 0.0, -np.inf
        for _, s, e in sorted(self.device_ops, key=lambda x: x[1]):
            if e <= end:
                continue
            busy += e - max(s, end)
            end = e
        return busy

    def idle_gaps(self):
        """``(start, end)`` of every stretch of the window with no device
        operation running."""
        gaps, end = [], 0.0
        for _, s, e in sorted(self.device_ops, key=lambda x: x[1]):
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if end < self.wall_s:
            gaps.append((end, self.wall_s))
        return gaps

    def family(self, fam: str):
        names = FAMILIES[fam]
        ops = [o for o in self.device_ops if any(n in o[0] for n in names)]
        main = sum(1 for o in ops if MAIN_KERNEL[fam] in o[0])
        return sum(e - s for _, s, e in ops), main

    def top_device_ops(self, k: int = 10):
        by = defaultdict(float)
        for name, s, e in self.device_ops:
            by[short_name(name)] += e - s
        return sorted(([n, t] for n, t in by.items()), key=lambda x: -x[1])[:k]

    def top_idle_gaps(self, k: int = 10):
        """Idle time summed by what the host was doing: the host operation
        that started last before the middle of each gap."""
        ops = sorted(self.host_ops, key=lambda x: x[1])
        starts = [o[1] for o in ops]
        by = defaultdict(float)
        for a, b in self.idle_gaps():
            i = bisect.bisect_right(starts, 0.5 * (a + b)) - 1
            label = ops[i][0] if i >= 0 and ops[i][2] >= a else "host (no op)"
            by[label] += b - a
        return sorted(([n, t] for n, t in by.items()), key=lambda x: -x[1])[:k]


def short_name(name: str) -> str:
    """A kernel's name without namespaces' noise and parameter list."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(", 1)[0].strip()[:120]


def profile(fn: Callable[[], int], host: bool = True) -> Profile:
    """Run ``fn`` (which returns how many steps it took) under the profiler
    and keep its device and, with ``host``, its host operations.  Without
    ``host`` only the device's activity is recorded: no host operation is
    wrapped, and a run on the CPU records nothing."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile
    activities = [ProfilerActivity.CPU] if host else []
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    _sync()
    if not activities:
        t0 = time.perf_counter_ns()
        steps = fn()
        return Profile([], [], (time.perf_counter_ns() - t0) * 1e-9, steps)
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter_ns()
        steps = fn()
        _sync()
        t1 = time.perf_counter_ns()
    events = prof.profiler.kineto_results.events()
    dev, host_ops = [], []
    for e in events:
        if "cuda" in str(e.device_type()).lower():
            dev.append((e.name(), e.start_ns(), e.end_ns()))
        elif host:
            host_ops.append((e.name(), e.start_ns(), e.end_ns()))
    starts = [s for _, s, _ in dev + host_ops]
    origin = min(starts) if starts else 0
    wall = (t1 - t0) * 1e-9
    # The profiler's clock is not the host's perf counter: the window is
    # taken as [first event, first event + wall].
    def rel(rows):
        return [(n, (s - origin) * 1e-9, (e - origin) * 1e-9) for n, s, e
                in rows if e > s]
    return Profile(rel(dev), rel(host_ops), wall, steps)


def _sync():
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def stretch(fn: Callable[[], int], recorder: Recorder, snapshot=None,
            restore=None, generator=None) -> dict:
    """``fn`` (which returns how many steps it took) three times from the
    same start (``restore(snapshot())`` and ``generator``'s state between
    passes): recorded, profiled, and timed with the collector off.
    Returns ``stretch_records`` (the Recorder's), ``profile``,
    ``stretch_s`` (the timed pass's wall time) and ``stretch_steps``."""
    snap = snapshot() if snapshot is not None else None
    g0 = generator.get_state() if generator is not None else None

    def rewind():
        if restore is not None:
            restore(snap)
        if generator is not None:
            generator.set_state(g0)
    _sync()
    recorder.install()
    try:
        steps = fn()
    finally:
        recorder.uninstall()
    records = recorder.take()
    rewind()
    prof = profile(fn)
    rewind()
    gc.collect()
    gc.disable()
    _sync()
    t0 = time.perf_counter()
    fn()
    _sync()
    wall = time.perf_counter() - t0
    gc.enable()
    return {"stretch_records": records, "profile": prof, "stretch_s": wall,
            "stretch_steps": steps}


def records_match(records: list, main_launches: int) -> bool:
    """Whether the records account for the kernels the trace saw: the
    profiler may miss a launch or two of many; a path that launches the
    kernel without passing the recorded entry (a replayed graph) shows as
    a mismatch, and the readers then say nothing."""
    n = len(records)
    return n > 0 and abs(n - main_launches) <= max(2, 0.02 * n)
