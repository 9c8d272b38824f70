"""Timers, program spans and profiler traces (port of
:mod:`pigs_tpu.utils.profiling`, plus the spans).

``Timer`` accumulates wall-clock time per name and waits for the device
before it stops the clock when given tensors to wait for; ``trace`` records
a ``torch.profiler`` trace (the card's kernels too, when there is one) and
writes it as a Chrome-trace JSON, which Perfetto reads.

``span(name)`` marks a stretch of the program at a layer boundary (the
training loop, a step, the network, the no-MLP solve); the spans are
recorded only inside ``tracing()``, their one on-switch.  Off, a span is a
shared no-op context behind one module-level check: it allocates nothing,
reads no counter and adds no device operation or host sync.  On, each span
appends a :class:`SpanRecord` (its id, the id of the innermost span open on
the same thread, its name, start and end on ``time.time_ns``'s clock,
which is the profiler's, and the change across it of the kernels' launch
counters K1-K6 and of the no-MLP solver's counters) and enters
``torch.profiler.record_function(name)``, so a profile or a ``trace`` file
shows it as a user annotation.  Open spans only on the thread
that calls the program, never inside an autograd ``Function.backward``
(which runs on autograd's device thread): a launch made there while the
caller waits in ``torch.autograd.grad`` falls inside the caller's span on
the clock, and the counters, which are process-wide, count it there.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List, Optional

import torch

__all__ = ["Timer", "trace", "span", "tracing", "SpanRecord"]


def _cuda_devices(x, found: set) -> set:
    """The CUDA devices of the tensors in ``x``: a tensor, or a (nested)
    sequence of them, ``None`` entries allowed."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            found.add(x.device)
    elif isinstance(x, (list, tuple)):
        for item in x:
            _cuda_devices(item, found)
    return found


class Timer:
    """Accumulating wall-clock timer that waits for the card.

    >>> t = Timer()
    >>> with t("evolve", sync=state):
    ...     state = step(state)
    >>> t.totals()["evolve"]

    ``sync`` is a tensor or a (nested) sequence of tensors; the clock stops
    after ``torch.cuda.synchronize`` on each CUDA device they live on (CPU
    tensors are ready when the call returns).
    """

    def __init__(self):
        self._totals: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str, sync=None):
        start = time.perf_counter()
        try:
            yield
        finally:
            for device in _cuda_devices(sync, set()):
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - start
            self._totals[name] = self._totals.get(name, 0.0) + dt
            self._counts[name] = self._counts.get(name, 0) + 1

    def totals(self) -> Dict[str, float]:
        return dict(self._totals)

    def means(self) -> Dict[str, float]:
        return {k: v / self._counts[k] for k, v in self._totals.items()}

    def report(self) -> str:
        return "  ".join(f"{k}: {v*1e3:.2f}ms (x{self._counts[k]})"
                         for k, v in sorted(self._totals.items()))


# The kernels' launch counters a span reads: (label, module, global).
LAUNCHES = (("k1", "mixture_kernel", "launches"),
            ("k2", "mixture_kernel", "bwd_gauss_launches"),
            ("k3", "mixture_kernel", "bwd_sample_launches"),
            ("k4", "aggregate_kernel", "fwd_launches"),
            ("k5", "aggregate_kernel", "bwd_launches"),
            ("k6", "optim_kernel", "launches"))
# The no-MLP solver's counters, read across spans as the launch counters
# are: Adam iterations, blocks, timesteps stopped by the convergence rule
# and by ``max_iters``, densify calls.
SOLVER_COUNTERS = (("solve_iters", "no_mlp", "iterations"),
                   ("solve_blocks", "no_mlp", "blocks"),
                   ("solve_stop_tol", "no_mlp", "stopped_tol"),
                   ("solve_stop_cap", "no_mlp", "stopped_cap"),
                   ("solve_densify", "no_mlp", "densify_calls"))


class SpanRecord:
    """One span as :func:`tracing` records it: ``id`` (its index in the
    records), ``parent`` (the id of the innermost span open on the same
    thread when it opened, or None), ``name``, ``thread``
    (``threading.get_ident()``), ``start_ns`` and ``end_ns`` (``time.time_ns``;
    ``end_ns`` is None while it is open) and ``launches``, the change of
    each counter of :data:`LAUNCHES` and :data:`SOLVER_COUNTERS` across it,
    by label (its children's included)."""

    __slots__ = ("id", "parent", "name", "thread", "start_ns", "end_ns",
                 "launches")

    def __init__(self, id: int, parent: Optional[int], name: str,
                 thread: int):
        self.id = id
        self.parent = parent
        self.name = name
        self.thread = thread
        self.start_ns = 0
        self.end_ns: Optional[int] = None
        self.launches: Dict[str, int] = {}


class _Tracing:
    """The records of one :func:`tracing` block and its open spans, a stack
    per thread."""

    def __init__(self):
        from pigs_tpu_torch.ops import (aggregate_kernel, mixture_kernel,
                                        optim_kernel)
        from pigs_tpu_torch.train import no_mlp
        modules = {"mixture_kernel": mixture_kernel,
                   "aggregate_kernel": aggregate_kernel,
                   "optim_kernel": optim_kernel, "no_mlp": no_mlp}
        self.counters = [(label, modules[module], name)
                         for label, module, name
                         in LAUNCHES + SOLVER_COUNTERS]
        self.records: List[SpanRecord] = []
        self.lock = threading.Lock()
        self.local = threading.local()

    def counts(self) -> List[int]:
        return [getattr(module, name) for _, module, name in self.counters]


_tracing: Optional[_Tracing] = None
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "tracing", "record", "annotation", "counts")

    def __init__(self, name: str, tracing_: _Tracing):
        self.name = name
        self.tracing = tracing_

    # The clock is read next to the annotation's own reads, so that the
    # record and the annotation agree to a few microseconds.
    def __enter__(self):
        tr = self.tracing
        stack = getattr(tr.local, "stack", None)
        if stack is None:
            stack = tr.local.stack = []
        with tr.lock:
            self.record = SpanRecord(len(tr.records),
                                     stack[-1].id if stack else None,
                                     self.name, threading.get_ident())
            tr.records.append(self.record)
        stack.append(self.record)
        self.counts = tr.counts()
        self.annotation = torch.profiler.record_function(self.name)
        self.annotation.__enter__()
        self.record.start_ns = time.time_ns()
        return self.record

    def __exit__(self, *exc):
        self.record.end_ns = time.time_ns()
        self.annotation.__exit__(*exc)
        tr = self.tracing
        self.record.launches = {
            label: after - before for (label, _, _), before, after
            in zip(tr.counters, self.counts, tr.counts())}
        tr.local.stack.pop()
        return False


def span(name: str):
    """A context manager around one stretch of the program, recorded as
    ``name`` inside :func:`tracing` and nothing outside it."""
    if _tracing is None:
        return _OFF
    return _Span(name, _tracing)


@contextlib.contextmanager
def tracing():
    """Record every :func:`span` of the process inside the block; yields
    the list of :class:`SpanRecord` it fills, in the order the spans
    opened.  A ``tracing()`` inside another shares the outer one's list."""
    global _tracing
    if _tracing is not None:
        yield _tracing.records
        return
    _tracing = _Tracing()
    try:
        yield _tracing.records
    finally:
        _tracing = None


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Profile the block with ``torch.profiler`` (CPU activity, and the
    card's when CUDA is available) inside :func:`tracing`, so the program's
    spans show as user annotations above the operations they ran, and
    write the trace as ``log_dir/trace_<pid>_<ns>.json`` on exit; a no-op
    when ``log_dir`` is None.  Open the file in Perfetto
    (ui.perfetto.dev)."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    with tracing():
        prof.start()
        try:
            yield
        finally:
            prof.stop()
            prof.export_chrome_trace(os.path.join(
                log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
