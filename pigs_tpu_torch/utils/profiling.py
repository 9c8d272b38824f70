"""Timers and profiler traces (port of :mod:`pigs_tpu.utils.profiling`).

``Timer`` accumulates wall-clock time per name and waits for the device
before it stops the clock when given tensors to wait for; ``trace`` records
a ``torch.profiler`` trace (the card's kernels too, when there is one) and
writes it as a Chrome-trace JSON, which Perfetto reads.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch

__all__ = ["Timer", "trace"]


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


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Profile the block with ``torch.profiler`` (CPU activity, and the
    card's when CUDA is available) and write the trace as
    ``log_dir/trace_<pid>_<ns>.json`` on exit; a no-op when ``log_dir`` is
    None.  Open the file in Perfetto (ui.perfetto.dev)."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
