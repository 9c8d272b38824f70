"""The port's timers and profiler traces (pigs_tpu_torch.utils.profiling)
against the JAX package's (CPU).

* ``Timer``: the same totals, means and report string as JAX's ``Timer``
  for the same recorded times, and ``sync`` takes tensors, nested sequences
  and ``None`` entries (CPU tensors need no wait).
* ``trace``: writes a Chrome-trace JSON under ``log_dir`` that loads and
  names the profiled op; ``None`` records nothing.
"""

import json

import pytest
import torch

from pigs_tpu.utils.profiling import Timer as JTimer
from pigs_tpu_torch.utils.profiling import Timer, trace


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


def test_trace_none_records_nothing(tmp_path):
    with trace(None):
        torch.ones(2) + 1
    assert not any(tmp_path.iterdir())
