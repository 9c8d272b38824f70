"""The result line: its keys, in order, with ``checks`` last."""

import importlib.util
import json
import os

import pytest
import torch

from portbench import trace
from portbench.drivers import train
from portbench.tests import tiny

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_run():
    spec = importlib.util.spec_from_file_location(
        "portbench_run", os.path.join(HERE, "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


DEVICE = {"platform": "gpu", "kind": "test", "count": 1,
          "memory_peak_bytes": 1}


@pytest.fixture(scope="module")
def result():
    c, overrides = tiny.cell("burgers-train")
    return c, train.run(c, 11, 0.2, None, torch.device("cpu"), overrides)


def test_untraced_line(result):
    c, out = result
    line = load_run().result_line(c, "train", out, False, DEVICE)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True
    assert set(line["metrics"]) == {"setup_s", "train_step_ms"}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert set(line["checks"]) == {"loss_gap", "grad_gap", "update_gap",
                                   "window_update_gap", "window_count_gap"}
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())
    json.loads(json.dumps(line))


def test_traced_line_and_unreadable_metrics(result):
    c, out = result
    out = dict(out)
    out["profile"] = trace.Profile(
        [("mixture_fwd_kernel<2, 1, 2>", 0.0, 0.001), ("elementwise", 0.002,
                                                       0.003)],
        [("aten::add", 0.0015, 0.0016)], 0.004, 2)
    out["stretch_records"] = {"k1": [], "k2": [], "net": []}
    out["stretch_s"] = 0.004
    line = load_run().result_line(c, "train", out, True, DEVICE)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    # Without records nothing is attributed: no roofline, no mfu.
    assert set(line["metrics"]) == {"idle_share.train",
                                    "device_ops_per_step.train"}
    assert line["metrics"]["idle_share.train"]["value"] == pytest.approx(50.0)
    assert line["metrics"]["device_ops_per_step.train"]["value"] == 1.0
    assert line["device"]["busy_s"] == pytest.approx(0.002)
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_infinite_reading_prints_as_a_number():
    run = load_run()
    assert run.finite(float("inf")) > 1e300
    assert run.finite(0.5) == 0.5


def test_device_timed_cell_reports_its_own_metrics(result):
    """A cell whose end-to-end step time is the device's reports that and
    set-up untraced, and traced the host's window time and the readers
    that move the device's time."""
    _, out = result
    from portbench import common
    c = common.Cell(common.load_benchmark(), "ns-train")
    out = dict(out, metrics=dict(out["metrics"], train_device_ms=5.4))
    line = load_run().result_line(c, "train", out, False, DEVICE)
    assert set(line["metrics"]) == {"setup_s", "train_device_ms"}
    out["profile"] = trace.Profile(
        [("mixture_fwd_kernel<2, 1, 2>", 0.0, 0.001), ("elementwise", 0.002,
                                                       0.003)],
        [], 0.004, 2)
    out["stretch_records"] = {"k1": [], "k2": [], "net": []}
    out["stretch_s"] = 0.004
    line = load_run().result_line(c, "train", out, True, DEVICE)
    assert set(line["metrics"]) == {"train_step_ms.host",
                                    "device_ops_per_step.train_device"}
    assert (line["metrics"]["train_step_ms.host"]["value"]
            == out["metrics"]["train_step_ms"])


def test_device_only_profile_on_the_cpu_records_nothing():
    prof = trace.profile(lambda: 3, host=False)
    if not torch.cuda.is_available():
        assert prof.device_ops == [] and prof.host_ops == []
    assert prof.steps == 3 and prof.wall_s >= 0.0
