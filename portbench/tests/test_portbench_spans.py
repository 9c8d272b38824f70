"""The program's spans in a profiled pass (``portbench/spans.py``): the
charging of device operations to spans through their launches, the
readings, and the per-layer metrics that return None on a run without
spans."""

import pytest
import torch

from portbench import spans
from portbench.tests import tiny
from pigs_tpu_torch.utils.profiling import SpanRecord

MS = 1_000_000          # ns


def record(i, parent, name, a, b, **launches):
    r = SpanRecord(i, parent, name, 1)
    r.start_ns, r.end_ns = a * MS, b * MS
    r.launches = {k: launches.get(k, 0) for k in ("k1", "k2", "k3", "k4",
                                                  "k5")}
    return r


def synthetic(with_spans=True):
    """Two steps' worth of one epoch, in ms: epoch 0-100 holding a step
    10-90 (network 12-30 with its inputs and forward, backward 40-70,
    split 75-85), then ema 95-99; the pass ends at 110, a gap with no span
    open.  Operation 2 was launched by another thread (autograd's) during
    ``step.backward``; operation 4 has no launch event."""
    records = [record(0, None, "epoch", 0, 100, k1=3, k2=1),
               record(1, 0, "step", 10, 90, k1=3, k2=1),
               record(2, 1, "network", 12, 30, k1=1),
               record(3, 2, "network.inputs", 13, 20, k1=1),
               record(4, 2, "network.forward", 21, 29),
               record(5, 1, "step.backward", 40, 70, k2=1),
               record(6, 1, "step.split", 75, 85, k1=2),
               record(7, None, "ema", 95, 99)]
    ops = [("k1", 15 * MS, 25 * MS, 1), ("gemm", 52 * MS, 60 * MS, 2),
           ("split", 81 * MS, 84 * MS, 3), ("lost", 86 * MS, 87 * MS, 4),
           ("ema", 98 * MS, 99 * MS, 5)]
    launches = {1: 14 * MS, 2: 50 * MS, 3: 80 * MS, 5: 97 * MS}
    annotations = [(r.name, r.start_ns - 1000, r.end_ns + 2000)
                   for r in records]
    return spans.Spanned(ops, launches, annotations,
                         records if with_spans else [], 0, 110 * MS, 2)


def test_charging_through_launches():
    s = synthetic()
    names = [None if sid is None else s.by_id[sid].name for sid in s.charged]
    assert names == ["network.inputs", "step.backward", "step.split", None,
                     "ema"]
    assert s.chain(3) == ("network.inputs", "network", "step", "epoch")


def test_readings():
    s = synthetic()
    assert s.host_ms("network") == pytest.approx(9.0)        # 18 ms / 2
    assert s.host_ms("step.backward") == pytest.approx(15.0)
    assert s.host_ms("step.split") == pytest.approx(5.0)
    assert s.own_ms() == pytest.approx((100 + 4 - 80) / 2)
    assert s.device_ms("network") == pytest.approx(5.0)      # 10 ms / 2
    assert s.device_ms("step.backward") == pytest.approx(4.0)
    assert s.device_ms("step.split") == pytest.approx(1.5)
    assert s.device_ms("step") == pytest.approx(10.5)
    cov = s.coverage()
    assert cov["host"] == pytest.approx(80 / 110)
    assert cov["device"] == pytest.approx(22 / 23)
    assert cov["linked"] == pytest.approx(4 / 5)
    assert s.launches_by_span() == {"network.inputs": {"k1": 0.5},
                                    "step.backward": {"k2": 0.5},
                                    "step.split": {"k1": 1.0}}
    clock = s.clock()
    assert clock["matched"] == 8 and clock["median_us"] == pytest.approx(1.5)
    assert clock["max_us"] == pytest.approx(2.0)
    assert clock["same_charge"] == 1.0


def test_breakdowns_name_the_spans():
    out = spans.breakdown(synthetic())
    gaps = dict(out["idle_gaps_by_span"])
    # By the span open at each gap's middle: 0-15 and 87-98 the epoch's
    # own time, 25-52, 60-81 and 84-86 the step's (the split closes at 85:
    # a close comes before anything at its instant), 99-110 no span.
    assert gaps == pytest.approx({"epoch": 0.026, "step": 0.050,
                                  spans.NO_SPAN: 0.011})
    dev = dict(out["device_ms_by_span"])
    assert dev == pytest.approx({"network.inputs": 10.0,
                                 "step.backward": 8.0, "step.split": 3.0,
                                 spans.NO_SPAN: 1.0, "ema": 1.0})


def test_timeline_nests_and_ties():
    bounds, labels = spans.timeline([(0, 10, "a"), (0, 5, "b"),
                                     (5, 10, "c")])
    assert bounds == [0, 5, 10] and labels == ["b", "c", None]


class Run:
    def __init__(self, driver, result):
        self.driver = driver
        self.result = result


@pytest.mark.parametrize("name", sorted(spans.METRICS))
def test_every_metric_is_none_without_spans(name):
    driver = spans.METRICS[name][0]
    assert spans.read(name, Run(driver, {})) is None
    assert spans.read(name, Run(driver, {
        "spanned_profile": synthetic(with_spans=False)})) is None
    other = "rollout" if driver == "train" else "train"
    assert spans.read(name, Run(other, {
        "spanned_profile": synthetic()})) is None
    assert spans.read(name, Run(driver, {
        "spanned_profile": synthetic()})) > 0


@pytest.mark.parametrize("workload", ["burgers-train", "burgers-rollout"])
def test_measure_on_the_cpu(workload):
    """The command line's passes at a CPU test's size: the host readings,
    every span matched to its annotation, no device readings."""
    c, overrides = tiny.cell(workload)
    out = spans.measure(c, 11, torch.device("cpu"), overrides, pairs=1)
    assert len(out["host_ms_per_step"]["off"]) == 1
    assert len(out["host_ms_per_step"]["on"]) == 1
    want = {"burgers-train": {"network_host_ms.train",
                              "backward_host_ms.train",
                              "split_host_ms.train", "loop_host_ms.train"},
            "burgers-rollout": {"network_host_ms.rollout"}}[workload]
    assert set(out["metrics"]) == want
    assert out["clock"]["matched"] == out["clock"]["spans"] > 0
    assert 0 < out["coverage"]["host"] <= 1
    assert out["device_ops_per_step"] == 0
    steps = out["steps"]
    per = c.config["recipe"]["train_timesteps"] * c.traffic[
        "profile_epochs"] if workload.endswith("train") else \
        c.config["rollout"]["steps"] * c.traffic["profile_rollouts"]
    assert steps == per
