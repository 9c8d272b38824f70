"""The work count against hand counts at tiny shapes: active pairs only,
masked slots left out."""

import pytest
import torch

from portbench import readings, trace, workcount


def test_pair_flop_by_hand():
    # geometry 11, weights (0, 0, 6, 16), one FMA per output component.
    assert workcount.mixture_pair_flop("fwd", 0, 1, False) == 11 + 2
    assert workcount.mixture_pair_flop("fwd", 2, 1, False) == 11 + 6 + 12
    assert workcount.mixture_pair_flop("fwd", 3, 2, True) == 11 + 8 + 16 + 40
    # backward: + one FMA into each of the 5 + c accumulators.
    assert workcount.mixture_pair_flop("bwd", 2, 1, False) == 29 + 12
    assert workcount.mixture_pair_flop("bwd", 3, 2, True) == 75 + 14


def test_mixture_work_by_hand():
    flop, sfu, nbytes = workcount.mixture_work("fwd", 3, 2, 0, 1, False)
    assert (flop, sfu, nbytes) == (6 * 13, 6, 4 * (2 * 3 + 6 * 2 + 3))
    flop, sfu, nbytes = workcount.mixture_work("bwd", 3, 2, 0, 1, False)
    assert flop == 6 * (13 + 12)
    assert nbytes == 4 * (2 * 3 + 6 * 2 + 3 + 3 + 6 * 2)


def test_bound_takes_the_slowest_resource():
    t, by = workcount.bound_s(67e12, 0.0, 0.0)
    assert (t, by) == (1.0, "FLOP")
    t, by = workcount.bound_s(0.0, 4.18e12 * 2, 3.35e12)
    assert (t, by) == (2.0, "SFU")


def test_recorder_counts_active_gaussians_only():
    from pigs_tpu_torch.ops.mixture import eval_mixture
    g = torch.Generator().manual_seed(0)
    n, m = 5, 7
    means = torch.rand((n, 2), generator=g)
    conics = torch.eye(2).repeat(n, 1, 1) * 4.0
    values = torch.rand((n, 1), generator=g) + 0.5
    mask = torch.tensor([True, False, True, False, False])
    samples = torch.rand((m, 2), generator=g)
    rec = trace.Recorder()
    rec.install()
    try:
        eval_mixture(means, conics, values, samples, order=2, mask=mask)
        eval_mixture(means, conics, values, means, order=0, mask=mask)
        values.requires_grad_(True)
        out = eval_mixture(means, conics, values, samples, order=1, mask=mask)
        out.ux.sum().backward()
    finally:
        rec.uninstall()
    got = rec.take()
    assert got["k1"][0] == (m, 2, 2, 1, False)
    # Samples that are the means themselves: only the active ones count.
    assert got["k1"][1] == (None, 2, 0, 1, False)
    assert got["k2"] == [(m, 2, 1, 1, False)]
    run = readings.TracedRun.__new__(readings.TracedRun)
    flop = run._mixture("k1", got["k1"][:2])[0]
    assert flop == m * 2 * 29 + 2 * 2 * 13


class _Profile(trace.Profile):
    pass


def test_roofline_reads_bound_over_device_time():
    rows = [(4096, 1000, 2, 1, False)] * 10
    bound = workcount.bound_s(*workcount.mixture_work(
        "fwd", 4096, 1000, 2, 1, False))[0]
    ops = [("mixture_fwd_kernel<2, 1, 2>", i * 1e-3, i * 1e-3 + 4 * bound)
           for i in range(10)]
    prof = trace.Profile(ops, [], 0.02, 10)
    run = readings.TracedRun.__new__(readings.TracedRun)
    run.profile = prof
    run.result = {"stretch_records": {"k1": rows}}
    assert run.roofline("k1") == pytest.approx(25.0)
    # A launch the records do not account for: nothing is read.
    run.result = {"stretch_records": {"k1": rows[:5]}}
    assert run.roofline("k1") is None


def test_profile_busy_and_gaps():
    ops = [("a", 0.0, 1.0), ("b", 0.5, 2.0), ("c", 3.0, 4.0)]
    host = [("aten::mm", 1.9, 2.1), ("aten::nonzero", 2.2, 3.5)]
    prof = trace.Profile(ops, host, 5.0, 2)
    assert prof.busy_s() == pytest.approx(3.0)
    assert prof.idle_gaps() == [(2.0, 3.0), (4.0, 5.0)]
    gaps = dict(prof.top_idle_gaps())
    assert gaps["aten::nonzero"] == pytest.approx(1.0)
    assert gaps["host (no op)"] == pytest.approx(1.0)


def test_network_count_by_hand():
    shapes = {"params/delta_net/Dense_0/kernel": (4, 3),
              "params/delta_net/Dense_1/kernel": (3, 2),
              "params/InputTransform_0/transform_net/MLP_0/Dense_0/kernel":
                  (16, 48)}
    chains = workcount.dense_chains(shapes)
    assert chains == {"params/delta_net": [(4, 3), (3, 2)]}
    fwd = workcount.network_per_gaussian_flop(shapes, 1, 1, 0, 16)
    transforms = 2 * (8 + 2 + 8 + 1)
    assert fwd == 2 * 12 + 2 * 6 + transforms
    bwd = workcount.network_per_gaussian_flop(shapes, 1, 1, 0, 16,
                                              backward=True)
    assert bwd == 2 * 12 + 2 * 2 * 6 + 2 * transforms
