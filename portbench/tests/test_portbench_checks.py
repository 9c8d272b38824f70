"""What the checks of ``correct`` read: the window check follows the
window's object past set-up, a fault that starts only after set-up is
caught, the stable picks and epochs, and a traced stretch that replays
the same work from one start."""

import torch

from portbench import calibrate, common, trace, traffic
from portbench.drivers import rollout, train
from portbench.tests import tiny

CPU = torch.device("cpu")
SEED = 2 ** 31 + 17


class _Requests:
    def __init__(self, ics):
        self.ics = ics

    def __len__(self):
        return len(self.ics["edge"])


def test_first_pick_is_compared_over_every_frame():
    full = common.Cell(common.load_benchmark(), "burgers-rollout")
    edge_max = full.config["ic"]["stable_edge_max"]
    ics = traffic.rollout_ics(full.config, full.traffic, 5, 60, "cpu")
    req = _Requests({"edge": ics["edge"]})
    for seed in range(20):
        picks = rollout.pick(full, req, seed, 60)
        assert len(picks) == full.traffic["check_rollouts"]
        assert picks == sorted(set(picks))
        assert any(int(ics["edge"][i]) <= edge_max for i in picks)
        assert picks == rollout.pick(full, req, seed, 60)
    wide = [i for i in range(60) if int(ics["edge"][i]) > edge_max]
    assert wide and not rollout.stable(full, req, wide[0])
    # Without a stable rollout among those finished, the picks still come.
    only_wide = _Requests({"edge": ics["edge"][wide]})
    assert len(rollout.pick(full, only_wide, 3, len(wide))) == 3


def test_unstable_epochs_are_passed_over():
    full = common.Cell(common.load_benchmark(), "burgers-train")
    edge_max = full.config["ic"]["stable_edge_max"]
    m = 16
    for seed in range(6):
        g = torch.Generator().manual_seed(seed)
        passed = train.pass_unstable(full, g, m)
        mirror = torch.Generator().manual_seed(seed)
        for _ in range(passed):
            draw = traffic.epoch_inputs(full.config, mirror, m,
                                        torch.float32, "cpu")
            assert draw["edge"] > edge_max
        assert torch.equal(g.get_state(), mirror.get_state())
        assert traffic.epoch_inputs(full.config, g, m, torch.float32,
                                    "cpu")["edge"] <= edge_max


def test_window_check_catches_a_fault_past_setup():
    c, overrides = tiny.cell("burgers-train")
    with calibrate.fault(c, "late"):
        out = train.run(c, SEED, 0.2, None, CPU, overrides)
    checks = out["checks"]
    for k in ("loss_gap", "grad_gap", "update_gap"):
        assert checks[k]["value"] <= checks[k]["limit"], (k, checks)
    assert checks["window_update_gap"]["value"] > 0.9
    assert checks["window_count_gap"]["value"] == c.config["recipe"][
        "train_timesteps"]
    assert not common.judge(checks)


def test_stretch_replays_one_start():
    c, overrides = tiny.cell("burgers-train")
    prog = train.Program(c, CPU, overrides)
    g = torch.Generator().manual_seed(SEED)
    length = prog.tcfg.train_timesteps
    epoch = train.first_epoch(c)
    start = prog.snapshot()
    g0 = g.get_state()
    prog.epoch(g, epoch, length)
    once = [p.detach().clone() for p in prog.params]
    prog.restore(start)
    g.set_state(g0)
    out = trace.stretch(lambda: prog.epoch(g, epoch, length)[2],
                        trace.Recorder(), prog.snapshot, prog.restore, g)
    assert out["stretch_steps"] == length
    assert out["stretch_s"] > 0
    rec = out["stretch_records"]
    assert rec["k1"] and rec["k2"] and rec["net"]
    # The records count the active Gaussians, not the padded capacity.
    assert all(r[1] <= c.config["capacity"] for r in rec["k1"])
    for a, b in zip(prog.params, once):
        assert torch.equal(a.detach(), b)
    # Nothing stays installed after the recorded pass.
    from pigs_tpu_torch.ops import mixture_kernel
    assert mixture_kernel.mixture_forward.__module__ == mixture_kernel.__name__
