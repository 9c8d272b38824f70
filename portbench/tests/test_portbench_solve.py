"""The ``solve`` driver at a size a CPU test holds: stored states of a
3-timestep solve at capacity 64 (25 active), 128 samples, blocks of 5
iterations, written by the program's ``solve`` as the fixture script
writes them.

* the traffic: the requests' timesteps and the blocks' draws follow the
  seed, and only the seed;
* the result line: the keys ``run.result_line`` prints, untraced (the
  end-to-end metrics: ``setup_s``; ``train_device_ms`` needs a card) and
  traced (the per-layer metrics the CPU can read: ``mfu.solve``,
  ``loop_host_ms.solve`` and ``train_step_ms.solve_host``);
* a sound run comes out correct, and each planted fault
  (``calibrate_solve.FAULTS``) and the control (the reference in float32
  with its contractions' operands rounded to TF32) do not.
"""

import copy

import numpy as np
import pytest
import torch

from portbench import calibrate_solve, common, run as bench_run
from portbench import trace
from portbench.drivers import solve

CPU = torch.device("cpu")
CELL = "no-mlp-burgers2d-solve"
SEED = 2 ** 31 + 11


@pytest.fixture(scope="module")
def states(tmp_path_factory):
    """A tiny solve's states in the fixture's layout."""
    from pigs_tpu_torch.train import no_mlp
    c = tiny_cell(None)
    cfg = solve.recipe_config(c.config)
    traj = no_mlp.solve(cfg, torch.Generator().manual_seed(0), 3,
                        densify_every=c.config["recipe"]["densify_every"])
    path = tmp_path_factory.mktemp("states") / "states.npz"
    np.savez(path, **{k: np.stack([s["params"]._asdict()[k].numpy()
                                   for s in traj]) for k in solve.LEAVES},
             active=np.stack([s["active"].numpy() for s in traj]),
             loss=np.asarray([s["loss"] for s in traj]),
             iters=np.asarray([s["iters"] for s in traj]))
    return str(path)


def tiny_cell(path):
    c = common.Cell(common.load_benchmark(), CELL)
    c.config = copy.deepcopy(c.config)
    c.traffic = copy.deepcopy(c.traffic)
    c.config["capacity"] = 64
    c.config["fixture"]["states"] = path
    c.config["recipe"].update(n_init=5, n_samples=128, block_iters=5,
                              max_iters=20)
    c.traffic.update(timesteps=[1, 2], pool=16, profile_blocks=2)
    return c


def test_requests_and_draws_follow_the_seed():
    t = {"timesteps": [1, 19]}
    a = solve.request_timesteps(t, SEED, 200)
    assert a == solve.request_timesteps(t, SEED, 200)
    assert a != solve.request_timesteps(t, SEED + 1, 200)
    assert set(a) == set(range(1, 20))
    draws = [solve.block_inputs(torch.Generator().manual_seed(s), 3, 8)
             for s in (SEED, SEED, SEED + 1)]
    assert torch.equal(draws[0]["base"], draws[1]["base"])
    assert not torch.equal(draws[0]["base"], draws[2]["base"])
    assert draws[0]["base"].shape == (3, 8, 2)
    assert draws[0]["times"].shape == (3, 8)


def test_program_draws_are_the_checked_draws(states):
    """The reference's draws (``block_inputs``) are the program's
    (``block_draws``) from the same generator state."""
    from pigs_tpu_torch.train import no_mlp
    c = tiny_cell(states)
    prog = solve.Program(c, CPU)
    g = torch.Generator().manual_seed(SEED)
    s0 = g.get_state()
    mine = no_mlp.block_draws(prog.cfg, g, prog.states[0][1], False)
    g.set_state(s0)
    theirs = solve.block_inputs(g, prog.cfg.block_iters, prog.cfg.n_samples)
    assert torch.equal(mine.base, theirs["base"])
    assert torch.equal(mine.time, theirs["times"])


def test_result_line_untraced_and_traced(states):
    c = tiny_cell(states)
    out = solve.run(c, SEED, 2.0, None, CPU)
    line = bench_run.result_line(c, "solve", dict(out, memory_peak_bytes=0),
                                 False, {"platform": "cpu"})
    assert set(line) == {"correct", "attempted", "failed", "metrics",
                         "device", "checks"}
    # The cell's step metric is the device's (``train_device_ms``): none
    # without a card.
    assert set(line["metrics"]) == {"setup_s"}
    assert out["metrics"]["train_step_ms"] > 0
    assert line["correct"] and line["attempted"] % 5 == 0
    assert set(line["checks"]) == {"loss_gap", "grad_gap", "update_gap",
                                   "window_update_gap", "window_loss_gap",
                                   "window_count_gap"}

    traced = solve.run(c, SEED, 2.0, trace.Recorder(), CPU)
    for key in ("profile", "stretch_records", "stretch_s", "shapes",
                "spanned_profile"):
        assert key in traced
    assert traced["stretch_records"]["net"] == []
    rows = traced["stretch_records"]["k1"]
    assert len(rows) == 2 * 2 * 5         # 2 blocks of 5, 2 K1 each
    assert {r[1] for r in rows} <= {25}   # the active Gaussians, not 64
    line = bench_run.result_line(c, "solve", dict(traced,
                                                  memory_peak_bytes=0),
                                 True, {"platform": "cpu"})
    assert {"mfu.solve", "loop_host_ms.solve",
            "train_step_ms.solve_host"} <= set(line["metrics"])
    assert line["metrics"]["loop_host_ms.solve"]["value"] > 0
    assert "breakdown" in line and line["correct"]


@pytest.mark.parametrize("mode", ["sound", "control",
                                  *calibrate_solve.FAULTS])
def test_fault_is_caught(states, mode):
    c = tiny_cell(states)
    rows = calibrate_solve.readings(c, [SEED], mode, CPU, seconds=0.2,
                                    log=lambda *a, **k: None)
    limits = c.config["limits"]["solve"]
    checks = {k: {"value": v, "limit": limits.get(k, 0.0)}
              for k, v in rows[0].items()
              if k in limits or k == "window_count_gap"}
    assert common.judge(checks) == (mode == "sound"), rows[0]
