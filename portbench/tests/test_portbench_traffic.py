"""Traffic is drawn the same way from one seed, and the mirror of a
training epoch's draws is the program's own."""

import numpy as np
import pytest
import torch

from portbench import common, traffic
from portbench.tests import tiny


def config(name):
    return tiny.cell(name)[0].config


@pytest.mark.parametrize("name", ["burgers-train", "ns-train"])
def test_epoch_inputs_repeat_from_a_seed(name):
    c = tiny.cell(name)[0]
    data = None
    train_set = None
    if c.config["ic"]["kind"] == "stored_state":
        data = common.load_arrays(c.path(c.config["fixture"]["ns_data"]))
        train_set = traffic.trajectories(c.config, "train")
    seed = 2 ** 31 + 99
    a, b, other = (traffic.epoch_inputs(
        c.config, torch.Generator().manual_seed(s), 64, torch.float32, "cpu",
        data, train_set) for s in (seed, seed, seed + 1))
    for key in ("samples", "times", "bc_samples"):
        assert torch.equal(a[key], b[key])
        assert not torch.equal(a[key], other[key])
    for key in a["state"]:
        assert torch.equal(a["state"][key], b["state"][key])


def test_epoch_inputs_mirror_the_program_draws():
    from pigs_tpu_torch.convert import load_train_fixture
    from pigs_tpu_torch.models.model import randomize_state_dynamic
    from pigs_tpu_torch.utils.sampling import (boundary_band_samples,
                                               collocation_samples)
    c, overrides = tiny.cell("burgers-train")
    cfg = load_train_fixture(c.path(c.config["fixture"]["train"]))[0]
    cfg = cfg._replace(**overrides)
    seed = 77
    g = torch.Generator().manual_seed(seed)
    samples = collocation_samples(g, 64, 2, 1.0, torch.float32)
    times = torch.rand(64, generator=g, dtype=torch.float32)
    bc = boundary_band_samples(g, 64, 1.0, torch.float32)
    n = min(int(torch.randint(15, 40, (), generator=g)), 8)
    state = randomize_state_dynamic(cfg, g, n, 8)
    mine = traffic.epoch_inputs(c.config, torch.Generator().manual_seed(seed),
                                64, torch.float32, "cpu")
    assert torch.equal(mine["samples"], samples)
    assert torch.equal(mine["times"], times)
    assert torch.equal(mine["bc_samples"], bc)
    assert mine["edge"] == n
    for key in ("means", "scaling", "transforms", "u", "active", "boundary"):
        assert torch.equal(mine["state"][key], getattr(state, key)), key


def test_rollout_ics_repeat_and_cover_every_edge():
    c = tiny.cell("burgers-rollout")[0]
    full = common.Cell(common.load_benchmark(), "burgers-rollout")
    a = traffic.rollout_ics(full.config, full.traffic, 5, 50, "cpu")
    b = traffic.rollout_ics(full.config, full.traffic, 5, 50, "cpu")
    d = traffic.rollout_ics(full.config, full.traffic, 6, 50, "cpu")
    assert torch.equal(a["means"], b["means"])
    assert not torch.equal(a["means"], d["means"])
    # Every grid edge of [15, 40) twice in 50 requests, in another order.
    assert sorted(a["edge"].tolist()) == sorted(d["edge"].tolist()) == \
        sorted(list(range(15, 40)) * 2)
    assert not torch.equal(a["edge"], d["edge"])
    inner = a["active"] & ~a["boundary"]
    assert torch.equal(inner.sum(1), a["edge"] ** 2)
    assert c.config["capacity"] < full.config["capacity"]


def test_rollout_ics_match_one_grid_state():
    full = common.Cell(common.load_benchmark(), "burgers-rollout")
    ics = traffic.rollout_ics(full.config, full.traffic, 3, 4, "cpu")
    for i in range(4):
        n = int(ics["edge"][i])
        grid = traffic.grid_state(full.config["ic"], full.config["capacity"],
                                  n, torch.float32, "cpu")
        assert torch.equal(grid["active"], ics["active"][i])
        # Noise lands on the active interior only.
        off = ~grid["active"] | grid["boundary"]
        for key in ("means", "u", "scaling", "transforms"):
            np.testing.assert_allclose(ics[key][i][off].numpy(),
                                       grid[key][off].numpy(), rtol=1e-6)


def test_stored_trajectories_each_equally_often():
    full = common.Cell(common.load_benchmark(), "ns-rollout")
    ics = traffic.rollout_ics(full.config, full.traffic, 9, 80, "cpu")
    counts = np.bincount(ics["trajectory"].numpy(), minlength=8)
    assert counts.tolist() == [10] * 8
    assert traffic.trajectories(full.config, "train") == list(range(7))
