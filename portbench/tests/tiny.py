"""Cells of ``BENCHMARK.json`` cut to a size a CPU test holds: the Burgers
model at 180 slots (a grid of at most 8 x 8 behind the 100 boundary
Gaussians) and 64 samples, the NS model at its 640 slots and 64 samples,
training epochs of at most 4 steps, and rollouts of 30 and 28 steps.
The program's configuration gets the same capacity (``overrides``)."""

from __future__ import annotations

import copy

from portbench import common

BURGERS_CAPACITY = 180


def cell(name: str):
    c = common.Cell(common.load_benchmark(), name)
    c.config = copy.deepcopy(c.config)
    c.traffic = copy.deepcopy(c.traffic)
    c.config["recipe"]["n_samples"] = 64
    c.config["recipe"]["train_timesteps"] = 4
    c.config["rollout"]["steps"] = 30 if c.config["problem"] == "burgers" \
        else 28
    overrides = None
    if c.config["ic"]["kind"] == "randomized_grid":
        c.config["capacity"] = BURGERS_CAPACITY
        c.config["ic"]["edge_max"] = 8
        overrides = {"capacity": BURGERS_CAPACITY}
    c.traffic["pool"] = 16
    return c, overrides
