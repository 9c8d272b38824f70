"""A run, its look for a GPU skipped, on the CPU at a small size: sound, it
comes out correct; with the timed path broken underneath (a step that
returns its state unchanged, half of the batch left out, an answer altered
where it is produced, the state left unchanged only after set-up or
past step 10), it does not.  One device, so no exchange between
devices can be left out."""

import contextlib

import pytest
import torch

from portbench import calibrate, common
from portbench.drivers import rollout, train
from portbench.tests import tiny

CPU = torch.device("cpu")
CASES = [(cell, fault) for cell in ("burgers-train", "burgers-rollout",
                                    "ns-train", "ns-rollout")
         for fault in (None, *calibrate.FAULTS)]


def run(name, fault, seed=2 ** 31 + 5):
    c, overrides = tiny.cell(name)
    driver = train if c.traffic["driver"] == "train" else rollout
    seconds = 0.2 if driver is train else 4.0
    if driver is rollout:
        c.traffic["check_rollouts"] = 1
    with (calibrate.fault(c, fault) if fault
          else contextlib.nullcontext()):
        return driver.run(c, seed, seconds, None, CPU, overrides)


@pytest.mark.parametrize("name,fault", CASES,
                         ids=[f"{c}-{f or 'sound'}" for c, f in CASES])
def test_fault_is_caught(name, fault):
    out = run(name, fault)
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert common.judge(out["checks"]) == (fault is None), checks
