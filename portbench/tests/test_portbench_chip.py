"""On the GPU, at each cell's own size: the control (the reference in
float32 with TF32 matmuls, the nearest precision below the
configuration's float32, in the program's place) comes out not correct
on three seeds, and the program itself correct.  Run on a machine with a
card: ``python -m pytest portbench/tests/test_portbench_chip.py -q``."""

import pytest

from portbench import calibrate, common

CELLS = ["burgers-train", "ns-train", "burgers-rollout", "ns-rollout"]
SEEDS = [2 ** 31 + 41, 2 ** 31 + 42, 2 ** 31 + 43]


def device_or_skip():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def limits(cell):
    return cell.config["limits"][cell.traffic["driver"]]


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    device = device_or_skip()
    cell = common.Cell(common.load_benchmark(), name)
    lim = limits(cell)
    for row in calibrate.readings(cell, SEEDS, "control", device):
        assert any(row[k] > lim[k] for k in lim), row


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_program_is_correct(name):
    device = device_or_skip()
    cell = common.Cell(common.load_benchmark(), name)
    lim = limits(cell)
    for row in calibrate.readings(cell, SEEDS[:1], "sound", device):
        assert all(row[k] <= lim[k] for k in lim), row
