#!/usr/bin/env python3
"""The readings the limits of a ``solve`` cell's ``correct`` are set from,
many seeds in one process.  Not part of a benchmark run.

    python3 portbench/calibrate_solve.py --workload no-mlp-burgers2d-solve \\
        --seeds 11,12,13 --mode sound,control,unchanged --seconds 2

Each seed is one run of the ``solve`` driver with a short window (the
checks are those of a benchmark run, at the cell's sizes):

* ``sound``: the program as it is;
* ``control``: the reference in float32 with TF32 matmuls (the nearest
  precision below the configuration's float32) in the program's place;
* a fault (:data:`FAULTS`) planted in the program for the whole run.

Prints one JSON line per seed and mode: the checks' values.  On a machine
without a GPU it runs on the CPU, for the tests' small sizes.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAULTS = ("unchanged", "half_batch", "altered", "late")


@contextlib.contextmanager
def fault(cell, name: str):
    """Plant fault ``name`` in the no-MLP solver for the block:
    ``unchanged``, an Adam step that leaves the parameters and its state as
    they were; ``half_batch``, each iteration's loss over the first half of
    its samples; ``altered``, each iteration's loss 1 % high where it is
    produced; ``late``, the parameters left unchanged only after set-up
    (every Adam step of the window's timesteps on)."""
    from pigs_tpu_torch.train import no_mlp
    saved = {k: getattr(no_mlp, k) for k in (
        "adam_update", "_loss_fn", "timestep_blocks")}

    def frozen_update(params, grads, state, *a, **k):
        return state
    try:
        if name == "unchanged":
            no_mlp.adam_update = frozen_update
        elif name == "half_batch":
            def half(cfg, params, active, prev, samples, time_samples,
                     first_step):
                h = samples.shape[0] // 2
                cut = None if prev is None else tuple(x[:h] for x in prev)
                return saved["_loss_fn"](cfg, params, active, cut,
                                         samples[:h], time_samples[:h],
                                         first_step)
            no_mlp._loss_fn = half
        elif name == "altered":
            def louder(*a, **k):
                return saved["_loss_fn"](*a, **k) * 1.01
            no_mlp._loss_fn = louder
        elif name == "late":
            # The driver enters the program once a check block and once to
            # warm up before its window.
            setup = len(cell.traffic["check_iters"]) + 1
            calls = [0]

            def counted(*a, **k):
                calls[0] += 1
                if calls[0] > setup:
                    no_mlp.adam_update = frozen_update
                return saved["timestep_blocks"](*a, **k)
            no_mlp.timestep_blocks = counted
        else:
            raise ValueError(f"unknown fault {name!r}")
        yield
    finally:
        for k, v in saved.items():
            setattr(no_mlp, k, v)


def readings(cell, seeds, mode, device, seconds=2.0, log=print):
    """One dict of check values per seed, each from one run of the
    ``solve`` driver with a ``seconds`` window."""
    from portbench.drivers import solve
    out = []
    for seed in seeds:
        ctx = (fault(cell, mode) if mode not in ("sound", "control")
               else contextlib.nullcontext())
        with ctx:
            result = solve.run(cell, seed, seconds, None, device,
                               control=mode == "control")
        checks = result["checks"]
        row = {"seed": seed, "mode": mode,
               **{k: v["value"] for k, v in checks.items()},
               **{f"{k}_{a}": b for k, v in checks.items()
                  for a, b in v.items() if a not in ("value", "limit")}}
        log(json.dumps(row), flush=True)
        out.append(row)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", default="no-mlp-burgers2d-solve")
    p.add_argument("--seeds", required=True)
    p.add_argument("--mode", default="sound")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import common
    cell = common.Cell(common.load_benchmark(), args.workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    if device.type == "cuda":
        common.check_fixtures(cell.config)
    for mode in args.mode.split(","):
        readings(cell, [int(s) for s in args.seeds.split(",")], mode, device,
                 seconds=args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
