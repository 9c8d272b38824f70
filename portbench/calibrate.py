#!/usr/bin/env python3
"""The readings the limits of ``correct`` are set from, many seeds in one
process.  Not part of a benchmark run.

    python3 portbench/calibrate.py --workload burgers-train \\
        --seeds 11,12,13 --mode sound|control|<fault> --seconds 3

Each seed is one run of the cell's driver with a short window (the
checks are those of a benchmark run, at the cell's sizes):

* ``sound``: the program as it is;
* ``control``: the reference in float32 with TF32 matmuls (the nearest
  precision below the configuration's float32) in the program's place;
* a fault (:data:`FAULTS`) planted in the program for the whole run.

Prints one JSON line per seed: the checks' values.  On a machine without
a GPU it runs on the CPU, for the tests' small sizes.
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
    """Plant fault ``name`` in the program for the block: ``unchanged``,
    a step that returns its state unchanged (training: the update leaves
    the parameters and moments as they were; rollout: the forward step
    returns its input state); ``half_batch``, half of the batch left out
    (training: the losses over the first half of the samples; rollout:
    each render over the first half of the Gaussians); ``altered``, an
    answer altered where it is produced (training: each step's losses
    1 % high; rollout: frame 5 of every rollout 1 % high); ``late``, the
    state left unchanged only after set-up (training: by every update
    from the first window epoch on) or past step 10 (rollout: the forward
    step returns its input state from half the rollout on)."""
    import torch
    from pigs_tpu_torch.models.model import Losses, StepFields
    from pigs_tpu_torch.train import pn
    driver = cell.traffic["driver"]
    saved = {k: getattr(pn, k) for k in (
        "adam_update", "compute_loss", "pn_loss_grads", "forward_step",
        "eval_mixture", "rollout_frames", "rollout_vorticity",
        "train_epoch")}

    def frozen_update(params, grads, state, *a, **k):
        return state
    try:
        if name == "unchanged" and driver == "train":
            pn.adam_update = frozen_update
        elif name == "unchanged":
            def frozen(cfg, network, state, t=0.0):
                _, deltas = saved["forward_step"](cfg, network, state, t)
                return state, deltas
            pn.forward_step = frozen
        elif name == "half_batch" and driver == "train":
            def half(cfg, state, deltas, prev, curr, samples, time_samples,
                     t, dt, initial_fields=None):
                m = samples.shape[0]
                h = m // 2

                def cut(f):
                    return StepFields(*(None if x is None else
                                        (x[:h] if x.shape[0] == m else x)
                                        for x in f))
                return saved["compute_loss"](cfg, state, deltas, cut(prev),
                                             cut(curr), samples[:h],
                                             time_samples[:h], t, dt)
            pn.compute_loss = half
        elif name == "half_batch":
            def half_mixture(means, conics, values, samples, order=0,
                             mask=None, **kw):
                n = means.shape[0]
                keep = mask if mask is not None else torch.ones(
                    n, dtype=torch.bool, device=means.device)
                idx = keep.cumsum(0)
                keep = keep & (idx <= keep.sum() // 2)
                return saved["eval_mixture"](means, conics, values, samples,
                                             order=order, mask=keep, **kw)
            pn.eval_mixture = half_mixture
        elif name == "altered" and driver == "train":
            def louder(*a, **k):
                new, curr, losses, total, grads = saved["pn_loss_grads"](
                    *a, **k)
                return (new, curr, Losses(*(x * 1.01 for x in losses)),
                        total * 1.01, grads)
            pn.pn_loss_grads = louder
        elif name == "altered":
            for key in ("rollout_frames", "rollout_vorticity"):
                def altered(*a, _f=saved[key], **k):
                    out = _f(*a, **k).clone()
                    out[5] = out[5] * 1.01
                    return out
                setattr(pn, key, altered)
        elif name == "late" and driver == "train":
            setup = len(cell.traffic["check_steps"]) + 1
            calls = [0]

            def counted(*a, **k):
                calls[0] += 1
                if calls[0] > setup:
                    pn.adam_update = frozen_update
                return saved["train_epoch"](*a, **k)
            pn.train_epoch = counted
        elif name == "late":
            steps = cell.config["rollout"]["steps"]
            calls = [0]

            def late_frozen(cfg, network, state, t=0.0):
                new, deltas = saved["forward_step"](cfg, network, state, t)
                calls[0] += 1
                return (state if (calls[0] - 1) % steps >= steps // 2
                        else new), deltas
            pn.forward_step = late_frozen
        else:
            raise ValueError(f"unknown fault {name!r}")
        yield
    finally:
        for k, v in saved.items():
            setattr(pn, k, v)


def readings(cell, seeds, mode, device, overrides=None, seconds=3.0,
             log=print):
    """One dict of check values per seed, each from one run of the cell's
    driver with a ``seconds`` window."""
    import importlib
    driver = importlib.import_module(
        f"portbench.drivers.{cell.traffic['driver']}")
    out = []
    for seed in seeds:
        ctx = (fault(cell, mode)
               if mode not in ("sound", "control")
               else contextlib.nullcontext())
        with ctx:
            result = driver.run(cell, seed, seconds, None, device, overrides,
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
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--mode", default="sound")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import common
    cell = common.Cell(common.load_benchmark(), args.workload)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for mode in args.mode.split(","):
        readings(cell, [int(s) for s in args.seeds.split(",")], mode, device,
                 seconds=args.seconds)
    return 0


if __name__ == "__main__":
    sys.exit(main())
