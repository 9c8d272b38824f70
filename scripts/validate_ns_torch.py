#!/usr/bin/env python
"""Roll out the Navier-Stokes model with the PyTorch port and score it
against the solver's vorticity frames.

The rollout-only half of scripts/validate_ns.py (its steps 4: evolve the
held-out trajectory's curl-fit initial state with densify off, render the
vorticity w = d(u_y)/dx - d(u_x)/dy at order 1 on the 64x64 pixel centres,
frame 0 plus ``steps`` frames, and compare each with the dataset's frame),
for pigs_tpu_torch.  The network comes from an exported fixture
(scripts/export_torch_fixture.py --kind ns), the initial state and the
ground truth from the NS dataset.  Prints the per-step and mean relative L2
error and the t=0 (curl-fit) error beside the JAX-CPU rollout's.

Example:
  python scripts/validate_ns_torch.py --device cuda
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--fixture", default="artifacts/ns_vorttrain_torch.npz")
    p.add_argument("--ns-data", default="artifacts/ns_data_8traj.npz")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    import numpy as np
    import torch

    from pigs_tpu_torch.convert import load_fixture
    from pigs_tpu_torch.train.pn import (NSDataset, rollout_metrics,
                                         rollout_vorticity)

    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg, network, fixture = load_fixture(args.fixture, device=device)
    data = NSDataset.load(args.ns_data, device=device)
    index = int(fixture["config_held_out"])
    steps, res = int(fixture["config_steps"]), int(fixture["config_res"])
    state = data.state_for(cfg, index)

    def run():
        return rollout_vorticity(cfg, network, state, steps, res)

    run()  # warm-up: the kernels' build and first launches
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    frames = run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    evo_s = time.perf_counter() - t0
    frames = frames.cpu().numpy()
    gt = data.frames[index].permute(2, 0, 1).cpu().numpy()
    m = rollout_metrics(frames, gt)
    fit = rollout_metrics(frames[:1], gt[:1])
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"rollout: held-out trajectory {index}, {steps} steps in "
          f"{evo_s * 1e3:.2f} ms on {name}")
    print("per-step vorticity rel-L2 vs the solver: "
          + " ".join(f"{v:.3f}" for v in m["per_step_rel_norm"]))
    print(f"mean rel-L2 {m['mean_rel_norm']:.6f} (JAX-CPU "
          f"{float(fixture['jax_mean_rel_l2']):.6f}); t=0 curl-fit error "
          f"{fit['mean_rel_norm']:.6f} (JAX-CPU "
          f"{float(fixture['jax_t0_rel_l2']):.6f})")
    vs_jax = [float(np.linalg.norm(a - b) / np.linalg.norm(b))
              for a, b in zip(frames, fixture["jax_frames"])]
    print("per-step rel-L2 vs the JAX-CPU frames: "
          + " ".join(f"{v:.1e}" for v in vs_jax))
    print(json.dumps({"mean_rel_norm": m["mean_rel_norm"],
                      "t0_fit_rel_norm": fit["mean_rel_norm"],
                      "evo_time_s": evo_s, "device": name}))


if __name__ == "__main__":
    main()
