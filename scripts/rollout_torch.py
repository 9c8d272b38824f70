#!/usr/bin/env python
"""Roll out a trained PN model with the PyTorch port and score it against
the finite-difference frames stored in its fixture.

The rollout half of scripts/validate_pn.py, for pigs_tpu_torch: it loads an
exported fixture (scripts/export_torch_fixture.py), rolls the model out on
``--device``, and prints the per-step and mean relative L2 error against the
fixture's FD frames, beside the JAX-CPU rollout's mean.

The rollout runs twice, the first time to warm up (rollout's timing).

Examples (the flagship's EMA; the dt=0.1 checkpoint's raw parameters):
  python scripts/rollout_torch.py \
      --fixture artifacts/burgers_ns4096_ema2_torch.npz --device cuda
  python scripts/rollout_torch.py \
      --fixture artifacts/burgers_dt01_torch.npz --device cuda
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--fixture", default="artifacts/burgers_ns4096_ema2_torch.npz")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch

    from pigs_tpu_torch.convert import load_fixture
    from pigs_tpu_torch.train.pn import rollout, rollout_metrics

    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg, network, data = load_fixture(args.fixture, device=device)
    steps = int(data["config_steps"])
    frames, evo_time = rollout(cfg, network, n_steps=steps,
                               res=int(data["config_res"]),
                               dt=float(data["config_dt"]), device=device)
    m = rollout_metrics(frames[:, 0], data["fd_frames"])
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"rollout: {steps} steps in {evo_time * 1e3:.2f} ms on {name}")
    print("per-step rel-L2 vs FD: "
          + " ".join(f"{v:.3f}" for v in m["per_step_rel_norm"]))
    print(f"mean rel-L2 vs FD: {m['mean_rel_norm']:.4f} "
          f"(JAX-CPU rollout of the same fixture: "
          f"{float(data['jax_mean_rel_l2']):.4f})")
    summary = {"mean_rel_norm": m["mean_rel_norm"],
               "jax_mean_rel_norm": float(data["jax_mean_rel_l2"]),
               "evo_time_s": evo_time, "device": name}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
