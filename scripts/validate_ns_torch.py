#!/usr/bin/env python
"""Train the Navier-Stokes model with the PyTorch port, roll it out and score
it against the solver's vorticity frames.

The train and rollout halves of scripts/validate_ns.py (its steps 3 and 4)
for pigs_tpu_torch, on the committed dataset: PN training with the
vorticity-reconstruction loss on every trajectory but the last, then the
held-out trajectory's curl-fit initial state evolved with densify off, its
vorticity w = d(u_y)/dx - d(u_x)/dy rendered at order 1 on the 64x64 pixel
centres, frame 0 plus ``steps`` frames, each compared with the dataset's
frame.  Prints the per-step and mean relative L2 error and the t=0
(curl-fit) error beside the JAX-CPU rollout of the committed checkpoint.

With ``--epochs 0`` (the default) nothing trains: the network is the
rollout fixture's (scripts/export_torch_fixture.py --kind ns, the EMA
parameters of artifacts/ns_vorttrain_ckpt_20000).  ``--resume-fixture``
starts training from the NS training fixture (--kind ns-train): its
parameters, Adam state and EMA are written as the port's checkpoint at the
fixture's epoch (20000) in ``--ckpt-dir`` and training resumes there;
``--epochs`` is the run's total, as in the JAX script (20003: three epochs
past the fixture).  The recipe flags default to results_ns_r5_vorttrain's.
After training the EMA parameters (the raw ones without an EMA) roll out.

Examples (three epochs resumed from the exported checkpoint):
  python scripts/validate_ns_torch.py --device cpu --epochs 20003 \\
      --resume-fixture artifacts/ns_vorttrain_train_torch.npz \\
      --ckpt-dir build/ns_train/checkpoints
  python scripts/validate_ns_torch.py --device cuda     # rollout only
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
    p.add_argument("--fixture", default="artifacts/ns_vorttrain_torch.npz",
                   help="rollout fixture: the untrained network, the "
                        "held-out index and the JAX-CPU reference")
    p.add_argument("--ns-data", default="artifacts/ns_data_8traj.npz")
    p.add_argument("--epochs", type=int, default=0,
                   help="train up to this epoch (0: roll out the fixture)")
    p.add_argument("--resume-fixture", default=None,
                   help="start from an exported NS training fixture (.npz)")
    p.add_argument("--ckpt-dir", default="build/ns_train/checkpoints")
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest checkpoint in --ckpt-dir")
    p.add_argument("--n-samples", type=int, default=2048)
    p.add_argument("--train-timesteps", type=int, default=30)
    p.add_argument("--dt", type=float, default=0.1)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--lr-min", type=float, default=2e-5)
    p.add_argument("--loss-weight-floor", type=float, default=0.05)
    p.add_argument("--split-epoch", type=int, default=10000)
    p.add_argument("--ema-decay", type=float, default=0.999)
    p.add_argument("--clip-norm", type=float, default=1.0,
                   help="global-norm gradient clipping (0 = none)")
    p.add_argument("--skip-nonfinite", action="store_true", default=True)
    p.add_argument("--no-skip-nonfinite", dest="skip_nonfinite",
                   action="store_false")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    import numpy as np
    import torch

    from pigs_tpu_torch.convert import load_fixture, load_train_fixture
    from pigs_tpu_torch.train.checkpoint import latest_epoch, save_checkpoint
    from pigs_tpu_torch.train.pn import (NSDataset, TrainConfig,
                                         rollout_metrics, rollout_vorticity,
                                         train)

    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg, network, fixture = load_fixture(args.fixture, device=device)
    data = NSDataset.load(args.ns_data, device=device)
    index = int(fixture["config_held_out"])
    steps, res = int(fixture["config_steps"]), int(fixture["config_res"])
    summary = {}

    if args.epochs > 0:
        resume = args.resume
        if args.resume_fixture:
            cfg, net, opt, ema, tdata = load_train_fixture(args.resume_fixture,
                                                           device=device)
            epoch = int(tdata["train_epoch"])
            if (latest_epoch(args.ckpt_dir) or -1) < epoch:
                names = [k for k, _ in net.named_parameters()]
                save_checkpoint(args.ckpt_dir, epoch,
                                dict(net.named_parameters()), opt, [],
                                ema=dict(zip(names, ema)))
            resume = True
        tcfg = TrainConfig(n_epochs=args.epochs, n_samples=args.n_samples,
                           lr=args.lr, lr_min=args.lr_min, dt=args.dt,
                           train_timesteps=args.train_timesteps,
                           loss_weight_floor=args.loss_weight_floor,
                           split_epoch=args.split_epoch,
                           ema_decay=args.ema_decay,
                           clip_norm=args.clip_norm or None,
                           skip_nonfinite_updates=args.skip_nonfinite,
                           seed=args.seed)
        # Every trajectory but the held-out one, as validate_ns.py trains.
        train_data = NSDataset(*(torch.cat([x[:index], x[index + 1:]])
                                 for x in data))
        t0 = time.perf_counter()
        result = train(cfg, tcfg, checkpoint_dir=args.ckpt_dir, resume=resume,
                       device=device, ns_data=train_data)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        summary["train_s"] = time.perf_counter() - t0
        summary["training_loss"] = [float(x) for x in
                                    result.training_loss[-5:]]
        network = result.network
        if result.ema is not None:
            print("rolling out with EMA params")
            with torch.no_grad():
                for p_, e in zip(network.parameters(), result.ema):
                    p_.copy_(e)
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
    print(f"mean rel-L2 {m['mean_rel_norm']:.6f} (JAX-CPU rollout of the "
          f"committed checkpoint {float(fixture['jax_mean_rel_l2']):.6f}); "
          f"t=0 curl-fit error {fit['mean_rel_norm']:.6f} (JAX-CPU "
          f"{float(fixture['jax_t0_rel_l2']):.6f})")
    if args.epochs == 0:
        vs_jax = [float(np.linalg.norm(a - b) / np.linalg.norm(b))
                  for a, b in zip(frames, fixture["jax_frames"])]
        print("per-step rel-L2 vs the JAX-CPU frames: "
              + " ".join(f"{v:.1e}" for v in vs_jax))
    summary.update({"mean_rel_norm": m["mean_rel_norm"],
                    "t0_fit_rel_norm": fit["mean_rel_norm"],
                    "evo_time_s": evo_s, "device": name})
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
