#!/usr/bin/env python
"""Train the PN dynamics network with the PyTorch port, then roll out and
score it against the finite-difference frames of the rollout fixture.

The training half of scripts/validate_pn.py for pigs_tpu_torch, with its
training flags (the Burgers flagship recipe's set).  ``--resume-fixture``
starts from the training state exported from the JAX checkpoint
(scripts/export_torch_fixture.py --kind train): its parameters, Adam state
and EMA are written as the port's checkpoint at the fixture's epoch, and
training resumes there.  After training, the EMA parameters (or the raw
ones without --ema-decay) roll out from the default initial condition; the
rollout is scored when its setting is the rollout fixture's (nx 20,
capacity 1664, dt 0.1), whose FD frames are the ground truth (the port has
no FD solver yet).

Example (the flagship recipe, resumed from the exported checkpoint for
three epochs):
  python scripts/train_torch.py --epochs 30003 --dt 0.1 \\
      --loss-weight-floor 0.05 --lr 3e-4 --lr-min 2e-5 --train-timesteps 50 \\
      --n-samples 4096 --ema-decay 0.999 --clip-norm 1.0 --skip-nonfinite \\
      --resume-fixture artifacts/burgers_ns4096_ema2_train_torch.npz \\
      --out build/train_torch --device cuda
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--epochs", type=int, default=5000)
    p.add_argument("--nx", type=int, default=20)
    p.add_argument("--capacity", type=int, default=None)
    p.add_argument("--n-samples", type=int, default=1024)
    p.add_argument("--dt", type=float, default=1.0)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--lr-min", type=float, default=None)
    p.add_argument("--loss-weight-floor", type=float, default=0.0)
    p.add_argument("--train-timesteps", type=int, default=30)
    p.add_argument("--split-epoch", type=int, default=10000)
    p.add_argument("--ema-decay", type=float, default=None)
    p.add_argument("--clip-norm", type=float, default=0.0,
                   help="global-norm gradient clipping (0 = none)")
    p.add_argument("--skip-nonfinite", action="store_true")
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--log-step", type=int, default=10)
    p.add_argument("--rollout-steps", type=int, default=50)
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--out", default="build/train_torch")
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest checkpoint under --out")
    p.add_argument("--resume-fixture", default=None,
                   help="start from an exported training fixture (.npz)")
    p.add_argument("--fixture", default="artifacts/burgers_ns4096_ema2_torch.npz",
                   help="rollout fixture whose FD frames score the rollout")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    import numpy as np
    import torch

    from pigs_tpu_torch.models.model import ModelConfig
    from pigs_tpu_torch.pde import IntegrationRule, Problem
    from pigs_tpu_torch.train.checkpoint import latest_epoch, save_checkpoint
    from pigs_tpu_torch.train.pn import (TrainConfig, rollout,
                                         rollout_metrics, train)

    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = ModelConfig.create(Problem.BURGERS, IntegrationRule.TRAPEZOID,
                             nx=args.nx, ny=args.nx, d=2, scale=1.0,
                             capacity=args.capacity)
    tcfg = TrainConfig(n_epochs=args.epochs, n_samples=args.n_samples,
                       lr=args.lr, lr_min=args.lr_min, dt=args.dt,
                       train_timesteps=args.train_timesteps,
                       loss_weight_floor=args.loss_weight_floor,
                       split_epoch=args.split_epoch, ema_decay=args.ema_decay,
                       clip_norm=args.clip_norm or None,
                       skip_nonfinite_updates=args.skip_nonfinite,
                       seed=args.seed, log_step=args.log_step)
    ckpt_dir = os.path.join(args.out, "checkpoints")
    resume = args.resume
    if args.resume_fixture:
        from pigs_tpu_torch.convert import load_train_fixture
        fcfg, net, opt, ema, data = load_train_fixture(args.resume_fixture,
                                                       device=device)
        if fcfg.capacity != cfg.capacity:
            p.error(f"the fixture's capacity {fcfg.capacity} is not "
                    f"{cfg.capacity}")
        epoch = int(data["train_epoch"])
        if (latest_epoch(ckpt_dir) or -1) < epoch:
            names = [k for k, _ in net.named_parameters()]
            save_checkpoint(ckpt_dir, epoch, dict(net.named_parameters()), opt,
                            [], ema=dict(zip(names, ema)))
        resume = True

    log_path = os.path.join(args.out, "train.log")
    os.makedirs(args.out, exist_ok=True)

    def log_fn(msg):
        print(msg, flush=True)
        with open(log_path, "a") as f:
            f.write(str(msg) + "\n")

    result = train(cfg, tcfg, checkpoint_dir=ckpt_dir, resume=resume,
                   log_fn=log_fn, device=device)
    network = result.network
    if result.ema is not None:
        log_fn("rolling out with EMA params")
        with torch.no_grad():
            for p_, e in zip(network.parameters(), result.ema):
                p_.copy_(e)
    frames, evo_time = rollout(cfg, network, n_steps=args.rollout_steps,
                               res=args.res, dt=args.dt, device=device)
    summary = {"epochs": args.epochs, "training_loss": [
        float(x) for x in result.training_loss[-5:]],
        "evo_time_s": evo_time, "device": (
            torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")}
    with np.load(args.fixture) as z:
        scorable = (float(z["config_dt"]) == args.dt
                    and int(z["config_nx"]) == args.nx
                    and int(z["config_capacity"]) == cfg.capacity
                    and args.res == int(z["config_res"]))
        if scorable:
            m = rollout_metrics(frames[:, 0], z["fd_frames"])
            summary["mean_rel_norm"] = m["mean_rel_norm"]
            summary["per_step_rel_norm"] = m["per_step_rel_norm"]
            log_fn(f"mean rel-L2 vs FD: {m['mean_rel_norm']:.6f} (JAX-CPU "
                   f"rollout of the exported checkpoint: "
                   f"{float(z['jax_mean_rel_l2']):.6f})")
        else:
            log_fn("rollout not scored: its setting is not the fixture's")
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: v for k, v in summary.items()
                      if k != "per_step_rel_norm"}))


if __name__ == "__main__":
    main()
