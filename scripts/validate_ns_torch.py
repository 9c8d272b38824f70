#!/usr/bin/env python
"""Make the Navier-Stokes dataset, train the model with the PyTorch port, roll
it out and score it against the solver's vorticity frames.

scripts/validate_ns.py's steps for pigs_tpu_torch.  Steps 1-2 run only
when ``--ns-data`` does not exist: generate ``--n-traj`` trajectories with
the spectral solver (``--steps``, ``--res``, ``--dt``, ``--nu``; white
noise from ``--seed``, or the draws in ``--noise``) into
``<ns-data>_fno.npy``, then curl-fit frame 0 of each (``--nx``,
``--fit-iters``; trajectory i from seed ``--seed`` + i) into ``--ns-data``,
printing each trajectory's final loss, the conversion's wall time and,
where the shapes agree, the largest difference from the committed dataset
(artifacts/ns_data_8traj.npz).  ``--noise artifacts/fit_torch.npz`` holds
JAX's draws for seed 1, the committed dataset's.  The default
``--ns-data`` is the committed file, so nothing is generated then.

Steps 3-4 run on that dataset: PN training with the
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

Examples (the full pipeline on JAX's draws, then the rollout only; three
epochs resumed from the exported checkpoint):
  python scripts/validate_ns_torch.py --ns-data build/ns_data_port.npz \
      --n-traj 8 --noise artifacts/fit_torch.npz
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

COMMITTED_NS_DATA = "artifacts/ns_data_8traj.npz"


def make_dataset(args, device, summary):
    """Steps 1-2: generate the FNO-format trajectories and curl-fit them
    into ``args.ns_data``."""
    import numpy as np

    from pigs_tpu_torch.train.ns_data import convert_fno, generate_fno

    fno = os.path.splitext(args.ns_data)[0] + "_fno.npy"
    os.makedirs(os.path.dirname(fno) or ".", exist_ok=True)
    noise = None
    if args.noise:
        with np.load(args.noise) as z:
            noise = z["noise"][:args.n_traj]
    t0 = time.perf_counter()
    generate_fno(fno, n_traj=args.n_traj, res=args.res, steps=args.steps,
                 dt=args.dt, nu=args.nu, seed=args.seed, device=device,
                 noise=noise)
    summary["generate_s"] = time.perf_counter() - t0
    losses = []

    def log_fn(msg):
        print(msg, flush=True)
        if msg.startswith("trajectory "):
            losses.append(float(msg.rsplit(" ", 1)[1]))
    t0 = time.perf_counter()
    convert_fno(fno, args.ns_data, nx=args.nx, iters=args.fit_iters,
                seed=args.seed, log_fn=log_fn, device=device)
    summary["convert_s"] = time.perf_counter() - t0
    summary["fit_final_losses"] = losses
    print(f"curl-fit conversion: {summary['convert_s']:.1f} s", flush=True)
    if os.path.exists(COMMITTED_NS_DATA):
        with np.load(COMMITTED_NS_DATA) as a, np.load(args.ns_data) as b:
            if a["frames"].shape == b["frames"].shape:
                diff = np.abs(a["frames"] - b["frames"]).max(axis=(1, 2, 3))
                summary["max_abs_vs_committed_frames"] = diff.tolist()
                print("max abs vs the committed frames, by trajectory: "
                      + " ".join(f"{d:.3e}" for d in diff), flush=True)


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--fixture", default="artifacts/ns_vorttrain_torch.npz",
                   help="rollout fixture: the untrained network, the "
                        "held-out index and the JAX-CPU reference")
    p.add_argument("--ns-data", default=COMMITTED_NS_DATA,
                   help="the NSDataset .npz; generated and converted into "
                        "when it does not exist")
    p.add_argument("--n-traj", type=int, default=4,
                   help="trajectories to generate (steps 1-2 only)")
    p.add_argument("--steps", type=int, default=50,
                   help="solver frames per trajectory after frame 0")
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--nu", type=float, default=1e-3)
    p.add_argument("--nx", type=int, default=20,
                   help="curl-fit grid edge (nx * nx Gaussians)")
    p.add_argument("--fit-iters", type=int, default=2000)
    p.add_argument("--noise", default=None,
                   help=".npz whose 'noise' (n_traj, 128, 128) is the white "
                        "noise to generate from (default: draws from --seed)")
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

    from pigs_tpu_torch.convert import checkpoint_train_fixture, load_fixture
    from pigs_tpu_torch.train.pn import (NSDataset, TrainConfig,
                                         rollout_metrics, rollout_vorticity,
                                         train)

    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    summary = {}
    if not os.path.exists(args.ns_data):
        make_dataset(args, device, summary)
    cfg, network, fixture = load_fixture(args.fixture, device=device)
    data = NSDataset.load(args.ns_data, device=device)
    index = int(fixture["config_held_out"])
    if index >= data.means.shape[0]:
        raise ValueError(f"{args.ns_data} holds {data.means.shape[0]} "
                         f"trajectories; the fixture holds out trajectory "
                         f"{index}")
    steps, res = int(fixture["config_steps"]), int(fixture["config_res"])

    if args.epochs > 0:
        resume = args.resume
        if args.resume_fixture:
            cfg = checkpoint_train_fixture(args.resume_fixture,
                                           args.ckpt_dir, device)
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
