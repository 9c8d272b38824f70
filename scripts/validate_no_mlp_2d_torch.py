#!/usr/bin/env python
"""20-timestep 2D no-MLP solve of the PyTorch port validated against the
port's finite-difference solution (the port of
scripts/validate_no_mlp_2d.py, with its flags and defaults, plus
``--device``).

Per timestep the Gaussian field is rendered on a grid (padded by
``--pad-domain``) and compared, on the central [-scale, scale]^2 crop, to a
``solve_fd_2d`` trajectory started from the *rendered* t=0 field.
``summary.json`` holds the JAX script's fields plus the device, the card's
``nvidia-smi`` name and power limit, the iterations each timestep ran and
the iterations per second of the solve.  ``--states PATH`` also writes the
solve's states after every timestep (raw parameters, active mask, loss and
iterations, stacked over the timesteps) as an ``.npz``: the benchmark's
stored states of the 2-D Burgers solve are written so, from the published
flags on an H100::

  python scripts/validate_no_mlp_2d_torch.py --problem burgers --timesteps 20 \\
      --lr-min 1e-4 --states artifacts/no_mlp_burgers2d_states_torch.npz

The output goes to
``build/no_mlp_2d_<problem>`` unless ``--out`` names another directory, so
the committed JAX results stay as they are.

Examples:
  python scripts/validate_no_mlp_2d_torch.py --problem burgers --timesteps 20 \\
      --lr-min 1e-4
  python scripts/validate_no_mlp_2d_torch.py --problem wave --dt 0.01 \\
      --n-samples 2048 --active-sampling 0.5 --pad-domain 2 --lr-min 1e-4
  python scripts/validate_no_mlp_2d_torch.py --device cpu --timesteps 3 \\
      --n-init 5 --capacity 64 --n-samples 128 --max-iters 300 --res 16
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
    p.add_argument("--problem", default="burgers",
                   choices=["diffusion", "burgers", "wave"])
    p.add_argument("--scale", type=float, default=2.5)
    p.add_argument("--n-init", type=int, default=20)
    p.add_argument("--capacity", type=int, default=1024)
    p.add_argument("--timesteps", type=int, default=20)
    p.add_argument("--dt", type=float, default=0.1)
    p.add_argument("--n-samples", type=int, default=1024)
    p.add_argument("--max-iters", type=int, default=5000)
    p.add_argument("--densify-every", type=int, default=3,
                   help="densify every N blocks; 0 = off")
    p.add_argument("--warm-up-blocks", type=int, default=300,
                   help="blocks before densification may fire within a "
                        "timestep (300 = never within 5000 iterations)")
    p.add_argument("--min-keep", type=int, default=0,
                   help="pruning floor (0 = the reference's criterion)")
    p.add_argument("--active-sampling", type=float, default=0.0,
                   help="fraction of collocation samples drawn around the "
                        "active Gaussians")
    p.add_argument("--lr-min", type=float, default=None,
                   help="cosine-decay the per-step Adam lr from 1e-2 to this "
                        "over max_iters (default: constant lr)")
    p.add_argument("--init-raw-scaling", type=float, default=-5.0,
                   help="initial log-variance")
    p.add_argument("--pad-domain", type=float, default=1.0,
                   help="run the FD ground truth on a domain this many times "
                        "wider than [-scale, scale]^2 and compare on the "
                        "central crop, out of reach of the FD walls' "
                        "reflections")
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--states", default=None,
                   help="write every timestep's state to this .npz")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    import numpy as np
    import torch

    from pigs_tpu_torch.ops.mixture import eval_mixture
    from pigs_tpu_torch.pde import Problem
    from pigs_tpu_torch.train.no_mlp import NoMLPConfig, concrete, solve
    from pigs_tpu_torch.utils.card import card_description
    from pigs_tpu_torch.utils.fd import solve_fd_2d
    from pigs_tpu_torch.utils.sampling import grid_samples

    device = torch.device(args.device)
    out_dir = args.out or os.path.join("build", f"no_mlp_2d_{args.problem}")
    os.makedirs(out_dir, exist_ok=True)

    problem = Problem[args.problem.upper()]
    cfg = NoMLPConfig(problem=problem, d=2, scale=args.scale,
                      n_init=args.n_init, capacity=args.capacity,
                      n_samples=args.n_samples, dt=args.dt,
                      max_iters=args.max_iters, min_keep=args.min_keep,
                      warm_up_blocks=args.warm_up_blocks,
                      init_raw_scaling=args.init_raw_scaling,
                      lr_min=args.lr_min,
                      active_sampling=args.active_sampling)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    sync()
    t0 = time.time()
    traj = solve(cfg, generator, args.timesteps,
                 densify_every=args.densify_every or None, device=device)
    sync()
    solve_s = time.time() - t0

    # Render every timestep on a (possibly padded) grid (axis 0 = x, like FD).
    pad = args.pad_domain
    res = int(round(args.res * pad))
    wide = cfg.scale * pad
    xs = grid_samples(res, 2, wide, device=device)
    fields, losses, counts, iters = [], [], [], []
    c = cfg.c
    with torch.no_grad():
        for snap in traj:
            means, conics, values = concrete(cfg, snap["params"])
            u = eval_mixture(means, conics, values, xs, order=0,
                             mask=snap["active"]).u
            fields.append(u.cpu().numpy().reshape(res, res, c))
            losses.append(snap["loss"])
            counts.append(int(snap["active"].sum()))
            iters.append(snap["iters"])
    fields = np.stack(fields)                       # (T, res, res, c)

    u0 = torch.from_numpy(fields[0].squeeze(-1) if c == 1 else fields[0])
    gt = solve_fd_2d(u0.to(device), wide, cfg.dt, args.timesteps - 1,
                     problem=args.problem, nu=cfg.nu).cpu().numpy()
    if c == 1:
        gt = gt[..., None]

    # Compare on the central [-scale, scale]^2 crop (all of it when pad=1).
    coords = np.linspace(-1.0, 1.0, res) * wide
    sel = np.abs(coords) <= cfg.scale + 1e-6
    rel = []
    for i in range(args.timesteps):
        a = fields[i][np.ix_(sel, sel)].reshape(-1)
        b = gt[i][np.ix_(sel, sel)].reshape(-1)
        denom = np.linalg.norm(b)
        rel.append(float(np.linalg.norm(a - b) / (denom if denom else 1.0)))

    if args.states:
        def stacked(key):
            return np.stack([snap["params"]._asdict()[key].cpu().numpy()
                             for snap in traj])
        np.savez(args.states, **{k: stacked(k) for k in
                                 ("raw_means", "values", "raw_scaling",
                                  "transforms")},
                 active=np.stack([snap["active"].cpu().numpy()
                                  for snap in traj]),
                 loss=np.asarray(losses), iters=np.asarray(iters))

    np.save(os.path.join(out_dir, "fields.npy"), fields)
    np.save(os.path.join(out_dir, "fd_gt.npy"), gt)
    summary = {"problem": args.problem, "timesteps": args.timesteps,
               "dt": args.dt, "solve_s": solve_s,
               "args": {k: v for k, v in vars(args).items() if k != "out"},
               "per_step_rel_l2": rel, "max_rel_l2": max(rel),
               "mean_rel_l2": float(np.mean(rel)),
               "per_step_loss": losses, "active_counts": counts,
               "per_step_iters": iters,
               "iters_per_s": sum(iters) / solve_s,
               "device": str(device), "card": card_description(device)}
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print("per-step rel-L2 vs FD:", " ".join(f"{v:.4f}" for v in rel))
    print(f"max {max(rel):.4f}  mean {np.mean(rel):.4f}  "
          f"solve {solve_s:.1f}s ({sum(iters)} iterations, "
          f"{sum(iters) / solve_s:.1f}/s)  gaussians {counts[0]}->{counts[-1]}"
          f"  on {summary['card'] or device}")
    if args.problem == "burgers" and args.timesteps == 20:
        print("earlier runs of the published flags: this port on an H100 "
              "mean 0.0985 max 0.2914; the JAX package mean 0.0998 "
              "max 0.2988")


if __name__ == "__main__":
    main()
