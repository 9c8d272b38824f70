#!/usr/bin/env python
"""Direct (no-MLP) PDE solve CLI of the PyTorch port (the port of
scripts/solve_no_mlp.py, with its flags and defaults, plus ``--device``).

Writes per timestep ``gaussians_<problem>_<i>.npz`` (the raw parameters,
the active mask and the field rendered on a ``--render-res`` grid) and
``summary.json`` (the losses, plus the device, the card's ``nvidia-smi``
name and power limit and the iterations each timestep ran).  The output
goes to ``build/no_mlp_<d>d`` unless ``--out`` names another directory.

Examples:
  python scripts/solve_no_mlp_torch.py --problem burgers --d 1 --timesteps 13
  python scripts/solve_no_mlp_torch.py --problem wave --d 2 --timesteps 20
  python scripts/solve_no_mlp_torch.py --device cpu --timesteps 3 \\
      --capacity 64 --max-iters 300
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--problem", default="burgers",
                   choices=["diffusion", "burgers", "wave"])
    p.add_argument("--d", type=int, default=1, choices=[1, 2])
    p.add_argument("--scale", type=float, default=2.5)
    p.add_argument("--n-init", type=int, default=25)
    p.add_argument("--capacity", type=int, default=1024)
    p.add_argument("--timesteps", type=int, default=13)
    p.add_argument("--dt", type=float, default=None)
    p.add_argument("--max-iters", type=int, default=5000)
    p.add_argument("--densify-every", type=int, default=0,
                   help="densify every N blocks (0 = off)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--render-res", type=int, default=200)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    import numpy as np
    import torch

    from pigs_tpu_torch.ops.mixture import eval_mixture
    from pigs_tpu_torch.pde import Problem
    from pigs_tpu_torch.train.no_mlp import NoMLPConfig, concrete, solve
    from pigs_tpu_torch.utils.card import card_description
    from pigs_tpu_torch.utils.sampling import grid_samples

    device = torch.device(args.device)
    out_dir = args.out or os.path.join("build", f"no_mlp_{args.d}d")
    os.makedirs(out_dir, exist_ok=True)

    cfg = NoMLPConfig(
        problem=Problem[args.problem.upper()], d=args.d, scale=args.scale,
        n_init=args.n_init, capacity=args.capacity,
        dt=args.dt if args.dt is not None else (0.05 if args.d == 1 else 0.1),
        max_iters=args.max_iters)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    traj = solve(cfg, generator, args.timesteps,
                 densify_every=args.densify_every or None, device=device)

    xs = grid_samples(args.render_res, args.d, cfg.scale, device=device)
    losses = []
    for i, snap in enumerate(traj):
        with torch.no_grad():
            means, conics, values = concrete(cfg, snap["params"])
            u = eval_mixture(means, conics, values, xs, order=0,
                             mask=snap["active"]).u
        raw = {k: v.cpu().numpy() for k, v in snap["params"]._asdict().items()}
        np.savez(os.path.join(out_dir, f"gaussians_{args.problem}_{i}.npz"),
                 **raw, active=snap["active"].cpu().numpy(),
                 field=u.cpu().numpy())
        losses.append(snap["loss"])
        print(f"timestep {i}: loss {snap['loss']:.6f} "
              f"active {int(snap['active'].sum())} iterations {snap['iters']}")
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump({"losses": losses,
                   "per_step_iters": [s["iters"] for s in traj],
                   "device": str(device), "card": card_description(device)},
                  f, indent=2)


if __name__ == "__main__":
    main()
