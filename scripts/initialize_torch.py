#!/usr/bin/env python
"""Fit-to-target mixture initialization with the PyTorch port: the modes and
flags of scripts/initialize.py for pigs_tpu_torch, plus ``--device``.

Modes (the positional ``target``):
  gaussian   two anisotropic bumps (the default recipe: nx 50 -> 2500
             Gaussians at capacity 4096, 1024 samples, 6000 iterations)
  sinusoid   cos(1.5 pi x) cos(1.5 pi y)
  f          curl-fit one frame of an FNO-format .npy (--fno, --index,
             --frame): periodic, nx * nx Gaussians at capacity
  convert    curl-fit frame 0 of the first --count trajectories of --fno
             into an NSDataset .npz (nx capped at 20)
  <path>     an image file, read through matplotlib (imported only in this
             mode; a machine without matplotlib cannot run it, so this mode
             is checked on the CPU only)

The fit renders the result on a --render-res grid (K1 on the card) and
writes ``fit.npz`` (raw parameters, active mask, render, block losses)
under --out, by default build/initialize/.  ``convert`` writes --out if it
ends in .npz, else <out>/ns_data.npz.

Examples:
  python scripts/initialize_torch.py gaussian --device cuda
  python scripts/initialize_torch.py sinusoid --nx 10 --capacity 128 \\
      --iters 200 --device cpu
  python scripts/initialize_torch.py convert --fno build/ns_fno.npy \\
      --count 8 --seed 1 --out build/ns_data_port.npz
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("target",
                   help="'gaussian' | 'sinusoid' | 'f' | 'convert' | "
                        "image path (CPU only: needs matplotlib)")
    p.add_argument("--nx", type=int, default=50)
    p.add_argument("--capacity", type=int, default=4096)
    p.add_argument("--iters", type=int, default=6000)
    p.add_argument("--split-every", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="build/initialize")
    p.add_argument("--render-res", type=int, default=128)
    p.add_argument("--fno", default=None,
                   help="FNO .npy (T, res, res, N) for 'f'/'convert' modes")
    p.add_argument("--index", type=int, default=0,
                   help="trajectory index for 'f' mode")
    p.add_argument("--frame", type=int, default=0,
                   help="vorticity frame to fit in 'f' mode")
    p.add_argument("--count", type=int, default=None,
                   help="trajectories to convert in 'convert' mode")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import numpy as np
    import torch

    from pigs_tpu_torch.ops.mixture import eval_mixture_image
    from pigs_tpu_torch.train import fit as fit_mod
    from pigs_tpu_torch.train.fit import (FitConfig, fit, gaussian_pair_target,
                                          image_target, sinusoid_target)

    device = torch.device(args.device)
    if args.target == "convert":
        from pigs_tpu_torch.train.ns_data import convert_fno
        out = (args.out if args.out.endswith(".npz")
               else os.path.join(args.out, "ns_data.npz"))
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        convert_fno(args.fno, out, count=args.count,
                    nx=min(args.nx, 20), iters=args.iters, seed=args.seed,
                    device=device)
        return

    cfg = FitConfig(nx=args.nx, capacity=args.capacity, iters=args.iters,
                    split_every_blocks=args.split_every)

    if args.target == "f":
        from pigs_tpu_torch.train.ns_data import load_fno
        frame = load_fno(args.fno)[args.index, :, :, args.frame]
        cfg = cfg._replace(curl=True, periodic=True, tanh_means=False,
                           capacity=cfg.nx * cfg.nx)
        target = image_target(torch.as_tensor(frame, dtype=torch.float32,
                                              device=device))
    elif args.target == "gaussian":
        target = gaussian_pair_target(cfg)
    elif args.target == "sinusoid":
        target = sinusoid_target()
    else:
        import matplotlib.image as mpimg
        img = np.asarray(mpimg.imread(args.target), np.float32)
        if img.ndim == 3:
            img = img[..., 0]
        target = image_target(torch.as_tensor(img, device=device))

    generator = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    # fit reads every block's loss, so the device is done when it returns.
    params, active, losses = fit(cfg, target, generator, device)
    seconds = time.perf_counter() - t0
    os.makedirs(args.out, exist_ok=True)
    with torch.no_grad():
        means, conics, values = fit_mod._concrete(cfg, params)
        img = eval_mixture_image(means, conics, values, args.render_res,
                                 mask=active)
    np.savez(os.path.join(args.out, "fit.npz"),
             raw_means=params.raw_means.cpu().numpy(),
             values=params.values.cpu().numpy(),
             raw_scaling=params.raw_scaling.cpu().numpy(),
             transforms=params.transforms.cpu().numpy(),
             active=active.cpu().numpy(), render=img.cpu().numpy(),
             losses=np.asarray(losses))
    print(f"final loss {losses[-1]:.6f}, "
          f"active {int(active.sum())}, saved to {args.out}; "
          f"{cfg.iters // cfg.block_iters * cfg.block_iters} iterations in "
          f"{seconds:.2f} s on {device}")


if __name__ == "__main__":
    main()
