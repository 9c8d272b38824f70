#!/usr/bin/env python
"""Render rollout-vs-ground-truth figures for a results directory
(scripts/plot_rollout.py for pigs_tpu_torch; needs matplotlib).

Produces ``rollout_panel.png`` (three rows: PN prediction, ground truth,
|difference|, at a handful of timesteps) and ``rollout_rel_norm.png`` (the
per-step relative-L2 curve) from the rollout_frames.npy, fd_gt_frames.npy
and summary.json that scripts/validate_pn_torch.py writes (or the
rollout_w.npy / gt_w.npy of a Navier-Stokes run), through
pigs_tpu_torch.utils.plotting.render_rollout_artifacts.

Example:
  python scripts/plot_rollout_torch.py build/validate_pn --steps 0 10 25 49
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("results_dir")
    p.add_argument("--steps", type=int, nargs="*", default=None,
                   help="timesteps to show (default: 6 evenly spaced)")
    p.add_argument("--channel", type=int, default=0,
                   help="field channel for multi-channel problems (wave)")
    args = p.parse_args(argv)

    from pigs_tpu_torch.utils.plotting import render_rollout_artifacts
    written = render_rollout_artifacts(args.results_dir, channel=args.channel,
                                       steps=args.steps)
    for w in written:
        print(f"wrote {w}")
    if not written:
        print(f"no rollout artifacts found in {args.results_dir}")
    return written


if __name__ == "__main__":
    main()
