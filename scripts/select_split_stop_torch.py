#!/usr/bin/env python
"""Stop-step selection for eval-time densification with the PyTorch port
(the counterpart of scripts/select_split_stop.py).

Selection and evaluation are kept apart:

  1. SELECTION: roll the model out from K held-out randomized ICs
     (``randomize_state``, the distribution training draws from) for every
     candidate stop step (``rollout(densify=stop)``; 0 = no densification),
     scoring each against the FD solution from that rollout's rendered t=0
     field, as scripts/select_split_stop.py scores.  Every stop of one IC
     renders the same t=0 field, so its FD solution is solved once (the
     JAX script solves it again for every stop: the same scores).
  2. EVALUATION: on the standard IC (``make_initial_state``) report
       * parity   -- stop 0, the reference's eval semantics,
       * held-out -- the stop step chosen in (1),
       * oracle   -- the best stop step on this trajectory (an upper bound).

The model comes from a rollout fixture (scripts/export_torch_fixture.py;
the default holds the dt=0.1 checkpoint's raw parameters).  The held-out
ICs are drawn from ``torch.Generator(seed + k)``, or, with ``--ic-fixture``
(``export_torch_fixture.py --kind select-split``), taken from the JAX
package's draws, since the two RNGs give different numbers.  Writes
``summary.json`` with scripts/select_split_stop.py's keys (``ckpt`` names
the fixture) and the device.

Example:
  python scripts/select_split_stop_torch.py \\
      --ic-fixture artifacts/select_split_torch.npz --out build/select_split
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--fixture", default="artifacts/burgers_dt01_torch.npz",
                   help="rollout fixture with the model's parameters")
    p.add_argument("--dt", type=float, default=0.1)
    p.add_argument("--n-select", type=int, default=3,
                   help="held-out selection ICs")
    p.add_argument("--stops", default="0,8,14,20,26,32,38,44,50",
                   help="candidate stop steps (0 = no densification)")
    p.add_argument("--rollout-steps", type=int, default=50)
    p.add_argument("--res", type=int, default=64)
    p.add_argument("--seed", type=int, default=100,
                   help="base seed of the held-out ICs")
    p.add_argument("--ic-fixture", default=None,
                   help="take the held-out ICs from this JAX export")
    p.add_argument("--out", default="build/select_split_stop")
    p.add_argument("--device", default="cuda")
    return p


def held_out_states(args, cfg, device):
    """The ``--n-select`` held-out ICs."""
    import numpy as np
    import torch

    from pigs_tpu_torch.models.model import randomize_state
    from pigs_tpu_torch.models.state import MixtureState
    if args.ic_fixture is None:
        return [randomize_state(cfg, torch.Generator().manual_seed(
            args.seed + k), n=cfg.nx, device=device)
            for k in range(args.n_select)]
    with np.load(args.ic_fixture) as z:
        ics = {f: z[f"ic_{f}"] for f in MixtureState._fields}
    if args.n_select > len(ics["means"]):
        raise ValueError(f"{args.ic_fixture} holds {len(ics['means'])} ICs, "
                         f"--n-select is {args.n_select}")
    return [MixtureState(*(torch.from_numpy(ics[f][k]).to(device)
                           for f in MixtureState._fields))
            for k in range(args.n_select)]


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from pigs_tpu_torch.convert import load_fixture
    from pigs_tpu_torch.models.model import make_initial_state
    from pigs_tpu_torch.train.pn import rollout_frames, rollout_metrics
    from pigs_tpu_torch.utils.card import card_description
    from pigs_tpu_torch.utils.fd import solve_fd_2d

    device = torch.device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg, network, _ = load_fixture(args.fixture, device=device)
    problem = cfg.problem.name.lower()
    stops = [int(s) for s in args.stops.split(",")]

    def fd_truth(frames):
        """The FD trajectory from the rendered t=0 field, in image layout
        (image rows are y flipped, the FD grid's axis 0 is x)."""
        u0 = np.ascontiguousarray(np.flipud(frames[0, 0]).T)
        gt = solve_fd_2d(torch.from_numpy(u0).to(device), cfg.scale,
                         args.dt, args.rollout_steps, problem=problem,
                         nu=cfg.coeff.nu).cpu().numpy()
        return np.stack([np.flipud(g.T) for g in gt])

    def scores(state):
        """{stop: mean rel-L2 against the FD truth} for one IC."""
        out, truth = {}, None
        for stop in stops:
            frames = rollout_frames(cfg, network, state, args.rollout_steps,
                                    args.res, args.dt,
                                    densify=stop).cpu().numpy()
            if truth is None:
                truth = fd_truth(frames)
            out[stop] = rollout_metrics(frames[:, 0],
                                        truth)["mean_rel_norm"]
        return out

    t0 = time.time()
    per_ic = [scores(state) for state in held_out_states(args, cfg, device)]
    select = {}
    for stop in stops:
        vals = [ic[stop] for ic in per_ic]
        select[stop] = float(np.mean(vals))
        print(f"selection stop={stop}: mean rel-L2 {select[stop]:.4f} "
              f"(per-IC {['%.3f' % v for v in vals]})", flush=True)
    heldout_stop = min(select, key=select.get)

    eval_scores = scores(make_initial_state(cfg, device=device))
    oracle_stop = min(eval_scores, key=eval_scores.get)
    summary = {
        "problem": problem, "ckpt": args.fixture, "stops": stops,
        "selection_mean_rel_l2": {str(k): v for k, v in select.items()},
        "heldout_stop": heldout_stop,
        "eval_mean_rel_l2": {str(k): v for k, v in eval_scores.items()},
        "parity": eval_scores[0] if 0 in eval_scores else None,
        "heldout": eval_scores[heldout_stop],
        "oracle_stop": oracle_stop,
        "oracle": eval_scores[oracle_stop],
        "wall_s": time.time() - t0,
        "device": card_description(device) or str(device),
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({k: summary[k] for k in
                      ("parity", "heldout_stop", "heldout", "oracle_stop",
                       "oracle")}, indent=1), flush=True)
    return summary


if __name__ == "__main__":
    main()
