#!/usr/bin/env python
"""Neighbour pairs per K4 and K5 warp at the models' real aggregation inputs.

K4 (pigs_tpu_torch/ops/csrc/aggregate_fwd.cu) gives one warp a query row
and one slice of the key axis, and a warp walks its row's neighbour pairs
in that slice one after another, so the kernel's time follows its heaviest
warp. K5 (aggregate_bwd.cu) takes the same grid for its row pass, and for
its column pass one key column and one slice of the rows (the 32-row
chunks dealt alike). For each real input (the flagship's initial state,
the training fixture's state, the NS held-out state at t=0) this prints
the index range of the active Gaussians, the most neighbours of any row,
and, at each grid target of `aggregate_kernel.fwd_geometry`, the most
pairs any warp holds: K4 (and K5's row pass) when the key axis is cut into
runs of keys and when its 32-key chunks are dealt to the slices round
robin (what both kernels do), and K5's column pass with dealt row chunks.
The neighbour rule is the kernel's (`kernel_mask`). Runs on the CPU in
about a minute:

  python scripts/aggregate_balance_torch.py
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def real_inputs(device):
    """``(label, cfg, network, state)`` of the three real inputs."""
    import torch

    from pigs_tpu_torch.convert import load_fixture, load_train_fixture
    from pigs_tpu_torch.models.model import make_initial_state
    from pigs_tpu_torch.models.state import MixtureState
    from pigs_tpu_torch.train.pn import NSDataset

    art = os.path.join(ROOT, "artifacts")
    cfg, net, _ = load_fixture(os.path.join(
        art, "burgers_ns4096_ema2_torch.npz"), device=device)
    yield "flagship t=0", cfg, net, make_initial_state(cfg, device=device)
    tcfg, tnet, _, _, d = load_train_fixture(os.path.join(
        art, "burgers_ns4096_ema2_train_torch.npz"), device=device)

    def t(key):
        x = torch.from_numpy(d[key])
        return x.to(device=device, dtype=torch.float32
                    if x.is_floating_point() else x.dtype)
    yield ("training fixture", tcfg, tnet,
           MixtureState(*(t("input_" + f) for f in MixtureState._fields)))
    ncfg, nnet, fix = load_fixture(os.path.join(
        art, "ns_vorttrain_torch.npz"), device=device)
    data = NSDataset.load(os.path.join(art, "ns_data_8traj.npz"),
                          device=device)
    yield ("NS t=0", ncfg, nnet,
           data.state_for(ncfg, int(fix["config_held_out"])))


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--sms", type=int, default=132, help="the card's SMs")
    p.add_argument("--threads", type=int, default=4)
    args = p.parse_args()

    import torch

    from pigs_tpu_torch.models.model import network_inputs
    from pigs_tpu_torch.ops import aggregate_kernel as ak

    torch.set_num_threads(args.threads)
    unit = ak.KEY_SLICE_UNIT
    for label, cfg, network, state in real_inputs(torch.device("cpu")):
        with torch.no_grad():
            inputs = network_inputs(cfg, state)
        means, radii = inputs[0], ak.radii_of(inputs[1], inputs[8])
        mask = ak.kernel_mask(means, radii, 3.0, cfg.period)
        n = mask.shape[0]
        chunks = -(-n // unit)

        def chunk_counts(m):      # (rows of m, chunks of its columns)
            return torch.nn.functional.pad(m, (0, chunks * unit - n)) \
                .reshape(n, chunks, unit).sum(2)
        per_chunk = chunk_counts(mask)             # row i, key chunk c
        per_row_chunk = chunk_counts(mask.T)       # column j, row chunk c
        active = (radii > -float("inf")).nonzero().flatten()
        print(f"{label}: n={n}, {len(active)} active in slots "
              f"{int(active.min())}-{int(active.max())}, "
              f"{int(mask.sum())} pairs, at most {int(mask.sum(1).max())} "
              "a row", flush=True)
        for b in (2, 4, 6, 8):
            _, slices, slice_len = ak.fwd_geometry(n, args.sms, b)
            run = slice_len // unit
            runs = max(int(per_chunk[:, s * run:(s + 1) * run].sum(1).max())
                       for s in range(slices))
            dealt = max(int(per_chunk[:, s::slices].sum(1).max())
                        for s in range(slices))
            column = max(int(per_row_chunk[:, s::slices].sum(1).max())
                         for s in range(slices))
            print(f"  {b} blocks per SM: {slices} slices; most pairs a warp "
                  f"holds: runs of keys {runs}, dealt chunks {dealt} (K4 "
                  f"and K5's row pass), K5's column pass {column}",
                  flush=True)


if __name__ == "__main__":
    main()
