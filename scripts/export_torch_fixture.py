#!/usr/bin/env python
"""Export a trained PN checkpoint and its JAX rollout for the PyTorch port.

Restores the EMA parameters of an orbax checkpoint through
``pigs_tpu.train.checkpoint.restore_checkpoint`` (the bare step directory
staged under a manager root, as scripts/select_split_stop.py does), rolls the
model out with the JAX package on the CPU, solves the finite-difference
ground truth from the rendered initial field exactly as
scripts/validate_pn.py does, and writes one ``np.savez_compressed`` file:

  params/...            the EMA params, flax paths joined with '/'
  frequencies           the network's fixed embedding frequencies
  config_*              problem, nx, capacity, dt, res, steps
  jax_frames            (steps, 1, res, res) JAX-CPU rollout frames
  fd_frames             (steps + 1, res, res) FD frames in image layout
  jax_mean_rel_l2       the JAX-CPU rollout's mean rel-L2 against fd_frames
  jax_per_step_rel_l2   (steps,) its per-step values

The port (pigs_tpu_torch) loads this file on a machine without JAX.

Example:
  JAX_PLATFORMS=cpu python scripts/export_torch_fixture.py \
      --ckpt artifacts/burgers_ns4096_ema2_ckpt_30000 \
      --out artifacts/burgers_ns4096_ema2_torch.npz
"""

import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# The flagship's rollout (scripts/validate_pn.py with --dt 0.1): nx=20,
# capacity 1664, 50 steps rendered at 64x64, densify off.
NX, DT, STEPS, RES = 20, 0.1, 50, 64


def flagship_config():
    from pigs_tpu.models.model import ModelConfig
    from pigs_tpu.pde import IntegrationRule, Problem
    return ModelConfig.create(Problem.BURGERS, IntegrationRule.TRAPEZOID,
                              nx=NX, ny=NX, d=2, scale=1.0)


def restore_ema_params(ckpt: str, cfg):
    """(network, EMA params) of the single-step orbax checkpoint ``ckpt``."""
    from pigs_tpu.train.checkpoint import restore_checkpoint
    from pigs_tpu.train.pn import TrainConfig, init_training
    network, template, _, _ = init_training(cfg, TrainConfig(n_epochs=1))
    step = os.path.basename(os.path.normpath(ckpt)).rsplit("_", 1)[-1]
    with tempfile.TemporaryDirectory() as td:
        shutil.copytree(ckpt, os.path.join(td, step if step.isdigit() else "0"))
        restored = restore_checkpoint(td, template)
    if restored.ema_params is None:
        raise ValueError(f"{ckpt} carries no ema_params")
    return network, restored.ema_params


def flatten_params(tree) -> dict:
    """A flax params tree -> {'/'-joined path: numpy array}."""
    import jax
    import numpy as np
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        flat[key] = np.asarray(leaf)
    return flat


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--ckpt", default="artifacts/burgers_ns4096_ema2_ckpt_30000")
    p.add_argument("--out", default="artifacts/burgers_ns4096_ema2_torch.npz")
    args = p.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from pigs_tpu.train.pn import rollout, rollout_metrics
    from pigs_tpu.utils.fd import solve_fd_2d

    cfg = flagship_config()
    network, params = restore_ema_params(args.ckpt, cfg)
    flat = flatten_params(params)
    print(f"restored {args.ckpt}: {len(flat)} leaves, "
          f"{sum(v.size for v in flat.values())} numbers", flush=True)

    frames, _ = rollout(cfg, network, params, n_steps=STEPS, res=RES, dt=DT)
    u0_fd = jnp.asarray(np.flipud(frames[0, 0]).T)
    gt = np.asarray(solve_fd_2d(u0_fd, cfg.scale, DT, STEPS,
                                problem="burgers", nu=cfg.coeff.nu))
    fd_frames = np.stack([np.flipud(g.T) for g in gt])
    metrics = rollout_metrics(frames[:, 0], fd_frames)
    print(f"JAX-CPU mean rel-L2 vs FD: {metrics['mean_rel_norm']:.6f}",
          flush=True)

    freq_size = (25 - 1) // cfg.d // 2
    frequencies = np.asarray(
        jax.random.normal(jax.random.PRNGKey(42), (freq_size,),
                          dtype=jnp.float32) * 10.0)
    np.savez_compressed(
        args.out, **flat,
        frequencies=frequencies,
        config_problem=np.asarray(cfg.problem.name),
        config_nx=np.asarray(NX),
        config_capacity=np.asarray(cfg.capacity),
        config_dt=np.asarray(DT),
        config_res=np.asarray(RES),
        config_steps=np.asarray(STEPS),
        jax_frames=np.asarray(frames, np.float32),
        fd_frames=fd_frames.astype(np.float32),
        jax_mean_rel_l2=np.asarray(metrics["mean_rel_norm"]),
        jax_per_step_rel_l2=np.asarray(metrics["per_step_rel_norm"]))
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")


if __name__ == "__main__":
    main()
