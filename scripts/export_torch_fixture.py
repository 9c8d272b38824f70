#!/usr/bin/env python
"""Export a trained PN checkpoint and JAX references for the PyTorch port.

``--kind rollout`` (the default) restores the EMA parameters of an orbax
checkpoint through ``pigs_tpu.train.checkpoint.restore_checkpoint`` (the
bare step directory staged under a manager root, as
scripts/select_split_stop.py does), rolls the model out with the JAX package
on the CPU, solves the finite-difference ground truth from the rendered
initial field exactly as scripts/validate_pn.py does, and writes one
``np.savez_compressed`` file:

  params/...            the EMA params, flax paths joined with '/'
  frequencies           the network's fixed embedding frequencies
  config_*              problem, nx, capacity, dt, res, steps
  jax_frames            (steps, 1, res, res) JAX-CPU rollout frames
  fd_frames             (steps + 1, res, res) FD frames in image layout
  jax_mean_rel_l2       the JAX-CPU rollout's mean rel-L2 against fd_frames
  jax_per_step_rel_l2   (steps,) its per-step values

``--kind train`` restores the whole training state (raw params, EMA params,
optax Adam state) under the flagship recipe, draws the inputs of the first
epoch that ``train`` runs when it resumes at the checkpoint's epoch (samples
and the randomized IC with noise, exactly as ``train_epoch`` draws them),
and runs the JAX package in float64 on the CPU from there:

  params/..., ema/..., adam_mu/..., adam_nu/..., adam_count
                        the checkpoint, float32 as stored
  frequencies, config_* as above
  train_*               the recipe: epoch, n_epochs, base_lr, dt, epsilon,
                        loss_weight_floor, clip_norm, ema_decay, ...
  input_*               samples, time_samples, bc_samples and the IC state
                        (means, scaling, transforms, u, active, boundary)
  step_losses           one pn_step from that state: [pde, bc, cons, init,
                        mag, total] (float64)
  step_grads/...        its gradients (float64)
  step_params/...       the parameters after its Adam update (float64)
  step_loss_weight      its new loss weight
  epoch_per_step        (steps, 6) losses of the 20-step split-regime epoch
  epoch_active          (steps, capacity) active masks after each step
  epoch_params/...      the parameters after the epoch (float64)

``--kind ns`` restores the EMA parameters of the Navier-Stokes checkpoint
(``artifacts/ns_vorttrain_ckpt_20000``: NAVIER_STOKES, TRAPEZOID, nx 20,
capacity 640, split criteria "vorticity"), rolls out the held-out (last)
trajectory of ``artifacts/ns_data_8traj.npz`` with the JAX package on the
CPU exactly as scripts/validate_ns.py does with densify off (the vorticity
w = d(u_y)/dx - d(u_x)/dy rendered at order 1 on the 64x64 pixel centres,
frame 0 plus 50 steps), and writes:

  params/..., frequencies, config_* (and config_split_criteria,
                        config_held_out: the trajectory's index)
  jax_frames            (steps + 1, res, res) JAX-CPU vorticity frames, [y, x]
  jax_mean_rel_l2       their mean rel-L2 against the dataset's frames
  jax_t0_rel_l2         frame 0's rel-L2 (the curl fit's error)
  jax_per_step_rel_l2   (steps + 1,) the per-frame values

The ground-truth frames stay in the dataset file; the fixture does not copy
them.

``--kind ns-train`` restores the NS checkpoint's whole training state under
results_ns_r5_vorttrain's recipe (``ns_train_config``), draws the inputs of
the first epoch that ``train(ns_data=...)`` runs when it resumes at the
checkpoint's epoch on the first seven trajectories (the last is held out),
and runs the JAX package in float64 on the CPU from there.  It writes the
``--kind train`` keys with these differences:

  config_split_criteria, config_held_out   as for --kind ns
  input_data_index      the stored state the epoch starts from (the input_*
                        state fields hold it)
  input_recon_targets   (train_timesteps, n_samples) the reconstruction
                        targets: the trajectory's frame i + 1 at the samples
  step_losses           [pde, bc, cons, init, mag, total], the total with
                        the reconstruction term
  step_recon            that term, 5 * mean((w - target)^2)
  epoch_per_step        the split-regime epoch with the vorticity criteria,
                        totals with the reconstruction term

``--kind no-mlp`` runs the no-MLP direct solver (``pigs_tpu.train.no_mlp``)
on the CPU at the full width of the committed 2-D Burgers recipe
(results_no_mlp_2d_burgers/summary.json's args: capacity 1024, n_init 20,
1024 samples, dt 0.1, lr 1e-2 -> lr_min 1e-4 over max_iters 5000,
init_raw_scaling -5, densify every 3 blocks after 300): the IC fit and one
dynamics block in float32, as ``solve`` runs them from PRNGKey(seed); then
the next block of that timestep, in float32 draws and float64 arithmetic.
It writes (``<prefix>/<field>`` holds a RawParams field: raw_means,
values, raw_scaling, transforms):

  config_*              the recipe (problem, d, scale, n_init, capacity,
                        n_samples, dt, nu, lr, lr_min, block_iters,
                        max_iters, tol, init_raw_scaling, warm_up_blocks,
                        min_keep, active_sampling, sampling_inflate,
                        densify_every, seed)
  ic/..., ic_active     the parameters after the IC fit (the previous
                        mixture of the block), float32
  start/..., start_active, start_adam_mu/..., start_adam_nu/...,
  start_adam_count      the parameters and optax Adam state after the IC
                        fit and one dynamics block, float32
  draws_base, draws_time  (block_iters, n_samples, 2) and (block_iters,
                        n_samples): the next block's uniform draws, split
                        from its key exactly as _run_block and draw_samples
                        split it (jax_block_draws), float32
  block_loss, block/..., block_grad_acc/..., block_adam_mu/...,
  block_adam_nu/..., block_adam_count
                        that block run in float64 on those draws: its mean
                        loss, parameters, summed gradients and Adam state
  densify_in/..., densify_in_active, densify_mean_grad
                        a densify input at full width: the start state (its
                        Adam state start_adam_*) with every 40th active
                        value scaled by 1e-3 (pruning fires), and dynamics
                        block 0's mean raw_means gradient with every 50th
                        kept slot's scaled by 20 (splitting fires)
  densify0_*, densifyk_*  densify's output (params, active, adam mu/nu) with
                        min_keep 0 and with min_keep = densify_min_keep
                        (five above the count the criterion keeps, so its
                        fallback fires)

``--kind fit`` exports the fit-to-target initializer (``pigs_tpu.train.
fit``) and the NS data pipeline (``pigs_tpu.train.ns_data``), all from the
JAX package on the CPU.  Trajectory 7's frame 0 of
artifacts/ns_data_8traj.npz is curl-fitted in ``fit_fno_trajectory``'s
config (nx 20, capacity 400, 1024 samples, periodic) from PRNGKey(8), the
key ``convert_fno(seed=1)`` gives trajectory 7, for one block in float32;
the next block then runs on its float32 draws in float64 arithmetic.  A
``sinusoid_target`` fit at ``scripts/initialize.py``'s widths (nx 50,
capacity 4096) runs one block of SPLIT_ITERS iterations in float32 from
PRNGKey(0) and is split once: 315 Gaussians are dropped and 98 split.  (A
``gaussian_pair_target`` fit splits none: its last raw_means gradients
stay under the split's 5e-4 threshold.)  It
writes (``<prefix>/<field>`` a RawParams field, ``<prefix>/<group>_mu``,
``_nu``, ``_count`` one of the four Adams of the fit's multi_transform,
groups means, values, scaling, transforms):

  config_*, split_config_*  the two FitConfigs (d, nx, capacity, n_samples,
                        block_iters, iters, split_every_blocks, tanh_means,
                        curl, periodic); config_traj, config_seed
  frame                 (64, 64) the fitted vorticity frame, [y, x]
  start/..., start_active, start_adam/...
                        the curl fit after its first block, float32
  draws                 (FIT_BLOCK_ITERS, 1024, 2) the second block's U[0, 1)
                        draws, split from its key as _fit_block splits it
                        (jax_fit_draws), float32
  block_loss, block/..., block_adam/..., block_last_grad
                        that block in float64: its mean loss, parameters,
                        Adam states and last raw_means gradient
  split_in/..., split_in_active, split_in_adam/..., split_in_last_grad
                        the sinusoid fit's state before the split, float32
  split/..., split_active, split_adam/...
                        _eig_split's output (float32)
  noise                 (8, 128, 128) the float32 normal draws of
                        generate_fno(seed=1) (its key-split sequence): the
                        white noise the committed dataset was solved from

``--kind no-mlp-1d`` runs the 1-D Burgers IC fit (``solve_no_mlp.py``'s
defaults: 25 Gaussians, capacity 1024, 128 samples, lr 1e-2, blocks of 100
iterations) from PRNGKey(seed) for seeds 0-9, as ``solve`` keys timestep 0,
and scores it by the rel-L2 against exp(-2 x^2) on 201 points (chip_smoke.py
phase 12d's score).  It writes:

  final_rel_l2          (10,) each seed's fit as solve_timestep stops it
  block_loss, block_rel_l2
                        (10, 50) the same fits followed block by block for
                        50 blocks (past the stopping rule): each block's
                        mean loss and the rel-L2 after it
  draws_base, draws_time  (5, 100, 128, 1), (5, 100, 128): seed 0's first
                        five blocks of draws (jax_block_draws), float32

``--kind select-split`` writes the JAX references of
scripts/select_split_stop.py for scripts/select_split_stop_torch.py:

  ic_means, ic_scaling, ic_transforms, ic_u, ic_active, ic_boundary
                        (3, capacity, ...) ``randomize_state(cfg,
                        PRNGKey(100 + k), n=20)`` for k < 3, the held-out
                        ICs the JAX script draws (float32)
  <case>_stops, <case>_steps, <case>_selection, <case>_eval
                        select_split_stop.py run on the JAX CPU with one
                        held-out IC (--n-select 1) at each case's stops and
                        rollout steps: the selection score of each stop (the
                        one IC's mean rel-L2) and the standard IC's score;
                        cases ``smoke`` (stops 0, 8, 14; 50 steps) and
                        ``test`` (stops 0, 8; 5 steps)

``--params raw`` (rollout) exports a checkpoint's raw parameters where it
carries no EMA (artifacts/burgers_dt01_ckpt_30000); ``config_params`` says
which were exported.

The port (pigs_tpu_torch) loads these files on a machine without JAX.

Examples:
  JAX_PLATFORMS=cpu python scripts/export_torch_fixture.py \
      --ckpt artifacts/burgers_ns4096_ema2_ckpt_30000 \
      --out artifacts/burgers_ns4096_ema2_torch.npz
  JAX_PLATFORMS=cpu python scripts/export_torch_fixture.py --kind train \
      --out artifacts/burgers_ns4096_ema2_train_torch.npz
  JAX_PLATFORMS=cpu python scripts/export_torch_fixture.py --kind ns
  JAX_PLATFORMS=cpu python scripts/export_torch_fixture.py --kind ns-train
  JAX_PLATFORMS=cpu python scripts/export_torch_fixture.py --kind no-mlp
  JAX_PLATFORMS=cpu python scripts/export_torch_fixture.py --kind fit
  JAX_PLATFORMS=cpu python scripts/export_torch_fixture.py --kind no-mlp-1d
  JAX_PLATFORMS=cpu python scripts/export_torch_fixture.py --kind select-split
  JAX_PLATFORMS=cpu python scripts/export_torch_fixture.py --params raw \
      --ckpt artifacts/burgers_dt01_ckpt_30000 \
      --out artifacts/burgers_dt01_torch.npz
"""

import argparse
import os
import shutil
import subprocess
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


def restore_params(ckpt: str, cfg, which: str = "ema"):
    """(network, params) of the single-step orbax checkpoint ``ckpt``: its
    EMA params (``which="ema"``) or its raw ones (``"raw"``, for a
    checkpoint that carries no EMA)."""
    from pigs_tpu.train.checkpoint import restore_checkpoint
    from pigs_tpu.train.pn import TrainConfig, init_training
    network, template, _, _ = init_training(cfg, TrainConfig(n_epochs=1))
    step = os.path.basename(os.path.normpath(ckpt)).rsplit("_", 1)[-1]
    with tempfile.TemporaryDirectory() as td:
        shutil.copytree(ckpt, os.path.join(td, step if step.isdigit() else "0"))
        restored = restore_checkpoint(td, template)
    if which == "raw":
        return network, restored.params
    if restored.ema_params is None:
        raise ValueError(f"{ckpt} carries no ema_params (export its raw "
                         "params with --params raw)")
    return network, restored.ema_params


def flagship_train_config():
    """The flagship recipe (BENCHMARKS.md, results_burgers_ns4096_ema2),
    resumed for three epochs past the checkpoint's 30000."""
    from pigs_tpu.train.pn import TrainConfig
    return TrainConfig(n_epochs=30003, n_samples=4096, lr=3e-4, lr_min=2e-5,
                       dt=DT, train_timesteps=50, loss_weight_floor=0.05,
                       ema_decay=0.999, clip_norm=1.0,
                       skip_nonfinite_updates=True)


def restore_training_state(ckpt: str, cfg, tcfg):
    """(network, opt, params, opt_state, ema_params, epoch) of ``ckpt``."""
    from pigs_tpu.train.checkpoint import restore_checkpoint
    from pigs_tpu.train.pn import init_training
    network, template, opt, opt_template = init_training(cfg, tcfg)
    step = os.path.basename(os.path.normpath(ckpt)).rsplit("_", 1)[-1]
    with tempfile.TemporaryDirectory() as td:
        shutil.copytree(ckpt, os.path.join(td, step))
        r = restore_checkpoint(td, template, opt_template)
    if r.opt_state is None or r.ema_params is None:
        raise ValueError(f"{ckpt} lacks opt_state or ema_params")
    return network, opt, r.params, r.opt_state, r.ema_params, r.step


def flatten_params(tree) -> dict:
    """A flax params tree -> {'/'-joined path: numpy array}."""
    import jax
    import numpy as np
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        flat[key] = np.asarray(leaf)
    return flat


def frequencies_of(cfg):
    import jax
    import jax.numpy as jnp
    import numpy as np
    return np.asarray(jax.random.normal(
        jax.random.PRNGKey(42), ((25 - 1) // cfg.d // 2,),
        dtype=jnp.float32) * 10.0)


def adam_of(opt_state):
    """The ScaleByAdamState inside an inject_hyperparams(chain(clip, adam))
    state."""
    import jax
    import optax
    is_adam = lambda x: isinstance(x, optax.ScaleByAdamState)
    found = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=is_adam)
             if is_adam(s)]
    if len(found) != 1:
        raise ValueError(f"expected one ScaleByAdamState, found {len(found)}")
    return found[0]


def float32_default_normal():
    """Patch ``jax.random.normal`` to draw float32 unless told otherwise.

    The network draws its fixed embedding frequencies with
    ``jax.random.normal(PRNGKey(42), ...)`` and no dtype.  The flagship was
    trained without x64, so its frequencies are the float32 draw; under x64
    the same call draws float64 numbers, which are different numbers, and
    the reference would not be the flagship's network.  Every other draw
    here names its dtype."""
    from unittest import mock

    import jax
    import jax.numpy as jnp
    normal = jax.random.normal

    def f32_normal(key, shape=(), dtype=None):
        return normal(key, shape, jnp.float32 if dtype is None else dtype)
    return mock.patch.object(jax.random, "normal", f32_normal)


def export_train(ckpt: str, out: str):
    """Write the training fixture (see the module docstring)."""
    with float32_default_normal():
        _export_train(ckpt, out)


def _export_train(ckpt: str, out: str):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pigs_tpu.models.model import (adaptive_split, compute_loss,
                                       forward_step, randomize_state_dynamic,
                                       sample_fields)
    from pigs_tpu.train.pn import _filter_finite, pn_step
    from pigs_tpu.utils.sampling import (boundary_band_samples,
                                         collocation_samples)

    cfg, tcfg = flagship_config(), flagship_train_config()
    network, opt, params, opt_state, ema, epoch = restore_training_state(
        ckpt, cfg, tcfg)
    adam = adam_of(opt_state)
    print(f"restored {ckpt} at epoch {epoch}; adam count {int(adam.count)}",
          flush=True)

    # The first epoch of train(resume=True): key split as train() and
    # train_epoch() do it, in float32 as the run draws it.
    key = jax.random.PRNGKey(tcfg.seed)
    key, sub = jax.random.split(key)
    k_rand, k_s, k_t, k_bc, k_n, _ = jax.random.split(sub, 6)
    m = tcfg.n_samples
    samples = collocation_samples(k_s, m, cfg.d, cfg.scale, cfg.dtype)
    time_samples = jax.random.uniform(k_t, (m,), cfg.dtype)
    bc_samples = boundary_band_samples(k_bc, m, cfg.scale, cfg.dtype)
    n_max = min(39, int(np.floor(np.sqrt(cfg.capacity - 100))))
    n = int(jnp.minimum(jax.random.randint(k_n, (), 15, 40), n_max))
    state = randomize_state_dynamic(cfg, k_rand, n, n_max=n_max)
    n_steps = min(min(epoch // tcfg.bootstrap_rate + 1,
                      tcfg.initial_timesteps), tcfg.train_timesteps)
    base_lr = tcfg.base_lr_at(epoch)

    # Everything below in float64.
    f64 = jnp.float64
    up = lambda tree: jax.tree_util.tree_map(
        lambda x: x.astype(f64) if jnp.issubdtype(x.dtype, jnp.floating)
        else x, tree)
    cfg64 = cfg._replace(dtype=f64)
    params64, opt64, state64 = up(params), up(opt_state), up(state)
    smp, ts, bc = up((samples, time_samples, bc_samples))
    prev = sample_fields(cfg64, state64, smp, bc)

    def loss_fn(p):
        new_state, deltas = forward_step(cfg64, network, p, state64, t=0.0)
        curr = sample_fields(cfg64, new_state, smp, bc)
        return _filter_finite(compute_loss(cfg64, new_state, deltas, prev,
                                           curr, smp, ts, 0.0, tcfg.dt)).total

    grads = jax.grad(loss_fn)(params64)
    step_args = dict(loss_weight_floor=jnp.asarray(tcfg.loss_weight_floor, f64),
                     skip_nonfinite=tcfg.skip_nonfinite_updates)
    (p1, _, _, _, losses, total, lw) = pn_step(
        cfg64, network, opt, params64, opt64, state64, prev, smp, ts, bc,
        jnp.ones((), f64), jnp.asarray(base_lr, f64), tcfg.epsilon,
        jnp.asarray(0.0, f64), tcfg.dt, **step_args)
    step_losses = np.asarray([losses.pde, losses.bc, losses.conservation,
                              losses.initial, losses.magnitude, total])
    print(f"one pn_step: losses {step_losses}", flush=True)

    # The split-regime epoch, step by step (train_epoch's loop form).
    split = jax.jit(adaptive_split, static_argnames=("cfg",))
    sample = jax.jit(sample_fields, static_argnames=("cfg",))
    p, o, s, pf, loss_weight = params64, opt64, state64, prev, jnp.ones((), f64)
    per_step, active = [], []
    for i in range(n_steps):
        before = s
        (p, o, s, pf, losses, total, loss_weight) = pn_step(
            cfg64, network, opt, p, o, s, pf, smp, ts, bc, loss_weight,
            jnp.asarray(base_lr, f64), tcfg.epsilon,
            jnp.asarray(i * tcfg.dt, f64), tcfg.dt, **step_args)
        s = split(cfg64, s, before)
        pf = sample(cfg64, s, smp, bc)
        per_step.append([float(x) for x in (losses.pde, losses.bc,
                                            losses.conservation,
                                            losses.initial, losses.magnitude,
                                            total)])
        active.append(np.asarray(s.active))
        print(f"epoch step {i}: total {per_step[-1][5]:.6f}, active "
              f"{int(active[-1].sum())}", flush=True)

    prefixed = lambda prefix, tree: {
        prefix + k[len("params"):]: v for k, v in flatten_params(tree).items()}
    np.savez_compressed(
        out, **flatten_params(params), **prefixed("ema", ema),
        **prefixed("adam_mu", adam.mu), **prefixed("adam_nu", adam.nu),
        adam_count=np.asarray(adam.count),
        frequencies=frequencies_of(cfg),
        config_problem=np.asarray(cfg.problem.name),
        config_nx=np.asarray(NX), config_capacity=np.asarray(cfg.capacity),
        config_dt=np.asarray(DT),
        train_epoch=np.asarray(epoch), train_n_epochs=np.asarray(tcfg.n_epochs),
        train_n_samples=np.asarray(m), train_lr=np.asarray(tcfg.lr),
        train_lr_min=np.asarray(tcfg.lr_min), train_base_lr=np.asarray(base_lr),
        train_dt=np.asarray(tcfg.dt), train_epsilon=np.asarray(tcfg.epsilon),
        train_timesteps=np.asarray(tcfg.train_timesteps),
        train_loss_weight_floor=np.asarray(tcfg.loss_weight_floor),
        train_clip_norm=np.asarray(tcfg.clip_norm),
        train_ema_decay=np.asarray(tcfg.ema_decay),
        train_split_epoch=np.asarray(tcfg.split_epoch),
        train_n_steps=np.asarray(n_steps), input_grid_n=np.asarray(n),
        input_samples=np.asarray(samples),
        input_time_samples=np.asarray(time_samples),
        input_bc_samples=np.asarray(bc_samples),
        **{f"input_{f}": np.asarray(getattr(state, f))
           for f in state._fields},
        step_losses=step_losses, **prefixed("step_grads", grads),
        **prefixed("step_params", p1), step_loss_weight=np.asarray(lw),
        epoch_per_step=np.asarray(per_step),
        epoch_active=np.stack(active), **prefixed("epoch_params", p))
    print(f"wrote {out} ({os.path.getsize(out)} bytes)")


def ns_config():
    """scripts/validate_ns.py's config for the NS checkpoint: nx 20,
    capacity ((20*20 + 127) // 128 + 1) * 128 = 640, vorticity criteria."""
    from pigs_tpu.models.model import ModelConfig
    from pigs_tpu.pde import IntegrationRule, Problem
    return ModelConfig.create(Problem.NAVIER_STOKES, IntegrationRule.TRAPEZOID,
                              nx=NX, ny=NX, d=2, scale=1.0, capacity=640,
                              split_criteria="vorticity")


def ns_train_config():
    """The NS recipe of results_ns_r5_vorttrain (scripts/validate_ns.py with
    the r4c flags that BENCHMARKS.md gives it: 2048 samples, 30 timesteps,
    cosine lr 3e-4 -> 2e-5, loss-weight floor 0.05, EMA 0.999, clip 1.0,
    skipped non-finite updates, split regime after epoch 10000), resumed for
    three epochs past the checkpoint's 20000."""
    from pigs_tpu.train.pn import TrainConfig
    return TrainConfig(n_epochs=20003, n_samples=2048, lr=3e-4, lr_min=2e-5,
                       dt=DT, train_timesteps=30, loss_weight_floor=0.05,
                       split_epoch=10000, ema_decay=0.999, clip_norm=1.0,
                       skip_nonfinite_updates=True)


def export_ns_train(ckpt: str, data_path: str, out: str):
    """Write the NS training fixture (see the module docstring)."""
    with float32_default_normal():
        _export_ns_train(ckpt, data_path, out)


def _export_ns_train(ckpt: str, data_path: str, out: str):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pigs_tpu.models.model import (adaptive_split, compute_loss,
                                       forward_step, sample_fields)
    from pigs_tpu.train.pn import NSDataset, _filter_finite, pn_step
    from pigs_tpu.utils.sampling import (boundary_band_samples,
                                         collocation_samples)

    cfg, tcfg = ns_config(), ns_train_config()
    network, opt, params, opt_state, ema, epoch = restore_training_state(
        ckpt, cfg, tcfg)
    adam = adam_of(opt_state)
    print(f"restored {ckpt} at epoch {epoch}; adam count {int(adam.count)}",
          flush=True)
    data = NSDataset.load(data_path)
    held_out = int(data.means.shape[0]) - 1
    train_data = NSDataset(*(x[:-1] for x in data))

    # The first epoch of train(resume=True, ns_data=train_data): key split
    # as train() and train_epoch() do it, in float32 as the run draws it.
    key = jax.random.PRNGKey(tcfg.seed)
    key, sub = jax.random.split(key)
    _, k_s, k_t, k_bc, k_n, _ = jax.random.split(sub, 6)
    m = tcfg.n_samples
    samples = collocation_samples(k_s, m, cfg.d, cfg.scale, cfg.dtype)
    time_samples = jax.random.uniform(k_t, (m,), cfg.dtype)
    bc_samples = boundary_band_samples(k_bc, m, cfg.scale, cfg.dtype)
    index = int(jax.random.randint(k_n, (), 0, train_data.means.shape[0]))
    state = train_data.state_for(cfg, index)
    targets = jnp.stack([train_data.recon_target(index, i + 1, samples)
                         for i in range(tcfg.train_timesteps)])
    n_steps = min(min(epoch // tcfg.bootstrap_rate + 1,
                      tcfg.initial_timesteps), tcfg.train_timesteps)
    base_lr = tcfg.base_lr_at(epoch)
    print(f"trajectory {index}, {n_steps} steps, base lr {base_lr:.6e}",
          flush=True)

    # Everything below in float64.
    f64 = jnp.float64
    up = lambda tree: jax.tree_util.tree_map(
        lambda x: x.astype(f64) if jnp.issubdtype(x.dtype, jnp.floating)
        else x, tree)
    cfg64 = cfg._replace(dtype=f64)
    params64, opt64, state64 = up(params), up(opt_state), up(state)
    smp, ts, bc, tg = up((samples, time_samples, bc_samples, targets))
    prev = sample_fields(cfg64, state64, smp, bc)

    def recon_of(curr, target):
        recon = 5.0 * jnp.mean((curr.w - target) ** 2)
        return jnp.where(jnp.isfinite(recon), recon, 0.0)

    def loss_fn(p):
        new_state, deltas = forward_step(cfg64, network, p, state64, t=0.0)
        curr = sample_fields(cfg64, new_state, smp, bc)
        total = _filter_finite(compute_loss(cfg64, new_state, deltas, prev,
                                            curr, smp, ts, 0.0, tcfg.dt)).total
        return total + recon_of(curr, tg[0])

    grads = jax.grad(loss_fn)(params64)
    step_args = dict(loss_weight_floor=jnp.asarray(tcfg.loss_weight_floor, f64),
                     skip_nonfinite=tcfg.skip_nonfinite_updates)
    (p1, _, _, curr, losses, total, lw) = pn_step(
        cfg64, network, opt, params64, opt64, state64, prev, smp, ts, bc,
        jnp.ones((), f64), jnp.asarray(base_lr, f64), tcfg.epsilon,
        jnp.asarray(0.0, f64), tcfg.dt, recon_target=tg[0], **step_args)
    step_losses = np.asarray([losses.pde, losses.bc, losses.conservation,
                              losses.initial, losses.magnitude, total])
    step_recon = float(recon_of(curr, tg[0]))
    print(f"one pn_step: losses {step_losses}, recon {step_recon}",
          flush=True)

    # The split-regime epoch, step by step (train_epoch's loop form).
    split = jax.jit(adaptive_split, static_argnames=("cfg",))
    sample = jax.jit(sample_fields, static_argnames=("cfg",))
    p, o, s, pf, loss_weight = params64, opt64, state64, prev, jnp.ones((), f64)
    per_step, active = [], []
    for i in range(n_steps):
        before = s
        (p, o, s, pf, losses, total, loss_weight) = pn_step(
            cfg64, network, opt, p, o, s, pf, smp, ts, bc, loss_weight,
            jnp.asarray(base_lr, f64), tcfg.epsilon,
            jnp.asarray(i * tcfg.dt, f64), tcfg.dt, recon_target=tg[i],
            **step_args)
        s = split(cfg64, s, before)
        pf = sample(cfg64, s, smp, bc)
        per_step.append([float(x) for x in (losses.pde, losses.bc,
                                            losses.conservation,
                                            losses.initial, losses.magnitude,
                                            total)])
        active.append(np.asarray(s.active))
        print(f"epoch step {i}: total {per_step[-1][5]:.6f}, active "
              f"{int(active[-1].sum())}", flush=True)

    prefixed = lambda prefix, tree: {
        prefix + k[len("params"):]: v for k, v in flatten_params(tree).items()}
    np.savez_compressed(
        out, **flatten_params(params), **prefixed("ema", ema),
        **prefixed("adam_mu", adam.mu), **prefixed("adam_nu", adam.nu),
        adam_count=np.asarray(adam.count),
        frequencies=frequencies_of(cfg),
        config_problem=np.asarray(cfg.problem.name),
        config_nx=np.asarray(NX), config_capacity=np.asarray(cfg.capacity),
        config_dt=np.asarray(DT),
        config_split_criteria=np.asarray(cfg.split_criteria),
        config_held_out=np.asarray(held_out),
        train_epoch=np.asarray(epoch), train_n_epochs=np.asarray(tcfg.n_epochs),
        train_n_samples=np.asarray(m), train_lr=np.asarray(tcfg.lr),
        train_lr_min=np.asarray(tcfg.lr_min), train_base_lr=np.asarray(base_lr),
        train_dt=np.asarray(tcfg.dt), train_epsilon=np.asarray(tcfg.epsilon),
        train_timesteps=np.asarray(tcfg.train_timesteps),
        train_loss_weight_floor=np.asarray(tcfg.loss_weight_floor),
        train_clip_norm=np.asarray(tcfg.clip_norm),
        train_ema_decay=np.asarray(tcfg.ema_decay),
        train_split_epoch=np.asarray(tcfg.split_epoch),
        train_n_steps=np.asarray(n_steps), input_data_index=np.asarray(index),
        input_samples=np.asarray(samples),
        input_time_samples=np.asarray(time_samples),
        input_bc_samples=np.asarray(bc_samples),
        input_recon_targets=np.asarray(targets),
        **{f"input_{f}": np.asarray(getattr(state, f))
           for f in state._fields},
        step_losses=step_losses, step_recon=np.asarray(step_recon),
        **prefixed("step_grads", grads), **prefixed("step_params", p1),
        step_loss_weight=np.asarray(lw),
        epoch_per_step=np.asarray(per_step),
        epoch_active=np.stack(active), **prefixed("epoch_params", p))
    print(f"wrote {out} ({os.path.getsize(out)} bytes)")


def export_ns(ckpt: str, data_path: str, out: str):
    """Write the NS rollout fixture (see the module docstring)."""
    with float32_default_normal():
        _export_ns(ckpt, data_path, out)


def _export_ns(ckpt: str, data_path: str, out: str):
    from functools import partial

    import jax
    import jax.numpy as jnp
    import numpy as np

    from pigs_tpu.models.model import covariance_of, forward_step
    from pigs_tpu.ops.mixture import eval_mixture
    from pigs_tpu.train.pn import NSDataset, rollout_metrics

    cfg = ns_config()
    network, params = restore_params(ckpt, cfg)
    flat = flatten_params(params)
    data = NSDataset.load(data_path)
    index = int(data.means.shape[0]) - 1

    # scripts/validate_ns.py's render: pixel centres, [x, y] samples, the
    # frame transposed to [y, x].
    centers = (jnp.arange(RES) + 0.5) / RES * 2.0 - 1.0
    gx, gy = jnp.meshgrid(centers, centers, indexing="ij")
    samples = jnp.stack([gx, gy], axis=-1).reshape(-1, 2)

    def render_w(state):
        _, conics = covariance_of(state)
        out = eval_mixture(state.means, conics, state.u, samples, order=1,
                           mask=state.active, period=cfg.period,
                           diff_samples=False)
        w = out.ux[:, 0, 1] - out.ux[:, 1, 0]
        return w.reshape(RES, RES).T

    state = data.state_for(cfg, index)
    step = jax.jit(partial(forward_step, cfg, network))
    render = jax.jit(render_w)
    frames = [np.asarray(render(state))]
    for _ in range(STEPS):
        state, _ = step(params, state)
        frames.append(np.asarray(render(state)))
    frames = np.stack(frames)
    gt = np.asarray(data.frames[index]).transpose(2, 0, 1)
    m = rollout_metrics(frames, gt)
    fit = rollout_metrics(frames[:1], gt[:1])
    print(f"JAX-CPU held-out trajectory {index}: mean rel-L2 "
          f"{m['mean_rel_norm']:.6f}, t=0 {fit['mean_rel_norm']:.6f}",
          flush=True)
    np.savez_compressed(
        out, **flat, frequencies=frequencies_of(cfg),
        config_problem=np.asarray(cfg.problem.name),
        config_nx=np.asarray(NX), config_capacity=np.asarray(cfg.capacity),
        config_dt=np.asarray(DT), config_res=np.asarray(RES),
        config_steps=np.asarray(STEPS),
        config_split_criteria=np.asarray(cfg.split_criteria),
        config_held_out=np.asarray(index),
        jax_frames=frames.astype(np.float32),
        jax_mean_rel_l2=np.asarray(m["mean_rel_norm"]),
        jax_t0_rel_l2=np.asarray(fit["mean_rel_norm"]),
        jax_per_step_rel_l2=np.asarray(m["per_step_rel_norm"]))
    print(f"wrote {out} ({os.path.getsize(out)} bytes)")


NO_MLP_SUMMARY = "results_no_mlp_2d_burgers/summary.json"
NO_MLP_FIELDS = ("raw_means", "values", "raw_scaling", "transforms")


def no_mlp_recipe(summary: str = NO_MLP_SUMMARY):
    """(NoMLPConfig in float32, densify_every, seed) of the committed 2-D
    run's args, as scripts/validate_no_mlp_2d.py builds them."""
    import json

    from pigs_tpu.pde import Problem
    from pigs_tpu.train.no_mlp import NoMLPConfig
    with open(summary) as f:
        a = json.load(f)["args"]
    cfg = NoMLPConfig(problem=Problem[a["problem"].upper()], d=2,
                      scale=a["scale"], n_init=a["n_init"],
                      capacity=a["capacity"], n_samples=a["n_samples"],
                      dt=a["dt"], max_iters=a["max_iters"],
                      min_keep=a["min_keep"],
                      warm_up_blocks=a["warm_up_blocks"],
                      init_raw_scaling=a["init_raw_scaling"],
                      lr_min=a["lr_min"],
                      active_sampling=a["active_sampling"])
    return cfg, a["densify_every"], a["seed"]


def jax_block_draws(cfg, key, active, first_step: bool):
    """The random numbers ``pigs_tpu.train.no_mlp._run_block`` draws from
    ``key``, split as it splits them (one key per iteration, each split in
    two, the first split in three by ``draw_samples``), as numpy in the
    layout of ``pigs_tpu_torch.train.no_mlp.BlockDraws``: base, idx, z
    (None without active sampling) and time."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pigs_tpu.pde import Problem
    n, d = cfg.n_samples, cfg.d
    n_act = int(round(n * cfg.active_sampling))
    wave_ic = first_step and cfg.problem == Problem.WAVE and d == 2
    base, idx, z, time = [], [], [], []
    for k in jax.random.split(key, cfg.block_iters):
        k1, k2 = jax.random.split(k)
        k_u, k_idx, k_z = jax.random.split(k1, 3)
        if wave_ic:
            base.append(jax.random.normal(k_u, (n, d), cfg.dtype))
        else:
            base.append(jax.random.uniform(k_u, (n, d), cfg.dtype))
            if n_act:
                logits = jnp.where(active, 0.0, -jnp.inf)
                idx.append(jax.random.categorical(k_idx, logits,
                                                  shape=(n_act,)))
                z.append(jax.random.normal(k_z, (n_act, d), cfg.dtype))
        time.append(jax.random.uniform(k2, (n,), cfg.dtype))
    stack = lambda xs: np.stack([np.asarray(x) for x in xs]) if xs else None
    return stack(base), stack(idx), stack(z), stack(time)


def float32_draws():
    """Patch ``jax.random.uniform`` and ``normal`` to draw float32 numbers
    and cast them to the dtype asked for: a float64 run then sees the
    float32 run's draws."""
    from contextlib import ExitStack
    from unittest import mock

    import jax
    import jax.numpy as jnp
    stack = ExitStack()
    for name in ("uniform", "normal"):
        fn = getattr(jax.random, name)

        def f32(key, shape=(), dtype=jnp.float32, *args, _fn=fn, **kw):
            return _fn(key, shape, jnp.float32, *args, **kw).astype(dtype)
        stack.enter_context(mock.patch.object(jax.random, name, f32))
    return stack


def no_mlp_flat(prefix: str, tree) -> dict:
    """A RawParams of arrays -> {prefix/field: numpy array}."""
    import numpy as np
    return {f"{prefix}/{f}": np.asarray(x) for f, x in zip(NO_MLP_FIELDS, tree)}


def export_no_mlp(out: str):
    """Write the no-MLP fixture (see the module docstring)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from pigs_tpu.train.no_mlp import (_make_opt, _run_block, concrete,
                                       densify, init_params, solve_timestep)
    cfg, densify_every, seed = no_mlp_recipe()

    # As solve() runs timestep 0 (the IC fit) and the first block of
    # timestep 1, in float32.
    key = jax.random.PRNGKey(seed)
    params, active = init_params(cfg)
    key, sub = jax.random.split(key)
    ic, active, ic_loss = solve_timestep(cfg, params, active, None, sub,
                                         first_step=True)
    print(f"IC fit: loss {ic_loss:.3e}, {int(active.sum())} active",
          flush=True)
    means, conics, values = concrete(cfg, ic)
    prev = tuple(jax.lax.stop_gradient(x) for x in (means, conics, values)) \
        + (active,)
    key, step_key = jax.random.split(key)
    step_key, b0 = jax.random.split(step_key)
    opt_state = _make_opt(cfg).init(ic)
    start, opt_state, grad0, loss0 = _run_block(cfg, ic, opt_state, active,
                                                prev, b0, False)
    print(f"dynamics block 0: mean loss {float(loss0):.3e}", flush=True)
    adam = opt_state[0]

    # The next block: float32 draws, float64 arithmetic.
    step_key, b1 = jax.random.split(step_key)
    base, _, _, time = jax_block_draws(cfg, b1, active, False)
    f64 = jnp.float64
    up = lambda tree: jax.tree_util.tree_map(
        lambda x: x.astype(f64) if jnp.issubdtype(x.dtype, jnp.floating)
        else x, tree)
    with float32_draws():
        p64, s64, g64, l64 = _run_block(cfg._replace(dtype=f64), up(start),
                                        up(opt_state), active, up(prev), b1,
                                        False)
    print(f"dynamics block 1 (float64): mean loss {float(l64):.6e}",
          flush=True)

    # densify at full width: prune every 40th active slot's value.
    act = np.asarray(active)
    vals = np.array(start.values)
    vals[np.nonzero(act)[0][::40]] *= 1e-3
    d_in = start._replace(values=jnp.asarray(vals))
    keep = ((np.linalg.norm(vals, axis=-1) > 0.01)
            & (np.exp(np.asarray(d_in.raw_scaling)).sum(-1) < 0.5) & act)
    # The largest gradients sit on slots the criterion prunes; scale up every
    # 50th kept slot's so that splitting fires too.
    mean_grad = np.array(grad0.raw_means / cfg.block_iters)
    mean_grad[np.nonzero(keep)[0][::50]] *= 20.0
    mean_grad = jnp.asarray(mean_grad)
    min_keep = int(keep.sum()) + 5
    outs = {}
    for tag, mk in (("densify0", 0), ("densifyk", min_keep)):
        dp, ds, da = densify(cfg._replace(min_keep=mk), d_in, opt_state,
                             active, mean_grad)
        da = np.asarray(da)
        # Children land in free slots, pruned ones first: count the slots
        # whose mean was written.
        children = int((np.asarray(dp.raw_means)
                        != np.asarray(d_in.raw_means)).any(-1).sum())
        print(f"densify min_keep {mk}: {int((act & ~keep).sum())} fail the "
              f"criterion, {children} children, {int(da.sum())} active",
              flush=True)
        if tag == "densify0" and not ((act & ~keep).any() and children):
            raise ValueError("densify input does not both prune and split")
        dadam = [s for s in ds if isinstance(s, optax.ScaleByAdamState)][0]
        outs.update(no_mlp_flat(tag, dp))
        outs.update(no_mlp_flat(f"{tag}_adam_mu", dadam.mu))
        outs.update(no_mlp_flat(f"{tag}_adam_nu", dadam.nu))
        outs[f"{tag}_active"] = da

    adam64 = s64[0]
    np.savez_compressed(
        out,
        config_problem=np.asarray(cfg.problem.name), config_d=cfg.d,
        config_scale=cfg.scale, config_n_init=cfg.n_init,
        config_capacity=cfg.capacity, config_n_samples=cfg.n_samples,
        config_dt=cfg.dt, config_nu=cfg.nu, config_lr=cfg.lr,
        config_lr_min=cfg.lr_min, config_block_iters=cfg.block_iters,
        config_max_iters=cfg.max_iters, config_tol=cfg.tol,
        config_init_raw_scaling=cfg.init_raw_scaling,
        config_warm_up_blocks=cfg.warm_up_blocks,
        config_min_keep=cfg.min_keep,
        config_active_sampling=cfg.active_sampling,
        config_sampling_inflate=cfg.sampling_inflate,
        config_densify_every=densify_every, config_seed=seed,
        **no_mlp_flat("ic", ic), ic_active=act,
        **no_mlp_flat("start", start), start_active=act,
        **no_mlp_flat("start_adam_mu", adam.mu),
        **no_mlp_flat("start_adam_nu", adam.nu),
        start_adam_count=np.asarray(adam.count),
        draws_base=base, draws_time=time,
        block_loss=np.asarray(l64), **no_mlp_flat("block", p64),
        **no_mlp_flat("block_grad_acc", g64),
        **no_mlp_flat("block_adam_mu", adam64.mu),
        **no_mlp_flat("block_adam_nu", adam64.nu),
        block_adam_count=np.asarray(adam64.count),
        **no_mlp_flat("densify_in", d_in), densify_in_active=act,
        densify_mean_grad=np.asarray(mean_grad),
        densify_min_keep=min_keep, **outs)
    print(f"wrote {out} ({os.path.getsize(out)} bytes)")


FIT_TRAJ = 7            # the NS checkpoint's held-out trajectory
FIT_SEED = 1 + FIT_TRAJ  # convert_fno(seed=1) fits trajectory i from 1 + i
FIT_BLOCK_ITERS = 100   # the fixture block's iterations (a full block)
SPLIT_ITERS = 20        # iterations of the sinusoid fit before the split
FNO_SEED, FNO_TRAJ, FNO_GEN_RES = 1, 8, 128  # validate_ns.py's defaults
FIT_GROUPS = (("means", "raw_means"), ("values", "values"),
              ("scaling", "raw_scaling"), ("transforms", "transforms"))
FIT_CONFIG_FIELDS = ("d", "nx", "capacity", "n_samples", "block_iters",
                     "iters", "split_every_blocks", "tanh_means", "curl",
                     "periodic")


def jax_fit_draws(cfg, key, iters=None):
    """The U[0, 1) draws ``pigs_tpu.train.fit._fit_block`` makes from
    ``key`` (one key per iteration), the first ``iters`` of them, as numpy
    ``(iters, n_samples, d)``."""
    import jax
    import numpy as np
    keys = jax.random.split(key, cfg.block_iters)[:iters]
    return np.stack([np.asarray(jax.random.uniform(
        k, (cfg.n_samples, cfg.d), cfg.dtype)) for k in keys])


def jax_fno_noise(seed: int, n_traj: int, gen_res: int, dtype=None):
    """The white noise ``pigs_tpu.train.ns_data.generate_fno`` draws from
    ``seed`` (``random_vorticity``'s normal draw per trajectory, from its
    key-split sequence), as numpy ``(n_traj, gen_res, gen_res)``; float32
    unless ``dtype`` says otherwise."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_traj):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(
            sub, (gen_res, gen_res), jnp.float32 if dtype is None else dtype)))
    return np.stack(out)


def fit_adam_groups(opt_state) -> list:
    """The fit's multi_transform state -> its four Adams' ``(mu, nu,
    count)`` of their one field each, as numpy, in RawParams field order."""
    import numpy as np
    out = []
    for label, field in FIT_GROUPS:
        adam = opt_state.inner_states[label].inner_state[0]
        out.append((np.asarray(getattr(adam.mu, field)),
                    np.asarray(getattr(adam.nu, field)),
                    np.asarray(adam.count)))
    return out


def fit_flat(prefix: str, params=None, adam=None) -> dict:
    """RawParams and/or the Adam groups -> the fixture's keys."""
    out = no_mlp_flat(prefix, params) if params is not None else {}
    for (label, _), (mu, nu, count) in zip(FIT_GROUPS, adam or ()):
        out.update({f"{prefix}_adam/{label}_mu": mu,
                    f"{prefix}_adam/{label}_nu": nu,
                    f"{prefix}_adam/{label}_count": count})
    return out


def export_fit(data_path: str, out: str):
    """Write the fit fixture (see the module docstring)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    # The float32 parts run without x64, as the JAX package runs them.
    jax.config.update("jax_enable_x64", False)
    from pigs_tpu.train import fit as jfit

    with np.load(data_path) as z:
        frame = np.asarray(z["frames"][FIT_TRAJ, :, :, 0], np.float32)
    # fit_fno_trajectory's config and fit's key sequence.
    cfg = jfit.FitConfig(nx=20, capacity=400, iters=2000, block_iters=100,
                         curl=True, periodic=True, tanh_means=False)
    target = jfit.image_target(jnp.asarray(frame))
    params, active = jfit._init(cfg)
    opt_state = jfit._make_optimizer(cfg).init(params)
    key = jax.random.PRNGKey(FIT_SEED)
    key, sub = jax.random.split(key)
    start, opt_state, loss0, _ = jfit._fit_block(cfg, target, params,
                                                 opt_state, active, sub)
    print(f"curl fit block 0: mean loss {float(loss0):.6f}", flush=True)
    key, b1 = jax.random.split(key)
    draws = jax_fit_draws(cfg, b1, FIT_BLOCK_ITERS)
    start_adam = fit_adam_groups(opt_state)

    # The split at initialize.py's widths.
    scfg = jfit.FitConfig(block_iters=SPLIT_ITERS)
    sp, s_active = jfit._init(scfg)
    s_opt = jfit._make_optimizer(scfg).init(sp)
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    sp, s_opt, sloss, last_grad = jfit._fit_block(
        scfg, jfit.sinusoid_target(), sp, s_opt, s_active, sub)
    print(f"sinusoid fit, {SPLIT_ITERS} iterations: mean loss "
          f"{float(sloss):.6f}", flush=True)
    split_p, split_opt, split_active = jfit._eig_split(scfg, sp, s_opt,
                                                       s_active, last_grad)
    act, new = np.asarray(s_active), np.asarray(split_active)
    keep = ((np.linalg.norm(np.asarray(sp.values), axis=-1) > 0.01)
            & (np.exp(np.asarray(sp.raw_scaling)).sum(-1) < 0.2) & act)
    # Children land in free slots in index order, dropped ones first.
    children = int(new.sum() - keep.sum())
    print(f"split: {int(act.sum())} active -> {int(new.sum())}, "
          f"{int((act & ~keep).sum())} dropped, {children} children",
          flush=True)
    if not ((act & ~keep).any() and children):
        raise ValueError("the split input does not both drop and split")
    noise = jax_fno_noise(FNO_SEED, FNO_TRAJ, FNO_GEN_RES)

    # The curl fit's next block: float32 draws, float64 arithmetic.
    jax.config.update("jax_enable_x64", True)
    f64 = jnp.float64
    up = lambda tree: jax.tree_util.tree_map(
        lambda x: x.astype(f64) if jnp.issubdtype(x.dtype, jnp.floating)
        else x, tree)
    cfg64 = cfg._replace(block_iters=FIT_BLOCK_ITERS, dtype=f64)
    with float32_draws():
        p64, o64, l64, g64 = jfit._fit_block(
            cfg64, jfit.image_target(jnp.asarray(frame, f64)), up(start),
            up(opt_state), active, b1)
    print(f"curl fit block 1 (float64): mean loss {float(l64):.9f}",
          flush=True)

    def config(prefix, c):
        return {f"{prefix}_{f}": np.asarray(getattr(c, f))
                for f in FIT_CONFIG_FIELDS}
    np.savez_compressed(
        out, **config("config", cfg._replace(block_iters=FIT_BLOCK_ITERS)),
        **config("split_config", scfg),
        config_traj=FIT_TRAJ, config_seed=FIT_SEED, frame=frame,
        **fit_flat("start", start, start_adam),
        start_active=np.asarray(active), draws=draws,
        block_loss=np.asarray(l64),
        **fit_flat("block", p64, fit_adam_groups(o64)),
        block_last_grad=np.asarray(g64),
        **fit_flat("split_in", sp, fit_adam_groups(s_opt)),
        split_in_active=act, split_in_last_grad=np.asarray(last_grad),
        **fit_flat("split", split_p, fit_adam_groups(split_opt)),
        split_active=new, noise=noise)
    print(f"wrote {out} ({os.path.getsize(out)} bytes)")


# The 1-D IC fit's band (scripts/solve_no_mlp.py's defaults, Burgers d=1):
# seeds, blocks followed, evaluation points and the blocks of draws kept.
IC1D_SEEDS, IC1D_BLOCKS, IC1D_POINTS, IC1D_DRAW_BLOCKS = 10, 50, 201, 5


def export_no_mlp_1d(out: str):
    """Write the 1-D no-MLP IC-fit fixture (see the module docstring)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pigs_tpu.ops.oracle import eval_mixture_dense
    from pigs_tpu.pde import Problem
    from pigs_tpu.train.no_mlp import (NoMLPConfig, _make_opt, _run_block,
                                       concrete, init_params, solve_timestep)
    cfg = NoMLPConfig(problem=Problem.BURGERS, d=1)
    x = (jnp.linspace(-1, 1, IC1D_POINTS) * cfg.scale).reshape(-1, 1)
    target = jnp.exp(-2.0 * x[:, 0] ** 2)

    def rel_l2(params, active):
        m, c, v = concrete(cfg, params)
        u = eval_mixture_dense(m, c, v, x, order=0, mask=active).u[:, 0]
        return float(jnp.linalg.norm(u - target) / jnp.linalg.norm(target))

    final, block_loss, block_rel, base, time = [], [], [], [], []
    for seed in range(IC1D_SEEDS):
        # As solve() keys timestep 0.
        _, key = jax.random.split(jax.random.PRNGKey(seed))
        params, active = init_params(cfg)
        fitted, _, loss = solve_timestep(cfg, params, active, None, key,
                                         first_step=True)
        final.append(rel_l2(fitted, active))
        # The same fit followed block by block past its stopping rule.
        opt_state = _make_opt(cfg).init(params)
        losses, rels = [], []
        for b in range(IC1D_BLOCKS):
            key, sub = jax.random.split(key)
            if seed == 0 and b < IC1D_DRAW_BLOCKS:
                bb, _, _, tt = jax_block_draws(cfg, sub, active, True)
                base.append(bb)
                time.append(tt)
            params, opt_state, _, lb = _run_block(cfg, params, opt_state,
                                                  active, None, sub, True)
            losses.append(float(lb))
            rels.append(rel_l2(params, active))
        block_loss.append(losses)
        block_rel.append(rels)
        print(f"seed {seed}: solve_timestep loss {loss:.3e} rel-L2 "
              f"{final[-1]:.5f}; blocks 10-{IC1D_BLOCKS} rel-L2 median "
              f"{np.median(rels[10:]):.5f} max {max(rels[10:]):.5f}",
              flush=True)
    np.savez_compressed(
        out, config_seeds=np.asarray(IC1D_SEEDS),
        config_points=np.asarray(IC1D_POINTS),
        config_block_iters=np.asarray(cfg.block_iters),
        final_rel_l2=np.asarray(final),
        block_loss=np.asarray(block_loss), block_rel_l2=np.asarray(block_rel),
        draws_base=np.stack(base).astype(np.float32),
        draws_time=np.stack(time).astype(np.float32))
    print(f"wrote {out} ({os.path.getsize(out)} bytes)")


# scripts/select_split_stop.py's held-out ICs (--seed 100, --n-select 3) and
# the reduced argument sets the port is checked at: name -> (stops, steps).
SELECT_SEED, SELECT_ICS = 100, 3
SELECT_CASES = {"smoke": ("0,8,14", 50), "test": ("0,8", 5)}


def export_select_split(ckpt: str, out: str):
    """Write the select-split fixture (see the module docstring)."""
    import json

    import jax
    import numpy as np

    from pigs_tpu.models.model import randomize_state
    cfg = flagship_config()
    states = [randomize_state(cfg, jax.random.PRNGKey(SELECT_SEED + k), n=NX)
              for k in range(SELECT_ICS)]
    arrays = {f"ic_{f}": np.stack([np.asarray(getattr(s, f)) for s in states])
              for f in states[0]._fields}
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "select_split_stop.py")
    for case, (stops, steps) in SELECT_CASES.items():
        with tempfile.TemporaryDirectory() as td:
            subprocess.run([sys.executable, script, "--ckpt", ckpt,
                            "--n-select", "1", "--stops", stops,
                            "--rollout-steps", str(steps), "--seed",
                            str(SELECT_SEED), "--out", td], check=True)
            with open(os.path.join(td, "summary.json")) as f:
                summary = json.load(f)
        keys = [str(k) for k in summary["stops"]]
        arrays[f"{case}_stops"] = np.asarray(summary["stops"])
        arrays[f"{case}_steps"] = np.asarray(steps)
        arrays[f"{case}_selection"] = np.asarray(
            [summary["selection_mean_rel_l2"][k] for k in keys])
        arrays[f"{case}_eval"] = np.asarray(
            [summary["eval_mean_rel_l2"][k] for k in keys])
        print(f"{case}: selection {arrays[f'{case}_selection']}, eval "
              f"{arrays[f'{case}_eval']}", flush=True)
    np.savez_compressed(out, **arrays)
    print(f"wrote {out} ({os.path.getsize(out)} bytes)")


def main():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--kind", choices=["rollout", "train", "ns", "ns-train",
                                      "no-mlp", "no-mlp-1d", "fit",
                                      "select-split"],
                   default="rollout")
    p.add_argument("--ckpt", default=None,
                   help="default: artifacts/burgers_ns4096_ema2_ckpt_30000 "
                        "(rollout, train), artifacts/ns_vorttrain_ckpt_20000 "
                        "(ns, ns-train) or artifacts/burgers_dt01_ckpt_30000 "
                        "(select-split)")
    p.add_argument("--params", choices=["ema", "raw"], default="ema",
                   help="rollout: the checkpoint's EMA params, or its raw "
                        "ones for a checkpoint without an EMA "
                        "(artifacts/burgers_dt01_ckpt_30000)")
    p.add_argument("--ns-data", default="artifacts/ns_data_8traj.npz")
    p.add_argument("--out", default=None,
                   help="default: artifacts/burgers_ns4096_ema2_torch.npz "
                        "(rollout), ..._train_torch.npz (train), "
                        "artifacts/ns_vorttrain_torch.npz (ns), "
                        "artifacts/ns_vorttrain_train_torch.npz (ns-train) "
                        "artifacts/no_mlp_torch.npz (no-mlp), "
                        "artifacts/no_mlp_1d_torch.npz (no-mlp-1d), "
                        "artifacts/fit_torch.npz (fit) or "
                        "artifacts/select_split_torch.npz (select-split)")
    args = p.parse_args()
    if args.kind == "select-split":
        export_select_split(args.ckpt or "artifacts/burgers_dt01_ckpt_30000",
                            args.out or "artifacts/select_split_torch.npz")
        return
    if args.kind == "fit":
        export_fit(args.ns_data, args.out or "artifacts/fit_torch.npz")
        return
    if args.kind == "no-mlp-1d":
        export_no_mlp_1d(args.out or "artifacts/no_mlp_1d_torch.npz")
        return
    if args.kind == "no-mlp":
        import jax
        jax.config.update("jax_enable_x64", True)
        export_no_mlp(args.out or "artifacts/no_mlp_torch.npz")
        return
    if args.kind == "ns":
        export_ns(args.ckpt or "artifacts/ns_vorttrain_ckpt_20000",
                  args.ns_data, args.out or "artifacts/ns_vorttrain_torch.npz")
        return
    if args.kind == "ns-train":
        import jax
        jax.config.update("jax_enable_x64", True)
        export_ns_train(args.ckpt or "artifacts/ns_vorttrain_ckpt_20000",
                        args.ns_data,
                        args.out or "artifacts/ns_vorttrain_train_torch.npz")
        return
    args.ckpt = args.ckpt or "artifacts/burgers_ns4096_ema2_ckpt_30000"
    if args.kind == "train":
        import jax
        jax.config.update("jax_enable_x64", True)
        export_train(args.ckpt, args.out
                     or "artifacts/burgers_ns4096_ema2_train_torch.npz")
        return
    args.out = args.out or "artifacts/burgers_ns4096_ema2_torch.npz"

    import jax
    import jax.numpy as jnp
    import numpy as np

    from pigs_tpu.train.pn import rollout, rollout_metrics
    from pigs_tpu.utils.fd import solve_fd_2d

    cfg = flagship_config()
    network, params = restore_params(args.ckpt, cfg, args.params)
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

    frequencies = frequencies_of(cfg)
    np.savez_compressed(
        args.out, **flat,
        frequencies=frequencies,
        config_problem=np.asarray(cfg.problem.name),
        config_nx=np.asarray(NX),
        config_capacity=np.asarray(cfg.capacity),
        config_dt=np.asarray(DT),
        config_res=np.asarray(RES),
        config_steps=np.asarray(STEPS),
        config_params=np.asarray(args.params),
        jax_frames=np.asarray(frames, np.float32),
        fd_frames=fd_frames.astype(np.float32),
        jax_mean_rel_l2=np.asarray(metrics["mean_rel_norm"]),
        jax_per_step_rel_l2=np.asarray(metrics["per_step_rel_norm"]))
    print(f"wrote {args.out} ({os.path.getsize(args.out)} bytes)")


if __name__ == "__main__":
    main()
