#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. device    the card's name and power limit, torch and CUDA versions, and
               the builds of the CUDA kernels from pigs_tpu_torch/ops/csrc/
               with nvcc for sm_90a, all five sources at once: K1 (mixture
               forward), K2/K3 (its backward, Gaussian and sample side), K4
               (fused neighbour aggregation), K5 (its backward) and K6 (the
               Adam step); each instantiation's registers and spills from
               ptxas (a K1-K6 instantiation that spills fails, combine,
               merge and reduction passes included);
  2. kernel    K1 against its plain PyTorch twin and the plain path in
               float32 (norm-relative error <= 1e-5 per field) and against
               the plain path in float64 (<= 1e-4), at the two shapes of the
               rollout, a ragged case at orders 0-3, c in {1, 2}, with and
               without a period, the same over 5 Gaussians (one slice: no
               combine pass), and d=1 through the d=2 embedding; two
               launches on the same ragged or one-slice input bitwise equal;
  3. backward  K2 and K3 against their plain twins in float32 (<= 1e-5) and
               against torch autograd through the float64 dense oracle
               (<= 1e-4, conic gradients symmetrized), at the two training
               shapes (collocation and boundary samples of the training
               fixture; K3 in 26 Gaussian slices), the ragged cases, the
               same at 20 samples (K2 in one slice) and over 5 Gaussians
               (K3 in one slice), and d=1; the launch counters rise, and K3
               stays idle when the samples need no gradient; K2 and K3
               bitwise equal over two launches on the ragged and one-slice
               inputs;
  4. rollout   the 50-step rollout of the Burgers flagship at capacity 1664
               from artifacts/burgers_ns4096_ema2_torch.npz: exactly 2 K1
               launches per step, finite frames, frames against the JAX
               frames in the fixture, and mean rel-L2 against the stored FD
               frames within 0.005 of the JAX-CPU value;
  5. step      one training step (pn_step) at full width from the training
               fixture (artifacts/burgers_ns4096_ema2_train_torch.npz) in
               float32 through K1/K2, against the JAX float64 reference:
               loss terms rel <= 1e-4, the gradient norm-rel <= 1e-3, the
               parameter update norm-rel <= 1e-2, one K6 launch; the plain
               path's errors are printed beside them;
  6. epoch     the resumed 20-step split-regime epoch on the fixture's
               inputs: exact K1/K2/K6 launch counts, finite losses, per-step
               totals within 1e-2 of JAX's up to the first step whose active
               mask differs from JAX's (reported, not failed: split
               decisions threshold on float32 values);
  7. train     train() resumed from the fixture for 3 epochs of the flagship
               recipe, one K6 launch per Adam step; a checkpoint saved and
               restored equal; the EMA
               parameters rolled out, mean rel-L2 vs FD within 0.005 of the
               JAX-CPU rollout of the checkpoint;
  8. times     K1 at the flagship's four main-path shapes (1664x1664 and
               4096x1664, orders 2 and 0) and K2/K3 at the two training
               shapes, each first checked bitwise equal over two launches:
               device_ms (the profiler's device time per launch of the raw
               launch function), graph_ms (CUDA events around the replay
               of a CUDA graph of 100 raw launches, per launch), call_ms
               (median of 20 event-timed single calls of the public
               wrapper: the caller's price, host work included), the plain
               twin's call time, the bound (FLOP, SFU results or bytes at
               the H100's peaks) and K1-K3's grid, and K1-K3's graph
               replay with the grid aimed at 2, 4, 6 and 8 blocks per SM
               (6 is the one the paths run); pn_step and the epoch
               through the kernels and through the plain path; a profile
               of training steps (kernels, K1/K2 device time per step,
               device idle share); the timed rollout;
  9. ns        the Navier-Stokes rollout of the held-out trajectory from
               artifacts/ns_vorttrain_torch.npz and artifacts/
               ns_data_8traj.npz (capacity 640, order 3, c=2, period 2.0):
               exactly 1 + 2 K1 launches per step (frame 0's render, then a
               step and a render), frame 0 <= 1e-5 and steps 1-5 <= 1e-3
               against the JAX frames, mean rel-L2 against the solver's
               frames within 0.005 of the JAX-CPU value; the timed rollout,
               a profile of 5 of its steps, and K1 at the NS shapes (640x640
               order 3 and 4096x640 order 1, c=2, periodic), timed as in 8;
 10. aggregate K4 and K5 (the fused neighbour aggregation, forward and
               backward) driven at both heads' real inputs: the flagship's
               initial state, the training fixture's state, and the NS
               held-out state at t=0 and after 25 steps.  K4 against its
               float32 twin (<= 1e-5) and float64 twin (<= 1e-4), K5's seven
               gradients against autograd through the float64 twin
               (<= 1e-4 each), K4 against the factored aggregation the
               network runs (its error and the number of pairs the two
               neighbour rules decide differently; above 1e-4 a failure
               only when no pair differs); exact K4/K5 launch counts; K4
               and K5 each bitwise equal over two launches at each real
               input (the summed axis in 2 or 5 slices).  Then forward and
               forward+backward call times of K4/K5, the factored path and
               the plain twin at the real inputs (head 0) and at
               benchmarks/perf_suite.py's synthetic inputs, n in {512,
               1664, 4096, 8192}, where K4 in one slice (n >= 4096), and K5
               in one slice at n=4096, are also checked against their twins
               and for equal bits; K4 and K5 at the real inputs timed as in
               8, the bound counting the neighbour pairs of each input,
               each with its grid and its graph replay aimed at 2-8 blocks
               per SM (K5's target taken printed), and the factored
               aggregation's device time beside K4;
 11. ns-train  Navier-Stokes training from artifacts/ns_vorttrain_train_
               torch.npz (the NS checkpoint's training state, one epoch's
               inputs with the reconstruction targets, and the JAX float64
               step and epoch): (a) one pn_step with the reconstruction
               loss in float32 through K1/K2 against the JAX float64 step,
               at phase 5's tolerances (the reconstruction term its own
               entry), the plain path's errors beside them; (b) the 20-step
               split-regime epoch (vorticity criteria) under phase 6's
               rules, with exact launch counts (2 + 8 K1 and 1 K2 a step);
               (c) train(ns_data=...) resumed for 3 epochs of the recipe, a
               checkpoint round trip, and the EMA parameters rolled out on
               the held-out trajectory within 0.005 of the JAX-CPU rollout
               of the checkpoint; (d) K1 at the NS training shapes phase 9
               does not time (2048x640 orders 3 and 0, 640x640 order 1 and
               order 0 c=1, periodic) and K2 at 2048x640 order 3 c=2,
               checked against their twins and the f64 oracle and timed as
               in 8; (e) the NS pn_step's time and a profile of 5 of them;
               (f) one flagship epoch with noise_std 0.01 and
               adaptive_sampling 0.5: exact launch counts, exactly one
               order-1 K1 launch at the 4 x 4096 importance candidates
               (checked against its twin and the f64 oracle, equal to a
               second launch, and timed), finite losses, and every boundary
               Gaussian's value unchanged by the noise.
 12. no-mlp    the no-MLP direct solver from artifacts/no_mlp_torch.npz
               (the committed 2-D Burgers recipe: capacity 1024, 1024
               samples): (b) the fixture's 100-iteration dynamics block on
               its injected draws in float32 through K1/K2 against the JAX
               float64 block (mean loss, parameters, summed gradients, Adam
               moments within NO_MLP_BLOCK_TOL), exactly 200 K1, 100 K2 and
               0 K3 launches; (c) densify at full width with min_keep 0 and
               > 0: active masks equal JAX's, the fresh rows' moments
               zero; (d) solve() at full width, only timesteps cut: 2-D
               Burgers (IC fit + 3 steps, each <= 0.01 rel-L2 against the
               port's FD from the rendered t=0 field, 400 active), 1-D
               Burgers at solve_no_mlp.py's defaults (IC fit < 0.05, steps
               1-3 <= 0.02 against the FD solution from exp(-2 x^2)) and 2-D
               WAVE with active_sampling 0.5 (IC fit + 1 step, finite), each
               with exact launch counts (an IC-fit iteration 1 K1 + 1 K2, a
               dynamics iteration 2 K1 + 1 K2, never K3); the 1-D IC fit's
               three diagnostics, each on its own line: its final params
               rendered through K1 and the plain path (float32, float64,
               and on the CPU) at the 201 points and at the fit's last
               samples; the IC fit rerun with the CPU generator's draws
               (seeds 0, 1) and CUDA seeds 1-4 beside JAX's band from
               artifacts/no_mlp_1d_torch.npz; K1 and K2 at its state
               (128 and 201 samples x 1024, 25 active) against the f64
               oracle; (a) K1 and K2 at
               every no-MLP shape (1024x1024 orders 2 and 0, the 4096x1024
               render, WAVE 2048x1024 order 2 c=2, 1-D 128x1024 order 2
               embedded in d=2) against their twins and the f64 oracle,
               timed as in 8; (e) a 100-iteration block's host time and a
               profile of 5 dynamics iterations.
 13. ns-data   the NS data pipeline and the fit-to-target initializer
               from artifacts/fit_torch.npz: (a) the native .npy reader
               loads (g++ build under build/) and load_fno reads a file
               this phase writes as np.load does, transposed; (b)
               generate_fno on the fixture's JAX draws regenerates the 8
               trajectories x 51 frames of artifacts/ns_data_8traj.npz
               within NS_REGEN_TOL (max abs; the worst frame and the time
               printed); (c) the fixture's curl-fit block (1024 samples x
               400 Gaussians, order 1, c=2, period 2) on its injected draws
               in float32 through K1/K2 against the JAX float64 block
               within FIT_BLOCK_TOL, exactly 1 K1 and 1 K2 an iteration,
               0 K3; (d) _eig_split at capacity 4096: masks equal JAX's,
               the fresh rows' moments zero; (e) fit_fno_trajectory of
               trajectory 7 at full width (nx 20, 2000 iterations, seed
               8): exactly 2000 K1 and 2000 K2, t=0 rel-L2 <= FIT_T0_TOL,
               and phase 9's NS network rolled out from that fit, mean
               rel-L2 in PORT_FIT_BAND; scripts/initialize_torch.py
               gaussian at capacity 4096 for INIT_SMOKE_ITERS iterations:
               exact launch counts, finite and falling block losses; (f) K1
               and K2 at the curl fit's shape and the gaussian mode's
               (1024x4096 order 0, 2500 active), K1 at its 128x128 render
               (16384x4096), against their twins and the f64 oracle, timed
               as in 8; (g) a profile of 5 curl-fit iterations.
 14. validate  (a) second-order gradients through the mixture (the JAX
               package's outer/inner loss) at 4096x1664 order 2, at
               16384x1664 order 1 (27.3 M pairs: the double vjp in 4
               sample chunks) and at 1024x1024 order 2 with the samples
               differentiated, each within 2e-4 scaled of the same double
               backward through the float64 oracle, with exact launches:
               1 K1 and 1 K2 (K3 only with the samples) for the inner
               gradient, one more K2 (and K3) when the outer backward
               passes back through the forward op; first- and
               second-order call times and peak memory; (b)
               scripts/validate_pn_torch.py with the flagship recipe from
               the training fixture at its epoch (the EMA rolled out: its
               FD frames within 1e-3 of the fixture's, the mean rel-L2
               within 0.005 of JAX-CPU) and 3 epochs past it, with exact
               launch counts; (c) validate_pn_torch from scratch for every
               problem at full width (2 epochs, 10 rollout steps): finite
               frames and scores, validate_pn.py's summary keys, exact
               launch counts; (d) the dt=0.1 checkpoint's raw parameters
               (artifacts/burgers_dt01_torch.npz) rolled out by
               scripts/rollout_torch.py: 2 K1 a step, mean rel-L2 within
               0.005 of the JAX-CPU score the fixture stores.
 15. parallel  the multi-process layer (pigs_tpu_torch.parallel) at the
               flagship's training shape (the training fixture's 1664
               Gaussians, its 4096 collocation samples, order 2, interior
               mask): (a) one NCCL rank on cuda:0 (a file:// store, the
               group destroyed after): eval_mixture_sharded and
               eval_mixture_ring, fields and gradients bitwise equal to
               eval_mixture's, 1 K1 and 1 K2 each; make_dp_train_step with
               Adam against pn_loss_grads + adam_update: loss within 1e-6,
               parameters bitwise equal (else, only if the reference does
               not repeat itself bitwise, the update within 1e-2), 3 K1 /
               2 K2 / 1 K6 as pn_step; (b) two gloo ranks spawned on
               cuda:0, meshes (2, 1) and (1, 2): each rank's gathered
               fields within 1e-5 and gradients within 1e-4 of a
               single-rank eval_mixture,
               exact launches per rank (a ring call: one K1 and one K2 per
               model rank), the ring's bytes through host memory (gloo's
               point-to-point ops take CPU tensors); 3 DP steps on (2, 1)
               against the same 3 steps on one rank (loss 1e-4, update
               1e-2), both ranks' parameters bitwise equal after each; (c)
               Timer around the DP step beside phase 8's pn_step, and a
               trace whose JSON names K1 and K2; (d)
               scripts/select_split_stop_torch.py on one of JAX's held-out
               ICs (artifacts/select_split_torch.npz), stops 0, 8, 14, 50
               steps: every score and the parity within 0.005 of JAX-CPU's.
 16. optim     K6 (one optax Adam step over a list of tensors) against its
               plain twin in float32 (norm-relative <= 1e-5 on the
               parameters' change and the moments) and the plain path in
               float64 (<= 1e-4): at the flagship's and the NS network's
               parameters and Adam state from the training fixtures, with
               JAX's gradient scaled so that the clip is active and not;
               one NaN and one inf gradient (parameters, moments and count
               bitwise unchanged); from the fixtures' per-tensor state and
               then from K6's own output state; a transposed gradient (one
               layout copy, bitwise the contiguous result); at a no-MLP
               size (with the 1-D empty transforms), a fit single-tensor
               size, the most tensors one launch takes, and a total ten
               times the networks'; every case through adam_update's
               dispatch.  Counts and skip decisions exact, two launches
               bitwise equal, the old state untouched, one launch counted a
               call; then K6's times at both networks (device, graph
               replay, call, plain twin, bound) and ptxas registers and
               spills (a K6 spill fails).  Every phase from 4 on counts K6
               beside K1-K5: one a training step, a no-MLP iteration and a
               DP step per rank, four a fit iteration, none in a rollout.

The line before the card's is the kernels line: per kernel its launches
(per path, per training step, per NS training step, per rollout step, per
no-MLP iteration, per curl-fit iteration, per rank of the parallel paths,
as each path's run counted them), errors, device, graph, call and plain
times and bounds by shape (K6: also its device time and kernels per step in
each path's profile), and
library_ms (null: no single PyTorch call computes any of these functions).

The line before the last is the card's ``nvidia-smi`` name and power limit;
the last line is a JSON object with ``ok`` and the device.  Without a CUDA
device, or outside a checkout of the repo, it fails and prints no result.
"""

import functools
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "artifacts", "burgers_ns4096_ema2_torch.npz")
TRAIN_FIXTURE = os.path.join(ROOT, "artifacts",
                             "burgers_ns4096_ema2_train_torch.npz")
NS_FIXTURE = os.path.join(ROOT, "artifacts", "ns_vorttrain_torch.npz")
NS_DATA = os.path.join(ROOT, "artifacts", "ns_data_8traj.npz")
NS_TRAIN_FIXTURE = os.path.join(ROOT, "artifacts",
                                "ns_vorttrain_train_torch.npz")
NO_MLP_FIXTURE = os.path.join(ROOT, "artifacts", "no_mlp_torch.npz")
FIT_FIXTURE = os.path.join(ROOT, "artifacts", "fit_torch.npz")
NO_MLP_1D_FIXTURE = os.path.join(ROOT, "artifacts", "no_mlp_1d_torch.npz")
DT01_FIXTURE = os.path.join(ROOT, "artifacts", "burgers_dt01_torch.npz")
SCRATCH = os.path.join(ROOT, "build", "chip_smoke")
PERF_SUITE_SIZES = (512, 1664, 4096, 8192)  # benchmarks/perf_suite.py

KERNEL_F32_TOL = 1e-5    # a kernel vs the same math in float32, summed in another order
KERNEL_F64_TOL = 1e-4    # a kernel vs the float64 oracle (the repo's bound, BASELINE.md:21)
K6_F32_TOL = 1e-5        # K6 vs its float32 twin: the norm's sum order, powf
K6_F64_TOL = 1e-4        # K6 vs the plain path in float64
FRAME0_TOL = 1e-5        # frame 0 renders the same initial state as JAX did
EARLY_FRAMES_TOL = 1e-3  # steps 1-5: float32 differences through the network
MEAN_REL_L2_TOL = 0.005  # mean rel-L2 vs FD, against the JAX-CPU rollout's
STEP_LOSS_TOL = 1e-4     # pn_step loss terms, float32 vs JAX float64
STEP_GRAD_TOL = 1e-3     # pn_step flattened gradient, norm-relative
STEP_UPDATE_TOL = 1e-2   # pn_step parameter update, norm-relative
EPOCH_TOTAL_TOL = 1e-2   # per-step totals while the split decisions agree
# The no-MLP fixture's 100-iteration block in float32 vs JAX float64: twice
# what the port's float32 plain path reaches on the CPU against the same
# fixture with 8 threads (tests/test_torch_no_mlp.py prints those errors).
NO_MLP_BLOCK_TOL = {"loss": 3.9e-5, "params": 4.5e-6, "grad_acc": 8.4e-5,
                    "mu": 1.7e-4, "nu": 8.8e-6}
NO_MLP_2D_STEP_TOL = 0.01   # 2-D Burgers steps 1-3 vs FD (JAX: 0.0021-0.0044)
NO_MLP_1D_IC_TOL = 0.05     # 1-D IC fit vs exp(-2 x^2) (tests/test_numerical.py)
NO_MLP_1D_STEP_TOL = 0.02   # 1-D steps 1-3 vs FD (JAX: 0.0023-0.0053)
# generate_fno on JAX's draws vs the committed ns_data_8traj.npz, max abs
# over every frame: twice the port's float32 CPU run's 8.47e-4 (trajectory
# 1, frame 50; frames 0-3 8.0e-5).
NS_REGEN_TOL = 1.7e-3
# The fit fixture's curl-fit block in float32 vs JAX float64: twice what
# the port's float32 plain path reaches on the CPU against the same fixture
# with 2 threads (tests/test_torch_fit.py prints those errors; 8 threads
# give the same).
FIT_BLOCK_TOL = {"loss": 2.5e-6, "params": 2.2e-5, "mu": 5.0e-5,
                 "nu": 2.9e-6, "last_grad": 4.6e-5}
FIT_T0_TOL = 0.06           # the port's curl fit of trajectory 7 at t=0
# The NS rollout from the port's own fit of trajectory 7: the committed
# fit's 0.257639 +- 0.03 (JAX fits from three seeds moved it by ~0.013).
PORT_FIT_BAND = (0.228, 0.288)
INIT_SMOKE_ITERS = 300      # initialize_torch.py gaussian: three blocks

DEVICE_RUNS = 20         # launches in one profiled window (device_ms)
GRAPH_LAUNCHES = 100     # raw launches captured in one CUDA graph (graph_ms)
SWEEP_BLOCKS_PER_SM = (2, 4, 6, 8)  # K1-K5 grid targets timed against each other
# An H100 SXM's peaks per millisecond (NVIDIA's data sheet, at 700 W):
# float32 outside the tensor cores, special-function results (exp, sin,
# cos: 132 SMs x 16 a clock x 1.98 GHz) and HBM3 bytes.
PEAK_FLOP_PER_MS = 67e9
PEAK_SFU_PER_MS = 4.18e9
PEAK_BYTES_PER_MS = 3.35e9
# The device kernels of K1 and K2 by name, as a profile of a step counts
# them.
KERNEL_FAMILIES = {"mixture_fwd": ("mixture_fwd", "FwdStore"),
                   "mixture_bwd_gauss": ("bwd_gauss", "GaussStore"),
                   "adam": ("adam_cluster_kernel",)}
LIBRARY_NOTE = ("no single PyTorch call computes this function; the plain "
                "twin repeats the kernel's arithmetic step by step")


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str):
    if not ok:
        raise SmokeFailure(msg)


def reset_counts(mk, ak):
    from pigs_tpu_torch.ops import optim_kernel
    mk.launches = mk.bwd_gauss_launches = mk.bwd_sample_launches = 0
    ak.fwd_launches = ak.bwd_launches = 0
    optim_kernel.launches = 0


def read_counts(mk, ak) -> tuple:
    """The launch counts of K1, K2, K3, K4, K5 and K6."""
    from pigs_tpu_torch.ops import optim_kernel
    return (mk.launches, mk.bwd_gauss_launches, mk.bwd_sample_launches,
            ak.fwd_launches, ak.bwd_launches, optim_kernel.launches)


def ptxas_name(mangled: str) -> str:
    """A mangled kernel name -> ``name<template arguments>``:
    ``..._18mixture_fwd_kernelILi2ELi1ELi2EEEv...`` ->
    ``mixture_fwd_kernel<2, 1, 2>``, ``..combine_slices_kernelI...8FwdStore
    ILi2EEEEEv..`` -> ``combine_slices_kernel<FwdStore, 2>``."""
    import re
    found = re.search(r"\d+([a-z_]+kernel)(I.*)?", mangled)
    if not found:
        return mangled
    rest = (found.group(2) or "").split("Ev")[0]
    store = re.search(r"\d+([A-Za-z]+Store)", rest)
    args = ([store.group(1)] if store else []) + re.findall(r"Li(\d+)E", rest)
    return f"{found.group(1)}<{', '.join(args)}>" if args else found.group(1)


def ptxas_report(log: str) -> dict:
    """``nvcc -Xptxas -v`` output -> {kernel<ORDER, C>: {registers,
    spill_stores, spill_loads}} (bytes), one entry per instantiation."""
    import re
    report, current = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            current = ptxas_name(entry.group(1))
            report[current] = {"registers": None, "spill_stores": 0,
                               "spill_loads": 0}
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if spill and current:
            report[current]["spill_stores"] = int(spill.group(1))
            report[current]["spill_loads"] = int(spill.group(2))
        regs = re.search(r"Used (\d+) registers", line)
        if regs and current:
            report[current]["registers"] = int(regs.group(1))
    return report


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def rel_err(a, b) -> float:
    import torch
    a, b = a.double(), b.double()
    denom = torch.linalg.vector_norm(b).item()
    return torch.linalg.vector_norm(a - b).item() / (denom if denom else 1.0)


def sym(g):
    return 0.5 * (g + g.transpose(-1, -2))


def random_mixture(gen, n, m, c, d, device):
    """Random Gaussians and samples, made in float64 on the CPU from ``gen``
    and rounded to float32, so every version sees the same numbers."""
    import torch

    from pigs_tpu_torch.gaussians import build_full_covariances
    f64 = dict(dtype=torch.float64)
    means = torch.rand((n, d), generator=gen, **f64) * 2.0 - 1.0
    scaling = torch.exp(torch.randn((n, d), generator=gen, **f64) * 0.3 - 2.0)
    transforms = torch.randn((n, d * (d - 1) // 2), generator=gen, **f64) * 0.5
    values = torch.randn((n, c), generator=gen, **f64)
    samples = torch.rand((m, d), generator=gen, **f64) * 2.4 - 1.2
    mask = torch.rand((n,), generator=gen, **f64) > 0.2
    _, conics = build_full_covariances(scaling, transforms)
    f32 = [x.float().to(device) for x in (means, conics, values, samples)]
    return f32, mask.to(device)


def compare_case(label, means, conics, values, samples, order, mask, period,
                 mk):
    """Run K1 and the plain versions on one input; return the errors."""
    import torch

    from pigs_tpu_torch.ops.mixture import eval_mixture
    from pigs_tpu_torch.ops.mixture_kernel import (mixture_forward_plain,
                                                   pack_conics, unpack_fields)
    args = dict(order=order, mask=mask, period=period)
    before = mk.launches
    out = eval_mixture(means, conics, values, samples, **args)
    torch.cuda.synchronize()
    check(mk.launches == before + 1, f"{label}: K1 was not launched")
    plain32 = eval_mixture(means, conics, values, samples, impl="plain", **args)
    plain64 = eval_mixture(means.double(), conics.double(), values.double(),
                           samples.double(), impl="plain", **args)
    errs = {"f32": 0.0, "f64": 0.0, "twin": 0.0, "abs": 0.0}
    if samples.shape[1] == 2:
        v = values * mask.to(values.dtype)[:, None] if mask is not None else values
        twin = unpack_fields(
            mixture_forward_plain(means, pack_conics(conics), v, samples,
                                  order, period),
            samples.shape[0], values.shape[1], order)
    else:
        twin = plain32
    for name, a, b32, b64, bt in zip(("u", "ux", "uxx", "uxxx"), out, plain32,
                                     plain64, twin):
        if a is None:
            continue
        check(bool(torch.isfinite(a).all()), f"{label}: {name} not finite")
        e32, e64, et = rel_err(a, b32), rel_err(a, b64), rel_err(a, bt)
        errs["f32"] = max(errs["f32"], e32)
        errs["f64"] = max(errs["f64"], e64)
        errs["twin"] = max(errs["twin"], et)
        errs["abs"] = max(errs["abs"], (a - bt).abs().max().item())
        print(f"  {label} {name}: rel err vs plain f32 {e32:.3e}, "
              f"twin f32 {et:.3e}, plain f64 {e64:.3e}", flush=True)
        check(e32 <= KERNEL_F32_TOL and et <= KERNEL_F32_TOL,
              f"{label} {name}: K1 vs float32 plain {max(e32, et):.3e} > "
              f"{KERNEL_F32_TOL}")
        check(e64 <= KERNEL_F64_TOL,
              f"{label} {name}: K1 vs float64 plain {e64:.3e} > "
              f"{KERNEL_F64_TOL}")
    return errs


def random_cotangents(gen, m, c, d, order, device):
    import torch
    shapes = [(m, c), (m, d, c), (m, d, d, c), (m, d, d, d, c)]
    return [torch.randn(s, generator=gen, dtype=torch.float64).float()
            .to(device) for s in shapes[:order + 1]]


def mixture_grads(means, conics, values, samples, cots, order, mask, period,
                  impl, samples_grad=True):
    """Gradients of sum(field * cotangent) through ``eval_mixture``."""
    import torch

    from pigs_tpu_torch.ops.mixture import eval_mixture
    tin = [means.clone().requires_grad_(), conics.clone().requires_grad_(),
           values.clone().requires_grad_(),
           samples.clone().requires_grad_(samples_grad)]
    out = eval_mixture(*tin, order=order, mask=mask, period=period, impl=impl)
    loss = sum(torch.sum(f * c.to(f.dtype)) for f, c in zip(out, cots))
    want = tin if samples_grad else tin[:3]
    return list(torch.autograd.grad(loss, want))


def compare_backward(label, means, conics, values, samples, order, mask,
                     period, mk, gen):
    """K2/K3 on one input: launches, the f64 oracle's gradients, and (d=2)
    the plain twins on the packed inputs.  Returns the errors."""
    import torch

    from pigs_tpu_torch.ops.mixture_kernel import pack_conics
    m, c, d = samples.shape[0], values.shape[1], samples.shape[1]
    cots = random_cotangents(gen, m, c, d, order, samples.device)
    g2, g3 = mk.bwd_gauss_launches, mk.bwd_sample_launches
    got = mixture_grads(means, conics, values, samples, cots, order, mask,
                        period, "auto")
    torch.cuda.synchronize()
    check(mk.bwd_gauss_launches == g2 + 1 and mk.bwd_sample_launches == g3 + 1,
          f"{label}: K2/K3 launches {mk.bwd_gauss_launches - g2}, "
          f"{mk.bwd_sample_launches - g3}, expected 1 each")
    want = mixture_grads(means.double(), conics.double(), values.double(),
                         samples.double(), cots, order, mask, period, "plain")
    errs = {"f64": 0.0, "twin": 0.0, "abs": 0.0}
    for name, a, b in zip(("means", "conics", "values", "samples"), got, want):
        check(bool(torch.isfinite(a).all()), f"{label}: grad {name} not finite")
        if name == "conics":
            a, b = sym(a), sym(b)
        e = rel_err(a, b)
        errs["f64"] = max(errs["f64"], e)
        check(e <= KERNEL_F64_TOL,
              f"{label} grad {name}: vs float64 oracle {e:.3e} > "
              f"{KERNEL_F64_TOL}")
    twin_msg = ""
    if d == 2:
        v = values * mask.to(values.dtype)[:, None] if mask is not None else values
        packed = [x.contiguous() for x in (means, pack_conics(conics), v,
                                           samples)]
        pcots = [torch.randn((m, gs * c), generator=gen, dtype=torch.float64)
                 .float().to(samples.device) for gs in (1, 2, 3, 4)[:order + 1]]
        k2 = mk.mixture_backward_gauss(*packed, pcots, order, period)
        k3 = mk.mixture_backward_sample(*packed, pcots, order, period)
        p2 = mk.mixture_backward_gauss_plain(*packed, pcots, order, period)
        p3 = mk.mixture_backward_sample_plain(*packed, pcots, order, period)
        for name, a, b in zip(("gm", "gc", "gv", "gx"), (*k2, k3), (*p2, p3)):
            e = rel_err(a, b)
            errs["twin"] = max(errs["twin"], e)
            errs["abs"] = max(errs["abs"], (a - b).abs().max().item())
            check(e <= KERNEL_F32_TOL,
                  f"{label} {name}: vs float32 twin {e:.3e} > {KERNEL_F32_TOL}")
        twin_msg = f", twin f32 {errs['twin']:.3e}"
    print(f"  {label}: grads rel err vs f64 oracle {errs['f64']:.3e}"
          f"{twin_msg}", flush=True)
    return errs


def median_ms(fn, runs: int = 20) -> float:
    """Median CUDA-event time of one call of ``fn`` on an idle card: the
    caller's price, i.e. the host's work in the call plus the device's
    (``call_ms``), not a kernel's device time."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0))


def kernel_name(key: str) -> str:
    """A profiler key without return type, namespaces and parameters:
    ``void (anonymous namespace)::mixture_fwd_kernel<2, 1, 2>(float const*,
    ...)`` -> ``mixture_fwd_kernel<2, 1, 2>``."""
    import re
    head = key.split("(float", 1)[0].split("(int", 1)[0]
    head = re.sub(r"\(anonymous namespace\)::|\w+::", "", head)
    return head.replace("void ", "").strip()


def profiled_device_ms(launch) -> tuple:
    """The profiler's device time per call of ``launch``, a raw kernel
    launch with nothing else on the card, over a window of DEVICE_RUNS
    calls: each kernel's mean device time times the number of times a call
    launches it, summed; and, by kernel name, (launches per call, mean ms).
    The profiler may miss a launch or two of a window, so a total over
    DEVICE_RUNS would read low; a window in which it saw no kernel at all
    is taken again, up to three times, and then gives (None, {}) after
    printing what the windows held: the device events of any kind and the
    host's launch calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    launch()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(DEVICE_RUNS):
                launch()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if str(getattr(e, "device_type", "")).endswith("CUDA")
                  and e.count and device_us(e) > 0]
        if events:
            break
        every = prof.key_averages()
        device = sum(e.count for e in every if str(getattr(
            e, "device_type", "")).endswith("CUDA"))
        launches = {e.key: e.count for e in every if e.key.startswith("cu")
                    and "Launch" in e.key}
        print(f"[profiler] a window of {DEVICE_RUNS} launches without a "
              f"device kernel: {device} device events, host launch calls "
              f"{launches}", flush=True)
    else:
        return None, {}
    kernels = {kernel_name(e.key): (max(1, round(e.count / DEVICE_RUNS)),
                                    device_us(e) / e.count / 1e3)
               for e in events}
    return sum(n * ms for n, ms in kernels.values()), kernels


def graph_device_ms(launch) -> float:
    """Cross-check of the device time: CUDA events around the replay of a
    CUDA graph that captured GRAPH_LAUNCHES calls of ``launch`` (a raw
    launch; the host is out of the loop, the gaps between kernels are in),
    per launch; median of 5 replays."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_LAUNCHES):
            launch()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / GRAPH_LAUNCHES)
    del graph
    return statistics.median(times)


def roofline(flop: float, sfu: float, nbytes: float) -> tuple:
    """The least time the card could take (ms) and what sets it: float32
    FLOP at PEAK_FLOP_PER_MS, SFU results at PEAK_SFU_PER_MS or bytes at
    PEAK_BYTES_PER_MS, whichever takes longest."""
    times = {"FLOP": flop / PEAK_FLOP_PER_MS, "SFU": sfu / PEAK_SFU_PER_MS,
             "bytes": nbytes / PEAK_BYTES_PER_MS}
    by = max(times, key=times.get)
    return times[by], by


# FLOP per (sample, Gaussian) pair counted from the arithmetic the mixture
# kernels run: every add, subtract and multiply once (an FMA as 2),
# negations free, a product the code forms twice once (nvcc computes it
# once), and the terms that are zero at the order (adjoint_fields'
# accumulators start at 0) left out.  The pair geometry (displacement,
# p = C d, the scaled quadratic form; +8 with the period's wrap); the output
# weights W_k up to each order (K1's pair_weights; K2 at c=2 shares their
# polynomials with the adjoint and pays only the K-1 products with g); the
# adjoint fields K2 runs (adjoint_order0 at order 0, adjoint_fields above)
# and the part of adjoint_fields K3 keeps (Q, R, A and E_dx, E_dy).
GEOMETRY_FLOP = 12
WRAP_FLOP = 8
WEIGHT_FLOP = (0, 2, 11, 34)
ADJOINT_FLOP = (10, 35, 60, 121)
ADJOINT_XY_FLOP = (4, 16, 38, 87)


def mixture_bound(name: str, m: int, n: int, order: int, c: int,
                  periodic: bool) -> tuple:
    """(bound_ms, what bounds it) of K1 (``mixture_fwd``), K2 or K3 at one
    shape: every pair's FLOP and one exp, the inputs read once and the
    outputs written once."""
    k = (order + 1) * (order + 2) // 2
    comps = k * c
    geom = GEOMETRY_FLOP + (WRAP_FLOP if periodic else 0)
    inputs = 2 * m + (5 + c) * n
    # r_k = sum over channels of cot_k v: a multiply and c-1 FMAs per k.
    r = k * (2 * c - 1)
    if name == "mixture_fwd":
        flop, nbytes = geom + WEIGHT_FLOP[order] + 2 * comps, inputs + comps * m
    elif name == "mixture_bwd_gauss":
        # c=1, the rank-1 route: no r_k, and gv adds A g.
        gv = 1 if c == 1 else k - 1 + 2 * comps
        flop = geom + (0 if c == 1 else r) + ADJOINT_FLOP[order] + 5 + gv
        nbytes = inputs + comps * m + (5 + c) * n
    else:
        # c=1: v folded into g, one multiply.
        flop = geom + (1 if c == 1 else r) + ADJOINT_XY_FLOP[order] + 2
        nbytes = inputs + comps * m + 2 * m
    return roofline(m * n * flop, m * n, 4 * nbytes)


# FLOP per neighbour pair of the fused aggregation (L = K = 16, F = 6,
# d = 2, 2E = 50), an FMA as 2.  K4: the logit (2K + 1), alpha (4), the 24
# angles (3 F d), the gate W_d emb (2 L 2E) and alpha mapped gate (3 L).
# K5 adds the gradient of W_d (2 L 2E), the gate's derivative contracted
# with the gate's cotangent (2 L 2E), dalpha (2 L), gq and gk (4 K) and gm
# (2 L).  Every pair also takes the neighbour test (7), and mapped = W_t f
# costs 2 L^2 per Gaussian.  SFU: two exps and the sin and cos of 24 angles
# per neighbour pair.
AGG_FWD_PAIR_FLOP = 2 * 16 + 1 + 4 + 3 * 12 + 2 * 16 * 50 + 3 * 16
AGG_BWD_PAIR_FLOP = AGG_FWD_PAIR_FLOP + 2 * (2 * 16 * 50) + 2 * 16 \
    + 4 * 16 + 2 * 16
AGG_PAIR_SFU = 2 + 2 * 24


def aggregate_bound(name: str, n: int, pairs: int) -> tuple:
    """(bound_ms, what bounds it) of K4 (``aggregate_fwd``) or K5 at ``n``
    Gaussians with ``pairs`` neighbour pairs (what these inputs need, not
    n^2)."""
    per_pair = AGG_FWD_PAIR_FLOP if name == "aggregate_fwd" else \
        AGG_BWD_PAIR_FLOP
    flop = pairs * per_pair + 7 * n * n + 2 * 16 * 16 * n
    # features, queries, keys (n, 16), means, radii; W_t, freqs, W_d; out.
    nbytes = n * (3 * 16 + 3) + 16 * 16 + 6 + 16 * 50 + n * 16
    if name != "aggregate_fwd":   # the cotangent and the seven gradients
        nbytes += n * 16 + (3 * n * 16 + 16 * 16 + 6 + 16 * 50 + 2 * n)
    return roofline(flop, pairs * AGG_PAIR_SFU, 4 * nbytes)


def time_kernel(launch, call, plain) -> dict:
    """One kernel at one shape: ``device_ms`` (profiler), ``graph_ms``
    (graph-replayed events), ``call_ms`` (one call of the public wrapper)
    and ``plain_ms`` (one call of the plain twin)."""
    device, kernels = profiled_device_ms(launch)
    graph = graph_device_ms(launch)
    return {"device_ms": graph if device is None else device,
            "device_source": "graph replay (the profiler saw no kernel)"
                             if device is None else "profiler",
            "kernels_per_launch": {k: n for k, (n, _) in kernels.items()},
            "kernel_ms": {k: ms for k, (_, ms) in kernels.items()},
            "graph_ms": graph, "call_ms": median_ms(call),
            "plain_ms": median_ms(plain)}


def check_deterministic(label: str, launch):
    """Two launches on the same inputs give the same bits; ``launch``
    returns a tensor or a tuple of them."""
    import torch
    first, second = launch(), launch()
    torch.cuda.synchronize()
    if isinstance(first, torch.Tensor):
        first, second = (first,), (second,)
    check(all(torch.equal(a, b) for a, b in zip(first, second)),
          f"{label}: two launches on the same inputs differ")


def describe_kernel_times(name: str, label: str, t: dict, card: str) -> str:
    kernels = ", ".join(f"{k} x{n} {t['kernel_ms'][k]:.4f} ms"
                        for k, n in t["kernels_per_launch"].items())
    text = (f"[times] {name} {label}: device {t['device_ms']:.4f} ms "
            f"({t['device_source']}; graph replay {t['graph_ms']:.4f} ms), "
            f"bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}; share "
            f"{t['bound_ms'] / t['device_ms']:.3f}), call {t['call_ms']:.4f} "
            f"ms, plain twin {t['plain_ms']:.4f} ms; kernels per launch: "
            f"{kernels}")
    g = t.get("grid")
    if g:
        text += (f"; grid {g['tiles']} tiles x {g['slices']} slices of "
                 f"{g['slice_len']} = {g['blocks']} blocks, "
                 f"{g['blocks_per_sm']:.2f} per SM")
    return f"{text} ({card})"


def host_ms(fn) -> float:
    """Wall time of ``fn`` between two device synchronisations."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def time_k1(label, mu, con, val, smp, order, mask, period, mk, card) -> dict:
    """K1 at one main-path input: two raw launches bitwise equal, then its
    times, bound and grid, and its time against the grid's target."""
    args = (mu.contiguous(), mk.pack_conics(con).contiguous(),
            (val * mask.to(val.dtype)[:, None]).contiguous(), smp.contiguous(),
            order, period)
    check_deterministic(f"K1 {label}", lambda: mk._launch_fwd(*args))
    t = time_kernel(lambda: mk._launch_fwd(*args),
                    lambda: mk.mixture_forward(*args),
                    lambda: mk.mixture_forward_plain(*args))
    m, n, c = smp.shape[0], mu.shape[0], val.shape[1]
    t["bound_ms"], t["bound_by"] = mixture_bound(
        "mixture_fwd", m, n, order, c, period is not None)
    t["grid"] = grid_of(mk, mk.fwd_geometry(m, n, mk._sm_count(0)),
                        mk.FWD_SLICE_UNIT)
    print(describe_kernel_times("mixture_fwd", label, t, card), flush=True)
    t["graph_ms_by_blocks_per_sm"] = sweep_grid(
        "mixture_fwd", label,
        lambda b: mk.fwd_geometry(m, n, mk._sm_count(0), b),
        lambda b: mk._launch_fwd(*args, blocks_per_sm=b), card)
    return t


def sweep_grid(name, label, geometry, launch, card) -> dict:
    """A sliced kernel (K1-K6) at one input with the slicing aimed at each
    of SWEEP_BLOCKS_PER_SM blocks per SM (``mixture_kernel.BLOCKS_PER_SM``
    is the one the paths and wrappers run): the graph-replayed device time
    per launch by target."""
    times = {b: graph_device_ms(lambda: launch(b))
             for b in SWEEP_BLOCKS_PER_SM}
    print(f"[grid] {name} {label}: " + "; ".join(
        "{} per SM: {} x {} slices of {} -> {:.4f} ms".format(
            b, *geometry(b), ms) for b, ms in times.items())
        + f" (graph replay; {card})", flush=True)
    return times


def grid_of(mod, geometry, unit: int) -> dict:
    """A K1-K5 geometry ``(tiles, slices, slice_len)`` as the kernels
    line reports it; fails unless it puts 2 blocks on every SM or, where the
    summed axis is too short for that, cuts it into slices of the slicing
    ``unit`` (the most the geometry helpers' contract allows)."""
    tiles, slices, slice_len = geometry
    sms = mod._sm_count(0)
    check(tiles * slices >= 2 * sms or slice_len == unit,
          f"grid of {tiles} x {slices} slices of {slice_len} is under 2 "
          f"blocks per SM ({sms} SMs) with the axis still above the unit "
          f"{unit}")
    return {"blocks": tiles * slices, "blocks_per_sm": tiles * slices / sms,
            "tiles": tiles, "slices": slices, "slice_len": slice_len}


def time_k23(label, packed, smp, order, mk, gen, card, period=None,
             with_k3=True) -> dict:
    """K2 (and K3 unless ``with_k3`` is False) at one training input: each
    bitwise deterministic over two raw launches, then the kernels' times,
    bounds and grids, and each one's time against the grid's target."""
    import torch
    m, n, c = smp.shape[0], packed[0].shape[0], packed[2].shape[1]
    cots = [torch.randn((m, gs * c), generator=gen).to(smp.device)
            for gs in (1, 2, 3, 4)[:order + 1]]
    a = (*packed, smp.contiguous(), cots, order, period)
    out = {}
    kernels = (("mixture_bwd_gauss", mk._launch_bwd_gauss,
                mk.mixture_backward_gauss, mk.mixture_backward_gauss_plain,
                mk.gauss_geometry, mk.BWD_SLICE_UNIT),
               ("mixture_bwd_sample", mk._launch_bwd_sample,
                mk.mixture_backward_sample, mk.mixture_backward_sample_plain,
                mk.fwd_geometry, mk.FWD_SLICE_UNIT))
    for name, launch, call, plain, geometry, unit in \
            kernels[:2 if with_k3 else 1]:
        check_deterministic(f"{name} {label}", lambda: launch(*a))
        t = time_kernel(lambda: launch(*a), lambda: call(*a),
                        lambda: plain(*a))
        t["bound_ms"], t["bound_by"] = mixture_bound(name, m, n, order, c,
                                                     period is not None)
        t["grid"] = grid_of(mk, geometry(m, n, mk._sm_count(0)), unit)
        print(describe_kernel_times(name, label, t, card), flush=True)
        t["graph_ms_by_blocks_per_sm"] = sweep_grid(
            name, label, lambda b: geometry(m, n, mk._sm_count(0), b),
            lambda b: launch(*a, blocks_per_sm=b), card)
        out[name] = t
    return out


def rollout_slice_inputs(cfg, state, res):
    """The two K1 calls of one rollout step, as the rollout makes them."""
    from pigs_tpu_torch.models.state import covariance_of
    from pigs_tpu_torch.utils.sampling import image_samples
    _, conics = covariance_of(state)
    grid = image_samples(res, cfg.scale, cfg.dtype, state.means.device)
    return {
        "means 1664x1664 order 2": (state.means, conics, state.u, state.means,
                                    2, state.active),
        "render 4096x1664 order 0": (state.means, conics, state.u, grid, 0,
                                     state.interior),
    }


class TrainInputs:
    """The training fixture on the card: config, network and Adam state as
    the checkpoint has them, the epoch's inputs, and the JAX references."""

    def __init__(self, device, path=TRAIN_FIXTURE):
        import torch

        from pigs_tpu_torch.convert import load_train_fixture
        from pigs_tpu_torch.models.state import MixtureState
        self.device = device
        (self.cfg, self.network, self.opt, self.ema,
         self.data) = load_train_fixture(path, device=device)
        self.names = [k for k, _ in self.network.named_parameters()]
        self.params0 = [p.detach().clone() for p in self.network.parameters()]
        self.opt0 = self.opt
        d = self.data

        def t(key):
            x = torch.from_numpy(d[key])
            return x.to(device=device, dtype=torch.float32
                        if x.is_floating_point() else x.dtype)
        self.state = MixtureState(*(t("input_" + f)
                                    for f in MixtureState._fields))
        self.samples, self.time_samples, self.bc_samples = (
            t("input_samples"), t("input_time_samples"), t("input_bc_samples"))
        self.dt = float(d["train_dt"])
        self.base_lr = float(d["train_base_lr"])
        self.epsilon = float(d["train_epsilon"])
        self.floor = float(d["train_loss_weight_floor"])
        self.clip = float(d["train_clip_norm"])
        self.n_steps = int(d["train_n_steps"])
        # NS: step i's reconstruction target (the flagship has none).
        self.recon = (t("input_recon_targets")
                      if "input_recon_targets" in d else None)

    def recon_target(self, i):
        return None if self.recon is None else self.recon[i]

    def train_config(self, **kw):
        """The fixture's recipe, resumed for three epochs."""
        from pigs_tpu_torch.train.pn import TrainConfig
        d = self.data
        return TrainConfig(
            n_epochs=int(d["train_n_epochs"]),
            n_samples=int(d["train_n_samples"]), lr=float(d["train_lr"]),
            lr_min=float(d["train_lr_min"]), dt=self.dt,
            train_timesteps=int(d["train_timesteps"]),
            loss_weight_floor=self.floor,
            split_epoch=int(d["train_split_epoch"]),
            ema_decay=float(d["train_ema_decay"]), clip_norm=self.clip,
            skip_nonfinite_updates=True, **kw)

    def reset(self):
        """Parameters and Adam state back to the checkpoint's."""
        import torch
        with torch.no_grad():
            for p, p0 in zip(self.network.parameters(), self.params0):
                p.copy_(p0)
        self.opt = self.opt0

    def jax_tree(self, prefix):
        """A stored JAX parameter tree as one flat float64 vector in the
        network's parameter order."""
        import torch

        from pigs_tpu_torch.convert import params_from_flax
        flat = {"params" + k[len(prefix):]: v for k, v in self.data.items()
                if k.startswith(prefix + "/")}
        tree = params_from_flax(flat)
        return torch.cat([tree[k].flatten() for k in self.names]).double()

    def flat_params(self):
        import torch
        return torch.cat([p.detach().flatten().double().cpu()
                          for p in self.network.parameters()])

    def prev_fields(self, cfg):
        import torch

        from pigs_tpu_torch.models.model import sample_fields
        with torch.no_grad():
            return sample_fields(cfg, self.state, self.samples,
                                 self.bc_samples)


def train_step_phase(ti, impl):
    """One pn_step on ``impl``'s mixture path: errors against JAX f64 (loss
    terms [pde, bc, cons, init, mag, (NS: recon,) total], the gradient, the
    update and the loss weight)."""
    import torch

    from pigs_tpu_torch.ops import optim_kernel
    from pigs_tpu_torch.train.pn import pn_loss_grads, pn_step
    cfg = ti.cfg._replace(mixture_impl=impl)
    ti.reset()
    prev = ti.prev_fields(cfg)
    recon = ti.recon_target(0)
    _, curr, losses, total, grads = pn_loss_grads(
        cfg, ti.network, ti.state, prev, ti.samples, ti.time_samples,
        ti.bc_samples, 0.0, ti.dt, recon_target=recon)
    got = [float(x) for x in losses]
    want = list(ti.data["step_losses"][:5])
    if recon is not None:
        got.append(float(5.0 * torch.mean((curr.w - recon) ** 2)))
        want.append(float(ti.data["step_recon"]))
    got.append(float(total))
    want.append(float(ti.data["step_losses"][5]))
    loss_errs = [abs(a - b) / abs(b) if b else abs(a - b)
                 for a, b in zip(got, want)]
    grad = torch.cat([g.flatten().double().cpu() for g in grads])
    grad_err = rel_err(grad, ti.jax_tree("step_grads"))
    before = ti.flat_params()
    k6 = optim_kernel.launches
    opt, _, _, _, _, lw = pn_step(
        cfg, ti.network, ti.opt, ti.state, prev, ti.samples, ti.time_samples,
        ti.bc_samples, torch.ones((), device=ti.device), ti.base_lr,
        ti.epsilon, 0.0, ti.dt, loss_weight_floor=ti.floor, clip_norm=ti.clip,
        skip_nonfinite=True, recon_target=recon)
    update = ti.flat_params() - before
    update_err = rel_err(update, ti.jax_tree("step_params") - before)
    lw_err = abs(float(lw) - float(ti.data["step_loss_weight"]))
    torch.cuda.synchronize()
    check(int(opt.count) == int(ti.opt0.count) + 1, "Adam count not advanced")
    check(optim_kernel.launches == k6 + 1,
          f"pn_step launched {optim_kernel.launches - k6} K6, expected 1")
    return loss_errs, grad_err, update_err, lw_err


def split_epoch_phase(ti, mk, ak, want_counts, tag):
    """The fixture's split-regime epoch through the kernels: exact K1, K2,
    K3 and K6 launch counts (``want_counts`` in that order), finite
    losses, per-step totals within EPOCH_TOTAL_TOL of JAX's up to the first
    step whose active mask differs from JAX's (reported, not failed: split
    decisions threshold on float32 values).  Returns the launch counts
    (K1-K6) and that step (or None)."""
    import numpy as np
    import torch

    from pigs_tpu_torch.train.pn import pn_epoch
    ti.reset()
    reset_counts(mk, ak)
    prev = ti.prev_fields(ti.cfg)
    epoch = pn_epoch(ti.cfg, ti.network, ti.opt, ti.state, prev, ti.samples,
                     ti.time_samples, ti.bc_samples, ti.base_lr, ti.epsilon,
                     ti.dt, ti.n_steps, loss_weight_floor=ti.floor,
                     do_split=True, clip_norm=ti.clip, skip_nonfinite=True,
                     recon_targets=None if ti.recon is None else
                     ti.recon[:ti.n_steps])
    torch.cuda.synchronize()
    counts = read_counts(mk, ak)
    print(f"[{tag}] launches (K1-K6) {counts}, expected (K1, K2, K3, K6) "
          f"{want_counts}", flush=True)
    check(counts[:3] + counts[5:] == want_counts,
          f"{tag} launches {counts} != {want_counts}")
    per_step = epoch.per_step.cpu().numpy()
    check(bool(np.isfinite(per_step).all()), f"{tag} losses not finite")
    jax_steps = ti.data["epoch_per_step"]
    diverged = [i for i in range(ti.n_steps)
                if not np.array_equal(epoch.active[i].cpu().numpy(),
                                      ti.data["epoch_active"][i])]
    first = diverged[0] if diverged else None
    upto = ti.n_steps if first is None else first + 1
    total_errs = np.abs(per_step[:, 5] - jax_steps[:, 5]) / np.abs(
        jax_steps[:, 5])
    print(f"[{tag}] per-step total rel err vs JAX f64: "
          + " ".join(f"{e:.2e}" for e in total_errs), flush=True)
    print(f"[{tag}] active counts: "
          + " ".join(str(int(a.sum())) for a in epoch.active.cpu()), flush=True)
    print(f"[{tag}] first step whose active mask differs from JAX's: "
          f"{'none' if first is None else first}", flush=True)
    check(float(total_errs[:upto].max()) <= EPOCH_TOTAL_TOL,
          f"{tag} totals vs JAX {float(total_errs[:upto].max()):.3e} > "
          f"{EPOCH_TOTAL_TOL} before the split decisions diverge")
    return counts, first


def resumed_train(ti, log, dev, ns_data=None):
    """train() resumed from the fixture's checkpoint for its three epochs,
    logging every epoch into ``log`` (printed); fails unless it resumed and
    logged three finite losses."""
    import numpy as np

    from pigs_tpu_torch.train.checkpoint import save_checkpoint
    from pigs_tpu_torch.train.pn import train
    ckpt_dir = os.path.join(SCRATCH, "resume")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    ti.reset()
    save_checkpoint(ckpt_dir, int(ti.data["train_epoch"]),
                    dict(ti.network.named_parameters()), ti.opt, [],
                    ema=dict(zip(ti.names, ti.ema)))
    result = train(ti.cfg, ti.train_config(log_step=1),
                   checkpoint_dir=ckpt_dir, resume=True, log_fn=log.append,
                   device=dev, ns_data=ns_data)
    for line in log:
        print(f"  train: {line}", flush=True)
    check(any("Resumed" in line for line in log), "train() did not resume")
    check(len(result.training_loss) == 3 and all(
        np.isfinite(result.training_loss)), "train() losses")
    return result


def check_round_trip(ti, result, dev):
    """Save ``result`` as a checkpoint and restore it: every array equal.
    Returns the restored checkpoint."""
    import torch

    from pigs_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                 save_checkpoint)
    ckpt_dir = os.path.join(SCRATCH, "resume")
    n_epochs = int(ti.data["train_n_epochs"])
    names = ti.names
    save_checkpoint(ckpt_dir, n_epochs,
                    dict(result.network.named_parameters()), result.opt_state,
                    result.training_loss, ema=dict(zip(names, result.ema)))
    back = restore_checkpoint(ckpt_dir, dev)
    same = (back.epoch == n_epochs
            and back.training_loss == [float(x) for x in result.training_loss]
            and all(torch.equal(back.params[k], p)
                    for k, p in result.network.named_parameters())
            and all(torch.equal(a, b) for a, b in
                    zip(back.opt.mu + back.opt.nu + [back.opt.count],
                        result.opt_state.mu + result.opt_state.nu
                        + [result.opt_state.count]))
            and all(torch.equal(back.ema[k], e)
                    for k, e in zip(names, result.ema)))
    check(same, "checkpoint round trip changed values")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return back


def profile_ms(fn, steps: int, label: str, card: str):
    """Profile one call of ``fn`` (``steps`` steps, warmed up by the
    caller): device operations per step, device busy time against the wall
    time (the idle share under the profiler), and the largest items."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6

    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy = sum(device_us(e) for e in events)
    kernels = sum(e.count for e in events)
    top = sorted(events, key=lambda e: -device_us(e))[:8]
    print(f"[profile] {steps} {label}: {kernels / steps:.0f} device ops per "
          f"step, device busy {busy / 1e3:.3f} ms of {wall / 1e3:.3f} ms "
          f"wall (idle share {1 - busy / wall:.3f} under the profiler; "
          f"{card})", flush=True)
    for e in top:
        print(f"  {device_us(e) / 1e3 / steps:.4f} ms/step "
              f"x{e.count // steps} {e.key[:90]}", flush=True)
    families = {}
    for family, names in KERNEL_FAMILIES.items():
        mine = [e for e in events if any(s in e.key for s in names)]
        families[family] = {
            "device_ms_per_step": sum(device_us(e) for e in mine) / 1e3 / steps,
            "kernels_per_step": sum(e.count for e in mine) / steps}
    print(f"[profile] {label}, per step: " + "; ".join(
        f"{f} {v['device_ms_per_step']:.4f} ms device in "
        f"{v['kernels_per_step']:g} kernels" for f, v in families.items()),
        flush=True)
    return families


def ns_phase(dev, mk, ak, card) -> dict:
    """Phase 9: the NS held-out rollout through K1, counted and checked
    against the fixture's JAX frames and the dataset's solver frames."""
    import numpy as np
    import torch

    from pigs_tpu_torch.convert import load_fixture
    from pigs_tpu_torch.models.model import forward_step
    from pigs_tpu_torch.models.state import covariance_of
    from pigs_tpu_torch.train.pn import (NSDataset, rollout_metrics,
                                         rollout_vorticity, vorticity_samples)
    cfg, network, fix = load_fixture(NS_FIXTURE, device=dev)
    data = NSDataset.load(NS_DATA, device=dev)
    index = int(fix["config_held_out"])
    steps, res = int(fix["config_steps"]), int(fix["config_res"])
    state0 = data.state_for(cfg, index)

    reset_counts(mk, ak)
    frames = rollout_vorticity(cfg, network, state0, steps, res)
    torch.cuda.synchronize()
    counts = read_counts(mk, ak)
    # Frame 0's render, then per step forward_step (order 3 at the means)
    # and the render (order 1 at the 64x64 pixel centres).
    want = (1 + 2 * steps, 0, 0, 0, 0, 0)
    print(f"[ns] launches (K1-K6) {counts}, expected {want}: "
          f"{(counts[0] - 1) // steps} K1 per step", flush=True)
    check(counts == want, f"NS rollout launches {counts} != {want}")
    frames = frames.cpu().numpy()
    check(frames.shape == (steps + 1, res, res), f"NS frames {frames.shape}")
    check(bool(np.isfinite(frames).all()), "NS frames not finite")
    jax_frames = fix["jax_frames"]
    vs_jax = [float(np.linalg.norm(a - b) / np.linalg.norm(b))
              for a, b in zip(frames, jax_frames)]
    gt = data.frames[index].permute(2, 0, 1).cpu().numpy()
    metrics = rollout_metrics(frames, gt)
    fit = rollout_metrics(frames[:1], gt[:1])
    jax_mean = float(fix["jax_mean_rel_l2"])
    print("[ns] per-step rel-L2 vs JAX frames: "
          + " ".join(f"{v:.2e}" for v in vs_jax), flush=True)
    print(f"[ns] mean rel-L2 vs the solver {metrics['mean_rel_norm']:.6f} "
          f"(JAX-CPU {jax_mean:.6f}); t=0 curl-fit error "
          f"{fit['mean_rel_norm']:.6f} (JAX-CPU "
          f"{float(fix['jax_t0_rel_l2']):.6f})", flush=True)
    check(vs_jax[0] <= FRAME0_TOL, f"NS frame 0 vs JAX {vs_jax[0]:.3e}")
    check(max(vs_jax[1:6]) <= EARLY_FRAMES_TOL,
          f"NS steps 1-5 vs JAX {max(vs_jax[1:6]):.3e}")
    check(abs(metrics["mean_rel_norm"] - jax_mean) <= MEAN_REL_L2_TOL,
          f"NS mean rel-L2 {metrics['mean_rel_norm']:.6f} vs JAX "
          f"{jax_mean:.6f}")

    ms = statistics.median(
        host_ms(lambda: rollout_vorticity(cfg, network, state0, steps, res))
        for _ in range(3))
    print(f"[times] NS rollout {steps} steps at {res}x{res} with frame 0: "
          f"{ms:.2f} ms ({ms / steps:.3f} ms/step; median of 3, host clock "
          f"with device syncs; {card})", flush=True)
    state25 = state0
    k1_times = {}
    with torch.inference_mode():
        for _ in range(25):
            state25, _ = forward_step(cfg, network, state25)
        profile = profile_ms(
            lambda: rollout_vorticity(cfg, network, state0, 5, res), 5,
            "NS rollout steps", card)
        # K1 at the NS rollout's two shapes (each checked deterministic).
        _, conics = covariance_of(state0)
        n = state0.means.shape[0]
        pixels = vorticity_samples(res, cfg.dtype, dev)
        for label, (smp, order) in {
                f"NS {n}x{n} order 3 c=2 periodic (means)": (state0.means, 3),
                f"NS {pixels.shape[0]}x{n} order 1 c=2 periodic (render)":
                    (pixels, 1)}.items():
            k1_times[label] = time_k1(label, state0.means, conics, state0.u,
                                      smp, order, state0.active, cfg.period,
                                      mk, card)
    # Out of inference mode, so that the aggregate phase can differentiate.
    state25 = type(state25)(*(x.clone() for x in state25))
    return {"cfg": cfg, "network": network, "state0": state0,
            "state25": state25, "counts": counts, "ms": ms,
            "mean_rel_l2": metrics["mean_rel_norm"], "k1_times": k1_times,
            "profile": profile, "steps": steps, "fixture": fix}


def unpack_conics(packed):
    """Packed conics ``(n, 3)`` -> full ``(n, 2, 2)``."""
    import torch
    cxx, cxy, cyy = packed.unbind(-1)
    return torch.stack([torch.stack([cxx, cxy], -1),
                        torch.stack([cxy, cyy], -1)], -2)


def ns_train_phase(dev, mk, ak, card, fi) -> dict:
    """Phase 11: Navier-Stokes training from the NS training fixture, and
    one flagship epoch (``fi``: the flagship's TrainInputs) with the noise
    and importance sampling."""
    from unittest import mock

    import numpy as np
    import torch

    from pigs_tpu_torch.models.model import make_network
    from pigs_tpu_torch.models.state import covariance_of
    from pigs_tpu_torch.train import pn as tpn
    ti = TrainInputs(dev, NS_TRAIN_FIXTURE)
    out = {"counts": {}, "k1_times": {}, "k2_times": {}, "errs": [],
           "berrs": []}

    # (a) one NS step against JAX f64
    step_errs = {}
    for impl in ("auto", "plain"):
        loss_errs, grad_err, update_err, lw_err = train_step_phase(ti, impl)
        step_errs[impl] = (loss_errs, grad_err, update_err)
        print(f"[ns-train] step {'K1/K2' if impl == 'auto' else 'plain'}: "
              "loss terms [pde, bc, cons, init, mag, recon, total] rel err "
              "vs JAX f64 " + " ".join(f"{e:.2e}" for e in loss_errs)
              + f"; gradient {grad_err:.3e}; update {update_err:.3e}; "
              f"loss weight abs {lw_err:.2e}", flush=True)
    loss_errs, grad_err, update_err = step_errs["auto"]
    check(max(loss_errs) <= STEP_LOSS_TOL,
          f"NS pn_step loss terms {max(loss_errs):.3e} > {STEP_LOSS_TOL}")
    check(grad_err <= STEP_GRAD_TOL,
          f"NS pn_step gradient {grad_err:.3e} > {STEP_GRAD_TOL}")
    check(update_err <= STEP_UPDATE_TOL,
          f"NS pn_step update {update_err:.3e} > {STEP_UPDATE_TOL}")
    out["step_errs"] = step_errs

    # (b) the fixture's split-regime epoch (vorticity criteria), counted.
    # Launches: the IC's fields, 2 K1 (order 3 at the collocation samples,
    # order 0 at the boundary samples).  Each step: forward_step 1 K1 (order
    # 3 at the means); sample_fields 2 K1, of which only the order-3 output
    # reaches the loss (NS has no boundary term), so 1 K2; adaptive_split 3
    # K1 (density order 0 c=1, vorticity now and before order 1);
    # sample_fields of the split state 2 K1; the Adam step 1 K6.
    n_steps = ti.n_steps
    out["counts"]["ns_epoch"], out["first"] = split_epoch_phase(
        ti, mk, ak, (2 + 8 * n_steps, n_steps, 0, n_steps), "ns-train epoch")
    out["n_steps"] = n_steps

    # (c) train(ns_data=...) resumed for 3 epochs, the round trip, and the
    # EMA parameters rolled out on the held-out trajectory.
    data = tpn.NSDataset.load(NS_DATA, device=dev)
    held = int(ti.data["config_held_out"])
    check(held == data.means.shape[0] - 1, f"held-out trajectory {held}")
    log = []
    reset_counts(mk, ak)
    t_train = time.perf_counter()
    result = resumed_train(ti, log, dev, ns_data=tpn.NSDataset(
        *(x[:held] for x in data)))
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t_train
    out["counts"]["ns_train"] = read_counts(mk, ak)
    adam_steps = int(result.opt_state.count) - int(ti.opt0.count)
    check(out["counts"]["ns_train"][0] > 0
          and out["counts"]["ns_train"][1] > 0
          and out["counts"]["ns_train"][2] == 0
          and out["counts"]["ns_train"][5] == adam_steps > 0,
          f"NS train() launches (K1-K6) {out['counts']['ns_train']}, "
          f"{adam_steps} Adam steps")
    back = check_round_trip(ti, result, dev)
    net = make_network(ti.cfg, frequencies=ti.network.frequencies.cpu(),
                       device=dev)
    net.load_state_dict(back.ema)
    with np.load(NS_FIXTURE) as z:
        jax_mean = float(z["jax_mean_rel_l2"])
        steps, res = int(z["config_steps"]), int(z["config_res"])
    frames = tpn.rollout_vorticity(ti.cfg, net, data.state_for(ti.cfg, held),
                                   steps, res).cpu().numpy()
    check(bool(np.isfinite(frames).all()), "NS EMA frames not finite")
    gt = data.frames[held].permute(2, 0, 1).cpu().numpy()
    out["ema_mean_rel_l2"] = tpn.rollout_metrics(frames, gt)["mean_rel_norm"]
    print(f"[ns-train] 3 epochs in {out['train_s']:.2f} s; launches (K1-K6) "
          f"{out['counts']['ns_train']}; checkpoint round trip equal; EMA "
          f"rollout mean rel-L2 vs the solver {out['ema_mean_rel_l2']:.6f} "
          f"(JAX-CPU rollout of the checkpoint {jax_mean:.6f})", flush=True)
    check(abs(out["ema_mean_rel_l2"] - jax_mean) <= MEAN_REL_L2_TOL,
          f"NS EMA rollout mean rel-L2 {out['ema_mean_rel_l2']:.6f} vs "
          f"{jax_mean:.6f}")

    # (d) K1 and K2 at the NS training shapes the other phases do not time
    # (640x640 order 3 at the means is phase 9's): checked against the f32
    # twin and the f64 oracle, then timed as in phase 8.
    st, period = ti.state, ti.cfg.period
    _, conics = covariance_of(st)
    n, m = st.means.shape[0], ti.samples.shape[0]
    ones = torch.ones((n, 1), device=dev)
    k1_shapes = {
        f"NS {m}x{n} order 3 c=2 periodic (collocation)":
            (st.means, conics, st.u, ti.samples, 3, st.interior),
        f"NS {m}x{n} order 0 c=2 periodic (boundary)":
            (st.means, conics, st.u, ti.bc_samples, 0, st.interior),
        f"NS {n}x{n} order 1 c=2 periodic (split: vorticity)":
            (st.means, conics, st.u, st.means, 1, st.active),
        f"NS {n}x{n} order 0 c=1 periodic (split: density)":
            (st.means, conics, ones, st.means, 0, st.active),
    }
    gen = torch.Generator().manual_seed(11)
    with torch.inference_mode():
        for label, (mu, con, val, smp, order, mask) in k1_shapes.items():
            out["errs"].append(compare_case(label, mu, con, val, smp, order,
                                            mask, period, mk))
            out["k1_times"][label] = time_k1(label, mu, con, val, smp, order,
                                             mask, period, mk, card)
    label = f"NS {m}x{n} order 3 c=2 periodic (collocation)"
    out["berrs"].append(compare_backward(label, st.means, conics, st.u,
                                         ti.samples, 3, st.interior, period,
                                         mk, gen))
    with torch.inference_mode():
        packed = (st.means.contiguous(), mk.pack_conics(conics).contiguous(),
                  (st.u * st.interior.float()[:, None]).contiguous())
        out["k2_times"][label] = time_k23(label, packed, ti.samples, 3, mk,
                                          gen, card, period=period,
                                          with_k3=False)["mixture_bwd_gauss"]

    # (e) 5 NS training steps: time and profile
    ti.reset()
    prev = ti.prev_fields(ti.cfg)

    def step():
        return tpn.pn_step(ti.cfg, ti.network, ti.opt, ti.state, prev,
                           ti.samples, ti.time_samples, ti.bc_samples,
                           torch.ones((), device=dev), ti.base_lr, ti.epsilon,
                           0.0, ti.dt, ti.floor, ti.clip, True,
                           recon_target=ti.recon_target(0))
    step()
    out["step_ms"] = statistics.median(host_ms(step) for _ in range(5))
    print(f"[times] NS pn_step: K1/K2 {out['step_ms']:.2f} ms (median of 5, "
          f"host clock with device syncs; {card})", flush=True)
    out["profile"] = profile_ms(lambda: [step() for _ in range(5)], 5,
                                "NS pn_steps", card)
    ti.reset()

    # (f) one flagship epoch with noise_std and adaptive_sampling, its K1
    # launches recorded by shape.  The importance draw adds one order-1 K1
    # at the 4 x n_samples candidates; the noise re-samples the carried
    # fields at the start of each step (2 K1).
    fi.reset()
    tcfg = fi.train_config(noise_std=0.01, adaptive_sampling=0.5)
    launched, seen = [], {}
    launch_fwd, pn_epoch = mk._launch_fwd, tpn.pn_epoch
    cand_key = (4 * tcfg.n_samples, fi.cfg.capacity, 1)

    def spy_launch(*args, **kw):
        outs = launch_fwd(*args, **kw)
        key = (args[3].shape[0], args[0].shape[0], args[4])
        launched.append(key)
        if key == cand_key:
            seen["cand"] = (args, [o.clone() for o in outs])
        return outs

    def spy_epoch(*args, **kw):
        res = pn_epoch(*args, **kw)
        seen["state"] = (args[3], res.state)
        return res

    reset_counts(mk, ak)
    with mock.patch.object(mk, "_launch_fwd", spy_launch), \
            mock.patch.object(tpn, "pn_epoch", spy_epoch):
        _, totals, _, n_opt = tpn.train_epoch(
            fi.cfg, tcfg, fi.network, fi.opt,
            torch.Generator().manual_seed(tcfg.seed),
            int(fi.data["train_epoch"]), tcfg.initial_timesteps, dev)
    torch.cuda.synchronize()
    counts = out["counts"]["options_epoch"] = read_counts(mk, ak)
    want = (3 + 10 * n_opt, 2 * n_opt, 0, n_opt)
    n_cand = launched.count(cand_key)
    print(f"[ns-train] flagship epoch with noise_std 0.01 and "
          f"adaptive_sampling 0.5: {n_opt} steps, launches (K1-K6) {counts}, "
          f"expected (K1, K2, K3, K6) {want}; K1 launches at "
          f"{cand_key[0]}x{cand_key[1]} order 1: {n_cand}; totals {totals}",
          flush=True)
    check(counts[:3] + counts[5:] == want,
          f"options epoch launches {counts} != {want}")
    check(n_cand == 1, f"{n_cand} importance K1 launches, expected 1")
    check(bool(np.isfinite(totals).all()), "options epoch losses not finite")
    before, after = seen["state"]
    check(torch.equal(before.u[before.boundary], after.u[after.boundary]),
          "the noise moved a boundary Gaussian's value")
    args, outs = seen["cand"]
    label = (f"{cand_key[0]}x{cand_key[1]} order 1 (importance candidates "
             "of the flagship)")
    mu, packed, val, smp = args[:4]
    con = unpack_conics(packed)
    with torch.inference_mode():
        check(all(torch.equal(a, b) for a, b in zip(
            outs, mk._launch_fwd(*args[:6]))),
            f"{label}: the path's launch and a second one differ")
        out["errs"].append(compare_case(label, mu, con, val, smp, 1, None,
                                        None, mk))
        out["k1_times"][label] = time_k1(
            label, mu, con, val, smp, 1,
            torch.ones(mu.shape[0], dtype=torch.bool, device=dev), None, mk,
            card)
    fi.reset()
    return out


def aggregation_inputs(cfg, network, state):
    """Each head's aggregation inputs at ``state`` as forward_step builds
    them, the means, the radii, and the network's neighbour mask."""
    import torch

    from pigs_tpu_torch.models.model import network_inputs
    from pigs_tpu_torch.ops.aggregate_kernel import radii_of
    with torch.no_grad():
        args = network_inputs(cfg, state)
        _, heads = network.aggregation_inputs(*args[:9])
    means, full_cov, active, nbr = args[0], args[1], args[8], args[9]
    return heads, means, radii_of(full_cov, active), nbr


def perf_suite_inputs(n, gen, dev):
    """benchmarks/perf_suite.py's aggregation inputs (L=K=16, F=6, d=2,
    every Gaussian active, std 0.1 shrunk as 1/sqrt(n) past n=1664), drawn
    with torch from ``gen``: ``(head inputs, means, covariances)``."""
    import torch
    L, K, F, d = 16, 16, 6, 2
    E = 1 + 2 * F * d

    def normal(*shape):
        return torch.randn(shape, generator=gen)
    inputs = (normal(n, L), normal(L, L) / L ** 0.5, normal(n, K),
              normal(n, K), torch.abs(normal(F)) * 10.0,
              normal(L, 2 * E) / E ** 0.5)
    means = torch.rand((n, d), generator=gen) * 2.0 - 1.0
    sig = 0.1 * min(1.0, (1664.0 / n) ** 0.5)
    cov = (sig ** 2) * torch.eye(d).expand(n, d, d).contiguous()
    return ([x.to(dev) for x in inputs], means.to(dev), cov.to(dev))


def aggregate_phase(dev, ak, card, cases) -> dict:
    """Phase 10: K4/K5 at each case's real inputs (both heads), counted and
    checked; then the timings at perf_suite's sizes."""
    import torch

    from pigs_tpu_torch.ops import mixture_kernel as mk
    from pigs_tpu_torch.ops.aggregate import (aggregate_neighbors_factored,
                                              neighbor_mask)
    gen = torch.Generator().manual_seed(3)
    prepared = []
    for label, cfg, network, state in cases:
        heads, means, radii, nbr = aggregation_inputs(cfg, network, state)
        for h, head in enumerate(heads):
            cot = torch.randn(head.features.shape, generator=gen,
                              dtype=torch.float64).float().to(dev)
            prepared.append((f"{label} head {h}", cfg.period, nbr,
                             [x.detach().contiguous() for x in head]
                             + [means.contiguous(), radii.contiguous()],
                             cot))

    # The path: K4 forward and K5 backward once per case and head.  (The
    # timings below launch them again; those launches are not counted.)
    ak.fwd_launches = ak.bwd_launches = 0
    results = []
    for label, period, _, x32, cot in prepared:
        tin = [x.clone().requires_grad_() for x in x32[:7]]
        out = ak.aggregate_neighbors_fused(*tin, x32[7], period=period)
        grads = torch.autograd.grad(out, tin, cot)
        results.append((out.detach(), grads))
    torch.cuda.synchronize()
    launches = {"fwd": ak.fwd_launches, "bwd": ak.bwd_launches}
    print(f"[aggregate] launches (K4, K5) ({launches['fwd']}, "
          f"{launches['bwd']}), expected ({len(prepared)}, {len(prepared)})",
          flush=True)
    check(launches == {"fwd": len(prepared), "bwd": len(prepared)},
          f"aggregate launches {launches}")

    names = ("features", "transform", "queries", "keys", "frequencies",
             "distance_transform", "means")
    max_abs = {"fwd": 0.0, "bwd": 0.0}
    differ = {}
    for (label, period, nbr, x32, cot), (out, grads) in zip(prepared,
                                                            results):
        x64 = [x.double() for x in x32]
        twin32 = ak.aggregate_fused_plain(*x32, period=period)
        twin64 = ak.aggregate_fused_plain(*x64, period=period)
        factored = aggregate_neighbors_factored(*x32[:7], mask=nbr,
                                                period=period)
        kmask = ak.kernel_mask(x32[6], x32[7], 3.0, period)
        differ[label] = int((kmask != nbr).sum())
        active = int((x32[7] > -float("inf")).sum())
        e32, e64, ef = (rel_err(out, twin32), rel_err(out, twin64),
                        rel_err(out, factored))
        max_abs["fwd"] = max(max_abs["fwd"], (out - twin32).abs().max().item())
        check(bool(torch.isfinite(out).all()), f"{label}: K4 not finite")
        want64 = ak.aggregate_fused_backward_plain(*x64, cot.double(),
                                                   period=period)
        want32 = ak.aggregate_fused_backward_plain(*x32, cot, period=period)
        gerrs = [rel_err(a, b) for a, b in zip(grads, want64)]
        max_abs["bwd"] = max([max_abs["bwd"]] + [
            (a - b).abs().max().item() for a, b in zip(grads, want32)])
        print(f"  {label}: {active} active, {int(kmask.sum()) / active:.1f} "
              f"neighbours per active; K4 rel err vs twin f32 {e32:.3e}, "
              f"f64 {e64:.3e}, factored {ef:.3e} ({differ[label]} pairs "
              "decided differently); K5 vs f64 "
              + " ".join(f"{n[:5]} {e:.1e}" for n, e in zip(names, gerrs)),
              flush=True)
        check(e32 <= KERNEL_F32_TOL,
              f"{label}: K4 vs float32 twin {e32:.3e} > {KERNEL_F32_TOL}")
        check(e64 <= KERNEL_F64_TOL,
              f"{label}: K4 vs float64 twin {e64:.3e} > {KERNEL_F64_TOL}")
        check(ef <= KERNEL_F64_TOL or differ[label] > 0,
              f"{label}: K4 vs the factored path {ef:.3e} > "
              f"{KERNEL_F64_TOL} with the same neighbours")
        for n, e in zip(names, gerrs):
            check(e <= KERNEL_F64_TOL,
                  f"{label}: K5 grad {n} vs float64 {e:.3e} > "
                  f"{KERNEL_F64_TOL}")
    # Two raw K4 launches, and two raw K5 launches, on each real input
    # give the same bits.
    for label, period, _, x32, cot in prepared:
        check_deterministic(f"K4 {label}",
                            lambda: ak._launch_fwd(*x32, 3.0, period))
        check_deterministic(f"K5 {label}",
                            lambda: ak._launch_bwd(*x32, cot, 3.0, period))
    print(f"[aggregate] {len(prepared)} cases pass; max abs err vs the f32 "
          f"twins: K4 {max_abs['fwd']:.3e}, K5 {max_abs['bwd']:.3e}; K4 "
          "and K5 each bitwise equal over two launches", flush=True)

    # Times at the real inputs (head 0 of each case) and at perf_suite's
    # inputs.  The float32 twin's forward+backward at n=8192 keeps every
    # row chunk's autograd state, ~40 GB: it fits the 80 GB card.
    times = {}
    kernel_times = {"aggregate_fwd": {}, "aggregate_bwd": {}}
    for label, period, nbr, x32, cot in prepared[::2]:
        f, tr, q, k, fr, dist, means, radii = x32
        real = time_aggregation(ak, f, tr, q, k, fr, dist, means, radii, nbr,
                                period)
        times.update({(impl, key, label): t
                      for (impl, key), t in real.items()})
        print(f"[times] aggregation at {label} (n={f.shape[0]}): "
              + describe_times(real) + f" (median of 20; {card})",
              flush=True)
        pairs = int(ak.kernel_mask(means, radii, 3.0, period).sum())
        for name, t in time_k45(ak, x32, cot, nbr, period).items():
            t["bound_ms"], t["bound_by"] = aggregate_bound(name, f.shape[0],
                                                           pairs)
            t["pairs"] = pairs
            text = f"{label} ({pairs} neighbour pairs)"
            print(describe_kernel_times(name, text, t, card), flush=True)
            if name == "aggregate_fwd":
                print(f"[times] factored aggregation {text}: device "
                      f"{t['factored_device_ms']:.4f} ms in "
                      f"{sum(t['factored_kernels'].values())} kernels a call "
                      f"(profiler), K4 {t['device_ms']:.4f} ms ({card})",
                      flush=True)
                launch = functools.partial(ak._launch_fwd, *x32, 3.0, period)
            else:
                launch = functools.partial(ak._launch_bwd, *x32, cot, 3.0,
                                           period)
            t["graph_ms_by_blocks_per_sm"] = sweep_grid(
                name, label,
                lambda b: ak.fwd_geometry(f.shape[0], ak._sm_count(0), b),
                lambda b: launch(blocks_per_sm=b), card)
            if name == "aggregate_bwd":
                print(f"[grid] aggregate_bwd {label}: target taken "
                      f"{mk.BLOCKS_PER_SM} blocks per SM "
                      "(mixture_kernel.BLOCKS_PER_SM, K4's)", flush=True)
            kernel_times[name][label] = t
    for n in PERF_SUITE_SIZES:
        inputs, means, cov = perf_suite_inputs(n, gen, dev)
        active = torch.ones(n, dtype=torch.bool, device=dev)
        mask = neighbor_mask(means, cov, active)
        if ak.fwd_geometry(n, ak._sm_count(0))[1] == 1:
            # K5 too at n=4096 (its float64 twin's autograd state grows
            # as n^2).
            one_slice_k45(ak, n, inputs, means, ak.radii_of(cov, active),
                          gen, with_k5=n == 4096)
        synth = time_aggregation(ak, *inputs, means, ak.radii_of(cov, active),
                                 mask, None)
        times.update({(impl, key, n): t for (impl, key), t in synth.items()})
        print(f"[times] aggregation n={n} "
              f"({float(mask.sum()) / n:.1f} neighbours per Gaussian): "
              + describe_times(synth) + f" (median of 20; {card})",
              flush=True)
    return {"launches": launches, "max_abs": max_abs, "differ": differ,
            "times": times, "kernel_times": kernel_times}


def one_slice_k45(ak, n, inputs, means, radii, gen, with_k5):
    """K4 where its grid takes one slice (the warps write the output, no
    merge pass): against its float32 and float64 twins, and two launches
    bitwise equal; with ``with_k5``, K5 in one slice the same way (its
    seven gradients against the float64 twin)."""
    import torch
    x32 = [x.contiguous() for x in (*inputs, means, radii)]
    if with_k5:
        cot = torch.randn((n, 16), generator=gen).to(means.device)
        grads = ak._launch_bwd(*x32, cot, 3.0, None)
        want = ak.aggregate_fused_backward_plain(
            *(x.double() for x in x32), cot.double())
        errs = [rel_err(a, b) for a, b in zip(grads, want)]
        del want
        check(all(bool(torch.isfinite(g).all()) for g in grads),
              f"K5 n={n}: not finite")
        check(max(errs) <= KERNEL_F64_TOL,
              f"K5 n={n} (one slice): vs float64 twin {max(errs):.3e}")
        check_deterministic(f"K5 n={n}",
                            lambda: ak._launch_bwd(*x32, cot, 3.0, None))
        print(f"  K5 n={n} (one slice, perf_suite's input): largest rel "
              f"err of the seven gradients vs twin f64 {max(errs):.3e}; two "
              "launches equal", flush=True)
    with torch.no_grad():
        out = ak._launch_fwd(*x32, 3.0, None)
        e32 = rel_err(out, ak.aggregate_fused_plain(*x32))
        e64 = rel_err(out, ak.aggregate_fused_plain(*(x.double()
                                                      for x in x32)))
    check(bool(torch.isfinite(out).all()), f"K4 n={n}: not finite")
    check(e32 <= KERNEL_F32_TOL,
          f"K4 n={n} (one slice): vs float32 twin {e32:.3e}")
    check(e64 <= KERNEL_F64_TOL,
          f"K4 n={n} (one slice): vs float64 twin {e64:.3e}")
    check_deterministic(f"K4 n={n}", lambda: ak._launch_fwd(*x32, 3.0, None))
    print(f"  K4 n={n} (one slice, perf_suite's input): rel err vs twin f32 "
          f"{e32:.3e}, f64 {e64:.3e}; two launches equal", flush=True)


def time_k45(ak, x32, cot, nbr, period) -> dict:
    """K4 and K5 at one real input: device, graph-replay, call and plain
    times, K4's grid, and the device time of the factored aggregation the
    network runs (mask ``nbr``) beside K4.  K5's call is one autograd
    backward through the fused Function; its plain twin recomputes the
    forward, as K5 does."""
    import torch

    from pigs_tpu_torch.ops.aggregate import aggregate_neighbors_factored
    tin = [x.clone().requires_grad_() for x in x32[:7]]
    out = ak.aggregate_neighbors_fused(*tin, x32[7], period=period)
    with torch.no_grad():
        fwd = time_kernel(
            lambda: ak._launch_fwd(*x32, 3.0, period),
            lambda: ak.aggregate_neighbors_fused(*x32, period=period),
            lambda: ak.aggregate_fused_plain(*x32, period=period))
        fwd["grid"] = grid_of(ak, ak.fwd_geometry(x32[0].shape[0],
                                                  ak._sm_count(0)),
                              ak.KEY_SLICE_UNIT)
        factored, kernels = profiled_device_ms(
            lambda: aggregate_neighbors_factored(*x32[:7], mask=nbr,
                                                 period=period))
        check(factored is not None,
              "the profiler saw no kernel of the factored aggregation")
        fwd["factored_device_ms"] = factored
        fwd["factored_kernels"] = {k: c for k, (c, _) in kernels.items()}
        bwd = time_kernel(
            lambda: ak._launch_bwd(*x32, cot, 3.0, period),
            lambda: torch.autograd.grad(out, tin, cot, retain_graph=True),
            lambda: ak.aggregate_fused_backward_plain(*x32, cot,
                                                      period=period))
        # K5's statistics, row and column passes take K4's grid.
        bwd["grid"] = grid_of(ak, ak.fwd_geometry(x32[0].shape[0],
                                                  ak._sm_count(0)),
                              ak.KEY_SLICE_UNIT)
    return {"aggregate_fwd": fwd, "aggregate_bwd": bwd}


def time_aggregation(ak, f, tr, q, k, fr, dist, means, radii, mask,
                     period) -> dict:
    """Median CUDA-event times of K4 (``kernel``), the factored path with
    ``mask`` and the float32 twin: the forward (``fwd``) and the forward and
    backward of sum(out**2) in features, queries, keys and means (``bwd``),
    as benchmarks/perf_suite.py takes them."""
    import torch

    from pigs_tpu_torch.ops.aggregate import aggregate_neighbors_factored
    impls = {
        "kernel": lambda f, q, k, m: ak.aggregate_neighbors_fused(
            f, tr, q, k, fr, dist, m, radii, period=period),
        "factored": lambda f, q, k, m: aggregate_neighbors_factored(
            f, tr, q, k, fr, dist, m, mask, period=period),
        "plain": lambda f, q, k, m: ak.aggregate_fused_plain(
            f, tr, q, k, fr, dist, m, radii, period=period),
    }
    times = {}
    for impl, fn in impls.items():
        with torch.no_grad():
            times[(impl, "fwd")] = median_ms(lambda: fn(f, q, k, means))
        tin = [x.clone().requires_grad_() for x in (f, q, k, means)]

        def fwdbwd():
            torch.autograd.grad((fn(*tin) ** 2).sum(), tin)
        times[(impl, "bwd")] = median_ms(fwdbwd)
    return times


def no_mlp_block_inputs(cfg, data, dev, iters=None):
    """The fixture's block on the card: ``(params, opt_state, active, prev,
    draws, count)`` in float32, ``iters`` of its draws (all by default)."""
    import torch

    from pigs_tpu_torch.convert import (no_mlp_adam_from_optax, no_mlp_arrays,
                                        no_mlp_params_from_jax)
    from pigs_tpu_torch.train import no_mlp as nm
    kw = dict(device=dev, dtype=torch.float32)
    params = nm.RawParams(*(x.requires_grad_() for x in no_mlp_params_from_jax(
        no_mlp_arrays(data, "start"), **kw)))
    opt = no_mlp_adam_from_optax(no_mlp_arrays(data, "start_adam_mu"),
                                 no_mlp_arrays(data, "start_adam_nu"),
                                 data["start_adam_count"], **kw)
    with torch.no_grad():
        prev = nm.concrete(cfg, no_mlp_params_from_jax(
            no_mlp_arrays(data, "ic"), **kw)) + (
                torch.tensor(data["ic_active"], device=dev),)
    sl = slice(None, iters)
    draws = nm.BlockDraws(torch.tensor(data["draws_base"][sl], **kw), None,
                          None, torch.tensor(data["draws_time"][sl], **kw))
    return (params, opt, torch.tensor(data["start_active"], device=dev), prev,
            draws, int(data["start_adam_count"]))


def no_mlp_solve(label, cfg, n_steps, dev, mk, ak, densify_every=None):
    """``solve`` on the card from a seeded generator, counted: the
    trajectory, its launches (K1-K6), the seconds it took, and the
    iterations of the IC fit and of the dynamics steps.  An IC-fit
    iteration launches one K1 and one K2, a dynamics iteration two K1s (the
    previous mixture and the current one) and one K2; none launches K3;
    each takes one Adam step, one K6."""
    import torch

    from pigs_tpu_torch.train.no_mlp import solve
    gen = torch.Generator(device=dev).manual_seed(0)
    reset_counts(mk, ak)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    traj = solve(cfg, gen, n_steps, densify_every=densify_every, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts(mk, ak)
    ic = traj[0]["iters"]
    dyn = sum(s["iters"] for s in traj[1:])
    want = (ic + 2 * dyn, ic + dyn, 0, 0, 0, ic + dyn)
    losses = " ".join(f"{s['loss']:.3e}" for s in traj)
    print(f"[no-mlp] {label}: {n_steps - 1} steps after the IC fit in "
          f"{seconds:.2f} s, iterations {[s['iters'] for s in traj]} "
          f"({(ic + dyn) / seconds:.1f}/s), losses {losses}, active "
          f"{[int(s['active'].sum()) for s in traj]}; launches (K1-K6) "
          f"{counts}, expected {want}", flush=True)
    check(counts == want, f"no-MLP {label} launches {counts} != {want}")
    return traj, counts, seconds, ic + dyn


def ic_fit_rel_l2(cfg, params, active, x):
    """The rel-L2 of a 1-D IC fit against exp(-2 x^2) at ``x``, through
    eval_mixture (K1 on the card) and its plain path, in float32 and
    float64: ``{"k1", "plain", "plain64"}``."""
    import torch

    from pigs_tpu_torch.ops.mixture import eval_mixture
    from pigs_tpu_torch.train import no_mlp as nm
    target = torch.exp(-2.0 * x.double()[:, 0] ** 2)
    out = {}
    with torch.no_grad():
        for key, impl, dtype in (("k1", "auto", torch.float32),
                                 ("plain", "plain", torch.float32),
                                 ("plain64", "plain", torch.float64)):
            mu, con, val = (t.to(dtype) for t in nm.concrete(cfg, params))
            u = eval_mixture(mu, con, val, x.to(dtype), order=0, mask=active,
                             impl=impl).u[:, 0]
            out[key] = rel_err(u, target)
    return out


def one_d_diagnostics(cfg, ic, draws, x201, dev, mk, gen) -> dict:
    """Phase 12d's diagnostics of the 1-D IC fit, each on its own line:
    (1) its final parameters rendered through K1 and through the plain path
    at the 201 points, at the fit's last 128 samples and on the CPU; (2)
    the IC fit rerun on the card with the CPU generator's draws (seeds 0
    and 1) and with CUDA seeds 1-4 (seed 0 is the solve's), against JAX's
    band (artifacts/no_mlp_1d_torch.npz); (3) K1 and K2 at the fit's final
    state against the float64 oracle at 128x1024 (the fit's samples) and
    201x1024 (the render)."""
    import numpy as np
    import torch

    from pigs_tpu_torch.train import no_mlp as nm
    params, active = ic["params"], ic["active"]
    last = nm.draw_samples(cfg, draws.base[-1], params, first_step=True)
    at201 = ic_fit_rel_l2(cfg, params, active, x201)
    at_last = ic_fit_rel_l2(cfg, params, active, last)
    cpu = ic_fit_rel_l2(cfg, nm.RawParams(*(p.cpu() for p in params)),
                        active.cpu(), x201.cpu())
    print(f"[no-mlp] 1-D diagnostic 1 (render): the IC fit's final params "
          f"({int(active.sum())} active) at 201 points: K1 {at201['k1']:.5f}, "
          f"plain f32 {at201['plain']:.5f}, plain f64 {at201['plain64']:.5f}, "
          f"on the CPU (plain) {cpu['plain']:.5f}; at the fit's last "
          f"{last.shape[0]} samples: K1 {at_last['k1']:.5f}, plain "
          f"{at_last['plain']:.5f}", flush=True)

    with np.load(NO_MLP_1D_FIXTURE) as z:
        jax_final, jax_blocks = z["final_rel_l2"], z["block_rel_l2"][:, 10:]
    runs = {}
    for label, gen_ in ([(f"CPU generator seed {s}",
                          torch.Generator().manual_seed(s)) for s in (0, 1)]
                        + [(f"CUDA seed {s}",
                            torch.Generator(device=dev).manual_seed(s))
                           for s in range(1, 5)]):
        p0, a0 = nm.init_params(cfg, dev)
        fit, a1, loss, iters = nm.solve_timestep(cfg, p0, a0, None, gen_,
                                                 first_step=True)
        runs[label] = (ic_fit_rel_l2(cfg, fit, a1, x201)["k1"], loss, iters)
    runs["CUDA seed 0"] = (at201["k1"], ic["loss"], ic["iters"])
    print("[no-mlp] 1-D diagnostic 2 (draws): IC-fit rel-L2 at 201 points "
          "(loss, iterations): " + "; ".join(
              f"{k} {v[0]:.5f} ({v[1]:.2e}, {v[2]})" for k, v in runs.items())
          + f"; JAX (seeds 0-9, fixture): where solve_timestep stops "
          f"{jax_final.min():.5f}-{jax_final.max():.5f}, after blocks 10-50 "
          f"median {np.median(jax_blocks):.5f}, max per seed "
          f"{jax_blocks.max(axis=1).min():.5f}-{jax_blocks.max():.5f}",
          flush=True)
    check(all(np.isfinite(v[0]) for v in runs.values()),
          "1-D diagnostic IC fits not finite")

    mu, con, val = nm.concrete(cfg, params)
    errs, berrs = [], []
    for label, smp in (("fit's samples", last), ("render", x201)):
        label = f"1-D IC fit {smp.shape[0]}x{cfg.capacity} order 0 ({label})"
        with torch.inference_mode():
            errs.append(compare_case(label, mu, con, val, smp, 0, active,
                                     None, mk))
        berrs.append(compare_backward(label, mu, con, val, smp, 0, active,
                                      None, mk, gen))
    print(f"[no-mlp] 1-D diagnostic 3 (kernels): K1 at the IC fit's state vs "
          f"the f64 oracle {max(e['f64'] for e in errs):.3e}, K2/K3 "
          f"{max(e['f64'] for e in berrs):.3e} (128 and 201 samples x "
          f"{cfg.capacity}, {int(active.sum())} active)", flush=True)
    return {"render": at201, "render_at_fit_samples": at_last,
            "render_cpu": cpu, "fits": {k: v[0] for k, v in runs.items()},
            "errs": errs, "berrs": berrs}


def no_mlp_phase(dev, mk, ak, card) -> dict:
    """Phase 12: the no-MLP direct solver on the card (see the module
    docstring)."""
    import torch

    from pigs_tpu_torch.convert import (load_no_mlp_fixture, no_mlp_arrays,
                                        no_mlp_adam_from_optax,
                                        no_mlp_params_from_jax)
    from pigs_tpu_torch.ops.mixture import embed_d1, eval_mixture
    from pigs_tpu_torch.pde import Problem
    from pigs_tpu_torch.train import no_mlp as nm
    from pigs_tpu_torch.utils.fd import solve_fd_1d, solve_fd_2d
    from pigs_tpu_torch.utils.sampling import grid_samples
    cfg, densify_every, data = load_no_mlp_fixture(NO_MLP_FIXTURE)
    out = {"counts": {}, "k1_times": {}, "k2_times": {}, "errs": [],
           "berrs": []}

    # (b) the fixture's 100-iteration block against JAX float64, counted.
    params, opt, active, prev, draws, count = no_mlp_block_inputs(cfg, data,
                                                                  dev)
    reset_counts(mk, ak)
    params, opt, grad, loss = nm._run_block(cfg, params, opt, active, prev,
                                            False, draws, count)
    torch.cuda.synchronize()
    counts = out["counts"]["no_mlp_block"] = read_counts(mk, ak)
    iters = out["iters"] = cfg.block_iters
    want = (2 * iters, iters, 0, 0, 0, iters)
    arr = lambda p: no_mlp_arrays(data, p)

    def worst(got, prefix):
        return max(rel_err(a.detach().cpu(), torch.tensor(b))
                   for a, b in zip(got, arr(prefix)))
    errs = {"loss": abs(loss.item() - float(data["block_loss"]))
            / abs(float(data["block_loss"])),
            "params": worst(params, "block"),
            "grad_acc": worst(grad, "block_grad_acc"),
            "mu": worst(opt.mu, "block_adam_mu"),
            "nu": worst(opt.nu, "block_adam_nu")}
    print(f"[no-mlp] fixture block ({iters} iterations, 1024 samples x 1024 "
          f"Gaussians, float32 through K1/K2) vs JAX float64: "
          + ", ".join(f"{k} {v:.3e} (tol {NO_MLP_BLOCK_TOL[k]:.1e})"
                      for k, v in errs.items())
          + f"; launches (K1-K6) {counts}, expected {want}", flush=True)
    check(counts == want, f"no-MLP block launches {counts} != {want}")
    check(int(opt.count) == int(data["block_adam_count"]),
          f"no-MLP block Adam count {int(opt.count)}")
    for k, e in errs.items():
        check(e <= NO_MLP_BLOCK_TOL[k],
              f"no-MLP block {k} vs JAX f64 {e:.3e} > {NO_MLP_BLOCK_TOL[k]}")
    out["block_errs"] = errs

    # (c) densify at full width: masks equal JAX's, fresh moments zero.
    d_active = torch.tensor(data["densify_in_active"], device=dev)
    for tag, min_keep in (("densify0", 0),
                          ("densifyk", int(data["densify_min_keep"]))):
        d_opt = no_mlp_adam_from_optax(arr("start_adam_mu"),
                                       arr("start_adam_nu"),
                                       data["start_adam_count"], device=dev)
        d_params, d_opt, d_new = nm.densify(
            cfg._replace(min_keep=min_keep),
            no_mlp_params_from_jax(arr("densify_in"), device=dev), d_opt,
            d_active, torch.tensor(data["densify_mean_grad"], device=dev))
        fresh = (d_new & ~d_active) | (d_active & ~d_new)
        written = (d_params.raw_means
                   != torch.tensor(data["densify_in/raw_means"], device=dev)
                   ).any(-1)
        zero = all(bool((m[fresh | written] == 0).all())
                   for m in d_opt.mu + d_opt.nu)
        same = bool((d_new.cpu().numpy() == data[f"{tag}_active"]).all())
        print(f"[no-mlp] densify min_keep {min_keep}: {int(d_new.sum())} "
              f"active (JAX {int(data[f'{tag}_active'].sum())}), "
              f"{int(written.sum())} children; masks equal: {same}; fresh "
              f"moments zero: {zero}", flush=True)
        check(same, f"no-MLP densify min_keep {min_keep}: masks differ")
        check(zero and bool(written.any()),
              f"no-MLP densify min_keep {min_keep}: moments or children")

    # (d) short solves through solve() at full width; only timesteps cut.
    # 2-D Burgers, the committed recipe: IC fit + 3 steps against the FD
    # solution from the rendered t=0 field.
    traj, out["counts"]["no_mlp_burgers_2d"], secs, n_it = no_mlp_solve(
        "2-D Burgers", cfg, 4, dev, mk, ak, densify_every)
    res = 64
    xs = grid_samples(res, 2, cfg.scale, device=dev)
    with torch.no_grad():
        fields = torch.stack([eval_mixture(
            *nm.concrete(cfg, s["params"]), xs, order=0,
            mask=s["active"]).u.reshape(res, res) for s in traj])
    gt = solve_fd_2d(fields[0], cfg.scale, cfg.dt, len(traj) - 1,
                     problem="burgers", nu=cfg.nu)
    rel2 = [rel_err(a, b) for a, b in zip(fields, gt)]
    counts2 = [int(s["active"].sum()) for s in traj]
    print(f"[no-mlp] 2-D Burgers per-step rel-L2 vs the port's FD: "
          + " ".join(f"{v:.4f}" for v in rel2) + f" (committed JAX run: "
          f"0.0021 0.0029 0.0044); active {counts2}; {n_it / secs:.1f} "
          f"iterations/s ({card})", flush=True)
    check(bool(torch.isfinite(fields).all()), "2-D Burgers fields not finite")
    check(max(rel2[1:]) <= NO_MLP_2D_STEP_TOL,
          f"2-D Burgers steps 1-3 rel-L2 {max(rel2[1:]):.4f} > "
          f"{NO_MLP_2D_STEP_TOL}")
    check(counts2 == [400] * len(traj), f"2-D Burgers active {counts2}")
    out.update(burgers_2d_rel_l2=rel2, burgers_2d_s=secs,
               burgers_2d_iters=n_it)
    state_2d = traj[0]

    # 1-D Burgers, solve_no_mlp.py's defaults: IC fit + 3 steps against
    # the FD solution from exp(-2 x^2) on 201 points.  The draws are kept,
    # so that the diagnostics below see the IC fit's last samples.
    cfg1 = nm.NoMLPConfig(problem=Problem.BURGERS, d=1)
    kept, block_draws = [], nm.block_draws
    nm.block_draws = lambda *a, **kw: kept.append(block_draws(*a, **kw)) \
        or kept[-1]
    try:
        traj1, out["counts"]["no_mlp_burgers_1d"], secs1, n_it1 = \
            no_mlp_solve("1-D Burgers", cfg1, 4, dev, mk, ak)
    finally:
        nm.block_draws = block_draws
    x1 = (torch.linspace(-1, 1, 201, device=dev) * cfg1.scale).reshape(-1, 1)
    gt1 = solve_fd_1d(torch.exp(-2.0 * x1[:, 0] ** 2), cfg1.scale, cfg1.dt, 3,
                      problem="burgers", nu=cfg1.nu)
    with torch.no_grad():
        rel1 = [rel_err(eval_mixture(*nm.concrete(cfg1, s["params"]), x1,
                                     order=0, mask=s["active"]).u[:, 0], g)
                for s, g in zip(traj1, gt1)]
    print(f"[no-mlp] 1-D Burgers per-step rel-L2 vs the port's FD: "
          + " ".join(f"{v:.4f}" for v in rel1) + " (BENCHMARKS.md, JAX: "
          "0.0023 0.0053 0.0043 for steps 1-3)", flush=True)
    check(rel1[0] < NO_MLP_1D_IC_TOL,
          f"1-D IC fit rel-L2 {rel1[0]:.4f} >= {NO_MLP_1D_IC_TOL}")
    check(max(rel1[1:]) <= NO_MLP_1D_STEP_TOL,
          f"1-D steps 1-3 rel-L2 {max(rel1[1:]):.4f} > {NO_MLP_1D_STEP_TOL}")
    out.update(burgers_1d_rel_l2=rel1, burgers_1d_s=secs1)
    ic_draws = kept[traj1[0]["iters"] // cfg1.block_iters - 1]
    out["ic_1d"] = one_d_diagnostics(cfg1, traj1[0], ic_draws, x1, dev, mk,
                                     gen=torch.Generator().manual_seed(13))
    out["errs"] += out["ic_1d"]["errs"]
    out["berrs"] += out["ic_1d"]["berrs"]

    # 2-D WAVE, the committed wave recipe: IC fit + 1 step, finite, no K3.
    cfgw = cfg._replace(problem=Problem.WAVE, dt=0.01, n_samples=2048,
                        active_sampling=0.5)
    trajw, out["counts"]["no_mlp_wave_2d"], secsw, _ = no_mlp_solve(
        "2-D WAVE (active_sampling 0.5)", cfgw, 2, dev, mk, ak,
        densify_every)
    with torch.no_grad():
        wf = torch.stack([eval_mixture(*nm.concrete(cfgw, s["params"]), xs,
                                       order=0, mask=s["active"]).u
                          for s in trajw])
    check(bool(torch.isfinite(wf).all()), "2-D WAVE fields not finite")
    out["wave_2d_s"] = secsw

    # (a) K1 and K2 at every no-MLP shape: the twin and the f64 oracle,
    # bitwise determinism, then timed as in phase 8.
    gen = torch.Generator().manual_seed(12)
    samples = (torch.tensor(data["draws_base"][0], device=dev) * 2.0
               - 1.0) * cfg.scale
    start = no_mlp_params_from_jax(arr("start"), device=dev)
    wave = trajw[0]
    wdraws = nm.block_draws(cfgw, torch.Generator(device=dev).manual_seed(1),
                            wave["active"], False)
    wsamples = nm.draw_samples(cfgw, wdraws.base[0], wave["params"],
                               wdraws.idx[0], wdraws.z[0])
    s1 = traj1[1]
    m1, c1, v1 = nm.concrete(cfg1, s1["params"])
    x128 = (torch.rand((128, 1), generator=gen) * 2.0 - 1.0).to(dev) * 2.5
    e_means, e_conics, e_x128 = embed_d1(m1, c1, x128)
    with torch.no_grad():
        sm, sc, sv = nm.concrete(cfg, start)
        im, ic_, iv = nm.concrete(cfg, state_2d["params"])
        wm, wc, wv = nm.concrete(cfgw, wave["params"])
    act2 = torch.tensor(data["start_active"], device=dev)
    n = cfg.capacity
    shapes = {
        f"no-MLP 1024x{n} order 2 (dynamics; 2 K1, 1 K2 an iteration)":
            (sm, sc, sv, samples, 2, act2, True),
        f"no-MLP 1024x{n} order 0 (IC fit; 1 K1, 1 K2 an iteration)":
            (im, ic_, iv, samples, 0, state_2d["active"], True),
        f"no-MLP {xs.shape[0]}x{n} order 0 (64x64 render)":
            (sm, sc, sv, xs, 0, act2, False),
        f"no-MLP WAVE 2048x{n} order 2 c=2 (dynamics, active sampling)":
            (wm, wc, wv, wsamples, 2, wave["active"], True),
        f"no-MLP 1-D 128x{n} order 2 (dynamics, embedded in d=2)":
            (e_means, e_conics, v1, e_x128, 2, s1["active"], True),
    }
    for label, (mu, con, val, smp, order, mask, grad) in shapes.items():
        with torch.inference_mode():
            out["errs"].append(compare_case(label, mu, con, val, smp, order,
                                            mask, None, mk))
            out["k1_times"][label] = time_k1(label, mu, con, val, smp, order,
                                             mask, None, mk, card)
        if not grad:
            continue
        out["berrs"].append(compare_backward(label, mu, con, val, smp, order,
                                             mask, None, mk, gen))
        if label.startswith("no-MLP 1-D"):   # and as the solver sends it
            out["berrs"].append(compare_backward(
                label + " (d=1)", m1, c1, v1, x128, order, s1["active"], None,
                mk, gen))
        with torch.inference_mode():
            packed = (mu.contiguous(), mk.pack_conics(con).contiguous(),
                      (val * mask.float()[:, None]).contiguous())
            out["k2_times"][label] = time_k23(
                label, packed, smp, order, mk, gen, card,
                with_k3=False)["mixture_bwd_gauss"]

    # (e) 5 dynamics iterations: time and profile.
    cfg5 = cfg._replace(block_iters=5)
    block = no_mlp_block_inputs(cfg, data, dev)
    out["block_ms"] = statistics.median(
        host_ms(lambda: nm._run_block(cfg, *block[:4], False, *block[4:]))
        for _ in range(3))
    print(f"[times] no-MLP block of {iters} dynamics iterations: "
          f"{out['block_ms']:.2f} ms ({out['block_ms'] / iters:.3f} ms an "
          f"iteration; median of 3, host clock with device syncs; {card})",
          flush=True)
    five = no_mlp_block_inputs(cfg5, data, dev, iters=5)
    out["profile"] = profile_ms(
        lambda: nm._run_block(cfg5, *five[:4], False, *five[4:]), 5,
        "no-MLP dynamics iterations", card)
    return out


def fit_block_inputs(cfg, data, dev, iters=None):
    """The fit fixture's curl-fit block on ``dev``: ``(params, opt_state,
    active, draws, target)`` in float32, ``iters`` of its draws (all by
    default)."""
    import torch

    from pigs_tpu_torch.convert import (fit_adam_arrays, fit_adam_from_optax,
                                        fit_params_from_jax, no_mlp_arrays)
    from pigs_tpu_torch.train import fit as tf
    kw = dict(device=dev, dtype=torch.float32)
    params = tf.RawParams(*(x.requires_grad_() for x in fit_params_from_jax(
        no_mlp_arrays(data, "start"), **kw)))
    opt = fit_adam_from_optax(fit_adam_arrays(data, "start_adam"), **kw)
    draws = torch.tensor(data["draws"][slice(None, iters)], **kw)
    target = tf.image_target(torch.tensor(data["frame"], **kw))
    return (params, opt, torch.tensor(data["start_active"], device=dev),
            draws, target)


def fit_block_errors(cfg, data, dev) -> dict:
    """Run the fit fixture's curl-fit block in float32 on ``dev``; its
    errors against the JAX float64 block (norm-relative; the largest over
    the fields or the four Adams)."""
    import torch

    from pigs_tpu_torch.convert import fit_adam_arrays, no_mlp_arrays
    from pigs_tpu_torch.train import fit as tf
    params, opt, active, draws, target = fit_block_inputs(cfg, data, dev)
    params, opt, loss, grad = tf._fit_block(cfg, target, params, opt, active,
                                            draws)
    groups = fit_adam_arrays(data, "block_adam")
    check(all(int(s.count) == int(c) for s, (_, _, c) in zip(opt, groups)),
          f"fit block Adam counts {[int(s.count) for s in opt]}")
    return {"loss": abs(loss.item() - float(data["block_loss"]))
            / abs(float(data["block_loss"])),
            "params": max(rel_err(a.detach().cpu(), torch.tensor(b))
                          for a, b in zip(params, no_mlp_arrays(data, "block"))),
            "mu": max(rel_err(s.mu[0].cpu(), torch.tensor(m))
                      for s, (m, _, _) in zip(opt, groups)),
            "nu": max(rel_err(s.nu[0].cpu(), torch.tensor(n))
                      for s, (_, n, _) in zip(opt, groups)),
            "last_grad": rel_err(grad.cpu(),
                                 torch.tensor(data["block_last_grad"]))}


def fit_split_check(cfg, data, dev) -> tuple:
    """``_eig_split`` on the fixture's full-width state in float32 on
    ``dev``: (masks equal JAX's, the fresh rows' moments all zero, the
    number of children)."""
    import torch

    from pigs_tpu_torch.convert import (fit_adam_arrays, fit_adam_from_optax,
                                        fit_params_from_jax, no_mlp_arrays)
    from pigs_tpu_torch.train import fit as tf
    kw = dict(device=dev, dtype=torch.float32)
    active = torch.tensor(data["split_in_active"], device=dev)
    params = fit_params_from_jax(no_mlp_arrays(data, "split_in"), **kw)
    _, opt, new = tf._eig_split(
        cfg, params, fit_adam_from_optax(fit_adam_arrays(data, "split_in_adam"),
                                         **kw), active,
        torch.tensor(data["split_in_last_grad"], **kw))
    keep = ((torch.linalg.vector_norm(params.values, dim=-1) > 0.01)
            & (torch.exp(params.raw_scaling).sum(-1) < 0.2) & active)
    fresh = (new & ~keep) | (active & ~keep)
    same = bool((new.cpu().numpy() == data["split_active"]).all())
    zero = all(bool((m[0][fresh] == 0).all()) for s in opt
               for m in (s.mu, s.nu))
    return same, zero, int(new.sum() - keep.sum())


def load_script(name: str):
    """A script of ``scripts/`` as a module (its ``main`` not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def ns_data_phase(dev, mk, ak, card, ns) -> dict:
    """Phase 13: the NS data pipeline and the fit-to-target initializer on
    the card (see the module docstring); ``ns`` is phase 9's result (the NS
    config and EMA network)."""
    import numpy as np
    import torch

    from pigs_tpu_torch.convert import load_fit_fixture
    from pigs_tpu_torch.native import NpyFile, get_lib
    from pigs_tpu_torch.train import fit as tf
    from pigs_tpu_torch.train.ns_data import (fit_config, fit_fno_trajectory,
                                              generate_fno, load_fno)
    from pigs_tpu_torch.train.pn import (NSDataset, rollout_metrics,
                                         rollout_vorticity)
    from pigs_tpu_torch.utils.sampling import image_samples
    cfg, split_cfg, data = load_fit_fixture(FIT_FIXTURE)
    out = {"counts": {}, "k1_times": {}, "k2_times": {}, "errs": [],
           "berrs": []}
    os.makedirs(SCRATCH, exist_ok=True)
    with np.load(NS_DATA) as z:
        committed = z["frames"]                   # (8, 64, 64, 51)

    # (a) the native reader.
    check(get_lib() is not None, "the native library (g++ build of "
          "pigs_tpu_torch/native/npy_loader.cc) does not load")
    small = os.path.join(SCRATCH, "fno_small.npy")
    raw = np.ascontiguousarray(committed[:3].transpose(3, 1, 2, 0))
    np.save(small, raw)
    f = NpyFile(small)
    native = f.native
    f.close()
    same = np.array_equal(load_fno(small), np.transpose(raw, (3, 1, 2, 0)))
    print(f"[ns-data] native library loaded; NpyFile native: {native}; "
          f"load_fno of a {raw.shape} .npy equals np.load transposed: {same}",
          flush=True)
    check(native and same, "the native .npy reader")

    # (b) regenerate the committed trajectories from JAX's draws.
    fno = os.path.join(SCRATCH, "ns_fno.npy")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generate_fno(fno, n_traj=8, res=64, steps=50, dt=0.1, nu=1e-3, seed=1,
                 log_fn=lambda *_: None, device=dev,
                 noise=torch.tensor(data["noise"]))
    out["generate_s"] = time.perf_counter() - t0
    regen = load_fno(fno)                         # (8, 64, 64, 51)
    check(regen.shape == committed.shape, f"regenerated {regen.shape}")
    err = np.abs(regen - committed).max(axis=(1, 2))   # (8, 51)
    worst = np.unravel_index(int(np.argmax(err)), err.shape)
    out["regen_max_abs"] = float(err.max())
    print(f"[ns-data] generate_fno on JAX's draws: 8 trajectories x 51 "
          f"frames in {out['generate_s']:.2f} s; max abs vs "
          f"ns_data_8traj.npz {err.max():.3e} (trajectory {worst[0]}, frame "
          f"{worst[1]}; limit {NS_REGEN_TOL:.1e}), frames 0-3 "
          f"{err[:, :4].max():.3e}; {card}", flush=True)
    check(err.max() <= NS_REGEN_TOL,
          f"regenerated frames {err.max():.3e} > {NS_REGEN_TOL}")

    # (c) the fixture's curl-fit block against JAX float64, counted.
    iters = out["iters"] = cfg.block_iters
    reset_counts(mk, ak)
    errs = fit_block_errors(cfg, data, dev)
    torch.cuda.synchronize()
    counts = out["counts"]["fit_block"] = read_counts(mk, ak)
    want = (iters, iters, 0, 0, 0, 4 * iters)   # 4 Adams an iteration
    print(f"[ns-data] fixture curl-fit block ({iters} iterations, 1024 "
          f"samples x 400 Gaussians, order 1 c=2 periodic, float32 through "
          f"K1/K2) vs JAX float64: " + ", ".join(
              f"{k} {v:.3e} (tol {FIT_BLOCK_TOL[k]:.1e})"
              for k, v in errs.items())
          + f"; launches (K1-K6) {counts}, expected {want}", flush=True)
    check(counts == want, f"fit block launches {counts} != {want}")
    for k, e in errs.items():
        check(e <= FIT_BLOCK_TOL[k],
              f"fit block {k} vs JAX f64 {e:.3e} > {FIT_BLOCK_TOL[k]}")
    out["block_errs"] = errs

    # (d) _eig_split at full width.
    same, zero, children = fit_split_check(split_cfg, data, dev)
    print(f"[ns-data] _eig_split at capacity {split_cfg.capacity}: "
          f"{children} children; masks equal JAX's: {same}; fresh moments "
          f"zero: {zero}", flush=True)
    check(same and zero and children > 0, "fit _eig_split")

    # (e) the port's own curl fit of trajectory 7, then the NS rollout from
    # it.
    traj = int(data["config_traj"])
    full = fit_config()
    reset_counts(mk, ak)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    means, u, scaling, transforms, loss = fit_fno_trajectory(
        committed[traj, :, :, 0], nx=full.nx, iters=full.iters,
        seed=int(data["config_seed"]), device=dev)
    secs = out["fit_s"] = time.perf_counter() - t0
    counts = out["counts"]["port_fit"] = read_counts(mk, ak)
    want = (full.iters, full.iters, 0, 0, 0, 4 * full.iters)
    print(f"[ns-data] fit_fno_trajectory (trajectory {traj}, nx {full.nx}, "
          f"{full.iters} iterations, seed {int(data['config_seed'])}): final "
          f"block loss {loss:.6f}, {secs:.2f} s ({full.iters / secs:.1f} "
          f"iterations/s); launches (K1-K6) {counts}, expected {want}; "
          f"{card}", flush=True)
    check(counts == want, f"port fit launches {counts} != {want}")
    ds = NSDataset.load(NS_DATA, device=dev)
    fields = [x.clone() for x in ds[:4]]
    for field, new in zip(fields, (means, u, scaling, transforms)):
        field[traj] = torch.tensor(new, device=dev)
    ds = NSDataset(*fields, ds.frames)
    ncfg, network, fix = ns["cfg"], ns["network"], ns["fixture"]
    frames = rollout_vorticity(ncfg, network, ds.state_for(ncfg, traj),
                               ns["steps"], 64).cpu().numpy()
    gt = committed[traj].transpose(2, 0, 1)
    check(bool(np.isfinite(frames).all()), "port-fit rollout not finite")
    mean = rollout_metrics(frames, gt)["mean_rel_norm"]
    t0_err = rollout_metrics(frames[:1], gt[:1])["mean_rel_norm"]
    out.update(port_fit_t0_rel_l2=t0_err, port_fit_mean_rel_l2=mean,
               port_fit_loss=loss)
    lo, hi = PORT_FIT_BAND
    print(f"[ns-data] port fit: t=0 rel-L2 {t0_err:.4f} (limit "
          f"{FIT_T0_TOL}; the committed fit {float(fix['jax_t0_rel_l2']):.4f}"
          f"); NS rollout mean rel-L2 {mean:.6f} (band [{lo}, {hi}]; the "
          f"committed fit {float(fix['jax_mean_rel_l2']):.6f})", flush=True)
    check(t0_err <= FIT_T0_TOL, f"port fit t=0 rel-L2 {t0_err:.4f}")
    check(lo <= mean <= hi, f"port-fit rollout mean rel-L2 {mean:.6f} "
          f"outside [{lo}, {hi}]")

    # initialize_torch.py's gaussian mode at full width, a few blocks.
    init_out = os.path.join(SCRATCH, "initialize")
    init = tf.FitConfig(iters=INIT_SMOKE_ITERS)
    reset_counts(mk, ak)
    t0 = time.perf_counter()
    load_script("initialize_torch").main(
        ["gaussian", "--iters", str(init.iters), "--out", init_out,
         "--device", str(dev)])
    torch.cuda.synchronize()
    out["initialize_s"] = time.perf_counter() - t0
    counts = out["counts"]["initialize"] = read_counts(mk, ak)
    want = (init.iters + 1, init.iters, 0, 0, 0, 4 * init.iters)
    with np.load(os.path.join(init_out, "fit.npz")) as z:
        res = {k: z[k] for k in z.files}
    losses = res["losses"]
    print(f"[ns-data] initialize_torch.py gaussian, {init.iters} iterations "
          f"at capacity {init.capacity}: block losses "
          + " ".join(f"{x:.3e}" for x in losses)
          + f", {int(res['active'].sum())} active, {out['initialize_s']:.2f} "
          f"s; launches (K1-K6) {counts}, expected {want} (the last K1 the "
          f"128x128 render)", flush=True)
    check(counts == want, f"initialize launches {counts} != {want}")
    check(bool(np.isfinite(losses).all() and np.isfinite(res["render"]).all())
          and all(b < a for a, b in zip(losses, losses[1:])),
          f"initialize losses {losses}")

    # (f) K1/K2 at the slice's shapes: the twin and the f64 oracle, bitwise
    # determinism, then timed as in phase 8.
    gen = torch.Generator().manual_seed(13)
    kw = dict(device=dev, dtype=torch.float32)
    fc = tf.FitConfig(d=2, curl=True, periodic=True, tanh_means=False)
    port = tf.RawParams(torch.tensor(means, **kw), torch.tensor(u, **kw),
                        torch.log(torch.tensor(scaling, **kw)),
                        torch.tensor(transforms, **kw))
    init_params = tf.RawParams(*(torch.tensor(res[k], **kw) for k in (
        "raw_means", "values", "raw_scaling", "transforms")))
    init_active = torch.tensor(res["active"], device=dev)
    with torch.no_grad():
        cm, cc, cv = tf._concrete(fc, port)
        im, ic, iv = tf._concrete(init, init_params)
    smp = torch.tensor(data["draws"][0], **kw) * 2.0 - 1.0
    n_fit, n_init = cm.shape[0], im.shape[0]
    render = image_samples(128, device=dev)
    shapes = {
        f"curl fit 1024x{n_fit} order 1 c=2 periodic (1 K1, 1 K2 an "
        f"iteration)": (cm, cc, cv, smp, 1, torch.ones(n_fit, dtype=torch.bool,
                                                       device=dev), 2.0, True),
        f"initialize 1024x{n_init} order 0, {int(init_active.sum())} active "
        f"(1 K1, 1 K2 an iteration)": (im, ic, iv, smp, 0, init_active, None,
                                        True),
        f"initialize render {render.shape[0]}x{n_init} order 0":
            (im, ic, iv, render, 0, init_active, None, False),
    }
    for label, (mu, con, val, x, order, mask, period, grad) in shapes.items():
        with torch.inference_mode():
            out["errs"].append(compare_case(label, mu, con, val, x, order,
                                            mask, period, mk))
            out["k1_times"][label] = time_k1(label, mu, con, val, x, order,
                                             mask, period, mk, card)
        if not grad:
            continue
        out["berrs"].append(compare_backward(label, mu, con, val, x, order,
                                             mask, period, mk, gen))
        with torch.inference_mode():
            packed = (mu.contiguous(), mk.pack_conics(con).contiguous(),
                      (val * mask.float()[:, None]).contiguous())
            out["k2_times"][label] = time_k23(
                label, packed, x, order, mk, gen, card, period=period,
                with_k3=False)["mixture_bwd_gauss"]

    # (g) 5 curl-fit iterations: a profile.
    five = fit_block_inputs(cfg, data, dev, iters=5)
    tf._fit_block(cfg, *five[4:], *five[:3], five[3])
    five = fit_block_inputs(cfg, data, dev, iters=5)
    out["profile"] = profile_ms(
        lambda: tf._fit_block(cfg, five[4], *five[:3], five[3]), 5,
        "curl-fit iterations", card)
    print(f"[times] curl fit of {full.iters} iterations: {out['fit_s']:.2f} "
          f"s, {full.iters / out['fit_s']:.1f} iterations/s "
          f"({1e3 * out['fit_s'] / full.iters:.3f} ms an iteration, host "
          f"clock, one sync a block; {card})", flush=True)
    return out


def double_backward(means, conics, values, samples, order, mask, impl,
                    diff_samples, counts=None, mk=None, ak=None):
    """Second-order gradients through eval_mixture, the JAX package's
    outer/inner loss (tests/test_pallas_mixture.py:197-207): inner
    sum(u^2) + sum(f^2) with f the field of ``order``; outer the sum of
    squares of its first-order gradients (the conic one symmetrized).
    Returns the gradients of the outer loss with respect to means, conics,
    values (and samples with ``diff_samples``); with ``counts`` a list,
    appends the launch counts after the inner gradient and after the outer
    one (the counters are reset first)."""
    import torch

    from pigs_tpu_torch.ops.mixture import eval_mixture
    tin = [means.clone().requires_grad_(), conics.clone().requires_grad_(),
           values.clone().requires_grad_(),
           samples.clone().requires_grad_(diff_samples)]
    wrt = tin if diff_samples else tin[:3]
    if counts is not None:
        reset_counts(mk, ak)
    out = eval_mixture(*tin, order=order, mask=mask, impl=impl)
    inner = (out.u ** 2).sum() + (out[order] ** 2).sum()
    g = list(torch.autograd.grad(inner, wrt, create_graph=True))
    if counts is not None:
        torch.cuda.synchronize()
        counts.append(read_counts(mk, ak))
    g[1] = sym(g[1])
    outer = sum((x ** 2).sum() for x in g)
    gg = torch.autograd.grad(outer, wrt)
    if counts is not None:
        torch.cuda.synchronize()
        counts.append(read_counts(mk, ak))
    return gg


def first_order(means, conics, values, samples, order, mask, diff_samples):
    """The inner loss's first-order gradients through eval_mixture, as a
    training step asks for them."""
    import torch

    from pigs_tpu_torch.ops.mixture import eval_mixture
    tin = [means.clone().requires_grad_(), conics.clone().requires_grad_(),
           values.clone().requires_grad_(),
           samples.clone().requires_grad_(diff_samples)]
    out = eval_mixture(*tin, order=order, mask=mask)
    inner = (out.u ** 2).sum() + (out[order] ** 2).sum()
    return torch.autograd.grad(inner, tin if diff_samples else tin[:3])


def counted_validate(vpn, argv, pn, mk, ak):
    """Run scripts/validate_pn_torch.py's main on ``argv``, counted; returns
    ``(summary, launches (K1-K6), [steps of each epoch trained])``."""
    import torch
    steps, train_epoch = [], pn.train_epoch

    def recording(*a, **kw):
        result = train_epoch(*a, **kw)
        steps.append(int(result[3]))
        return result
    pn.train_epoch = recording
    try:
        reset_counts(mk, ak)
        summary = vpn.main(argv)
        torch.cuda.synchronize()
        return summary, read_counts(mk, ak), steps
    finally:
        pn.train_epoch = train_epoch


# validate_pn.py's summary keys (scripts/validate_pn.py:159-247) by problem.
VALIDATE_KEYS = {"problem", "epochs", "capacity", "train_s", "evo_time_s",
                 "rollout_split", "dt", "n_samples", "ema_decay",
                 "wave_psi_scale", "final_loss"}
VALIDATE_SCORE_KEYS = {
    "burgers": {"mean_rel_norm", "per_step_rel_norm"},
    "diffusion": {"mean_rel_norm", "per_step_rel_norm"},
    "wave": {"mean_rel_norm", "per_step_rel_norm", "mean_rel_norm_psi",
             "per_step_rel_norm_psi"},
    "poisson": {"mean_rel_norm", "per_step_rel_norm", "mean_rel_norm_t_end",
                "per_step_rel_norm_t_end"},
    "test": {"mean_abs_dy_minus_u_over_5", "per_step_dy_err",
             "mean_y_trajectory", "mean_u_trajectory"}}
FLAGSHIP_FLAGS = ["--dt", "0.1", "--loss-weight-floor", "0.05", "--lr", "3e-4",
                  "--lr-min", "2e-5", "--train-timesteps", "50",
                  "--n-samples", "4096", "--ema-decay", "0.999",
                  "--clip-norm", "1.0", "--skip-nonfinite"]
SECOND_ORDER_TOL = 2e-4     # tests/test_pallas_mixture.py's scaled bound
FD_FRAMES_TOL = 1e-3        # the FD frames from the card's rendered t=0 field
# Phase 14c's per-problem flags: the committed runs' dt (results_burgers_
# dt01, results_diffusion_dt001, results_wave_r5_psiscale, results_poisson_
# dt001, results_test); at validate_pn.py's default dt of 1.0 the explicit
# FD ground truth of diffusion and wave blows up.
SHORT_FLAGS = {"burgers": ["--dt", "0.1"], "diffusion": ["--dt", "0.01"],
               "wave": ["--dt", "0.01", "--wave-psi-scale", "30"],
               "poisson": ["--dt", "0.01"], "test": []}
SHORT_EPOCHS = 2            # phase 14c: epochs from scratch per problem
SHORT_STEPS = 10            # phase 14c: rollout steps


def second_order_cases(ti, dev) -> dict:
    """Phase 14a's inputs: label -> (means, conics, values, samples, order,
    mask, samples differentiated)."""
    import torch

    from pigs_tpu_torch.models.state import covariance_of
    gen = torch.Generator().manual_seed(14)
    ti.reset()
    st = ti.state
    _, conics = covariance_of(st)
    wide = (torch.rand((16384, 2), generator=gen) * 2.0 - 1.0).to(dev)
    (rm, rc, rv, rs), rmask = random_mixture(gen, 1024, 1024, 1, 2, dev)
    return {
        "4096x1664 order 2 (collocation)":
            (st.means, conics, st.u, ti.samples, 2, st.interior, False),
        "16384x1664 order 1 (chunked)":
            (st.means, conics, st.u, wide, 1, st.interior, False),
        "1024x1024 order 2, samples differentiated":
            (rm, rc, rv, rs, 2, rmask, True),
    }


def validate_phase(dev, mk, ak, card, ti, data) -> dict:
    """Phase 14: the mixture's double backward, scripts/validate_pn_torch.py
    and the dt=0.1 checkpoint on the card (see the module docstring).
    ``ti`` is phase 3's TrainInputs, ``data`` the rollout fixture's
    arrays."""
    import numpy as np
    import torch

    from pigs_tpu_torch.train import pn
    out = {"counts": {}, "second_order": {}}

    # (a) the double backward at three shapes against the float64 oracle.
    chunks, double_vjp = [], mk._double_vjp
    mk._double_vjp = lambda p, *a: chunks.append(p[3].shape[0]) or \
        double_vjp(p, *a)
    try:
        for label, (mu, con, val, smp, order, mask, ds) in \
                second_order_cases(ti, dev).items():
            m, n = smp.shape[0], mu.shape[0]
            chunks.clear()
            counts = []
            got = double_backward(mu, con, val, smp, order, mask, "auto", ds,
                                  counts, mk, ak)
            seen = list(chunks)
            want = double_backward(mu.double(), con.double(), val.double(),
                                   smp.double(), order, mask, "plain", ds)
            k3 = 1 if ds else 0
            expect = [(1, 1, k3, 0, 0, 0), (1, 2, 2 * k3, 0, 0, 0)]
            errs = []
            for name, a, b in zip(("means", "conics", "values", "samples"),
                                  got, want):
                check(bool(torch.isfinite(a).all()),
                      f"{label}: second-order {name} not finite")
                if name == "conics":
                    a, b = sym(a), sym(b)
                errs.append((a.double() - b).abs().max().item()
                            / max(1.0, b.abs().max().item()))
            per_chunk = max(mk.SECOND_ORDER_PAIR_BUDGET // n, 1)
            want_chunks = ([m] if m * n <= mk.SECOND_ORDER_PAIR_BUDGET else
                           [min(per_chunk, m - i)
                            for i in range(0, m, per_chunk)])
            first_ms = statistics.median(host_ms(lambda: first_order(
                mu, con, val, smp, order, mask, ds)) for _ in range(3))
            torch.cuda.reset_peak_memory_stats(dev)
            second_ms = statistics.median(host_ms(lambda: double_backward(
                mu, con, val, smp, order, mask, "auto", ds)) for _ in range(3))
            peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            print(f"[validate] double backward {label}: {m * n / 1e6:.1f} M "
                  f"pairs in {len(seen)} chunk(s) of {seen[0]} rows; "
                  f"scaled max err vs the f64 oracle (means, conics, values"
                  f"{', samples' if ds else ''}) "
                  + " ".join(f"{e:.2e}" for e in errs)
                  + f" (tol {SECOND_ORDER_TOL:.0e}); launches (K1-K6) after "
                  f"the inner gradient {counts[0]}, after the outer "
                  f"{counts[1]}; first order {first_ms:.2f} ms, second order "
                  f"{second_ms:.2f} ms (median of 3 calls, forward included, "
                  f"host clock with device syncs), peak memory "
                  f"{peak:.2f} GiB; {card}", flush=True)
            check(max(errs) <= SECOND_ORDER_TOL,
                  f"{label}: second order vs f64 {max(errs):.3e}")
            check(counts == expect,
                  f"{label}: launches {counts}, expected {expect}")
            check(seen == want_chunks,
                  f"{label}: chunks {seen}, expected {want_chunks}")
            out["second_order"][label] = {
                "max_scaled_err": max(errs), "chunks": len(want_chunks),
                "first_order_ms": first_ms, "second_order_ms": second_ms,
                "peak_gib": peak}
            out["counts"][f"double_backward {label}"] = counts[1]
    finally:
        mk._double_vjp = double_vjp

    # (b) validate_pn_torch on the flagship training fixture: the EMA at the
    # fixture's epoch, then three resumed epochs.  Each rollout() runs its
    # 50 steps twice (warm-up, then timed), 2 K1 a step; a resumed epoch in
    # the split regime launches 2 + 8 K1, 2 K2 and 1 K6 a step (phase 6).
    vpn = load_script("validate_pn_torch")
    run_dir = os.path.join(SCRATCH, "validate_pn")
    shutil.rmtree(run_dir, ignore_errors=True)
    jax_mean = float(data["jax_mean_rel_l2"])
    for epochs in (30000, 30003):
        t0 = time.perf_counter()
        summary, counts, steps = counted_validate(
            vpn, ["--epochs", str(epochs), *FLAGSHIP_FLAGS,
                  "--resume-fixture", TRAIN_FIXTURE, "--out", run_dir], pn,
            mk, ak)
        secs = time.perf_counter() - t0
        want = (sum(2 + 8 * n for n in steps) + 200, 2 * sum(steps), 0, 0, 0,
                sum(steps))
        fd = np.load(os.path.join(run_dir, "fd_gt_frames.npy"))
        fd_err = float(np.abs(fd - data["fd_frames"]).max())
        print(f"[validate] validate_pn_torch, flagship recipe, --epochs "
              f"{epochs} from the training fixture: {len(steps)} epochs of "
              f"{steps} steps, mean rel-L2 vs its FD {summary['mean_rel_norm']:.6f}"
              f" (JAX-CPU {jax_mean:.6f}); its FD frames vs the fixture's max "
              f"abs {fd_err:.3e}; launches (K1-K6) {counts}, expected {want}; "
              f"{secs:.1f} s ({card})", flush=True)
        check(len(steps) == epochs - 30000, f"validate --epochs {epochs}: "
              f"{len(steps)} epochs trained")
        check(counts == want, f"validate --epochs {epochs}: launches "
              f"{counts} != {want}")
        check(abs(summary["mean_rel_norm"] - jax_mean) <= MEAN_REL_L2_TOL,
              f"validate --epochs {epochs}: mean rel-L2 "
              f"{summary['mean_rel_norm']:.6f} vs {jax_mean:.6f}")
        if epochs == 30000:
            check(fd_err <= FD_FRAMES_TOL,
                  f"validate FD frames vs the fixture's {fd_err:.3e}")
        out["counts"][f"validate_flagship_{epochs}"] = counts
        out[f"flagship_{epochs}_mean_rel_l2"] = summary["mean_rel_norm"]
        out[f"flagship_{epochs}_s"] = secs
    out["flagship_fd_max_abs"] = fd_err

    # (c) every problem from scratch at full width: nx 20, the default
    # capacity, its committed run's dt, SHORT_EPOCHS epochs (one step each this early in the
    # curriculum: 2 + 3 K1, 2 K2 but for TEST, whose loss reads no
    # mixture, and 1 K6), SHORT_STEPS rollout steps twice (2 K1 a step)
    # and, for TEST, the law's SHORT_STEPS forward steps (1 K1 each).
    for problem in SHORT_FLAGS:
        pdir = os.path.join(SCRATCH, f"validate_{problem}")
        shutil.rmtree(pdir, ignore_errors=True)
        t0 = time.perf_counter()
        summary, counts, steps = counted_validate(
            vpn, ["--problem", problem, *SHORT_FLAGS[problem], "--epochs",
                  str(SHORT_EPOCHS), "--rollout-steps", str(SHORT_STEPS),
                  "--out", pdir], pn, mk, ak)
        secs = time.perf_counter() - t0
        k2 = 0 if problem == "test" else 2
        want = (sum(2 + 3 * n for n in steps) + 4 * SHORT_STEPS
                + (SHORT_STEPS if problem == "test" else 0),
                k2 * sum(steps), 0, 0, 0, sum(steps))
        frames = np.load(os.path.join(pdir, "rollout_frames.npy"))
        with open(os.path.join(pdir, "summary.json")) as f:
            keys = set(json.load(f))
        scores = {k: summary[k] for k in VALIDATE_SCORE_KEYS[problem]
                  if not isinstance(summary[k], list)}
        print(f"[validate] validate_pn_torch --problem {problem} from "
              f"scratch (capacity {summary['capacity']}, {SHORT_EPOCHS} "
              f"epochs of {steps} steps, {SHORT_STEPS} rollout steps): "
              + ", ".join(f"{k} {v:.5f}" for k, v in scores.items())
              + f"; launches (K1-K6) {counts}, expected {want}; "
              f"{secs:.1f} s", flush=True)
        check(frames.shape[0] == SHORT_STEPS and
              bool(np.isfinite(frames).all()), f"{problem}: frames")
        check(all(bool(np.isfinite(summary[k]).all())
                  for k in VALIDATE_SCORE_KEYS[problem]),
              f"{problem}: scores {scores}")
        missing = (VALIDATE_KEYS | VALIDATE_SCORE_KEYS[problem]) - keys
        check(not missing, f"{problem}: summary.json lacks {missing}")
        check(counts == want, f"{problem}: launches {counts} != {want}")
        out["counts"][f"validate_{problem}"] = counts

    # (d) the dt=0.1 checkpoint's raw parameters, 50 steps through
    # scripts/rollout_torch.py (run twice: 2 x 50 steps of 2 K1).
    reset_counts(mk, ak)
    dt01 = load_script("rollout_torch").main(["--fixture", DT01_FIXTURE])
    torch.cuda.synchronize()
    counts = read_counts(mk, ak)
    print(f"[validate] dt=0.1 checkpoint (raw params), 50 steps: mean rel-L2 "
          f"{dt01['mean_rel_norm']:.6f} (JAX-CPU "
          f"{dt01['jax_mean_rel_norm']:.6f}); launches (K1-K6) {counts}",
          flush=True)
    check(counts == (200, 0, 0, 0, 0, 0), f"dt=0.1 rollout launches {counts}")
    check(abs(dt01["mean_rel_norm"] - dt01["jax_mean_rel_norm"])
          <= MEAN_REL_L2_TOL, f"dt=0.1 rollout {dt01['mean_rel_norm']:.6f}")
    out["counts"]["dt01_rollout"] = counts
    out["dt01_mean_rel_l2"] = dt01["mean_rel_norm"]
    return out


# ------------------------------------------------------------- phase 15 ----

SELECT_FIXTURE = os.path.join(ROOT, "artifacts", "select_split_torch.npz")
PARALLEL_RANKS = 2          # phase 15b: gloo ranks, all on cuda:0
PARALLEL_MESHES = ((2, 1), (1, 2))
DP_STEPS = 3                # phase 15b: data-parallel steps against one rank
DP_LOSS_TOL = 1e-6          # phase 15a: the DP step's loss vs pn_loss_grads'
PARALLEL_TIMEOUT_S = 300
SELECT_SCORE_TOL = MEAN_REL_L2_TOL  # phase 15d: vs the JAX-CPU scores


def field_loss(fields):
    return sum((f ** 2).sum() for f in fields if f is not None)


def parallel_inputs(ti):
    """Phase 15's mixture inputs at the flagship's training shape: the
    training fixture's state (1664 Gaussians, interior mask) at its 4096
    collocation samples, order 2."""
    from pigs_tpu_torch.models.state import covariance_of
    st = ti.state
    return (st.means, covariance_of(st)[1], st.u, ti.samples, st.interior,
            ti.cfg.period)


def parallel_mixture(fn, mesh, ti, mk, ak):
    """``fn`` (the sharded or ring evaluation) forward and backward of the
    local loss at phase 15's inputs, counted: (this rank's fields, the
    gradients of means, conics and values, launches K1-K6)."""
    import torch
    means, conics, values, samples, mask, period = parallel_inputs(ti)
    leaves = [x.detach().clone().requires_grad_()
              for x in (means, conics, values)]
    torch.cuda.synchronize()
    reset_counts(mk, ak)
    out = fn(mesh, *leaves, samples, order=2, mask=mask, period=period)
    grads = torch.autograd.grad(field_loss(out), leaves)
    torch.cuda.synchronize()
    return out, grads, read_counts(mk, ak)


def single_rank_mixture(ti):
    """``eval_mixture`` at phase 15's inputs: fields and gradients."""
    import torch

    from pigs_tpu_torch.ops.mixture import eval_mixture
    means, conics, values, samples, mask, period = parallel_inputs(ti)
    leaves = [x.detach().clone().requires_grad_()
              for x in (means, conics, values)]
    out = eval_mixture(*leaves, samples, order=2, mask=mask, period=period)
    grads = torch.autograd.grad(field_loss(out), leaves)
    return out, grads


def dp_steps(step, ti, mesh, n_steps, timer=None):
    """``n_steps`` of ``step`` from the fixture's checkpoint, the fields
    carried as the epoch carries them: per step (loss, flat parameters on
    the host, launches K1-K6)."""
    import torch

    from pigs_tpu_torch.ops import aggregate_kernel as ak
    from pigs_tpu_torch.ops import mixture_kernel as mk
    from pigs_tpu_torch.parallel.sharded import gather
    ti.reset()
    opt, state, prev = ti.opt, ti.state, ti.prev_fields(ti.cfg)
    lr = torch.full((), ti.base_lr, device=ti.device)
    out = []
    for i in range(n_steps):
        torch.cuda.synchronize()
        reset_counts(mk, ak)
        if timer is None:
            opt, state, curr, loss = step(opt, state, prev, ti.samples,
                                          ti.time_samples, ti.bc_samples, lr,
                                          i * ti.dt, ti.dt)
        else:
            with timer("dp_step", sync=list(ti.network.parameters())):
                opt, state, curr, loss = step(
                    opt, state, prev, ti.samples, ti.time_samples,
                    ti.bc_samples, lr, i * ti.dt, ti.dt)
        torch.cuda.synchronize()
        out.append((float(loss), ti.flat_params(), read_counts(mk, ak)))
        prev = gather(mesh, curr)
    return out


def flat_params0(ti):
    """The checkpoint's parameters, flat, float64, on the host."""
    import torch
    return torch.cat([p.flatten().double().cpu() for p in ti.params0])


def parallel_rank(rank, store, out_dir, device):
    """Phase 15b, one of PARALLEL_RANKS gloo ranks on ``device`` (all on
    the same card): the sharded
    and ring evaluation on each mesh of PARALLEL_MESHES against this
    process's own single-rank ``eval_mixture``, and DP_STEPS data-parallel
    steps on mesh (2, 1); the results go to ``out_dir/rank<r>.pt``."""
    sys.path.insert(0, ROOT)
    import torch
    import torch.distributed as dist

    from pigs_tpu_torch.ops import aggregate_kernel as ak
    from pigs_tpu_torch.ops import mixture_kernel as mk
    from pigs_tpu_torch.parallel import sharded
    from pigs_tpu_torch.parallel.launch import initialize_distributed
    from pigs_tpu_torch.parallel.mesh import make_mesh
    from pigs_tpu_torch.parallel.train import make_dp_train_step
    from pigs_tpu_torch.utils.profiling import Timer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    check(initialize_distributed(f"file://{store}", PARALLEL_RANKS, rank,
                                 backend="gloo", device=dev),
          "gloo group not joined")
    ti = TrainInputs(dev)
    ref_out, ref_grads = single_rank_mixture(ti)
    result = {"backend": dist.get_backend(), "mixture": {}}
    for shape in PARALLEL_MESHES:
        mesh = make_mesh(shape)
        for name in ("sharded", "ring"):
            fn = getattr(sharded, f"eval_mixture_{name}")
            before = sharded.ring_host_bytes
            out, grads, counts = parallel_mixture(fn, mesh, ti, mk, ak)
            full = sharded.gather(mesh, out)
            result["mixture"][(shape, name)] = {
                "field_errs": [rel_err(a, b) for a, b in
                               zip(full[:3], ref_out[:3])],
                "grad_errs": [rel_err(sym(a) if k == 1 else a,
                                      sym(b) if k == 1 else b)
                              for k, (a, b) in enumerate(zip(grads,
                                                             ref_grads))],
                "max_abs": max(float((a - b.detach()).abs().max())
                               for a, b in zip(full[:3], ref_out[:3])),
                "counts": counts,
                "host_bytes": sharded.ring_host_bytes - before}
    mesh = make_mesh((PARALLEL_RANKS, 1))
    step = make_dp_train_step(mesh, ti.cfg, ti.network)
    timer = Timer()
    result["dp"] = dp_steps(step, ti, mesh, DP_STEPS, timer)
    result["dp_step_ms"] = timer.means()["dp_step"] * 1e3
    dist.destroy_process_group()
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def spawn_parallel_ranks(card, dev) -> list:
    """Start PARALLEL_RANKS processes of :func:`parallel_rank` and return
    their results; a rank that fails or outlives PARALLEL_TIMEOUT_S fails
    the phase (every rank is stopped)."""
    import torch
    import torch.multiprocessing as mp
    out_dir = os.path.join(SCRATCH, "parallel")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    ctx = mp.start_processes(parallel_rank, args=(
        os.path.join(out_dir, "store"), out_dir, str(dev)),
        nprocs=PARALLEL_RANKS,
        join=False, start_method="spawn")
    deadline = time.monotonic() + PARALLEL_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            check(time.monotonic() < deadline, f"the {PARALLEL_RANKS} gloo "
                  f"ranks did not finish in {PARALLEL_TIMEOUT_S} s")
    except mp.ProcessRaisedException as e:
        raise SmokeFailure(f"a gloo rank failed: {e}")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    print(f"[parallel] {PARALLEL_RANKS} gloo ranks on {dev} ran in "
          f"{time.perf_counter() - t0:.1f} s (start-up included; {card})",
          flush=True)
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(PARALLEL_RANKS)]


def parallel_phase(dev, mk, ak, card, ti, pn_step_ms) -> dict:
    """Phase 15: the multi-process layer on the card (see the module
    docstring).  ``ti`` is phase 3's TrainInputs, ``pn_step_ms`` phase 8's
    median pn_step time."""
    import glob

    import numpy as np
    import torch
    import torch.distributed as dist

    from pigs_tpu_torch.parallel import sharded
    from pigs_tpu_torch.parallel.launch import (host_summary,
                                                initialize_distributed)
    from pigs_tpu_torch.parallel.mesh import make_mesh
    from pigs_tpu_torch.parallel.train import make_dp_train_step
    from pigs_tpu_torch.train.optim import adam_update
    from pigs_tpu_torch.train.pn import pn_loss_grads
    from pigs_tpu_torch.utils.profiling import Timer, trace
    out = {"counts": {}, "parallel": {}}

    # (a) one NCCL rank on cuda:0.
    os.makedirs(SCRATCH, exist_ok=True)
    store = os.path.join(SCRATCH, f"nccl_store_{os.getpid()}")
    if os.path.exists(store):
        os.remove(store)
    check(initialize_distributed(f"file://{store}", 1, 0, device=dev),
          "NCCL group not joined")
    try:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        check(dist.get_backend() == backend, f"backend {dist.get_backend()}")
        mesh = make_mesh((1, 1))
        print(f"[parallel] {host_summary()}; backend {backend}, mesh "
              f"{tuple(mesh.shape)}", flush=True)
        ref_out, ref_grads = single_rank_mixture(ti)
        for name in ("sharded", "ring"):
            fn = getattr(sharded, f"eval_mixture_{name}")
            got, grads, counts = parallel_mixture(fn, mesh, ti, mk, ak)
            same = (all(torch.equal(a, b) for a, b in zip(got[:3],
                                                           ref_out[:3]))
                    and all(torch.equal(a, b) for a, b in zip(grads,
                                                               ref_grads)))
            print(f"[parallel] nccl 1x1 {name} 4096x1664 order 2: fields "
                  f"and gradients bitwise equal to eval_mixture's: {same}; "
                  f"launches (K1-K6) {counts}", flush=True)
            check(same, f"nccl 1x1 {name}: not bitwise equal to eval_mixture")
            check(counts == (1, 1, 0, 0, 0, 0),
                  f"nccl 1x1 {name} launches {counts}, expected "
                  "(1, 1, 0, 0, 0, 0)")
            out["counts"][f"parallel_{name}"] = counts

        # The DP step against pn_loss_grads + adam_update at the same lr;
        # the reference twice, to tell a DP difference from the step's own.
        lr = torch.full((), ti.base_lr, device=dev)
        refs = []
        for _ in range(2):
            ti.reset()
            prev = ti.prev_fields(ti.cfg)
            torch.cuda.synchronize()
            reset_counts(mk, ak)
            _, _, _, total, grads = pn_loss_grads(
                ti.cfg, ti.network, ti.state, prev, ti.samples,
                ti.time_samples, ti.bc_samples, 0.0, ti.dt)
            adam_update(list(ti.network.parameters()), grads, ti.opt, lr)
            torch.cuda.synchronize()
            refs.append((float(total), ti.flat_params(),
                         read_counts(mk, ak)))
        step = make_dp_train_step(mesh, ti.cfg, ti.network)
        (loss, params, counts), = dp_steps(step, ti, mesh, 1)
        start = flat_params0(ti)
        loss_err = abs(loss - refs[0][0]) / abs(refs[0][0])
        bitwise = torch.equal(params, refs[0][1])
        ref_bitwise = torch.equal(refs[1][1], refs[0][1])
        update_err = rel_err(params - start, refs[0][1] - start)
        print(f"[parallel] nccl 1x1 DP step vs pn_loss_grads + adam_update: "
              f"loss rel err {loss_err:.2e}; parameters bitwise equal "
              f"{bitwise} (the reference against itself: {ref_bitwise}); "
              f"update norm-rel err {update_err:.2e}; launches (K1-K6) "
              f"{counts}, pn_loss_grads' {refs[0][2]}", flush=True)
        check(loss_err <= DP_LOSS_TOL, f"DP loss {loss_err:.3e}")
        check(bitwise or (not ref_bitwise and update_err <= STEP_UPDATE_TOL),
              f"DP step parameters differ from pn_step's ({update_err:.3e}) "
              "although the reference repeats bitwise")
        check(counts == refs[0][2] == (3, 2, 0, 0, 0, 1),
              f"DP step launches {counts}, pn_loss_grads' {refs[0][2]}")
        out["counts"]["parallel_dp_step"] = counts
        out["dp_bitwise"] = bitwise

        # (c) Timer and trace around the DP step.
        timer = Timer()
        steps = dp_steps(step, ti, mesh, 5, timer)
        out["dp_step_ms"] = timer.means()["dp_step"] * 1e3
        trace_dir = os.path.join(SCRATCH, "trace_dp_step")
        shutil.rmtree(trace_dir, ignore_errors=True)
        with trace(trace_dir):
            dp_steps(step, ti, mesh, 1)
        traces = glob.glob(os.path.join(trace_dir, "trace_*.json"))
        check(len(traces) == 1, f"trace wrote {traces}")
        with open(traces[0]) as f:
            names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                     if e.get("cat") == "kernel"}
        found = {family: sorted(n for n in names if any(s in n for s in ids))
                 for family, ids in KERNEL_FAMILIES.items()}
        print(f"[parallel] Timer: DP step {out['dp_step_ms']:.2f} ms (mean of "
              f"5, {timer.report()}) beside phase 8's pn_step "
              f"{pn_step_ms:.2f} ms; trace {os.path.basename(traces[0])} "
              f"names {sum(map(len, found.values()))} K1/K2/K6 kernels: "
              + "; ".join(f"{k}: {', '.join(v)[:120]}"
                          for k, v in found.items()) + f" ({card})",
              flush=True)
        check(found["mixture_fwd"] and found["mixture_bwd_gauss"],
              f"trace names no K1 or K2 kernel: {found}")
        check(all(s[2] == (3, 2, 0, 0, 0, 1) for s in steps),
              "timed DP step launches")
        # The single-rank reference of (b): the same DP_STEPS steps.
        single = dp_steps(step, ti, mesh, DP_STEPS)
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)
    ti.reset()

    # (b) PARALLEL_RANKS gloo ranks on cuda:0.
    ranks = spawn_parallel_ranks(card, dev)
    max_abs = 0.0
    for r, res in enumerate(ranks):
        check(res["backend"] == "gloo", f"rank {r} backend {res['backend']}")
        for (shape, name), m in res["mixture"].items():
            model = shape[1]
            want = ((1, 1, 0, 0, 0, 0) if name == "sharded" else
                    (model, model, 0, 0, 0, 0))
            label = f"gloo rank {r} mesh {shape} {name}"
            print(f"[parallel] {label}: fields rel err "
                  + " ".join(f"{e:.2e}" for e in m["field_errs"])
                  + "; grads (means, conics, values) "
                  + " ".join(f"{e:.2e}" for e in m["grad_errs"])
                  + f"; launches (K1-K6) {m['counts']}; {m['host_bytes']} "
                  "bytes round the ring through host memory", flush=True)
            check(max(m["field_errs"]) <= KERNEL_F32_TOL,
                  f"{label} fields {max(m['field_errs']):.3e}")
            check(max(m["grad_errs"]) <= KERNEL_F64_TOL,
                  f"{label} grads {max(m['grad_errs']):.3e}")
            check(m["counts"] == want, f"{label} launches {m['counts']}")
            check(m["host_bytes"] > 0 if name == "ring" and model > 1
                  else m["host_bytes"] == 0, f"{label} host bytes")
            out["parallel"][f"gloo_{shape[0]}x{shape[1]}_{name}_rank{r}"] = \
                m["counts"]
            max_abs = max(max_abs, m["max_abs"])
    start = flat_params0(ti)
    for i in range(DP_STEPS):
        loss0, params0, _ = ranks[0]["dp"][i]
        loss_s, params_s, _ = single[i]
        loss_err = abs(loss0 - loss_s) / abs(loss_s)
        update_err = rel_err(params0 - start, params_s - start)
        equal = all(torch.equal(res["dp"][i][1], params0) for res in ranks)
        counts = [res["dp"][i][2] for res in ranks]
        print(f"[parallel] gloo 2x1 DP step {i}: loss rel err vs one rank "
              f"{loss_err:.2e}, update norm-rel err {update_err:.2e}; ranks' "
              f"parameters bitwise equal: {equal}; launches per rank "
              f"{counts}", flush=True)
        check(loss_err <= STEP_LOSS_TOL, f"DP step {i} loss {loss_err:.3e}")
        check(update_err <= STEP_UPDATE_TOL,
              f"DP step {i} update {update_err:.3e}")
        check(equal, f"DP step {i}: the ranks' parameters differ")
        check(all(c == (3, 2, 0, 0, 0, 1) for c in counts),
              f"DP step {i} launches {counts}")
    for r, res in enumerate(ranks):
        out["parallel"][f"gloo_2x1_dp_step_rank{r}"] = res["dp"][0][2]
    out["gloo_dp_step_ms"] = [res["dp_step_ms"] for res in ranks]
    print(f"[parallel] harness check, not a scaling figure: a DP step of "
          f"{PARALLEL_RANKS} gloo ranks sharing cuda:0 took "
          + ", ".join(f"{t:.2f}" for t in out["gloo_dp_step_ms"])
          + f" ms per rank (Timer mean of {DP_STEPS}; {card})", flush=True)
    out["max_abs"] = max_abs

    # (d) select_split_stop_torch at one held-out IC of JAX's draws.
    with np.load(SELECT_FIXTURE) as z:
        stops, steps = z["smoke_stops"].tolist(), int(z["smoke_steps"])
        selection, evaluation = z["smoke_selection"], z["smoke_eval"]
    with np.load(DT01_FIXTURE) as z:
        parity = float(z["jax_mean_rel_l2"])
    reset_counts(mk, ak)
    t0 = time.perf_counter()
    summary = load_script("select_split_stop_torch").main([
        "--fixture", DT01_FIXTURE, "--ic-fixture", SELECT_FIXTURE, "--n-select", "1", "--stops",
        ",".join(map(str, stops)), "--rollout-steps", str(steps), "--out",
        os.path.join(SCRATCH, "select_split")])
    torch.cuda.synchronize()
    counts = read_counts(mk, ak)
    errs = [abs(summary["selection_mean_rel_l2"][str(s)] - selection[k])
            for k, s in enumerate(stops)] + [
        abs(summary["eval_mean_rel_l2"][str(s)] - evaluation[k])
        for k, s in enumerate(stops)]
    print(f"[parallel] select_split_stop_torch (1 held-out IC, stops {stops}, "
          f"{steps} steps) in {time.perf_counter() - t0:.1f} s: selection "
          + " ".join(f"{summary['selection_mean_rel_l2'][str(s)]:.6f}"
                     for s in stops)
          + " (JAX-CPU " + " ".join(f"{v:.6f}" for v in selection)
          + "), eval " + " ".join(f"{summary['eval_mean_rel_l2'][str(s)]:.6f}"
                                  for s in stops)
          + " (JAX-CPU " + " ".join(f"{v:.6f}" for v in evaluation)
          + f"); parity {summary['parity']:.6f} (JAX-CPU {parity:.6f}); "
          f"launches (K1-K6) {counts}", flush=True)
    check(max(errs) <= SELECT_SCORE_TOL,
          f"select_split scores off JAX-CPU's by {max(errs):.4f}")
    check(abs(summary["parity"] - parity) <= SELECT_SCORE_TOL,
          f"select_split parity {summary['parity']:.6f}")
    # Two trajectories (the held-out IC, the standard one) per stop, each
    # 2 K1 a step (render, forward_step) and 3 a densified step.
    want = (2 * sum(2 * steps + 3 * s for s in stops), 0, 0, 0, 0, 0)
    check(counts == want, f"select_split launches {counts}, expected {want}")
    out["select_split"] = {k: summary[k] for k in (
        "selection_mean_rel_l2", "eval_mean_rel_l2", "parity", "heldout_stop",
        "oracle_stop")}
    return out


def describe_times(times) -> str:
    return "; ".join(f"{impl} fwd {times[(impl, 'fwd')]:.4f} ms, fwd+bwd "
                     f"{times[(impl, 'bwd')]:.4f} ms"
                     for impl in ("kernel", "factored", "plain"))

# ------------------------------------------------------------ phase 16 ----


def adam_fixture(path, dev):
    """A training fixture's parameters (clones, on the card), JAX's
    gradient of its stored step in the network's order and layout, its
    Adam state as the checkpoint gives it (one tensor per parameter), the
    base learning rate and the clip norm."""
    import torch

    from pigs_tpu_torch.convert import load_train_fixture, params_from_flax
    _, network, opt, _, data = load_train_fixture(path, device=dev)
    names = [k for k, _ in network.named_parameters()]
    tree = params_from_flax({"params" + k[len("step_grads"):]: v
                             for k, v in data.items()
                             if k.startswith("step_grads/")})
    grads = [tree[k].to(device=dev, dtype=torch.float32).contiguous()
             for k in names]
    params = [p.detach().clone() for p in network.parameters()]
    return (params, grads, opt, float(data["train_base_lr"]),
            float(data["train_clip_norm"]))


def random_adam_case(gen, shapes, dev, count=7):
    """Parameters, gradients and a per-tensor Adam state of ``shapes``
    (normal draws; nu from squares, so it is positive)."""
    import torch

    from pigs_tpu_torch.train.optim import AdamState

    def draw(scale=1.0):
        return [(scale * torch.randn(sh, generator=gen)).to(dev)
                for sh in shapes]
    nu = [x * x for x in draw(1e-2)]
    return draw(), draw(1e-2), AdamState(
        draw(1e-3), nu, torch.tensor(count, dtype=torch.int32, device=dev))


def flat(ts):
    import torch
    return torch.cat([t.detach().reshape(-1).double().cpu() for t in ts])


def adam_case(label, params, grads, state, lr, clip, skip):
    """K6 from ``(params, grads, state)``, through ``adam_update``'s
    dispatch (the parameters cloned, nothing the caller holds changes),
    against its float32 twin and the float64 plain path: the errors, and
    K6's parameters and state.  Fails on a count or skip decision that
    differs, a call that did not launch K6 once, an old state that changed,
    or two launches that differ by a bit."""
    import torch

    from pigs_tpu_torch.ops import optim_kernel as ok
    from pigs_tpu_torch.train.optim import (AdamState, adam_update,
                                            adam_update_plain, global_norm)

    def clone(ts, dtype=None):
        return [t.detach().clone() if dtype is None else t.detach().to(dtype)
                for t in ts]

    def k6():
        p = clone(params)
        before = ok.launches
        new = adam_update(p, list(grads), state, lr, clip_norm=clip,
                          skip_nonfinite=skip)
        torch.cuda.synchronize()
        check(ok.launches == before + 1,
              f"K6 {label}: {ok.launches - before} launches counted")
        return p, new

    old = (flat(state.mu), flat(state.nu), int(state.count))
    p_k, s_k = k6()
    check(torch.equal(flat(state.mu), old[0]) and torch.equal(
        flat(state.nu), old[1]) and int(state.count) == old[2],
        f"K6 {label}: the old Adam state changed")
    p_k2, s_k2 = k6()
    check(torch.equal(flat(p_k), flat(p_k2))
          and torch.equal(s_k.mu.flat, s_k2.mu.flat)
          and torch.equal(s_k.nu.flat, s_k2.nu.flat)
          and int(s_k.count) == int(s_k2.count),
          f"K6 {label}: two launches on the same inputs differ")
    check([tuple(m.shape) for m in s_k.mu] == [tuple(p.shape) for p in params]
          and [tuple(v.shape) for v in s_k.nu]
          == [tuple(p.shape) for p in params],
          f"K6 {label}: the moments lost their parameters' shapes")

    p_t = clone(params)
    s_t = adam_update_plain(p_t, grads, state, lr, clip, skip)
    f64 = torch.float64
    p_d = clone(params, f64)
    s_d = adam_update_plain(
        p_d, clone(grads, f64), AdamState(clone(state.mu, f64),
                                          clone(state.nu, f64), state.count),
        lr.double() if isinstance(lr, torch.Tensor) else lr, clip, skip)
    torch.cuda.synchronize()
    counts = (int(s_k.count), int(s_t.count), int(s_d.count))
    check(len(set(counts)) == 1,
          f"K6 {label}: counts {counts} (K6, f32 twin, f64)")
    skipped = counts[0] == old[2]
    p0 = flat(params)
    err = {"label": label, "skipped": skipped,
           "norm": float(global_norm(grads))}
    if skipped:
        check(torch.equal(flat(p_k), p0) and torch.equal(
            s_k.mu.flat.cpu().double(), old[0])
            and torch.equal(s_k.nu.flat.cpu().double(), old[1]),
            f"K6 {label}: a skipped step changed the parameters or moments")
        return err, p_k, s_k
    # The float64 path's parameters are rounded to float32, as K6 stores
    # them: at lr 3e-4 on parameters of order 1 that rounding alone is
    # ~1e-3 of the change, in any float32 implementation.
    p_d = [p.float() for p in p_d]
    for tag, p_ref, s_ref, tol in (("f32", p_t, s_t, K6_F32_TOL),
                                   ("f64", p_d, s_d, K6_F64_TOL)):
        e = {"change": rel_err(flat(p_k) - p0, flat(p_ref) - p0),
             "mu": rel_err(flat(s_k.mu), flat(s_ref.mu)),
             "nu": rel_err(flat(s_k.nu), flat(s_ref.nu))}
        check(max(e.values()) <= tol,
              f"K6 {label}: norm-relative error vs the {tag} plain path "
              f"{e} (tolerance {tol})")
        err[tag] = e
    return err, p_k, s_k


def adam_bound(total: int) -> tuple:
    """(bound_ms, what bounds it) of one K6 launch over ``total``
    elements: per element the gradient, parameter and both moments read
    once, the parameter and both moments written once; 18 FLOP (norm 2,
    clip 2, moments 7, bias correction 2, the denominator and the update 5)
    and a square root."""
    return roofline(18 * total, total, 28 * total)


def optim_phase(dev, card, ptxas) -> dict:
    """Phase 16: K6 against its twins, then timed (see the module
    docstring).  ``ptxas`` is phase 1's report of the adam library."""
    import torch

    from pigs_tpu_torch.ops import optim_kernel as ok
    from pigs_tpu_torch.train.optim import (AdamState, adam_update,
                                            adam_update_plain)
    errs = []
    gen = torch.Generator().manual_seed(16)
    nets = {"flagship": adam_fixture(TRAIN_FIXTURE, dev),
            "NS": adam_fixture(NS_TRAIN_FIXTURE, dev)}
    for name, (params, grads, opt, base_lr, clip) in nets.items():
        total = sum(p.numel() for p in params)
        lr = torch.full((), base_lr, device=dev)
        norm = float(torch.linalg.vector_norm(flat(grads)))
        # (a) JAX's gradient scaled to put the clip on and off, from the
        # checkpoint's per-tensor state (moments transposed as flax lays
        # them out: copied to the parameters' layout first).
        for factor, tag in ((2.0, "clip active"), (0.5, "clip inactive")):
            g = [x * (factor * clip / norm) for x in grads]
            copies = ok.layout_copies
            e, p1, s1 = adam_case(f"{name} {total} {tag}", params, g, opt, lr,
                                  clip, True)
            e["layout_copies"] = ok.layout_copies - copies
            errs.append(e)
        # (b) from K6's own output state (the flat buffers read directly).
        copies = ok.layout_copies
        errs.append(adam_case(f"{name} from K6's state", p1, g, s1, lr,
                              clip, True)[0])
        check(ok.layout_copies == copies,
              f"K6 {name}: K6's own state was copied "
              f"({ok.layout_copies - copies})")
        # (c) one NaN, one inf: parameters, moments and count unchanged.
        for bad in (float("nan"), float("inf")):
            g = [x.clone() for x in grads]
            i = next(k for k in range(len(g) // 2, len(g))
                     if g[k].numel() > 3)
            g[i].view(-1)[3] = bad
            e = adam_case(f"{name} one {bad} gradient", params, g, opt, lr,
                          clip, True)[0]
            check(e["skipped"], f"K6 {name}: a {bad} gradient was applied")
            errs.append(e)
        # (d) a transposed gradient: one layout copy, the same bits.
        i = next(k for k, p in enumerate(params) if p.dim() == 2
                 and p.shape[0] != p.shape[1])
        g = list(grads)
        g[i] = grads[i].t().contiguous().t()
        st = AdamState(list(s1.mu), list(s1.nu), s1.count)
        _, p_c, s_c = adam_case(f"{name} contiguous", params, grads, st, lr,
                                clip, True)
        copies = ok.layout_copies
        e, p_t, s_t = adam_case(f"{name} transposed gradient {i}", params, g,
                                st, lr, clip, True)
        check(ok.layout_copies == copies + 2,   # adam_case launches twice
              f"K6 {name}: {ok.layout_copies - copies} layout copies for one "
              "transposed gradient over two launches")
        check(torch.equal(flat(p_t), flat(p_c))
              and torch.equal(s_t.mu.flat, s_c.mu.flat),
              f"K6 {name}: a transposed gradient changed the result")
        errs.append(e)
    # (e) the other callers' sizes: a no-MLP solve's raw parameters (2-D;
    # 1-D with its empty transforms), a fit's single tensor, the most
    # tensors a launch takes, and a total ten times the networks', where
    # each of the cluster's blocks strides over ~38 k elements.
    sizes = {"no-MLP 2-D 1024": [(1024, 2), (1024, 1), (1024, 2), (1024, 1)],
             "no-MLP 1-D 1024": [(1024, 1), (1024, 1), (1024, 1), (1024, 0)],
             "fit 1024x2": [(1024, 2)],
             f"{ok.MAX_TENSORS} tensors": [(int(n),) for n in torch.randint(
                 1, 700, (ok.MAX_TENSORS,), generator=gen)],
             "300k": [(512, 512), (40000,), (3,), (13, 517)]}
    for label, shapes in sizes.items():
        params, grads, state = random_adam_case(gen, shapes, dev)
        total = sum(p.numel() for p in params)
        # The plain path's skip test has no answer on an empty tensor; the
        # 1-D solve skips nothing.
        for clip, skip, lr in ((None, False, 1e-3), (1.0, True, 5e-3),
                               (0.01, True, torch.full((), 2e-3,
                                                       device=dev)))[
                                   :1 if "1-D" in label else 3]:
            errs.append(adam_case(f"{label} ({total}) clip {clip}", params,
                                  grads, state, lr, clip, skip)[0])
    for tag in ("f32", "f64"):
        worst = max(max(e[tag].values()) for e in errs if tag in e)
        print(f"[optim] K6 {len(errs)} cases pass; max norm-relative error "
              f"vs the {tag} plain path {worst:.3e}", flush=True)
    for e in errs:
        print(f"[optim] {json.dumps(e)}", flush=True)

    # Times at both networks, from the checkpoint's state in K6's layout.
    times = {}
    for name, (params, grads, opt, base_lr, clip) in nets.items():
        total = sum(p.numel() for p in params)
        lr = torch.full((), base_lr, device=dev)
        st = AdamState(*ok.adam_step(params, grads, opt.mu, opt.nu, opt.count,
                                     lr, clip, True, 0.9, 0.999, 1e-8))
        twin = [p.clone() for p in params]
        label = f"{name} {len(params)} tensors, {total} elements"

        def launch():
            return ok.adam_step(params, grads, st.mu, st.nu, st.count, lr,
                                clip, True, 0.9, 0.999, 1e-8)
        t = time_kernel(launch, lambda: adam_update(
            params, grads, st, lr, clip_norm=clip, skip_nonfinite=True),
            lambda: adam_update_plain(twin, grads, st, lr, clip, True))
        t["bound_ms"], t["bound_by"] = adam_bound(total)
        print(describe_kernel_times("adam", label, t, card), flush=True)
        times[label] = t
    for kernel, r in ptxas.items():
        print(f"[optim] ptxas: {kernel}: {r['registers']} registers, "
              f"{r['spill_stores']} + {r['spill_loads']} bytes spilled",
              flush=True)

    def col(key):
        return {label: v[key] for label, v in times.items()}
    row = {"name": "adam", "route": "cuda",
           "source": "pigs_tpu_torch/ops/csrc/adam.cu",
           "replaces": None,
           "replaces_note": "the JAX package's optax Adam (clip_by_global_"
                            "norm, adam), which XLA fuses: no Pallas kernel",
           "max_err": {tag: max(max(e[tag].values()) for e in errs
                                if tag in e) for tag in ("f32", "f64")},
           "cases": len(errs),
           "device_ms_by_shape": col("device_ms"),
           "graph_ms_by_shape": col("graph_ms"),
           "call_ms_by_shape": col("call_ms"),
           "plain_ms_by_shape": col("plain_ms"),
           "bound_ms_by_shape": col("bound_ms"),
           "bound_by_shape": col("bound_by"),
           "share_of_bound_by_shape": {label: v["bound_ms"] / v["device_ms"]
                                       for label, v in times.items()},
           "device_ms_source_by_shape": col("device_source"),
           "kernels_per_launch_by_shape": col("kernels_per_launch"),
           "kernel_ms_by_shape": col("kernel_ms"),
           "grid": f"one cluster of {ok.CLUSTER} blocks of {ok.THREADS} "
                   "threads, every size",
           "library_ms": None, "library_note": LIBRARY_NOTE,
           "ptxas": ptxas}
    return {"row": row, "errs": errs}


def run() -> tuple:
    try:
        import torch
    except ImportError as e:
        raise SmokeFailure(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: this smoke test runs on the GPU only")
    if not os.path.isdir(os.path.join(ROOT, "pigs_tpu_torch")):
        raise SmokeFailure(f"pigs_tpu_torch/ not found beside {__file__}: run "
                           "from a checkout of the repo")
    for path in (FIXTURE, TRAIN_FIXTURE, NS_FIXTURE, NS_DATA,
                 NS_TRAIN_FIXTURE, NO_MLP_FIXTURE, FIT_FIXTURE,
                 NO_MLP_1D_FIXTURE, DT01_FIXTURE, SELECT_FIXTURE):
        check(os.path.exists(path), f"fixture {path} not found")
    sys.path.insert(0, ROOT)

    import numpy as np

    from pigs_tpu_torch.convert import load_fixture
    from pigs_tpu_torch.models.model import make_initial_state, make_network
    from pigs_tpu_torch.models.state import covariance_of
    from pigs_tpu_torch.ops import aggregate_kernel as ak
    from pigs_tpu_torch.ops import mixture_kernel as mk
    from pigs_tpu_torch.ops import optim_kernel as ok
    from pigs_tpu_torch.train.pn import (pn_epoch, rollout, rollout_frames,
                                         rollout_metrics)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. device and builds
    card = card_line()
    print(f"[device] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)
    t0 = time.perf_counter()
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=3) as pool:
        builds = [pool.submit(mk.build), pool.submit(ak.build),
                  pool.submit(ok.build)]
        infos = {k: v for b in builds for k, v in b.result().items()}
    print(f"[device] kernels built in {time.perf_counter() - t0:.2f} s "
          "(all five sources at once)", flush=True)
    for name, info in infos.items():
        print(f"[device] {name}: {info.seconds:.2f} s "
              f"({'compiled' if info.compiled else 'cached'}: {info.path})",
              flush=True)
        for kernel, r in ptxas_report(info.log).items():
            print(f"  ptxas: {kernel}: {r['registers']} registers, "
                  f"{r['spill_stores']} + {r['spill_loads']} bytes spilled",
                  flush=True)
    # Every K1-K6 instantiation, compiled now or cached, spills nothing.
    ptxas = {lib: ptxas_report(infos[lib].log)
             for lib in ("mixture_fwd", "mixture_bwd", "aggregate_fwd",
                         "aggregate_bwd", "adam")}
    for lib, kernel, count in (
            ("mixture_fwd", "mixture_fwd_kernel<", 8),
            ("mixture_fwd", "combine_slices_kernel<FwdStore", 2),
            ("mixture_bwd", "bwd_gauss_partial_kernel<", 8),
            ("mixture_bwd", "combine_slices_kernel<GaussStore", 1),
            ("mixture_bwd", "bwd_sample_kernel<", 8),
            ("mixture_bwd", "combine_slices_kernel<SampleStore", 1),
            ("aggregate_fwd", "aggregate_fwd_kernel", 1),
            ("aggregate_fwd", "aggregate_merge_kernel", 1),
            ("aggregate_bwd", "mapped_kernel", 1),
            ("aggregate_bwd", "aggregate_bwd_stats_kernel", 1),
            ("aggregate_bwd", "aggregate_bwd_row_kernel", 1),
            ("aggregate_bwd", "aggregate_bwd_row_merge_kernel", 1),
            ("aggregate_bwd", "aggregate_bwd_col_kernel", 1),
            ("aggregate_bwd", "aggregate_bwd_col_merge_kernel", 1),
            ("aggregate_bwd", "aggregate_bwd_reduce_kernel", 1),
            ("adam", "adam_cluster_kernel", 1)):
        found = sum(k.startswith(kernel) for k in ptxas[lib])
        check(found == count, f"{lib}: ptxas reported {found} of the "
              f"{count} {kernel}... instantiations")
    spilled = [k for r in ptxas.values() for k, v in r.items()
               if v["spill_stores"] + v["spill_loads"] > 0]
    check(not spilled, f"K1-K6 instantiations spill: {spilled}")

    # 2. K1 vs plain
    cfg, network, data = load_fixture(FIXTURE, device=dev)
    steps, res, dt = (int(data["config_steps"]), int(data["config_res"]),
                      float(data["config_dt"]))
    state0 = make_initial_state(cfg, device=dev)
    errs = []
    gen = torch.Generator().manual_seed(0)
    with torch.inference_mode():
        for label, (mu, con, val, smp, order, mask) in rollout_slice_inputs(
                cfg, state0, res).items():
            errs.append(compare_case(label, mu, con, val, smp, order, mask,
                                     cfg.period, mk))
        for c in (1, 2):
            (mu, con, val, smp), mask = random_mixture(gen, 333, 1000, c, 2, dev)
            for period in (None, 2.0):
                for order in range(4):
                    errs.append(compare_case(
                        f"ragged 1000x333 c={c} order {order} period {period}",
                        mu, con, val, smp, order, mask, period, mk))
        # Two launches on the same ragged input give the same bits.
        k1_in = (mu, mk.pack_conics(con).contiguous(),
                 (val * mask.to(val.dtype)[:, None]).contiguous(), smp)
        for order in range(4):
            check_deterministic(f"K1 ragged 1000x333 c=2 order {order}",
                                lambda: mk._launch_fwd(*k1_in, order, 2.0))
        # Five Gaussians make one slice: the main pass writes the outputs
        # itself, with no combine pass.
        one = torch.Generator().manual_seed(1)
        check(mk.fwd_geometry(1000, 5, mk._sm_count(0))[1] == 1,
              "K1 at 1000x5 takes more than one slice")
        for c in (1, 2):
            (mu, con, val, smp), mask = random_mixture(one, 5, 1000, c, 2, dev)
            k1_in = (mu, mk.pack_conics(con).contiguous(),
                     (val * mask.to(val.dtype)[:, None]).contiguous(), smp)
            for period in (None, 2.0):
                for order in range(4):
                    label = (f"one slice 1000x5 c={c} order {order} period "
                             f"{period}")
                    errs.append(compare_case(label, mu, con, val, smp, order,
                                             mask, period, mk))
                    check_deterministic(
                        f"K1 {label}",
                        lambda: mk._launch_fwd(*k1_in, order, period))
        (mu, con, val, smp), mask = random_mixture(gen, 333, 1000, 1, 1, dev)
        for order in range(4):
            errs.append(compare_case(f"d=1 1000x333 order {order}", mu, con,
                                     val, smp, order, mask, None, mk))
    k1_abs = max(e["abs"] for e in errs)
    print(f"[kernel] {len(errs)} cases pass; max rel err f32 "
          f"{max(e['f32'] for e in errs):.3e}, f64 "
          f"{max(e['f64'] for e in errs):.3e}; max abs err vs twin "
          f"{k1_abs:.3e}", flush=True)

    # 3. K2/K3 vs plain
    ti = TrainInputs(dev)
    _, conics_t = covariance_of(ti.state)
    st = ti.state
    train_shapes = {
        "4096x1664 order 2 (collocation)": (ti.samples, 2),
        "4096x1664 order 0 (boundary)": (ti.bc_samples, 0),
    }
    berrs = []
    # At the training shapes K3 cuts the Gaussians into slices (the combine
    # pass runs); the one-slice branch runs at 1000x5 below.
    check(mk.fwd_geometry(4096, 1664, mk._sm_count(0))[1] > 1,
          "K3 at 4096x1664 takes one slice")
    for label, (smp, order) in train_shapes.items():
        berrs.append(compare_backward(label, st.means, conics_t, st.u, smp,
                                      order, st.interior, None, mk, gen))
        # As training differentiates it: the samples need no gradient.
        g3 = mk.bwd_sample_launches
        mixture_grads(st.means, conics_t, st.u, smp,
                      random_cotangents(gen, smp.shape[0], 1, 2, order, dev),
                      order, st.interior, None, "auto", samples_grad=False)
        torch.cuda.synchronize()
        check(mk.bwd_sample_launches == g3,
              f"{label}: K3 launched though the samples need no gradient")
    for c in (1, 2):
        (mu, con, val, smp), mask = random_mixture(gen, 333, 1000, c, 2, dev)
        for period in (None, 2.0):
            for order in range(4):
                berrs.append(compare_backward(
                    f"ragged 1000x333 c={c} order {order} period {period}",
                    mu, con, val, smp, order, mask, period, mk, gen))
    k2_in = (mu, mk.pack_conics(con).contiguous(),
             (val * mask.to(val.dtype)[:, None]).contiguous(), smp)
    for order in range(4):
        k2_cots = [torch.randn((1000, 2 * gs), generator=gen).to(dev)
                   for gs in (1, 2, 3, 4)[:order + 1]]
        check_deterministic(f"K2 ragged 1000x333 c=2 order {order}",
                            lambda: mk._launch_bwd_gauss(*k2_in, k2_cots,
                                                         order, 2.0))
        check_deterministic(f"K3 ragged 1000x333 c=2 order {order}",
                            lambda: mk._launch_bwd_sample(*k2_in, k2_cots,
                                                          order, 2.0))
    # Twenty samples make one slice: the main pass writes the gradients
    # itself, with no combine pass.
    check(mk.gauss_geometry(20, 333, mk._sm_count(0))[1] == 1,
          "K2 at 20x333 takes more than one slice")
    for c in (1, 2):
        (mu, con, val, smp), mask = random_mixture(one, 333, 20, c, 2, dev)
        k2_in = (mu, mk.pack_conics(con).contiguous(),
                 (val * mask.to(val.dtype)[:, None]).contiguous(), smp)
        for period in (None, 2.0):
            for order in range(4):
                label = f"one slice 20x333 c={c} order {order} period {period}"
                berrs.append(compare_backward(label, mu, con, val, smp, order,
                                              mask, period, mk, one))
                k2_cots = [torch.randn((20, c * gs), generator=one).to(dev)
                           for gs in (1, 2, 3, 4)[:order + 1]]
                check_deterministic(
                    f"K2 {label}",
                    lambda: mk._launch_bwd_gauss(*k2_in, k2_cots, order,
                                                 period))
    # Five Gaussians make one slice for K3: the main pass writes gx itself.
    check(mk.fwd_geometry(1000, 5, mk._sm_count(0))[1] == 1,
          "K3 at 1000x5 takes more than one slice")
    for c in (1, 2):
        (mu, con, val, smp), mask = random_mixture(one, 5, 1000, c, 2, dev)
        k3_in = (mu, mk.pack_conics(con).contiguous(),
                 (val * mask.to(val.dtype)[:, None]).contiguous(), smp)
        for period in (None, 2.0):
            for order in range(4):
                label = f"one slice 1000x5 c={c} order {order} period {period}"
                berrs.append(compare_backward(label, mu, con, val, smp, order,
                                              mask, period, mk, one))
                k3_cots = [torch.randn((1000, c * gs), generator=one).to(dev)
                           for gs in (1, 2, 3, 4)[:order + 1]]
                check_deterministic(
                    f"K3 {label}",
                    lambda: mk._launch_bwd_sample(*k3_in, k3_cots, order,
                                                  period))
    (mu, con, val, smp), mask = random_mixture(gen, 333, 1000, 1, 1, dev)
    for order in range(4):
        berrs.append(compare_backward(f"d=1 1000x333 order {order}", mu, con,
                                      val, smp, order, mask, None, mk, gen))
    bwd_abs = max(e["abs"] for e in berrs)
    print(f"[backward] {len(berrs)} cases pass; max rel err vs f64 "
          f"{max(e['f64'] for e in berrs):.3e}, vs twin "
          f"{max(e['twin'] for e in berrs):.3e}; max abs err vs twin "
          f"{bwd_abs:.3e}; K3 idle when samples need no gradient",
          flush=True)

    # 4. the rollout, counted
    counts = {}
    reset_counts(mk, ak)
    frames = rollout_frames(cfg, network, state0, steps, res, dt)
    torch.cuda.synchronize()
    counts["rollout"] = read_counts(mk, ak)
    check(counts["rollout"] == (2 * steps, 0, 0, 0, 0, 0),
          f"rollout launches (K1-K6) {counts['rollout']}, expected "
          f"({2 * steps}, 0, 0, 0, 0, 0)")
    frames = frames.cpu().numpy()
    check(frames.shape == (steps, cfg.channels, res, res),
          f"frames shape {frames.shape}")
    check(bool(np.isfinite(frames).all()), "rollout frames not finite")
    jax_frames = data["jax_frames"]
    vs_jax = [float(np.linalg.norm(frames[i] - jax_frames[i])
                    / np.linalg.norm(jax_frames[i])) for i in range(steps)]
    metrics = rollout_metrics(frames[:, 0], data["fd_frames"])
    jax_mean = float(data["jax_mean_rel_l2"])
    print("[rollout] per-step rel-L2 vs JAX frames: "
          + " ".join(f"{v:.2e}" for v in vs_jax), flush=True)
    print(f"[rollout] mean rel-L2 vs FD {metrics['mean_rel_norm']:.6f} "
          f"(JAX-CPU {jax_mean:.6f}); K1 launches {counts['rollout'][0]}",
          flush=True)
    check(vs_jax[0] <= FRAME0_TOL, f"frame 0 vs JAX {vs_jax[0]:.3e}")
    check(max(vs_jax[1:6]) <= EARLY_FRAMES_TOL,
          f"steps 1-5 vs JAX {max(vs_jax[1:6]):.3e}")
    check(abs(metrics["mean_rel_norm"] - jax_mean) <= MEAN_REL_L2_TOL,
          f"mean rel-L2 {metrics['mean_rel_norm']:.6f} vs JAX {jax_mean:.6f}")

    # 5. one training step against JAX f64
    step_errs = {}
    for impl in ("auto", "plain"):
        loss_errs, grad_err, update_err, lw_err = train_step_phase(ti, impl)
        step_errs[impl] = (loss_errs, grad_err, update_err)
        print(f"[step] {'K1/K2' if impl == 'auto' else 'plain'}: loss terms "
              "[pde, bc, cons, init, mag, total] rel err vs JAX f64 "
              + " ".join(f"{e:.2e}" for e in loss_errs)
              + f"; gradient {grad_err:.3e}; update {update_err:.3e}; "
              f"loss weight abs {lw_err:.2e}", flush=True)
    loss_errs, grad_err, update_err = step_errs["auto"]
    check(max(loss_errs) <= STEP_LOSS_TOL,
          f"pn_step loss terms {max(loss_errs):.3e} > {STEP_LOSS_TOL}")
    check(grad_err <= STEP_GRAD_TOL,
          f"pn_step gradient {grad_err:.3e} > {STEP_GRAD_TOL}")
    check(update_err <= STEP_UPDATE_TOL,
          f"pn_step update {update_err:.3e} > {STEP_UPDATE_TOL}")

    # 6. the 20-step split-regime epoch, counted.  Launches: sampling the
    # IC's fields, 2 K1 (order 2 at the collocation samples, order 0 at the
    # boundary samples).  Each step: forward_step 1 K1 (order 2 at the
    # means); sample_fields of the new state 2 K1, whose backward is 2 K2
    # (the samples need no gradient: no K3); adaptive_split 3 K1 (density,
    # value now, value before); sample_fields of the split state 2 K1; the
    # Adam step 1 K6.
    counts["epoch"], first = split_epoch_phase(
        ti, mk, ak, (2 + 8 * ti.n_steps, 2 * ti.n_steps, 0, ti.n_steps),
        "epoch")

    # 7. train() resumed from the fixture for 3 epochs, checkpoint, EMA rollout
    log = []
    reset_counts(mk, ak)
    t_train = time.perf_counter()
    result = resumed_train(ti, log, dev)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t_train
    counts["train"] = read_counts(mk, ak)
    adam_steps = int(result.opt_state.count) - int(ti.opt0.count)
    check(counts["train"][0] > 0 and counts["train"][1] > 0
          and counts["train"][2] == 0
          and counts["train"][5] == adam_steps > 0,
          f"train() launches (K1-K6) {counts['train']}, {adam_steps} Adam "
          "steps")
    back = check_round_trip(ti, result, dev)
    ema_net = make_network(cfg, frequencies=network.frequencies.cpu(),
                           device=dev)
    ema_net.load_state_dict(back.ema)
    ema_frames = rollout_frames(cfg, ema_net, state0, steps, res, dt)
    ema_metrics = rollout_metrics(ema_frames.cpu().numpy()[:, 0],
                                  data["fd_frames"])
    print(f"[train] 3 epochs in {t_train:.2f} s; launches (K1-K6) "
          f"{counts['train']}; checkpoint round trip equal; EMA rollout mean "
          f"rel-L2 vs FD {ema_metrics['mean_rel_norm']:.6f} (JAX-CPU "
          f"{jax_mean:.6f})", flush=True)
    check(abs(ema_metrics["mean_rel_norm"] - jax_mean) <= MEAN_REL_L2_TOL,
          f"EMA rollout mean rel-L2 {ema_metrics['mean_rel_norm']:.6f} vs "
          f"{jax_mean:.6f}")

    # 8. times.  K1 at the flagship's four main-path shapes and K2/K3 at
    # the two training shapes (each also checked bitwise deterministic).
    times = {"mixture_fwd": {}, "mixture_bwd_gauss": {},
             "mixture_bwd_sample": {}}
    ones = torch.ones((st.means.shape[0], 1), device=dev)
    k1_shapes = {
        "1664x1664 order 2 (means)": (state0.means, covariance_of(state0)[1],
                                      state0.u, state0.means, 2,
                                      state0.active),
        "1664x1664 order 0 (density, value)": (st.means, conics_t, ones,
                                               st.means, 0, st.active),
        "4096x1664 order 2 (collocation)": (st.means, conics_t, st.u,
                                            ti.samples, 2, st.interior),
        "4096x1664 order 0 (boundary, render)": (st.means, conics_t, st.u,
                                                 ti.bc_samples, 0,
                                                 st.interior),
    }
    with torch.inference_mode():
        for label, (mu, con, val, smp, order, mask) in k1_shapes.items():
            times["mixture_fwd"][label] = time_k1(
                label, mu, con, val, smp, order, mask, cfg.period, mk, card)
        v_int = (st.u * st.interior.float()[:, None]).contiguous()
        packed = (st.means.contiguous(), mk.pack_conics(conics_t).contiguous(),
                  v_int)
        for label, (smp, order) in train_shapes.items():
            for name, t in time_k23(label, packed, smp, order, mk, gen,
                                    card).items():
                times[name][label] = t

    def one_step(impl):
        from pigs_tpu_torch.train.pn import pn_step
        c = ti.cfg._replace(mixture_impl=impl)
        prev = ti.prev_fields(c)
        return lambda: pn_step(c, ti.network, ti.opt, ti.state, prev,
                               ti.samples, ti.time_samples, ti.bc_samples,
                               torch.ones((), device=dev), ti.base_lr,
                               ti.epsilon, 0.0, ti.dt, ti.floor, ti.clip, True)

    def one_epoch(impl):
        c = ti.cfg._replace(mixture_impl=impl)
        prev = ti.prev_fields(c)
        return lambda: pn_epoch(c, ti.network, ti.opt, ti.state, prev,
                                ti.samples, ti.time_samples, ti.bc_samples,
                                ti.base_lr, ti.epsilon, ti.dt, ti.n_steps,
                                ti.floor, True, ti.clip, True)

    step_ms, epoch_ms = {"auto": [], "plain": []}, {"auto": [], "plain": []}
    for impl in ("plain", "auto", "auto", "plain"):
        ti.reset()
        fn = one_step(impl)
        fn()
        step_ms[impl] += [host_ms(fn) for _ in range(5)]
        ti.reset()
        epoch_ms[impl].append(host_ms(one_epoch(impl)))
    med = {k: statistics.median(v) for k, v in step_ms.items()}
    emed = {k: statistics.median(v) for k, v in epoch_ms.items()}
    print(f"[times] pn_step: K1/K2 {med['auto']:.2f} ms, plain "
          f"{med['plain']:.2f} ms (median of 10, host clock with device "
          f"syncs; {card})", flush=True)
    print(f"[times] 20-step split-regime epoch: K1/K2 {emed['auto']:.2f} ms "
          f"({emed['auto'] / ti.n_steps:.2f} ms per training step), plain "
          f"{emed['plain']:.2f} ms (median of 2 each, order plain, K, K, "
          f"plain; {card})", flush=True)

    # A profile of 5 training steps: kernels per step and device idle share.
    ti.reset()
    fn = one_step("auto")
    fn()
    step_profile = profile_ms(lambda: [fn() for _ in range(5)], 5,
                              "pn_steps", card)

    _, evo = rollout(cfg, network, n_steps=steps, res=res, dt=dt, device=dev)
    print(f"[times] rollout {steps} steps at {res}x{res}: {evo * 1e3:.2f} ms "
          f"({evo * 1e3 / steps:.3f} ms/step; {card})", flush=True)

    # 9. the NS rollout, counted
    ns = ns_phase(dev, mk, ak, card)
    counts["ns"] = ns["counts"]

    # 10. K4/K5 at the real aggregation inputs, counted, then timed
    ti.reset()
    agg = aggregate_phase(dev, ak, card, [
        ("flagship t=0", cfg, network, state0),
        ("training fixture", ti.cfg, ti.network, ti.state),
        ("NS t=0", ns["cfg"], ns["network"], ns["state0"]),
        ("NS step 25", ns["cfg"], ns["network"], ns["state25"])])

    # 11. NS training and the two training options, counted
    nst = ns_train_phase(dev, mk, ak, card, ti)
    counts.update(nst["counts"])
    k1_abs = max([k1_abs] + [e["abs"] for e in nst["errs"]])
    bwd_abs = max([bwd_abs] + [e["abs"] for e in nst["berrs"]])

    # 12. the no-MLP direct solver, counted
    nmp = no_mlp_phase(dev, mk, ak, card)
    counts.update(nmp["counts"])
    k1_abs = max([k1_abs] + [e["abs"] for e in nmp["errs"]])
    bwd_abs = max([bwd_abs] + [e["abs"] for e in nmp["berrs"]])

    # 13. the NS data pipeline and the fit-to-target initializer, counted
    nsd = ns_data_phase(dev, mk, ak, card, ns)
    counts.update(nsd["counts"])
    k1_abs = max([k1_abs] + [e["abs"] for e in nsd["errs"]])
    bwd_abs = max([bwd_abs] + [e["abs"] for e in nsd["berrs"]])

    # 14. the double backward, validate_pn_torch and the dt=0.1
    # checkpoint, counted
    val = validate_phase(dev, mk, ak, card, ti, data)
    counts.update(val["counts"])

    # 15. the multi-process layer: one NCCL rank, two gloo ranks, Timer
    # and trace, select_split_stop_torch; counted
    par = parallel_phase(dev, mk, ak, card, ti, med["auto"])
    counts.update(par["counts"])

    # 16. K6, the Adam step, against its twins; timed
    opt = optim_phase(dev, card, ptxas["adam"])

    for phase in (ns, nst, nmp, nsd):
        times["mixture_fwd"].update(phase["k1_times"])
    for phase in (nst, nmp, nsd):
        times["mixture_bwd_gauss"].update(phase["k2_times"])
    times.update(agg["kernel_times"])
    parallel = {**par["counts"], **par["parallel"]}

    def launch_fields(i):
        """Kernel i's (K1 = 0) launches by path, as each path's run read
        the counters, and per step or iteration of the main paths."""
        by_path = {path: c[i] for path, c in counts.items()}
        if i in (3, 4):
            by_path["aggregate"] = agg["launches"]["fwd" if i == 3 else "bwd"]
        return {
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "launches_per_train_step": counts["epoch"][i] / ti.n_steps,
            "launches_per_ns_train_step":
                counts["ns_epoch"][i] / nst["n_steps"],
            "launches_per_rollout_step": {
                "flagship": counts["rollout"][i] / steps,
                "ns": counts["ns"][i] / ns["steps"]},
            "launches_per_no_mlp_iteration":
                counts["no_mlp_block"][i] / nmp["iters"],
            "launches_per_fit_iteration":
                counts["fit_block"][i] / nsd["iters"],
            "parallel": {
                "launches_per_rank_by_path": {path: c[i] for path, c in
                                              parallel.items()},
                "note": "parallel_*: one NCCL rank in this process; gloo_*: "
                        "each of two gloo ranks sharing cuda:0 (a ring call "
                        "launches one K1 per model rank: JAX's scan one "
                        "more)"},
            "on_main_path": any(counts[p][i] for p in (
                "rollout", "epoch", "ns", "ns_epoch", "no_mlp_block",
                "fit_block"))}

    kernels = []
    for i, (name, source, line, max_abs) in enumerate((
            ("mixture_fwd", "mixture_fwd.cu", "pallas_mixture.py:211",
             k1_abs),
            ("mixture_bwd_gauss", "mixture_bwd.cu", "pallas_mixture.py:313",
             bwd_abs),
            ("mixture_bwd_sample", "mixture_bwd.cu", "pallas_mixture.py:364",
             bwd_abs),
            ("aggregate_fwd", "aggregate_fwd.cu", "pallas_aggregate.py:246",
             agg["max_abs"]["fwd"]),
            ("aggregate_bwd", "aggregate_bwd.cu", "pallas_aggregate.py:287",
             agg["max_abs"]["bwd"]))):
        t = times[name]

        def col(key):
            return {label: v[key] for label, v in t.items()}
        bound_by = col("bound_by")
        row = {
            "name": name, "route": "cuda",
            "source": f"pigs_tpu_torch/ops/csrc/{source}",
            "replaces": f"pigs_tpu/ops/{line}",
            **launch_fields(i),
            "max_abs_err": max_abs,
            "timed": "ms (device), call_ms, plain_ms and bound_ms sum the "
                     "shapes of the *_by_shape fields",
            "ms": sum(col("device_ms").values()),
            "call_ms": sum(col("call_ms").values()),
            "plain_ms": sum(col("plain_ms").values()),
            "bound_ms": sum(col("bound_ms").values()),
            "bound_by": ("bytes" if set(bound_by.values()) == {"bytes"}
                         else "operations"),
            "library_ms": None, "library_note": LIBRARY_NOTE,
            "device_ms_by_shape": col("device_ms"),
            "graph_ms_by_shape": col("graph_ms"),
            "call_ms_by_shape": col("call_ms"),
            "plain_ms_by_shape": col("plain_ms"),
            "bound_ms_by_shape": col("bound_ms"),
            "bound_by_shape": bound_by,
            "share_of_bound_by_shape": {label: v["bound_ms"] / v["device_ms"]
                                        for label, v in t.items()},
            "device_ms_source_by_shape": col("device_source"),
            "kernels_per_launch_by_shape": col("kernels_per_launch"),
            "kernel_ms_by_shape": col("kernel_ms"),
        }
        if "grid" in next(iter(t.values())):
            row["grid_by_shape"] = col("grid")
            row["graph_ms_by_blocks_per_sm_by_shape"] = col(
                "graph_ms_by_blocks_per_sm")
        lib = ("mixture_fwd", "mixture_bwd", "mixture_bwd", "aggregate_fwd",
               "aggregate_bwd")[i]
        row["ptxas"] = {k: v for k, v in ptxas[lib].items()
                        if i not in (1, 2) or (i == 2) == (
                            k.startswith("bwd_sample") or "SampleStore" in k)}
        if name in step_profile:
            row["device_ms_per_pn_step"] = \
                step_profile[name]["device_ms_per_step"]
            row["device_ms_per_ns_pn_step"] = \
                nst["profile"][name]["device_ms_per_step"]
            row["device_ms_per_no_mlp_iteration"] = \
                nmp["profile"][name]["device_ms_per_step"]
            row["device_ms_per_fit_iteration"] = \
                nsd["profile"][name]["device_ms_per_step"]
        if i == 3:
            row["factored_device_ms_by_shape"] = col("factored_device_ms")
            row["factored_note"] = (
                "the device time of the factored aggregation the network "
                "runs, at the same inputs: several torch calls, not one "
                "library call, so not library_ms")
        if i >= 3:
            key = "fwd" if i == 3 else "bwd"
            row["pairs_by_shape"] = col("pairs")
            row["perf_suite_timed"] = ("forward" if i == 3 else
                                       "forward+backward") + \
                ", one call each (call time)"
            row["perf_suite_ms_by_size"] = {
                impl: {n: agg["times"][(impl, key, n)]
                       for n in PERF_SUITE_SIZES}
                for impl in ("kernel", "factored", "plain")}
        kernels.append(row)
    # K6: the counts of every path's own run, and its device time per step
    # and the K6 kernels the profiler saw in each path's profile.
    row = {**opt["row"], **launch_fields(5)}
    for key, profile in (("pn_step", step_profile),
                         ("ns_pn_step", nst["profile"]),
                         ("no_mlp_iteration", nmp["profile"]),
                         ("fit_iteration", nsd["profile"])):
        row[f"device_ms_per_{key}"] = profile["adam"]["device_ms_per_step"]
        row[f"profiled_kernels_per_{key}"] = \
            profile["adam"]["kernels_per_step"]
    kernels.append(row)
    return {"kernels": kernels,
            "pn_step_ms": med, "epoch_ms": emed, "rollout_ms": evo * 1e3,
            "ema_rollout_mean_rel_l2": ema_metrics["mean_rel_norm"],
            "epoch_first_mask_divergence": first,
            "ns_rollout_ms": ns["ms"],
            "ns_mean_rel_l2": ns["mean_rel_l2"],
            "ns_pn_step_ms": nst["step_ms"], "ns_train_3_epochs_s":
                nst["train_s"],
            "ns_ema_rollout_mean_rel_l2": nst["ema_mean_rel_l2"],
            "ns_epoch_first_mask_divergence": nst["first"],
            "aggregate_pairs_differing": agg["differ"],
            "no_mlp": {k: nmp[k] for k in (
                "block_errs", "burgers_2d_rel_l2", "burgers_2d_s",
                "burgers_2d_iters", "burgers_1d_rel_l2", "burgers_1d_s",
                "wave_2d_s", "block_ms")},
            "no_mlp_1d_ic_fit": {k: nmp["ic_1d"][k] for k in (
                "render", "render_at_fit_samples", "render_cpu", "fits")},
            "validate": {k: v for k, v in val.items() if k != "counts"},
            "parallel": {k: par[k] for k in (
                "dp_bitwise", "dp_step_ms", "gloo_dp_step_ms",
                "select_split", "max_abs")},
            "ns_data": {k: nsd[k] for k in (
                "generate_s", "regen_max_abs", "block_errs", "fit_s",
                "port_fit_loss", "port_fit_t0_rel_l2", "port_fit_mean_rel_l2",
                "initialize_s")}}, card


def main() -> int:
    try:
        kernels, card = run()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    import torch
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
