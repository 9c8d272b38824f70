#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. device   the card's name and power limit, torch and CUDA versions, and
              the build of the CUDA kernel K1 (mixture forward) from
              pigs_tpu_torch/ops/csrc/ with nvcc for sm_90a;
  2. kernel   K1 against its plain PyTorch twin and the plain path in float32
              (norm-relative error <= 1e-5 per field) and against the plain
              path in float64 (<= 1e-4), at the two shapes of the rollout, a
              ragged case at orders 0-3, c in {1, 2}, with and without a
              period, and d=1 through the d=2 embedding;
  3. rollout  the 50-step rollout of the Burgers flagship at capacity 1664
              from artifacts/burgers_ns4096_ema2_torch.npz: exactly 2 K1
              launches per step, finite frames, frames against the JAX frames
              in the fixture, and mean rel-L2 against the stored FD frames
              within 0.005 of the JAX-CPU value;
  4. times    median of 20 CUDA-event timed runs of K1 and of its plain twin
              at both rollout shapes, and the timed rollout.

The line before the last is the card's ``nvidia-smi`` name and power limit;
the last line is a JSON object with ``ok`` and the device.  Without a CUDA
device, or outside a checkout of the repo, it fails and prints no result.
"""

import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "artifacts", "burgers_ns4096_ema2_torch.npz")

KERNEL_F32_TOL = 1e-5    # K1 vs the same math in float32, summed in another order
KERNEL_F64_TOL = 1e-4    # K1 vs the float64 oracle (the repo's bound, BASELINE.md:21)
FRAME0_TOL = 1e-5        # frame 0 renders the same initial state as JAX did
EARLY_FRAMES_TOL = 1e-3  # steps 1-5: float32 differences through the network
MEAN_REL_L2_TOL = 0.005  # mean rel-L2 vs FD, against the JAX-CPU rollout's


class SmokeFailure(Exception):
    pass


def check(ok: bool, msg: str):
    if not ok:
        raise SmokeFailure(msg)


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
                 k1):
    """Run K1 and the plain versions on one input; return the errors."""
    import torch

    from pigs_tpu_torch.ops.mixture import eval_mixture
    from pigs_tpu_torch.ops.mixture_kernel import (mixture_forward_plain,
                                                   pack_conics, unpack_fields)
    args = dict(order=order, mask=mask, period=period)
    before = k1.launches
    out = eval_mixture(means, conics, values, samples, **args)
    torch.cuda.synchronize()
    check(k1.launches == before + 1, f"{label}: K1 was not launched")
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


def slice_inputs(cfg, state, res):
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


def median_ms(fn, runs: int = 20) -> float:
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
    check(os.path.exists(FIXTURE), f"fixture {FIXTURE} not found")
    sys.path.insert(0, ROOT)

    from pigs_tpu_torch.convert import load_fixture
    from pigs_tpu_torch.models.model import make_initial_state
    from pigs_tpu_torch.ops import mixture_kernel as k1
    from pigs_tpu_torch.train.pn import (rollout, rollout_frames,
                                         rollout_metrics)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # 1. device and build
    card = card_line()
    print(f"[device] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}", flush=True)
    info = k1.build()
    print(f"[device] K1 built in {info.seconds:.2f} s "
          f"({'compiled' if info.compiled else 'cached'}: {info.path})",
          flush=True)
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    # 2. kernel vs plain
    cfg, network, data = load_fixture(FIXTURE, device=dev)
    steps, res, dt = (int(data["config_steps"]), int(data["config_res"]),
                      float(data["config_dt"]))
    state0 = make_initial_state(cfg, device=dev)
    errs = []
    with torch.inference_mode():
        for label, (mu, con, val, smp, order, mask) in slice_inputs(
                cfg, state0, res).items():
            errs.append(compare_case(label, mu, con, val, smp, order, mask,
                                     cfg.period, k1))
        gen = torch.Generator().manual_seed(0)
        for c in (1, 2):
            (mu, con, val, smp), mask = random_mixture(gen, 333, 1000, c, 2, dev)
            for period in (None, 2.0):
                for order in range(4):
                    errs.append(compare_case(
                        f"ragged 1000x333 c={c} order {order} period {period}",
                        mu, con, val, smp, order, mask, period, k1))
        (mu, con, val, smp), mask = random_mixture(gen, 333, 1000, 1, 1, dev)
        for order in range(4):
            errs.append(compare_case(f"d=1 1000x333 order {order}", mu, con,
                                     val, smp, order, mask, None, k1))
    max_abs = max(e["abs"] for e in errs)
    print(f"[kernel] {len(errs)} cases pass; max rel err f32 "
          f"{max(e['f32'] for e in errs):.3e}, f64 "
          f"{max(e['f64'] for e in errs):.3e}; max abs err vs twin "
          f"{max_abs:.3e}", flush=True)

    # 3. the rollout, counted
    k1.launches = 0
    frames = rollout_frames(cfg, network, state0, steps, res, dt)
    torch.cuda.synchronize()
    launches = k1.launches
    check(launches == 2 * steps,
          f"K1 launched {launches} times in the rollout, expected {2 * steps}")
    frames = frames.cpu().numpy()
    check(frames.shape == (steps, cfg.channels, res, res),
          f"frames shape {frames.shape}")
    import numpy as np
    check(bool(np.isfinite(frames).all()), "rollout frames not finite")
    jax_frames = data["jax_frames"]
    vs_jax = [float(np.linalg.norm(frames[i] - jax_frames[i])
                    / np.linalg.norm(jax_frames[i])) for i in range(steps)]
    metrics = rollout_metrics(frames[:, 0], data["fd_frames"])
    jax_mean = float(data["jax_mean_rel_l2"])
    print("[rollout] per-step rel-L2 vs JAX frames: "
          + " ".join(f"{v:.2e}" for v in vs_jax), flush=True)
    print("[rollout] per-step rel-L2 vs FD: "
          + " ".join(f"{v:.4f}" for v in metrics["per_step_rel_norm"]),
          flush=True)
    print(f"[rollout] mean rel-L2 vs FD {metrics['mean_rel_norm']:.6f} "
          f"(JAX-CPU {jax_mean:.6f}); K1 launches {launches}", flush=True)
    check(vs_jax[0] <= FRAME0_TOL, f"frame 0 vs JAX {vs_jax[0]:.3e}")
    check(max(vs_jax[1:6]) <= EARLY_FRAMES_TOL,
          f"steps 1-5 vs JAX {max(vs_jax[1:6]):.3e}")
    check(abs(metrics["mean_rel_norm"] - jax_mean) <= MEAN_REL_L2_TOL,
          f"mean rel-L2 {metrics['mean_rel_norm']:.6f} vs JAX {jax_mean:.6f}")

    # 4. times
    from pigs_tpu_torch.ops.mixture_kernel import (mixture_forward,
                                                   mixture_forward_plain,
                                                   pack_conics)
    ms, plain_ms = {}, {}
    with torch.inference_mode():
        for label, (mu, con, val, smp, order, mask) in slice_inputs(
                cfg, state0, res).items():
            args = (mu.contiguous(), pack_conics(con).contiguous(),
                    (val * mask.to(val.dtype)[:, None]).contiguous(),
                    smp.contiguous(), order, cfg.period)
            plain_ms[label] = median_ms(lambda: mixture_forward_plain(*args))
            ms[label] = median_ms(lambda: mixture_forward(*args))
            print(f"[times] {label}: K1 {ms[label]:.4f} ms, plain "
                  f"{plain_ms[label]:.4f} ms (median of 20; {card})",
                  flush=True)
    _, evo = rollout(cfg, network, n_steps=steps, res=res, dt=dt, device=dev)
    print(f"[times] rollout {steps} steps at {res}x{res}: {evo * 1e3:.2f} ms "
          f"({evo * 1e3 / steps:.3f} ms/step; {card})", flush=True)

    return {"kernels": [{
        "name": "mixture_fwd",
        "route": "cuda",
        "source": "pigs_tpu_torch/ops/csrc/mixture_fwd.cu",
        "replaces": "pigs_tpu/ops/pallas_mixture.py:211",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": sum(ms.values()),
        "plain_ms": sum(plain_ms.values()),
        "ms_by_shape": ms,
        "plain_ms_by_shape": plain_ms,
        "rollout_ms": evo * 1e3,
    }]}, card


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
