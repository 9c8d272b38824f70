#!/usr/bin/env python3
"""The benchmark of the PyTorch port (``pigs_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout:

    python3 portbench/run.py --workload burgers-train --seed 7 \\
        --seconds 30 --trace 0

The workload is a cell of ``BENCHMARK.json``; its configuration
(``portbench/configs/<config>.json``), its traffic
(``portbench/traffic/<traffic>.json``, which names a driver in
``portbench/drivers/``) and, with ``--trace 1``, each per-layer metric
(``portbench/metrics/<metric>.py``) are found by name.  The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks``, each number that decided ``correct`` beside its
limit; the same checks end standard error.  The run exits non-zero,
printing no result, without a CUDA device, when the cell asks for more
devices than there are, or when the JAX package or JAX itself was loaded.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "pigs_tpu")


def set_environment():
    """Fixed cache directories inside the checkout, so that only a
    checkout's first run builds; no library loads JAX on its own."""
    build = os.path.join(ROOT, "build", "portbench")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # One process with one host thread: the program's host work is a
    # serial launch loop, and idle worker threads only add jitter.
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "nvidia-smi did not answer"


def read_metrics(cell, run) -> dict:
    """Each per-layer metric of the cell from its own reader."""
    out = {}
    for metric in cell.per_layer:
        path = os.path.join(ROOT, "portbench", "metrics",
                            metric["name"] + ".py")
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + metric["name"].replace(".", "_"), path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        value = module.read(run)
        if value is not None:
            out[metric["name"]] = {"value": value, "unit": metric["unit"]}
    return out


def finite(x: float) -> float:
    """JSON has no infinity: a non-finite reading prints as the largest
    float, which fails every limit."""
    return x if math.isfinite(x) else sys.float_info.max


def result_line(cell, driver_name: str, result: dict, traced: bool,
                device_info: dict) -> dict:
    """The result object: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, traced ``breakdown``, and last ``checks``."""
    from portbench import common, readings
    if traced:
        metrics = read_metrics(cell, readings.TracedRun(
            driver_name, result, cell.config))
    else:
        wanted = {m["name"]: m for m in cell.end_to_end}
        metrics = {"setup_s": {"value": result["setup_s"], "unit": "s"}}
        for name, value in result["metrics"].items():
            if name in wanted:
                metrics[name] = {"value": value, "unit": wanted[name]["unit"]}
    line = {"correct": common.judge(result["checks"]),
            "attempted": int(result["attempted"]),
            "failed": int(result["failed"]),
            "metrics": metrics, "device": dict(device_info)}
    if traced:
        prof = result["profile"]
        line["device"]["busy_s"] = prof.busy_s()
        line["device"]["window_s"] = prof.wall_s
        line["breakdown"] = {"device_ops": prof.top_device_ops(10),
                             "idle_gaps": prof.top_idle_gaps(10)}
    line["checks"] = {k: {"value": finite(v["value"]), "limit": v["limit"]}
                      for k, v in result["checks"].items()}
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_environment()
    sys.path.insert(0, ROOT)
    from portbench import common, readings, trace

    cell = common.Cell(common.load_benchmark(), args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures the GPU port",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    common.check_fixtures(cell.config)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.set_num_threads(1)
    print(f"[portbench] {args.workload} seed {args.seed} on "
          f"{power_limit()}; peaks: {readings.workcount.PEAK_FLOP_S:.3g} "
          f"FLOP/s float32, {readings.workcount.PEAK_BYTES_S:.3g} B/s, "
          f"{readings.workcount.PEAK_SFU_S:.3g} SFU/s", file=sys.stderr,
          flush=True)

    driver_name = cell.traffic["driver"]
    driver = importlib.import_module(f"portbench.drivers.{driver_name}")
    tracer = trace.Recorder() if args.trace else None
    result = driver.run(cell, args.seed, args.seconds, tracer, device)

    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad}; the port and the benchmark "
              "may not load JAX or the JAX package", file=sys.stderr)
        return 3

    device_info = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(device),
                   "count": cell.chips,
                   "memory_peak_bytes": int(result["memory_peak_bytes"])}
    line = result_line(cell, driver_name, result, bool(args.trace),
                       device_info)
    print(f"[portbench] attempted {line['attempted']}, failed "
          f"{line['failed']}, window {result['window_s']:.3f} s, set-up "
          f"{result['setup_s']:.3f} s", file=sys.stderr)
    for k, v in result["checks"].items():
        extra = "".join(f" {a}={b}" for a, b in v.items()
                        if a not in ("value", "limit"))
        print(f"check {k} {v['value']!r} limit {v['limit']!r}{extra}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
