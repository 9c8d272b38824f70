"""What every driver shares: ``BENCHMARK.json`` and the files it names,
the fixtures as plain arrays, parameter names, the comparisons that decide
``correct``, and the host clock.

Nothing here imports the program (``pigs_tpu_torch``); the drivers do, and
only inside their functions.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib
import json
import math
import os
import statistics
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic
    and the metrics it reports, all found by name."""

    def __init__(self, bench: dict, name: str, root: str = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                             f"(have {sorted(cells)})")
        self.bench = bench
        self.root = root
        self.workload = cells[name]
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = read_json(os.path.join(
            root, configs[self.workload["config"]]["file"]))
        self.traffic = read_json(os.path.join(
            HERE, "traffic", self.workload["traffic"] + ".json"))
        self.chips = int(self.workload["chips"])

    def reports(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    @property
    def end_to_end(self) -> List[dict]:
        return [m for m in self.bench["end_to_end"] if self.reports(m)]

    @property
    def per_layer(self) -> List[dict]:
        e2e = {m["name"] for m in self.end_to_end}
        return [m for m in self.bench["per_layer"]
                if m["moves"] in e2e and self.reports(m)]

    def path(self, rel: str) -> str:
        return os.path.join(self.root, rel)


def reference(cell: Cell):
    """The plain reference module the configuration names
    (``portbench/reference/<reference>.py``)."""
    return importlib.import_module(
        f"portbench.reference.{cell.config['reference']}")


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return read_json(os.path.join(root, "BENCHMARK.json"))


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def check_fixtures(config: dict, root: str = ROOT) -> None:
    """Every fixture the configuration names is there with its recorded
    hash: the inputs are part of the yardstick."""
    fx = config["fixture"]
    for key, rel in fx.items():
        if key.endswith("_sha256"):
            continue
        path = os.path.join(root, rel)
        if not os.path.exists(path):
            raise FileNotFoundError(f"fixture {rel} is missing")
        got = sha256(path)
        if got != fx[f"{key}_sha256"]:
            raise ValueError(f"fixture {rel} changed: sha256 {got}, the "
                             f"configuration records {fx[key + '_sha256']}")


def load_arrays(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def subtree(data: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    """The arrays stored under ``prefix/`` with ``params/`` in its place:
    a flat flax tree (``params/delta_net/Dense_0/kernel``)."""
    return {"params/" + k[len(prefix) + 1:]: v for k, v in data.items()
            if k.startswith(prefix + "/")}


def flax_name(torch_name: str) -> str:
    """The flax path of a parameter of the program's network, whose
    modules carry the flax tree's names: ``input_transform`` for
    ``InputTransform_0``, ``mlp`` for ``MLP_0``, ``layers.i`` for
    ``Dense_i``, ``query.h`` for ``query_h``, ``weight`` for ``kernel``."""
    parts = torch_name.split(".")
    if len(parts) == 1:
        return "params/" + parts[0]
    out, i = [], 0
    while i < len(parts) - 1:
        p = parts[i]
        if p == "input_transform":
            out.append("InputTransform_0")
        elif p == "mlp":
            out.append("MLP_0")
        elif p == "layers":
            out.append(f"Dense_{parts[i + 1]}")
            i += 1
        elif p in ("query", "key"):
            out.append(f"{p}_{parts[i + 1]}")
            i += 1
        else:
            out.append(p)
        i += 1
    leaf = {"weight": "kernel", "bias": "bias"}[parts[-1]]
    return "/".join(["params", *out, leaf])


# ------------------------------------------------------------ comparisons --

def relative_gap(got: float, want: float) -> float:
    """``|got - want| / |want|``; infinite when ``got`` is not finite."""
    if not math.isfinite(got):
        return math.inf
    return abs(got - want) / max(abs(want), 1e-300)


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              keep: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Each leaf's ``|got - want| / max(want, median leaf's want)`` over
    the leaves in ``keep`` (all of ``want`` by default); a missing or
    non-finite leaf reads infinite."""
    names = list(want if keep is None else keep)
    floor = statistics.median(want[k] for k in names)
    out = {}
    for k in names:
        g = got.get(k, math.nan)
        out[k] = math.inf if not math.isfinite(g) else \
            abs(g - want[k]) / max(want[k], floor, 1e-300)
    return out


def worst_leaf_gap(got: Dict[str, float], want: Dict[str, float],
                   keep: Optional[Sequence[str]] = None) -> tuple:
    """The worst of :func:`leaf_gaps`, with the leaf's name."""
    gaps = leaf_gaps(got, want, keep)
    where = max(gaps, key=gaps.get)
    return gaps[where], where


def frames_gap(got: np.ndarray, want: np.ndarray, stop: Optional[int] = None,
               start: int = 0) -> float:
    """The widest per-frame ``||got - want|| / ||want||`` over frames
    ``start`` to ``stop`` (all by default; 0 where that is none);
    infinite when any frame is not finite or the shapes differ."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        return math.inf
    gaps = [np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-300)
            for g, w in zip(got[start:stop], want[start:stop])]
    return float(max(gaps, default=0.0))


def judge(checks: Dict[str, dict]) -> bool:
    """Every number within its limit (``value <= limit``)."""
    return all(c["value"] <= c["limit"] for c in checks.values())


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 matmuls on or off for the block (the control's precision)."""
    import torch
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


# ----------------------------------------------------------------- clocks --

def process_age_s() -> float:
    """Seconds since this process started, from the kernel's record of its
    start; the host clock since import where that is not readable."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = float(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def percentile(values: Sequence[float], q: int) -> float:
    """The ``q``-th percentile as ``statistics.quantiles(n=100)`` cuts
    it (exclusive method)."""
    return statistics.quantiles(values, n=100)[q - 1]
