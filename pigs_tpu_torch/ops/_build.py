"""Build the package's CUDA sources at first use and load them with ctypes.

Each library is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
object with a plain C interface, under ``build/pigs_tpu_torch/`` at the root
of the checkout, named by a hash of its sources and flags, so an edited
source builds anew and an unchanged one loads at once.  Only the sources in
``ops/csrc/`` are compiled; the headers there (``*.cuh``) count towards every
hash, since any source may include them.  The compiler's report (ptxas's
registers and spills) is kept beside each library as ``<library>.log``, so
a cached build reports it too.  A failed build raises with the compiler's
output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from typing import NamedTuple

__all__ = ["load_library", "BuildInfo"]

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "pigs_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class BuildInfo(NamedTuple):
    """What one build did: the library path, whether it compiled now, the
    seconds it took, and the compiler's report (registers, shared memory)."""

    path: str
    compiled: bool
    seconds: float
    log: str


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: building the CUDA kernels needs the "
                       "CUDA toolkit (PATH or CUDA_HOME)")


@functools.lru_cache(maxsize=None)
def load_library(name: str, sources: tuple) -> tuple:
    """Compile ``sources`` (file names in ``csrc/``) into ``lib<name>`` if no
    build of this exact content exists, load it, and return
    ``(ctypes.CDLL, BuildInfo)``."""
    paths = [os.path.join(CSRC, s) for s in sources]
    headers = sorted(os.path.join(CSRC, h) for h in os.listdir(CSRC)
                     if h.endswith(".cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths + headers:
        with open(p, "rb") as f:
            digest.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    log_path = f"{out}.log"
    compiled = False
    t0 = time.perf_counter()
    if not (os.path.exists(out) and os.path.exists(log_path)):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *paths]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed building {name} "
                               f"(rc {proc.returncode}):\n{log}")
        # The report first: a library on disk always has its report.
        with open(f"{log_path}.{os.getpid()}.tmp", "w") as f:
            f.write(log)
        os.replace(f"{log_path}.{os.getpid()}.tmp", log_path)
        os.replace(tmp, out)
        compiled = True
    with open(log_path) as f:
        log = f.read()
    lib = ctypes.CDLL(out)
    return lib, BuildInfo(out, compiled, time.perf_counter() - t0, log)
