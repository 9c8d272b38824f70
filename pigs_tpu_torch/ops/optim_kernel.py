"""One optax Adam step over a list of float32 CUDA tensors: CUDA kernel K6.

K6 (``csrc/adam.cu``) replaces no TPU kernel: the JAX package updates with
optax, which XLA fuses on the TPU.  Its plain twin is
:func:`pigs_tpu_torch.train.optim.adam_update_plain`, the same arithmetic
in per-tensor PyTorch operations, which :func:`~pigs_tpu_torch.train.optim.
adam_update` runs on the CPU and in float64.  On CUDA float32 parameters
``adam_update`` calls :func:`adam_step`, one launch a call: clip by the
global norm, skip a step whose gradients are not all finite, Adam with bias
correction, and the parameters written in place.

The new moments go to fresh flat buffers, one for ``mu`` and one for
``nu``, so the caller's old state stays as it was (a training loop may
keep it to rewind).  They come back as :class:`FlatMoments`, a sequence of
per-parameter views made only when read, so that a step builds no views: a
state of this form with the same layout is read by the next call from its
flat buffer directly.

One cluster of :data:`CLUSTER` blocks runs both passes in one kernel,
whatever the total element count.  ``launches`` counts the wrapper's calls
that launched, ``layout_copies`` the inputs it made contiguous first.
"""

from __future__ import annotations

import ctypes
import functools
from collections.abc import Sequence
from typing import List, Optional, Tuple

import torch

__all__ = ["FlatMoments", "adam_step", "build", "launches", "layout_copies",
           "CLUSTER", "MAX_TENSORS", "THREADS"]

SOURCES = ("adam.cu",)
THREADS = 1024           # a block's threads
CLUSTER = 8              # the blocks of a launch (csrc kCluster)
MAX_TENSORS = 104        # the table K6's parameters hold (csrc kMaxSlots)
MAX_TOTAL = 1 << 30      # the most elements a call takes (int indices)

# Number of K6 calls that launched in this process, and of gradients or
# moments copied to their parameter's layout first.
launches = 0
layout_copies = 0


def build():
    """Build (or load the cached build of) K6; returns ``{"adam":
    BuildInfo}``."""
    return {"adam": _library()[1]}


_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FLOAT = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _library():
    from pigs_tpu_torch.ops._build import load_library
    lib, info = load_library("adam", SOURCES)
    fn = lib.pigs_adam
    fn.argtypes = ([_INT, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _FLOAT, _INT,
                    _FLOAT, _INT] + [_FLOAT] * 5 + [_PTR])
    fn.restype = _INT
    return lib, info


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


class FlatMoments(Sequence):
    """One Adam moment per parameter, in parameter order and shape: views
    of ``flat`` (all moments end to end, ``ends[i]`` the elements up to and
    including moment i), made when read.  ``+`` joins them with a list or
    another sequence of moments into a list, as it joins the per-tensor
    lists."""

    __slots__ = ("flat", "shapes", "ends")

    def __init__(self, flat: torch.Tensor, shapes: Tuple[torch.Size, ...],
                 ends: Tuple[int, ...]):
        self.flat = flat
        self.shapes = shapes
        self.ends = ends

    def __len__(self) -> int:
        return len(self.ends)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        n = len(self.ends)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(f"moment {i} of {n}")
        start = self.ends[i - 1] if i else 0
        return self.flat[start:self.ends[i]].view(self.shapes[i])

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def __add__(self, other):
        if not isinstance(other, (list, FlatMoments)):
            return NotImplemented
        return [*self, *other]

    def __radd__(self, other):
        if not isinstance(other, list):
            return NotImplemented
        return [*other, *self]


def _as_layout(t: torch.Tensor, p: torch.Tensor, index: int, what: str,
               i: int) -> torch.Tensor:
    """``t`` in ``p``'s layout (contiguous), copied if it is not; ``index``
    is the parameters' device index."""
    global layout_copies
    if (t.dtype is not torch.float32 or t.get_device() != index
            or t.shape != p.shape):
        raise ValueError(f"K6: {what} {i} is {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}; its parameter float32 "
                         f"{tuple(p.shape)} on {p.device}")
    if not t.is_contiguous():
        layout_copies += 1
        return t.contiguous()
    return t


def _moment_ptrs(m, params, ends, index: int, what: str,
                 keep: list) -> List[int]:
    """The addresses of each parameter's moment: from the flat buffer of a
    :class:`FlatMoments` of this layout, else tensor by tensor."""
    if (isinstance(m, FlatMoments) and m.ends == ends
            and m.flat.dtype is torch.float32
            and m.flat.get_device() == index):
        base = m.flat.data_ptr()
        return [base] + [base + 4 * e for e in ends[:-1]]
    m = list(m)
    if len(m) != len(params):
        raise ValueError(f"K6: {len(m)} {what} tensors for {len(params)} "
                         "parameters")
    out = [_as_layout(t, p, index, what, i) for i, (t, p) in
           enumerate(zip(m, params))]
    keep.extend(out)
    return [t.data_ptr() for t in out]


def adam_step(params: List[torch.Tensor], grads: List[torch.Tensor], mu,
              nu, count: torch.Tensor, lr, clip_norm: Optional[float],
              skip_nonfinite: bool, b1: float, b2: float, eps: float):
    """One K6 launch: updates ``params`` in place and returns ``(mu, nu,
    count)`` in fresh storage (``mu`` and ``nu`` as :class:`FlatMoments`).
    ``lr`` is a 0-d tensor (read on the device when it lies on the
    parameters' device) or a float."""
    global launches
    n = len(params)
    if not 1 <= n <= MAX_TENSORS:
        raise ValueError(f"K6 takes 1 to {MAX_TENSORS} tensors, not {n}")
    if len(grads) != n:
        raise ValueError(f"K6: {len(grads)} gradients for {n} parameters")
    dev = params[0].device
    index = params[0].get_device()
    keep = []
    table = []
    ends = []
    total = 0
    for i, (p, g) in enumerate(zip(params, grads)):
        if (p.dtype is not torch.float32 or p.get_device() != index
                or not p.is_contiguous()):
            raise ValueError(f"K6: parameter {i} is {p.dtype} on {p.device}"
                             f"{'' if p.is_contiguous() else ', strided'}; "
                             f"K6 takes contiguous float32 on {dev}")
        g = _as_layout(g, p, index, "gradient", i)
        keep.append(g)
        size = p.numel()
        table += (p.data_ptr(), g.data_ptr(), 0, 0, size)
        total += size
        ends.append(total)
    if total > MAX_TOTAL:
        raise ValueError(f"K6 takes at most {MAX_TOTAL} elements, not {total}")
    ends = tuple(ends)
    table[2::5] = _moment_ptrs(mu, params, ends, index, "mu", keep)
    table[3::5] = _moment_ptrs(nu, params, ends, index, "nu", keep)

    if count.dtype is not torch.int32 or count.get_device() != index \
            or count.numel() != 1:
        raise ValueError(f"K6: the count is {count.dtype} "
                         f"{tuple(count.shape)} on {count.device}; K6 takes "
                         f"one int32 on {dev}")
    lr_ptr, lr_value = None, 0.0
    if isinstance(lr, torch.Tensor) and lr.get_device() == index:
        if lr.numel() != 1:
            raise ValueError(f"K6: the learning rate has shape "
                             f"{tuple(lr.shape)}; K6 takes a scalar")
        lr = lr.to(torch.float32)
        keep.append(lr)
        lr_ptr = lr.data_ptr()
    else:
        lr_value = float(lr)

    out = torch.empty(2 * total, dtype=torch.float32, device=dev)
    count_out = torch.empty((), dtype=torch.int32, device=dev)
    err = _library()[0].pigs_adam(
        n, (ctypes.c_longlong * len(table))(*table), out.data_ptr(),
        out.data_ptr() + 4 * total, count.data_ptr(), count_out.data_ptr(),
        lr_ptr, lr_value, int(clip_norm is not None),
        0.0 if clip_norm is None else clip_norm, int(bool(skip_nonfinite)),
        b1, b2, 1.0 - b1, 1.0 - b2, eps, _stream(dev))
    if err != 0:
        raise RuntimeError(f"adam launch failed: cudaError {err}")
    launches += 1
    shapes = tuple(p.shape for p in params)
    return (FlatMoments(out[:total], shapes, ends),
            FlatMoments(out[total:], shapes, ends), count_out)
