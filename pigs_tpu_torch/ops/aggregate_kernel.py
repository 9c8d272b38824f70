"""The fused neighbour aggregation and its backward: CUDA kernels K4 and K5
and their plain twins (port of :mod:`pigs_tpu.ops.pallas_aggregate`).

* K4 (``csrc/aggregate_fwd.cu``) replaces
  ``pigs_tpu/ops/pallas_aggregate.py::_fwd_kernel``: per query Gaussian i the
  masked softmax over every key j and ``out_i = sum_j alpha_ij (W_t f_j) *
  (W_d emb(mu_j - mu_i))``, the neighbourhood rebuilt from the radii on the
  fly.
* K5 (``csrc/aggregate_bwd.cu``) replaces ``_bwd_kernel``: the gradients of
  features, transform, queries, keys, frequencies, distance_transform and
  means (both the query-side and the key-side terms) by full recompute, in
  a statistics pass, a row pass and a column pass over K4's grid, each
  followed by a merge of the slices in a fixed order.

The neighbour rule is the kernel's (:func:`kernel_mask`): a pair (i, j) are
neighbours when ``dist^2 <= cut^2``, ``cut > 0`` and ``i != j``, with
``cut = sigma_cut (r_i + r_j)`` and an inactive Gaussian's radius -inf
(:func:`radii_of`).  ``neighbor_mask`` tests ``sqrt(dist^2) <= cut``
instead, so the two can decide a pair at the threshold differently.  The
decisions are taken in float32 whatever the other inputs' dtype, so that
K4, its float32 twin and its float64 twin see the same pairs.

:func:`aggregate_neighbors_fused` is differentiable through
:class:`_AggregateFused`: on CUDA float32 tensors its forward launches K4
and its backward K5; on CPU tensors the same Function runs the plain twins,
:func:`aggregate_fused_plain` and :func:`aggregate_fused_backward_plain`.
The backward is first order only (``once_differentiable``), as the JAX
backward, a ``pallas_call``, is.  K4 splits the key axis it sums over so
that its grid fills the card at the models' sizes (:func:`fwd_geometry`:
query-row tiles x key slices); a last small pass merges a row's slices in
a fixed order, so it stays deterministic.  K5's passes over pairs take the
same grid (its column pass with columns and rows swapped: the neighbour
rule is symmetric).  On the card nothing gives way to a twin: a failed
build or launch raises.  ``fwd_launches`` and ``bwd_launches`` count the
kernels' launches (one a wrapper call, however many passes it takes) and
nothing else.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from pigs_tpu_torch.ops.aggregate import (_masked_softmax, _wrap,
                                          positional_embedding)
from pigs_tpu_torch.ops.mixture_kernel import (BLOCKS_PER_SM, _ptr, _sm_count,
                                               _split)

__all__ = ["radii_of", "kernel_mask", "aggregate_neighbors_fused",
           "aggregate_fused_plain", "aggregate_fused_backward_plain",
           "build", "fwd_geometry", "fwd_launches", "bwd_launches"]

FWD_SOURCES = ("aggregate_fwd.cu",)
BWD_SOURCES = ("aggregate_bwd.cu",)
L, K, F = 16, 16, 6          # the widths the kernels are built for
WARPS = 4                    # query rows (K4, K5) or key columns per block
KEY_SLICE_UNIT = 32          # K4's key chunk: one ballot, dealt to a slice
RECORD = 2 + L               # K4's (max, sum, acc[L]) of a row in a slice
PAIR_BUDGET = 1 << 26        # embedding entries a twin chunk may hold

# Number of times each CUDA kernel was launched in this process.
fwd_launches = 0   # K4
bwd_launches = 0   # K5


def build():
    """Build (or load the cached builds of) K4 and K5, one ``nvcc`` per
    source, both at once; returns ``{"aggregate_fwd": BuildInfo,
    "aggregate_bwd": BuildInfo}``."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=2) as pool:
        fwd, bwd = pool.submit(_fwd_library), pool.submit(_bwd_library)
        return {"aggregate_fwd": fwd.result()[1],
                "aggregate_bwd": bwd.result()[1]}


_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FLOAT = ctypes.c_float


@functools.lru_cache(maxsize=None)
def _fwd_library():
    from pigs_tpu_torch.ops._build import load_library
    lib, info = load_library("aggregate_fwd", FWD_SOURCES)
    fn = lib.pigs_aggregate_fwd
    fn.argtypes = ([_INT] + [_PTR] * 8 + [_FLOAT, _INT, _FLOAT, _INT]
                   + [_PTR] * 4)
    fn.restype = _INT
    return lib, info


@functools.lru_cache(maxsize=None)
def _bwd_library():
    from pigs_tpu_torch.ops._build import load_library
    lib, info = load_library("aggregate_bwd", BWD_SOURCES)
    fn = lib.pigs_aggregate_bwd
    fn.argtypes = ([_INT] + [_PTR] * 9 + [_FLOAT, _INT, _FLOAT, _INT]
                   + [_PTR] * 9)
    fn.restype = _INT
    lib.pigs_aggregate_bwd_scratch.argtypes = [_INT, _INT]
    lib.pigs_aggregate_bwd_scratch.restype = ctypes.c_longlong
    return lib, info


def radii_of(covariances: torch.Tensor,
             active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Principal std-dev radius ``sqrt(max diag Sigma)`` per Gaussian;
    inactive slots get -inf, so they join no pair."""
    r = torch.sqrt(torch.amax(torch.diagonal(covariances, dim1=-2, dim2=-1),
                              dim=-1))
    if active is not None:
        r = torch.where(active, r, torch.full_like(r, -math.inf))
    return r


# ------------------------------------------------------------ plain twins ----


def kernel_mask(means: torch.Tensor, radii: torch.Tensor,
                sigma_cut: float = 3.0, period: Optional[float] = None,
                rows: Optional[slice] = None) -> torch.Tensor:
    """The kernels' neighbourhood, rows ``rows`` of the ``(n, n)`` mask:
    ``dist^2 <= cut^2 & cut > 0 & i != j``, ``cut = sigma_cut (r_i + r_j)``,
    a non-finite radius read as -1e30; in float32, each operation rounded on
    its own as the kernels round it."""
    rows = rows if rows is not None else slice(0, means.shape[0])
    mu = means.detach().float()
    r = radii.detach().float()
    r = torch.where(torch.isfinite(r), r, torch.full_like(r, -1e30))
    rel = _wrap(mu[None, :, :] - mu[rows, None, :], period)
    dist2 = rel[..., 0] * rel[..., 0] + rel[..., 1] * rel[..., 1]
    cut = sigma_cut * (r[rows, None] + r[None, :])
    ids = torch.arange(means.shape[0], device=means.device)
    return ((dist2 <= cut * cut) & (cut > 0)
            & (ids[rows, None] != ids[None, :]))


def _dense_rows(rows, mapped, queries, keys, frequencies, distance_transform,
                means, mask, period):
    """The dense aggregation of query rows ``rows`` against every key."""
    rel = _wrap(means[None, :, :] - means[rows, None, :], period)
    emb = torch.cat([positional_embedding(rel, frequencies),
                     positional_embedding(2.0 * rel, frequencies)], dim=-1)
    alpha = _masked_softmax(queries[rows], keys, mask)
    gate = torch.einsum("ijE,lE->ijl", emb, distance_transform)
    return torch.einsum("ij,jl,ijl->il", alpha, mapped, gate)


def aggregate_fused_plain(features, transform, queries, keys, frequencies,
                          distance_transform, means, radii,
                          sigma_cut: float = 3.0,
                          period: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of K4: the dense aggregation
    (``ops/aggregate.py::aggregate_neighbors``) with :func:`kernel_mask` as
    its mask, in the inputs' dtype on their device, chunked over query rows
    so that the ``(rows, n, 2E)`` embedding stays under ``PAIR_BUDGET``
    entries.  Differentiable by torch autograd in every input but the
    radii."""
    n = features.shape[0]
    E2 = distance_transform.shape[1]
    chunk = max(1, PAIR_BUDGET // max(n * E2, 1))
    mapped = features @ transform.T
    parts = [features.new_zeros((0, features.shape[1]))]
    for start in range(0, n, chunk):
        rows = slice(start, min(start + chunk, n))
        mask = kernel_mask(means, radii, sigma_cut, period, rows)
        parts.append(_dense_rows(rows, mapped, queries, keys, frequencies,
                                 distance_transform, means, mask, period))
    return torch.cat(parts)


def aggregate_fused_backward_plain(features, transform, queries, keys,
                                   frequencies, distance_transform, means,
                                   radii, cot, sigma_cut: float = 3.0,
                                   period: Optional[float] = None
                                   ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of K5: the gradients of ``sum(out * cot)`` with
    respect to (features, transform, queries, keys, frequencies,
    distance_transform, means), by torch autograd through
    :func:`aggregate_fused_plain`."""
    with torch.enable_grad():
        tin = [x.detach().requires_grad_() for x in
               (features, transform, queries, keys, frequencies,
                distance_transform, means)]
        out = aggregate_fused_plain(*tin, radii, sigma_cut, period)
        return torch.autograd.grad(out, tin, cot, allow_unused=True,
                                   materialize_grads=True)


# ------------------------------------------------------------- launches ----


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _period_args(period):
    return (int(period is not None),
            float(period) if period is not None else 0.0)


def fwd_geometry(n: int, sms: int, blocks_per_sm: int = BLOCKS_PER_SM
                 ) -> Tuple[int, int, int]:
    """K4's grid for n Gaussians: ``(query-row tiles, key slices,
    slice_len)``; a tile is ``WARPS`` rows.  The count of slices follows
    the mixture kernels' rule (``_split``: runs of ``slice_len`` keys, a
    whole number of ``KEY_SLICE_UNIT``), but K4 deals the key axis out in
    chunks of ``KEY_SLICE_UNIT``, slice s taking chunks s, s + slices,
    s + 2 slices, ...; so no slice holds more than ``slice_len`` keys, and
    the models' states, which keep their active Gaussians in the first
    slots, give every slice a share of each row's neighbours."""
    tiles = max(-(-n // WARPS), 1)
    return (tiles, *_split(n, KEY_SLICE_UNIT, tiles, sms, blocks_per_sm))


def _launch_fwd(features, transform, queries, keys, frequencies, dist, means,
                radii, sigma_cut, period, blocks_per_sm=BLOCKS_PER_SM):
    global fwd_launches
    fn = _fwd_library()[0].pigs_aggregate_fwd
    n, dev = features.shape[0], features.device
    _, slices, _ = fwd_geometry(n, _sm_count(dev.index or 0), blocks_per_sm)
    mapped = torch.empty((n, L), dtype=torch.float32, device=dev)
    partials = None
    if slices > 1:
        partials = torch.empty((slices, n, RECORD), dtype=torch.float32,
                               device=dev)
    out = torch.empty((n, L), dtype=torch.float32, device=dev)
    err = fn(n, features.data_ptr(), transform.data_ptr(),
             queries.data_ptr(), keys.data_ptr(), frequencies.data_ptr(),
             dist.data_ptr(), means.data_ptr(), radii.data_ptr(),
             float(sigma_cut), *_period_args(period), slices,
             mapped.data_ptr(), _ptr(partials), out.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"aggregate_fwd launch failed: cudaError {err}")
    fwd_launches += 1
    return out


def _launch_bwd(features, transform, queries, keys, frequencies, dist, means,
                radii, cot, sigma_cut, period, blocks_per_sm=BLOCKS_PER_SM):
    """K5 over :func:`fwd_geometry`'s grid (its statistics, row and column
    passes all take it), with its scratch in one buffer."""
    global bwd_launches
    lib = _bwd_library()[0]
    n, dev = features.shape[0], features.device
    _, slices, _ = fwd_geometry(n, _sm_count(dev.index or 0), blocks_per_sm)
    scratch = torch.empty(lib.pigs_aggregate_bwd_scratch(n, slices),
                          dtype=torch.float32, device=dev)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)
    grads = (empty(n, L), empty(L, L), empty(n, K), empty(n, K), empty(F),
             empty(L, dist.shape[1]), empty(n, 2))
    err = lib.pigs_aggregate_bwd(
        n, features.data_ptr(), transform.data_ptr(), queries.data_ptr(),
        keys.data_ptr(), frequencies.data_ptr(), dist.data_ptr(),
        means.data_ptr(), radii.data_ptr(), cot.data_ptr(), float(sigma_cut),
        *_period_args(period), slices, scratch.data_ptr(),
        *(g.data_ptr() for g in grads), _stream(dev))
    if err != 0:
        raise RuntimeError(f"aggregate_bwd launch failed: cudaError {err}")
    bwd_launches += 1
    return grads


# ------------------------------------------------------------- wrappers ----


class _AggregateFused(torch.autograd.Function):
    """Autograd seam around K4 (forward) and K5 (backward), or their twins
    on CPU tensors.  The radii get no gradient."""

    @staticmethod
    def forward(ctx, features, transform, queries, keys, frequencies, dist,
                means, radii, sigma_cut, period):
        ctx.sigma_cut, ctx.period = sigma_cut, period
        inputs = (features, transform, queries, keys, frequencies, dist,
                  means, radii)
        ctx.save_for_backward(*inputs)
        if features.is_cuda:
            return _launch_fwd(*inputs, sigma_cut, period)
        return aggregate_fused_plain(*inputs, sigma_cut, period)

    @staticmethod
    @once_differentiable
    def backward(ctx, cot):
        inputs = ctx.saved_tensors
        cot = cot.to(inputs[0].dtype).contiguous()
        if cot.is_cuda:
            grads = _launch_bwd(*inputs, cot, ctx.sigma_cut, ctx.period)
        else:
            grads = aggregate_fused_backward_plain(*inputs, cot,
                                                   ctx.sigma_cut, ctx.period)
        need = ctx.needs_input_grad
        return (*(g if need[k] else None for k, g in enumerate(grads)),
                None, None, None)


def _check_cuda(tensors: dict):
    """Raise on anything K4/K5 do not take."""
    n = tensors["features"].shape[0]
    E2 = 2 * (1 + 2 * F * 2)
    shapes = {"features": (n, L), "transform": (L, L), "queries": (n, K),
              "keys": (n, K), "frequencies": (F,),
              "distance_transform": (L, E2), "means": (n, 2), "radii": (n,)}
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"aggregate_neighbors_fused: {name} is {t.dtype}; "
                            "the kernels take float32 (impl='plain' runs the "
                            "plain version in any dtype)")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"aggregate_neighbors_fused: {name} has shape "
                             f"{tuple(t.shape)}, the kernels take "
                             f"{shapes[name]} (L=K=16, F=6, d=2)")


def aggregate_neighbors_fused(features, transform, queries, keys, frequencies,
                              distance_transform, means, radii,
                              sigma_cut: float = 3.0,
                              period: Optional[float] = None,
                              impl: str = "auto") -> torch.Tensor:
    """Fused neighbour aggregation with the signature of
    ``aggregate_neighbors_pallas``: equivalent to ``aggregate_neighbors``
    with the mask of :func:`kernel_mask` (``radii`` from :func:`radii_of`).
    d=2 only.

    ``impl="auto"``: K4 (backward K5) on CUDA float32 tensors, the plain
    twins on CPU tensors, through one autograd Function.  ``impl="plain"``:
    :func:`aggregate_fused_plain` on any device and dtype, differentiated by
    torch autograd.  Anything else raises, CUDA float64 under "auto"
    included."""
    if means.shape[-1] != 2:
        raise ValueError("aggregate_neighbors_fused supports d=2 only")
    args = (features, transform, queries, keys, frequencies,
            distance_transform, means, radii)
    if impl == "plain":
        return aggregate_fused_plain(*args, sigma_cut, period)
    if impl != "auto":
        raise ValueError(f"unknown impl {impl!r}")
    names = ("features", "transform", "queries", "keys", "frequencies",
             "distance_transform", "means", "radii")
    tensors = dict(zip(names, args))
    devices = {t.device for t in args}
    if len(devices) != 1:
        raise ValueError(f"aggregate_neighbors_fused: inputs on several "
                         f"devices {devices}")
    device = devices.pop()
    if device.type == "cuda":
        _check_cuda(tensors)
        if features.shape[0] == 0:
            return features.new_zeros((0, L))
    elif device.type != "cpu":
        raise ValueError(f"aggregate_neighbors_fused: no kernel for device "
                         f"{device}")
    return _AggregateFused.apply(*(t.contiguous() for t in args), sigma_cut,
                                 period)
