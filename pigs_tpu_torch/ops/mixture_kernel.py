"""The fused 2D mixture and its backward: CUDA kernels K1-K3 and their plain
twins.

* K1 (``csrc/mixture_fwd.cu``) replaces
  ``pigs_tpu/ops/pallas_mixture.py::_fwd_kernel``.  Inputs are
  ``samples (m, 2)``, ``means (n, 2)``, packed conics ``(n, 3)`` =
  ``[cxx, cxy, cyy]`` and ``values (n, c)`` with any mask already folded in;
  the outputs are the packed fields ``(m, c)``, ``(m, 2c)``, ``(m, 3c)``,
  ``(m, 4c)`` up to ``order``.
* K2 (``csrc/mixture_bwd.cu``) replaces ``_bwd_gauss_kernel``: from the
  packed cotangents of those outputs, the gradients of the means ``(n, 2)``,
  the packed conics ``(n, 3)`` and the values ``(n, c)``.
* K3 (same file) replaces ``_bwd_sample_kernel``: the gradient of the
  samples ``(m, 2)``.

:func:`mixture_forward` is differentiable through :class:`_MixtureForward`.
On CUDA tensors its forward launches K1 and its backward K2 (when means,
conics or values need a gradient) and K3 (only when the samples need one,
PyTorch's form of the JAX package's ``diff_samples``).  On CPU tensors the
same Function runs the plain twins, :func:`mixture_forward_plain`,
:func:`mixture_backward_gauss_plain` and :func:`mixture_backward_sample_plain`,
which compute the same hand-derived adjoint.  Anything else raises.

The backward is itself differentiable: when a second-order gradient is
asked for (``create_graph=True``), it runs as :class:`_MixtureBackward`,
whose forward is the same K2/K3 call and whose own backward differentiates
the dense oracle's vjp of the packed mapping again, in torch ops on the
primals' device and dtype (the JAX package's ``_bwd_op_bwd``, plain AD of
the dense oracle, not a kernel).  Past
:data:`SECOND_ORDER_PAIR_BUDGET` sample-Gaussian pairs it runs over sample
chunks.  Without ``create_graph`` the backward calls the kernels directly.

Each kernel splits the axis it sums over so that the grid fills the card
at the main path's small shapes: K1 and K3 cut the Gaussians into slices
(:func:`fwd_geometry`: sample tiles x Gaussian slices), K2 the samples
(:func:`gauss_geometry`: Gaussian tiles x sample slices).  A second pass
adds the slices in a fixed order, so all three stay deterministic.
``launches``, ``bwd_gauss_launches`` and ``bwd_sample_launches`` count the
kernels' launches (one per wrapper call, the second pass included) and
nothing else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import torch
from pigs_tpu_torch.ops.oracle import MixtureFields, eval_mixture_dense

__all__ = ["mixture_forward", "mixture_forward_plain",
           "mixture_backward_gauss", "mixture_backward_gauss_plain",
           "mixture_backward_sample", "mixture_backward_sample_plain",
           "eval_mixture_fused", "pack_conics", "unpack_fields", "build",
           "fwd_geometry", "gauss_geometry", "launches",
           "SECOND_ORDER_PAIR_BUDGET",
           "bwd_gauss_launches", "bwd_sample_launches"]

GROUP_SIZES = (1, 2, 3, 4)   # packed components per derivative order
FWD_SOURCES = ("mixture_fwd.cu",)
BWD_SOURCES = ("mixture_bwd.cu",)
THREADS = 128                # samples per K1/K3 block, Gaussians per K2 block
FWD_SLICE_UNIT = 8           # K1/K3 Gaussian slices: whole numbers of these
BWD_SLICE_UNIT = 32          # K2's sample slices: whole numbers of these
BLOCKS_PER_SM = 6            # the grid the slicing aims for (at least 2)
# Most sample-Gaussian pairs one dense second-order vjp may hold at once
# (~30 (m, n) intermediates: ~1 GB in float32); past it, sample chunks.
SECOND_ORDER_PAIR_BUDGET = 1 << 23

# Number of times each CUDA kernel was launched in this process.
launches = 0             # K1
bwd_gauss_launches = 0   # K2
bwd_sample_launches = 0  # K3


def build():
    """Build (or load the cached builds of) K1 and K2/K3, one ``nvcc`` per
    source, both at once; returns their ``BuildInfo``s as
    ``{"mixture_fwd": ..., "mixture_bwd": ...}``."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=2) as pool:
        fwd, bwd = pool.submit(_fwd_library), pool.submit(_bwd_library)
        return {"mixture_fwd": fwd.result()[1],
                "mixture_bwd": bwd.result()[1]}


_PTR = ctypes.c_void_p
_INT = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _fwd_library():
    from pigs_tpu_torch.ops._build import load_library
    lib, info = load_library("mixture_fwd", FWD_SOURCES)
    fn = lib.pigs_mixture_fwd
    fn.argtypes = [_INT, _INT, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT,
                   _INT, ctypes.c_float, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR]
    fn.restype = _INT
    return lib, info


@functools.lru_cache(maxsize=None)
def _bwd_library():
    from pigs_tpu_torch.ops._build import load_library
    lib, info = load_library("mixture_bwd", BWD_SOURCES)
    gauss = lib.pigs_mixture_bwd_gauss
    gauss.argtypes = [_INT, _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                      _PTR, _INT, _INT, _INT, _INT, _INT, ctypes.c_float,
                      _PTR, _PTR, _PTR]
    gauss.restype = _INT
    sample = lib.pigs_mixture_bwd_sample
    sample.argtypes = [_INT, _INT, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR,
                       _PTR, _INT, _INT, _INT, _INT, _INT, ctypes.c_float,
                       _PTR, _PTR, _PTR]
    sample.restype = _INT
    return lib, info


# ------------------------------------------------------------ plain twins ----


def _geometry(smp, means, conics_packed, period):
    """Per-pair displacements, p = C delta and the density for a sample chunk:
    each ``(chunk, n)``; the conic entries broadcast as ``(1, n)``."""
    cxx, cxy, cyy = (conics_packed[None, :, k] for k in range(3))
    dx = smp[:, 0:1] - means[None, :, 0]
    dy = smp[:, 1:2] - means[None, :, 1]
    if period is not None:
        dx = dx - period * torch.round(dx * (1.0 / period))
        dy = dy - period * torch.round(dy * (1.0 / period))
    px = cxx * dx + cxy * dy
    py = cxy * dx + cyy * dy
    g = torch.exp(-0.5 * (dx * px + dy * py))
    return dx, dy, px, py, g, cxx, cxy, cyy


def _weights(geom, order: int):
    """The packed output weights W_k = P_k(p, C) * g, in output order."""
    dx, dy, px, py, g, cxx, cxy, cyy = geom
    w = [g]
    if order >= 1:
        w += [-px * g, -py * g]
    if order >= 2:
        w += [(px * px - cxx) * g, (px * py - cxy) * g, (py * py - cyy) * g]
    if order >= 3:
        w += [(3.0 * cxx * px - px * px * px) * g,
              (cxx * py + 2.0 * cxy * px - px * px * py) * g,
              (cyy * px + 2.0 * cxy * py - px * py * py) * g,
              (3.0 * cyy * py - py * py * py) * g]
    return w


def _adjoint_fields(geom, rs, order: int):
    """The hand-derived adjoint of ``pallas_mixture.py::_adjoint_fields``.

    With ``rs[k] = r_k(j, i) = sum_c cot_k[j, c] v[i, c]`` and the pair term
    T = sum_k r_k W_k, returns the fields E = dT/d(dx, dy, cxx, cxy, cyy)
    and A g = T.  Gaussian-parameter gradients are their column sums (means
    with a sign flip), sample gradients the row sums of (E_dx, E_dy).
    """
    dx, dy, px, py, g, cxx, cxy, cyy = geom
    A = rs[0]
    Q = R = Dxx = Dxy = Dyy = 0.0
    if order >= 1:
        r_x, r_y = rs[1], rs[2]
        Q = Q - r_x
        R = R - r_y
        A = A - px * r_x - py * r_y
    if order >= 2:
        r_xx, r_xy, r_yy = rs[3], rs[4], rs[5]
        Q = Q + 2.0 * px * r_xx + py * r_xy
        R = R + px * r_xy + 2.0 * py * r_yy
        A = A + ((px * px - cxx) * r_xx + (px * py - cxy) * r_xy
                 + (py * py - cyy) * r_yy)
        Dxx = Dxx - r_xx
        Dxy = Dxy - r_xy
        Dyy = Dyy - r_yy
    if order >= 3:
        r_xxx, r_xxy, r_xyy, r_yyy = rs[6:10]
        Q = Q + ((3.0 * cxx - 3.0 * px * px) * r_xxx
                 + (2.0 * cxy - 2.0 * px * py) * r_xxy
                 + (cyy - py * py) * r_xyy)
        R = R + ((cxx - px * px) * r_xxy
                 + (2.0 * cxy - 2.0 * px * py) * r_xyy
                 + (3.0 * cyy - 3.0 * py * py) * r_yyy)
        A = A + ((3.0 * cxx * px - px * px * px) * r_xxx
                 + (cxx * py + 2.0 * cxy * px - px * px * py) * r_xxy
                 + (cyy * px + 2.0 * cxy * py - px * py * py) * r_xyy
                 + (3.0 * cyy * py - py * py * py) * r_yyy)
        Dxx = Dxx + 3.0 * px * r_xxx + py * r_xxy
        Dxy = Dxy + 2.0 * px * r_xxy + 2.0 * py * r_xyy
        Dyy = Dyy + px * r_xyy + 3.0 * py * r_yyy
    E_dx = g * (Q * cxx + R * cxy - A * px)
    E_dy = g * (Q * cxy + R * cyy - A * py)
    E_cxx = g * (Q * dx + Dxx - 0.5 * A * dx * dx)
    E_cxy = g * (Q * dy + R * dx + Dxy - A * dx * dy)
    E_cyy = g * (R * dy + Dyy - 0.5 * A * dy * dy)
    return E_dx, E_dy, E_cxx, E_cxy, E_cyy, A * g


def _split_cotangents(cots: Sequence[torch.Tensor], c: int, order: int):
    """Packed cotangent groups ``(m, G*c)`` -> the per-component ``(m, c)``
    list in output order."""
    comps = []
    for cb, gsize in zip(cots[:order + 1], GROUP_SIZES):
        comps += [cb[:, k * c:(k + 1) * c] for k in range(gsize)]
    return comps


def mixture_forward_plain(means, conics_packed, values, samples, order: int,
                          period: Optional[float] = None,
                          sample_chunk: int = 1024) -> List[torch.Tensor]:
    """Plain PyTorch version of K1: the same packed outputs, computed in the
    inputs' dtype on their device, ``sample_chunk`` samples at a time."""
    c = values.shape[1]
    groups = GROUP_SIZES[:order + 1]
    if samples.shape[0] == 0:
        return [samples.new_zeros((0, gsize * c)) for gsize in groups]
    outs = [[] for _ in groups]
    for smp in torch.split(samples, sample_chunk):
        geom = _geometry(smp, means, conics_packed, period)
        w = torch.stack(_weights(geom, order))
        res = torch.matmul(w, values)                     # (K, chunk, c)
        row = 0
        for slot, gsize in zip(outs, groups):
            slot.append(res[row:row + gsize].permute(1, 0, 2)
                        .reshape(-1, gsize * c))
            row += gsize
    return [torch.cat(parts) for parts in outs]


def mixture_backward_gauss_plain(means, conics_packed, values, samples, cots,
                                 order: int, period: Optional[float] = None,
                                 sample_chunk: int = 1024
                                 ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch version of K2: ``(gm (n, 2), gc (n, 3), gv (n, c))``
    from the packed cotangents ``cots``, column sums of the adjoint fields
    over ``sample_chunk`` samples at a time."""
    n, c = means.shape[0], values.shape[1]
    gm = means.new_zeros((n, 2))
    gc = means.new_zeros((n, 3))
    gv = means.new_zeros((n, c))
    comps = _split_cotangents(cots, c, order)
    for start in range(0, samples.shape[0], sample_chunk):
        stop = start + sample_chunk
        geom = _geometry(samples[start:stop], means, conics_packed, period)
        chunk = [cc[start:stop] for cc in comps]
        rs = [cc @ values.T for cc in chunk]              # r_k (chunk, n)
        E_dx, E_dy, E_cxx, E_cxy, E_cyy, _ = _adjoint_fields(geom, rs, order)
        gm = gm + torch.stack([-E_dx.sum(0), -E_dy.sum(0)], dim=-1)
        gc = gc + torch.stack([E_cxx.sum(0), E_cxy.sum(0), E_cyy.sum(0)],
                              dim=-1)
        for w, cc in zip(_weights(geom, order), chunk):
            gv = gv + w.T @ cc
    return gm, gc, gv


def mixture_backward_sample_plain(means, conics_packed, values, samples, cots,
                                  order: int, period: Optional[float] = None,
                                  sample_chunk: int = 1024) -> torch.Tensor:
    """Plain PyTorch version of K3: ``gx (m, 2)``, row sums of the adjoint
    fields E_dx, E_dy."""
    c = values.shape[1]
    comps = _split_cotangents(cots, c, order)
    parts = [samples.new_zeros((0, 2))]
    for start in range(0, samples.shape[0], sample_chunk):
        stop = start + sample_chunk
        geom = _geometry(samples[start:stop], means, conics_packed, period)
        rs = [cc[start:stop] @ values.T for cc in comps]
        E_dx, E_dy, *_ = _adjoint_fields(geom, rs, order)
        parts.append(torch.stack([E_dx.sum(1), E_dy.sum(1)], dim=-1))
    return torch.cat(parts)


# ------------------------------------------------------------- launches ----


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _period_args(period):
    return (int(period is not None),
            float(period) if period is not None else 0.0)


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _split(length: int, unit: int, tiles: int, sms: int,
           blocks_per_sm: int) -> Tuple[int, int]:
    """``(slices, slice_len)`` cutting an axis of ``length`` so that
    ``tiles`` blocks per slice make a grid of at least ``blocks_per_sm``
    blocks per SM where the axis allows: every slice but the last a whole
    number of ``unit``; one slice when the tiles alone fill the card."""
    want = -(-blocks_per_sm * sms // max(tiles, 1))
    if want <= 1:
        return 1, max(length, 1)
    slice_len = max(unit, length // want // unit * unit)
    return max(-(-length // slice_len), 1), slice_len


def fwd_geometry(m: int, n: int, sms: int,
                 blocks_per_sm: int = BLOCKS_PER_SM) -> Tuple[int, int, int]:
    """K1's and K3's grid for m samples over n Gaussians: ``(sample tiles,
    Gaussian slices, slice_len)``; a tile is ``THREADS`` samples."""
    tiles = max(-(-m // THREADS), 1)
    return (tiles, *_split(n, FWD_SLICE_UNIT, tiles, sms, blocks_per_sm))


def gauss_geometry(m: int, n: int, sms: int,
                   blocks_per_sm: int = BLOCKS_PER_SM) -> Tuple[int, int, int]:
    """K2's grid for m samples over n Gaussians: ``(Gaussian tiles, sample
    slices, slice_len)``; a tile is ``THREADS`` Gaussians."""
    tiles = max(-(-n // THREADS), 1)
    return (tiles, *_split(m, BWD_SLICE_UNIT, tiles, sms, blocks_per_sm))


def _launch_fwd(means, conics_packed, values, samples, order, period,
                blocks_per_sm=BLOCKS_PER_SM):
    global launches
    fn = _fwd_library()[0].pigs_mixture_fwd
    m, n, c = samples.shape[0], means.shape[0], values.shape[1]
    dev = samples.device
    _, slices, slice_len = fwd_geometry(m, n, _sm_count(dev.index or 0),
                                        blocks_per_sm)
    outs = [torch.empty((m, gsize * c), dtype=torch.float32, device=dev)
            for gsize in GROUP_SIZES[:order + 1]]
    partials = None
    if slices > 1:
        comps = sum(GROUP_SIZES[:order + 1]) * c
        partials = torch.empty((slices, comps, m), dtype=torch.float32,
                               device=dev)
    ptrs = [o.data_ptr() for o in outs] + [None] * (4 - len(outs))
    err = fn(order, c, samples.data_ptr(), means.data_ptr(),
             conics_packed.data_ptr(), values.data_ptr(), m, n, slices,
             slice_len, *_period_args(period), *ptrs, _ptr(partials),
             _stream(dev))
    if err != 0:
        raise RuntimeError(f"mixture_fwd launch failed: cudaError {err}")
    launches += 1
    return outs


def _cot_args(cots, order):
    ptrs = [_ptr(cb) for cb in cots[:order + 1]]
    return ptrs + [None] * (4 - len(ptrs))


def _launch_bwd_gauss(means, conics_packed, values, samples, cots, order,
                      period, blocks_per_sm=BLOCKS_PER_SM):
    global bwd_gauss_launches
    fn = _bwd_library()[0].pigs_mixture_bwd_gauss
    m, n, c = samples.shape[0], means.shape[0], values.shape[1]
    dev = samples.device
    _, slices, slice_len = gauss_geometry(m, n, _sm_count(dev.index or 0),
                                          blocks_per_sm)
    partials = None
    if slices > 1:
        partials = torch.empty((slices, 5 + c, n), dtype=torch.float32,
                               device=dev)
    out = torch.empty((n, 5 + c), dtype=torch.float32, device=dev)
    err = fn(order, c, samples.data_ptr(), means.data_ptr(),
             conics_packed.data_ptr(), values.data_ptr(),
             *_cot_args(cots, order), m, n, slices, slice_len,
             *_period_args(period), _ptr(partials), out.data_ptr(),
             _stream(dev))
    if err != 0:
        raise RuntimeError(f"mixture_bwd_gauss launch failed: cudaError {err}")
    bwd_gauss_launches += 1
    return out[:, :2], out[:, 2:5], out[:, 5:]


def _launch_bwd_sample(means, conics_packed, values, samples, cots, order,
                       period, blocks_per_sm=BLOCKS_PER_SM):
    global bwd_sample_launches
    fn = _bwd_library()[0].pigs_mixture_bwd_sample
    m, n, c = samples.shape[0], means.shape[0], values.shape[1]
    dev = samples.device
    _, slices, slice_len = fwd_geometry(m, n, _sm_count(dev.index or 0),
                                        blocks_per_sm)
    partials = None
    if slices > 1:
        partials = torch.empty((slices, 2, m), dtype=torch.float32,
                               device=dev)
    gx = torch.empty((m, 2), dtype=torch.float32, device=dev)
    err = fn(order, c, samples.data_ptr(), means.data_ptr(),
             conics_packed.data_ptr(), values.data_ptr(),
             *_cot_args(cots, order), m, n, slices, slice_len,
             *_period_args(period), _ptr(partials), gx.data_ptr(),
             _stream(dev))
    if err != 0:
        raise RuntimeError(
            f"mixture_bwd_sample launch failed: cudaError {err}")
    bwd_sample_launches += 1
    return gx


# ------------------------------------------------------------- wrappers ----


def _check_inputs(fname, means, conics_packed, values, samples, order,
                  cots=None):
    """The one device of the inputs; on CUDA, raise on anything the kernels
    do not take."""
    tensors = {"means": means, "conics_packed": conics_packed,
               "values": values, "samples": samples}
    if cots is not None:
        tensors.update({f"cots[{k}]": cb for k, cb in
                        enumerate(cots[:order + 1])})
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{fname}: inputs on several devices {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"{fname}: no kernel for device {device}")
    m, n, c = samples.shape[0], means.shape[0], values.shape[1]
    shapes = {"means": (n, 2), "conics_packed": (n, 3), "values": (n, c),
              "samples": (m, 2)}
    if cots is not None:
        shapes.update({f"cots[{k}]": (m, gsize * c) for k, gsize in
                       enumerate(GROUP_SIZES[:order + 1])})
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{fname}: {name} is {t.dtype}, the kernel "
                            "takes float32")
        if t.dim() != 2 or tuple(t.shape) != shapes[name]:
            raise ValueError(f"{fname}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shapes[name]} (d=2)")
        if not t.is_contiguous():
            raise ValueError(f"{fname}: {name} is not contiguous")
    if c not in (1, 2) or order not in (0, 1, 2, 3):
        raise ValueError(f"{fname}: no kernel for c={c}, order={order}")
    return device


def mixture_backward_gauss(means, conics_packed, values, samples, cots,
                           order: int, period: Optional[float] = None):
    """Gradients ``(gm (n, 2), gc (n, 3), gv (n, c))`` of the packed K1
    outputs' cotangents ``cots``: K2 on CUDA tensors, the plain twin on CPU
    tensors."""
    device = _check_inputs("mixture_backward_gauss", means, conics_packed,
                           values, samples, order, cots)
    if device.type == "cpu":
        return mixture_backward_gauss_plain(means, conics_packed, values,
                                            samples, cots, order, period)
    if samples.shape[0] == 0:
        return (means.new_zeros((means.shape[0], 2)),
                means.new_zeros((means.shape[0], 3)), torch.zeros_like(values))
    return _launch_bwd_gauss(means, conics_packed, values, samples, cots,
                             order, period)


def mixture_backward_sample(means, conics_packed, values, samples, cots,
                            order: int, period: Optional[float] = None):
    """Gradient ``gx (m, 2)`` of the samples: K3 on CUDA tensors, the plain
    twin on CPU tensors."""
    device = _check_inputs("mixture_backward_sample", means, conics_packed,
                           values, samples, order, cots)
    if device.type == "cpu":
        return mixture_backward_sample_plain(means, conics_packed, values,
                                             samples, cots, order, period)
    return _launch_bwd_sample(means, conics_packed, values, samples, cots,
                              order, period)


def _first_order(means, conics_packed, values, samples, cots, order,
                 period, need_gauss, need_sample):
    """``(gm, gc, gv, gx)``: K2 when ``need_gauss``, K3 when
    ``need_sample`` (their plain twins on the CPU); None where not asked."""
    gm = gc = gv = gx = None
    if need_gauss:
        gm, gc, gv = mixture_backward_gauss(means, conics_packed, values,
                                            samples, cots, order, period)
    if need_sample:
        gx = mixture_backward_sample(means, conics_packed, values, samples,
                                     cots, order, period)
    return gm, gc, gv, gx


def _dense_packed(means, conics_packed, values, samples, order, period):
    """The dense oracle as a function of the packed conics, read as
    ``[[cxx, cxy], [cxy, cyy]]``, with its outputs packed as K1 packs them.
    Its vjp is K2's and K3's: the packed ``cxy`` appears in both
    off-diagonal places, so its gradient is C01 + C10."""
    cxx, cxy, cyy = conics_packed.unbind(-1)
    full = torch.stack([torch.stack([cxx, cxy], -1),
                        torch.stack([cxy, cyy], -1)], -2)
    out = eval_mixture_dense(means, full, values, samples, order=order,
                             period=period)
    m, c = samples.shape[0], values.shape[1]
    packed = [out.u]
    if order >= 1:
        packed.append(out.ux.reshape(m, 2 * c))
    if order >= 2:
        h = out.uxx
        packed.append(torch.stack([h[:, 0, 0], h[:, 0, 1], h[:, 1, 1]], 1)
                      .reshape(m, 3 * c))
    if order >= 3:
        t = out.uxxx
        packed.append(torch.stack([t[:, 0, 0, 0], t[:, 0, 0, 1],
                                   t[:, 0, 1, 1], t[:, 1, 1, 1]], 1)
                      .reshape(m, 4 * c))
    return packed


def _double_vjp(primals, cots, order, period, need_gauss, need_sample,
                grads):
    """The vjp of the first-order map (primals, cots) -> (gm, gc, gv, gx)
    against ``grads`` (None where that gradient was not formed), through the
    dense oracle: cotangents of the four primals and of every cotangent."""
    with torch.enable_grad():
        prim = [t.detach().requires_grad_() for t in primals]
        cot = [t.detach().requires_grad_() for t in cots]
        outs = _dense_packed(*prim, order, period)
        wanted = [need_gauss] * 3 + [need_sample]
        firsts = torch.autograd.grad(
            outs, [p for p, w in zip(prim, wanted) if w], cot,
            create_graph=True)
        pairs = [(f, g) for f, g in zip(
            firsts, [g for g, w in zip(grads, wanted) if w]) if g is not None]
        res = torch.autograd.grad([f for f, _ in pairs], prim + cot,
                                  [g for _, g in pairs], allow_unused=True)
    return [torch.zeros_like(t) if r is None else r
            for r, t in zip(res, prim + cot)]


class _MixtureBackward(torch.autograd.Function):
    """The first-order backward as a differentiable op (the JAX package's
    ``_bwd_op``): its forward is K2 (and K3) on CUDA, the plain twins on
    the CPU; its backward is the dense oracle's vjp differentiated again
    (``_bwd_op_bwd``), over sample chunks of ``max(budget // n, 1)`` rows
    past :data:`SECOND_ORDER_PAIR_BUDGET` pairs: the shared primals'
    cotangents summed, the samples' and the cotangents' concatenated."""

    @staticmethod
    def forward(ctx, means, conics_packed, values, samples, order, period,
                need_gauss, need_sample, *cots):
        ctx.args = (order, period, need_gauss, need_sample)
        ctx.save_for_backward(means, conics_packed, values, samples, *cots)
        return _first_order(means, conics_packed, values, samples, cots,
                            order, period, need_gauss, need_sample)

    @staticmethod
    def backward(ctx, *grads):
        order, period, need_gauss, need_sample = ctx.args
        means, conics_packed, values, samples, *cots = ctx.saved_tensors
        m, n = samples.shape[0], means.shape[0]
        chunk = m if m * n <= SECOND_ORDER_PAIR_BUDGET else max(
            SECOND_ORDER_PAIR_BUDGET // n, 1)
        shared, rows = None, []
        for start in range(0, m, chunk):
            stop = start + chunk
            gx = grads[3] if grads[3] is None else grads[3][start:stop]
            res = _double_vjp(
                (means, conics_packed, values, samples[start:stop]),
                [cb[start:stop] for cb in cots], order, period, need_gauss,
                need_sample, (*grads[:3], gx))
            shared = res[:3] if shared is None else [
                a + b for a, b in zip(shared, res[:3])]
            rows.append(res[3:])
        if shared is None:       # no samples: every gradient is zero
            return (None,) * (8 + len(cots))
        per_row = [torch.cat(parts) for parts in zip(*rows)]
        return (*shared, per_row[0], None, None, None, None, *per_row[1:])


class _MixtureForward(torch.autograd.Function):
    """Autograd seam around K1: the forward runs K1 (or its twin on the CPU),
    the backward K2 and, when the samples need a gradient, K3.

    The Function's outputs are the packed fields, so autograd through
    :func:`unpack_fields` already sums the cotangents of the symmetric
    positions into the packed components, as the JAX package's
    ``_pack_cotangents`` does; a field nobody used arrives as zeros.  Under
    ``create_graph=True`` the backward runs as :class:`_MixtureBackward`,
    so that it can be differentiated again; otherwise it calls the kernels
    directly.
    """

    @staticmethod
    def forward(ctx, means, conics_packed, values, samples, order, period):
        ctx.order, ctx.period = order, period
        ctx.save_for_backward(means, conics_packed, values, samples)
        if samples.is_cuda:
            return tuple(_launch_fwd(means, conics_packed, values, samples,
                                     order, period))
        return tuple(mixture_forward_plain(means, conics_packed, values,
                                           samples, order, period))

    @staticmethod
    def backward(ctx, *grads):
        means, conics_packed, values, samples = ctx.saved_tensors
        cots = [g.to(samples.dtype).contiguous() for g in grads]
        need = ctx.needs_input_grad
        args = (ctx.order, ctx.period, any(need[:3]), need[3])
        if torch.is_grad_enabled():
            gm, gc, gv, gx = _MixtureBackward.apply(
                means, conics_packed, values, samples, *args, *cots)
        else:
            gm, gc, gv, gx = _first_order(means, conics_packed, values,
                                          samples, cots, *args)
        return (gm if need[0] else None, gc if need[1] else None,
                gv if need[2] else None, gx, None, None)


def mixture_forward(means, conics_packed, values, samples, order: int,
                    period: Optional[float] = None) -> List[torch.Tensor]:
    """Packed mixture outputs up to ``order``, differentiable with respect to
    every tensor input: K1 (backward K2/K3) on CUDA tensors, the plain twins
    on CPU tensors.

    On CUDA the inputs must be contiguous float32 with ``samples (m, 2)``,
    ``means (n, 2)``, ``conics_packed (n, 3)``, ``values (n, c)``, c in {1, 2},
    order 0..3, all on one device.  Anything else raises.
    """
    _check_inputs("mixture_forward", means, conics_packed, values, samples,
                  order)
    return list(_MixtureForward.apply(means, conics_packed, values, samples,
                                      order, period))


def pack_conics(conics_full: torch.Tensor) -> torch.Tensor:
    """``(n, 2, 2)`` -> ``(n, 3)`` = ``[cxx, cxy, cyy]``.  A gradient of the
    packed ``cxy`` flows to ``C[0, 1]`` only."""
    return torch.stack([conics_full[:, 0, 0], conics_full[:, 0, 1],
                        conics_full[:, 1, 1]], dim=-1)


def unpack_fields(outs, m: int, c: int, order: int) -> MixtureFields:
    """Packed outputs -> full symmetric field tensors."""
    u = outs[0]
    ux = uxx = uxxx = None
    if order >= 1:
        ux = outs[1].reshape(m, 2, c)
    if order >= 2:
        p = outs[2].reshape(m, 3, c)
        uxx = torch.stack([
            torch.stack([p[:, 0], p[:, 1]], dim=1),
            torch.stack([p[:, 1], p[:, 2]], dim=1),
        ], dim=1)
    if order >= 3:
        q = outs[3].reshape(m, 4, c)
        uxxx = torch.stack([
            torch.stack([torch.stack([q[:, 0], q[:, 1]], dim=1),
                         torch.stack([q[:, 1], q[:, 2]], dim=1)], dim=1),
            torch.stack([torch.stack([q[:, 1], q[:, 2]], dim=1),
                         torch.stack([q[:, 2], q[:, 3]], dim=1)], dim=1),
        ], dim=1)
    return MixtureFields(u=u, ux=ux, uxx=uxx, uxxx=uxxx)


def eval_mixture_fused(means, conics, values, samples, order: int = 0,
                       mask: Optional[torch.Tensor] = None,
                       period: Optional[float] = None) -> MixtureFields:
    """The fused path with the oracle's contract (d=2): full ``(n, 2, 2)``
    conics in, full field tensors out."""
    if means.shape[1] != 2:
        raise ValueError("eval_mixture_fused supports d=2 only")
    if mask is not None:
        # Masked Gaussians contribute exactly zero to every output.
        values = values * mask.to(values.dtype)[:, None]
    outs = mixture_forward(means.contiguous(), pack_conics(conics).contiguous(),
                           values.contiguous(), samples.contiguous(), order,
                           period)
    return unpack_fields(outs, samples.shape[0], values.shape[1], order)
