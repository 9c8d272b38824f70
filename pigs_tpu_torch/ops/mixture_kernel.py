"""K1, the fused 2D mixture forward: the CUDA kernel and its plain twin.

Replaces ``pigs_tpu/ops/pallas_mixture.py::_fwd_kernel``.  Inputs are
``samples (m, 2)``, ``means (n, 2)``, packed conics ``(n, 3)`` =
``[cxx, cxy, cyy]`` and ``values (n, c)`` with any mask already folded in;
the outputs are the packed fields ``(m, c)``, ``(m, 2c)``, ``(m, 3c)``,
``(m, 4c)`` up to ``order`` (see ``csrc/mixture_fwd.cu``).

:func:`mixture_forward` launches the kernel on CUDA tensors and runs the
plain twin :func:`mixture_forward_plain` on CPU tensors; anything else raises.
``launches`` counts the kernel's launches and nothing else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional

import torch

from pigs_tpu_torch.ops.oracle import MixtureFields

__all__ = ["mixture_forward", "mixture_forward_plain", "eval_mixture_fused",
           "pack_conics", "unpack_fields", "build", "launches"]

GROUP_SIZES = (1, 2, 3, 4)   # packed components per derivative order
SOURCES = ("mixture_fwd.cu",)

# Number of times the CUDA kernel was launched in this process.
launches = 0


def build():
    """Build (or load the cached build of) K1; returns its ``BuildInfo``."""
    return _library()[1]


@functools.lru_cache(maxsize=None)
def _library():
    from pigs_tpu_torch.ops._build import load_library
    lib, info = load_library("mixture_fwd", SOURCES)
    fn = lib.pigs_mixture_fwd
    fn.argtypes = [ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, info


def _weights(dx, dy, px, py, g, cxx, cxy, cyy, order: int):
    """The packed output weights W_k = P_k(p, C) * g, in output order."""
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


def mixture_forward_plain(means, conics_packed, values, samples, order: int,
                          period: Optional[float] = None,
                          sample_chunk: int = 1024) -> List[torch.Tensor]:
    """Plain PyTorch version of K1: the same packed outputs, computed in the
    inputs' dtype on their device, ``sample_chunk`` samples at a time."""
    mx, my = means[:, 0], means[:, 1]
    cxx, cxy, cyy = conics_packed[:, 0], conics_packed[:, 1], conics_packed[:, 2]
    c = values.shape[1]
    groups = GROUP_SIZES[:order + 1]
    if samples.shape[0] == 0:
        return [samples.new_zeros((0, gsize * c)) for gsize in groups]
    outs = [[] for _ in groups]
    for smp in torch.split(samples, sample_chunk):
        dx = smp[:, 0:1] - mx[None, :]
        dy = smp[:, 1:2] - my[None, :]
        if period is not None:
            dx = dx - period * torch.round(dx * (1.0 / period))
            dy = dy - period * torch.round(dy * (1.0 / period))
        px = cxx * dx + cxy * dy
        py = cxy * dx + cyy * dy
        g = torch.exp(-0.5 * (dx * px + dy * py))
        w = torch.stack(_weights(dx, dy, px, py, g, cxx, cxy, cyy, order))
        res = torch.matmul(w, values)                     # (K, chunk, c)
        row = 0
        for slot, gsize in zip(outs, groups):
            slot.append(res[row:row + gsize].permute(1, 0, 2)
                        .reshape(-1, gsize * c))
            row += gsize
    return [torch.cat(parts) for parts in outs]


class _MixtureForward(torch.autograd.Function):
    """Autograd seam around K1.  Its backward is the Gaussian-side kernel K2,
    which is not ported yet, so differentiating through K1 raises."""

    @staticmethod
    def forward(ctx, means, conics_packed, values, samples, order, period):
        return tuple(_launch(means, conics_packed, values, samples, order,
                             period))

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the backward of the CUDA mixture kernel (K2) is not ported yet")


def _launch(means, conics_packed, values, samples, order, period):
    global launches
    fn = _library()[0].pigs_mixture_fwd
    m, c = samples.shape[0], values.shape[1]
    outs = [torch.empty((m, gsize * c), dtype=torch.float32,
                        device=samples.device)
            for gsize in GROUP_SIZES[:order + 1]]
    ptrs = [o.data_ptr() for o in outs] + [None] * (4 - len(outs))
    stream = torch.cuda.current_stream(samples.device).cuda_stream
    err = fn(order, c, samples.data_ptr(), means.data_ptr(),
             conics_packed.data_ptr(), values.data_ptr(), m, means.shape[0],
             int(period is not None),
             float(period) if period is not None else 0.0, *ptrs, stream)
    if err != 0:
        raise RuntimeError(f"mixture_fwd launch failed: cudaError {err}")
    launches += 1
    return outs


def mixture_forward(means, conics_packed, values, samples, order: int,
                    period: Optional[float] = None) -> List[torch.Tensor]:
    """Packed mixture outputs up to ``order``: K1 on CUDA tensors, the plain
    twin on CPU tensors.

    On CUDA the inputs must be contiguous float32 with ``samples (m, 2)``,
    ``means (n, 2)``, ``conics_packed (n, 3)``, ``values (n, c)``, c in {1, 2},
    order 0..3, all on one device, none requiring grad (the backward kernel
    is not ported yet).  Anything else raises.
    """
    tensors = {"means": means, "conics_packed": conics_packed,
               "values": values, "samples": samples}
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"mixture_forward: inputs on several devices {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return mixture_forward_plain(means, conics_packed, values, samples,
                                     order, period)
    if device.type != "cuda":
        raise ValueError(f"mixture_forward: no kernel for device {device}")
    n, c = means.shape[0], values.shape[1]
    shapes = {"means": (n, 2), "conics_packed": (n, 3), "values": (n, c),
              "samples": (samples.shape[0], 2)}
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"mixture_forward: {name} is {t.dtype}, the "
                            "kernel takes float32")
        if t.dim() != 2 or tuple(t.shape) != shapes[name]:
            raise ValueError(f"mixture_forward: {name} has shape "
                             f"{tuple(t.shape)}, expected {shapes[name]} (d=2)")
        if not t.is_contiguous():
            raise ValueError(f"mixture_forward: {name} is not contiguous")
    if c not in (1, 2) or order not in (0, 1, 2, 3):
        raise ValueError(f"mixture_forward: no kernel for c={c}, order={order}")
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in tensors.values()):
        raise NotImplementedError(
            "mixture_forward: gradients through the CUDA kernel need its "
            "backward (K2), which is not ported yet")
    return list(_MixtureForward.apply(means, conics_packed, values, samples,
                                      order, period))


def pack_conics(conics_full: torch.Tensor) -> torch.Tensor:
    """``(n, 2, 2)`` -> ``(n, 3)`` = ``[cxx, cxy, cyy]``."""
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
