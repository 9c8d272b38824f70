"""Mixture evaluation over a ``(data, model)`` mesh (port of
:mod:`pigs_tpu.parallel.sharded`).

The all-pairs (samples x Gaussians) sum splits along both axes: samples
over ``data``, Gaussians over ``model``.  Each rank evaluates its Gaussian
block at its sample block with :func:`pigs_tpu_torch.ops.mixture.
eval_mixture` (K1 on the card; its backward K2).  Either one sum over the
``model`` group completes the mixture (:func:`eval_mixture_sharded`), or
the Gaussian blocks travel round the ``model`` ring
(:func:`eval_mixture_ring`).

Every rank passes the global tensors and gets back its ``data`` block of
the fields, the same on every rank of its ``model`` group; :func:`gather`
assembles the global fields.  Gradients are those of the JAX package's
``jax.grad`` of the global loss, the sum of the ``data`` blocks' losses:
when each rank differentiates its own block's loss, every rank's gradients
of the means, conics and values are the global loss's (the means, conics,
values and mask travel as one packed tensor, sliced by
:mod:`pigs_tpu_torch.parallel.mesh`'s ``_ShardRows``, whose backward sums
the blocks' gradients over all ranks).  The samples get no gradient, as
the JAX package passes ``diff_samples=False``: K3 never runs here.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from pigs_tpu_torch.ops.mixture import eval_mixture
from pigs_tpu_torch.ops.oracle import MixtureFields
from pigs_tpu_torch.parallel.mesh import (DATA_AXIS, MODEL_AXIS, axis_group,
                                          axis_index, axis_size,
                                          data_sharding, model_sharding)

__all__ = ["eval_mixture_sharded", "eval_mixture_ring", "gather"]

# Bytes this process sent round the ring through host memory: gloo's
# point-to-point ops take CPU tensors only (NCCL's stay on the card).
ring_host_bytes = 0


class _ModelSum(torch.autograd.Function):
    """Sum over the ``model`` group, one all-reduce of the flattened
    fields; the backward is the identity, the transpose of JAX's ``psum``
    for an output replicated over the axis.  (The backward of
    ``torch.distributed.nn.functional.all_reduce`` sums the cotangents,
    which would scale every gradient by the axis size.)"""

    @staticmethod
    def forward(ctx, group, *fields):
        flat = torch.cat([f.reshape(-1) for f in fields])
        dist.all_reduce(flat, group=group)
        parts = torch.split(flat, [f.numel() for f in fields])
        return tuple(p.reshape(f.shape).clone()
                     for p, f in zip(parts, fields))

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + grads


class _Replicated(torch.autograd.Function):
    """Fields that each of ``size`` ranks computes in full: the backward
    passes ``1 / size`` of the cotangent on, as JAX's shard_map transposes
    an output replicated over an axis, so that the ranks' gradients add up
    to one copy's."""

    @staticmethod
    def forward(ctx, size, *fields):
        ctx.size = size
        return tuple(f.view_as(f) for f in fields)

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + tuple(g / ctx.size for g in grads)


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send ``x`` ``step`` ranks on round ``group`` and return what the rank
    ``step`` back sent.  Under gloo a tensor on the card goes through host
    memory (``ring_host_bytes``)."""
    global ring_host_bytes
    n, i = dist.get_world_size(group), dist.get_rank(group)
    host = x.is_cuda and dist.get_backend(group) == "gloo"
    send = x.cpu() if host else x.contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send,
                      dist.get_global_rank(group, (i + step) % n), group),
           dist.P2POp(dist.irecv, recv,
                      dist.get_global_rank(group, (i - step) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if host:
        ring_host_bytes += send.numel() * send.element_size()
        return recv.to(x.device)
    return recv


class _Rotate(torch.autograd.Function):
    """One step round the ring (JAX's ``ppermute`` with ``perm = [(i,
    (i + 1) % n)]``); the cotangent goes the other way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -1), None


def _pack(means, conics, values, mask) -> torch.Tensor:
    """``(n, d + d*d + c + 1)``: one row per Gaussian, the mask as 0/1."""
    n = means.shape[0]
    return torch.cat([means.reshape(n, -1), conics.reshape(n, -1),
                      values.reshape(n, -1),
                      mask.to(means.dtype).reshape(n, 1)], dim=1)


def _unpack(packed, means, conics, values):
    """The inverse of :func:`_pack`, shaped like the given globals' rows."""
    widths = [means[0].numel(), conics[0].numel(), values[0].numel(), 1]
    mu, con, val, mask = torch.split(packed, widths, dim=1)
    n = packed.shape[0]
    return (mu.reshape(n, *means.shape[1:]), con.reshape(n, *conics.shape[1:]),
            val.reshape(n, *values.shape[1:]), mask[:, 0] > 0.5)


def _blocks(mesh, means, conics, values, samples, mask):
    """This rank's Gaussian block (packed) and sample block."""
    if mask is None:
        mask = torch.ones(means.shape[0], dtype=torch.bool,
                          device=means.device)
    packed = model_sharding(mesh)(_pack(means, conics, values, mask))
    return packed, data_sharding(mesh)(samples.detach())


def _fields(fields, order: int) -> MixtureFields:
    return MixtureFields(*(list(fields) + [None] * (3 - order)))


def eval_mixture_sharded(mesh, means: torch.Tensor, conics: torch.Tensor,
                         values: torch.Tensor, samples: torch.Tensor,
                         order: int = 0, mask: Optional[torch.Tensor] = None,
                         period: Optional[float] = None,
                         impl: str = "auto") -> MixtureFields:
    """The mixture with samples split over ``data`` and Gaussians over
    ``model``: one ``eval_mixture`` call (one K1 launch on the card) for
    this rank's blocks, then one sum over the ``model`` group.

    Takes the global ``means (n, d)``, ``conics (n, d, d)``, ``values (n,
    c)``, ``samples (m, d)`` and ``mask (n,)``; ``n`` must divide over the
    ``model`` axis and ``m`` over ``data`` (``ValueError`` otherwise).
    Returns this rank's ``data`` block of the fields up to ``order``.
    """
    packed, smp = _blocks(mesh, means, conics, values, samples, mask)
    mu, con, val, msk = _unpack(packed, means, conics, values)
    out = eval_mixture(mu, con, val, smp, order=order, mask=msk,
                       period=period, impl=impl, diff_samples=False)
    fields = out[:order + 1]
    group = axis_group(mesh, MODEL_AXIS)
    if group is not None:
        fields = _ModelSum.apply(group, *fields)
    return _fields(fields, order)


def eval_mixture_ring(mesh, means: torch.Tensor, conics: torch.Tensor,
                      values: torch.Tensor, samples: torch.Tensor,
                      order: int = 0, mask: Optional[torch.Tensor] = None,
                      period: Optional[float] = None,
                      impl: str = "auto") -> MixtureFields:
    """Ring accumulation, for Gaussian counts too large to replicate: each
    rank evaluates the Gaussian block it holds at its sample block and
    passes the block to the next rank of its ``model`` group, until every
    block has been evaluated everywhere: ``model``-axis-size ``eval_mixture``
    calls (K1 launches), and one rotation between each two.  The JAX
    package's scan rotates once more after the last evaluation and runs one
    more evaluation to shape its zeros; neither changes the result.

    With a ``model`` axis of one rank no point-to-point op is issued.  Under
    gloo (which runs point-to-point ops on CPU tensors only) the blocks go
    through host memory; under NCCL they stay on the card.  Arguments and
    result as :func:`eval_mixture_sharded`.
    """
    packed, smp = _blocks(mesh, means, conics, values, samples, mask)
    size = axis_size(mesh, MODEL_AXIS)
    group = axis_group(mesh, MODEL_AXIS)
    acc = None
    for step in range(size):
        if step:
            packed = _Rotate.apply(packed, group)
        mu, con, val, msk = _unpack(packed, means, conics, values)
        out = eval_mixture(mu, con, val, smp, order=order, mask=msk,
                           period=period, impl=impl, diff_samples=False)
        acc = (out[:order + 1] if acc is None else
               tuple(a + f for a, f in zip(acc, out[:order + 1])))
    if size > 1:
        acc = _Replicated.apply(size, *acc)
    return _fields(acc, order)


def gather(mesh, fields: NamedTuple, axis: str = DATA_AXIS) -> NamedTuple:
    """The global tensors of ``fields`` (a named tuple of per-rank blocks
    along ``axis``, ``None`` entries kept), on every rank, without
    gradient: each block zero-padded to its global rows and summed over the
    axis group, which is exact and runs on the card under gloo and NCCL."""
    group = axis_group(mesh, axis)
    if group is None:
        return fields
    size, index = axis_size(mesh, axis), axis_index(mesh, axis)
    out = []
    with torch.no_grad():
        for x in fields:
            if x is None:
                out.append(None)
                continue
            rows = x.shape[0]
            full = x.new_zeros((rows * size,) + tuple(x.shape[1:]))
            full[index * rows:(index + 1) * rows] = x
            dist.all_reduce(full, group=group)
            out.append(full)
    return type(fields)(*out)
