"""The ``(data, model)`` device mesh and the specs that place a tensor on it
(port of :mod:`pigs_tpu.parallel.mesh`).

A mesh lays the ranks of the process group out as ``(data, model)``, row
major: rank ``r`` sits at ``(r // model, r % model)``.  The ``data`` axis
splits the samples (collocation and query points), the ``model`` axis the
Gaussians.  With more than one process it is a
``torch.distributed.device_mesh.DeviceMesh``, whose per-axis groups
``init_device_mesh`` creates on every rank in the same order.  A single
process without a process group gets :class:`LocalMesh`, a 1x1 mesh whose
collectives are identities, so the parallel paths run unchanged there.

Every rank holds the global tensors (as the JAX package's callers pass
global arrays); a spec returns this rank's block of rows.  Blocks must be
equal: a size that does not divide its axis raises ``ValueError``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["make_mesh", "data_sharding", "model_sharding", "replicated",
           "DATA_AXIS", "MODEL_AXIS", "LocalMesh", "Sharding", "axis_size",
           "axis_index", "axis_group"]

DATA_AXIS = "data"
MODEL_AXIS = "model"


class LocalMesh:
    """The 1x1 ``(data, model)`` mesh of one process with no process group:
    each axis has one rank, and its group is ``None`` (no collective)."""

    mesh_dim_names = (DATA_AXIS, MODEL_AXIS)
    shape = (1, 1)

    def get_group(self, mesh_dim=None):
        return None

    def get_local_rank(self, mesh_dim=None) -> int:
        return 0


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              device_type: Optional[str] = None):
    """A ``(data, model)`` mesh over the ranks of the process group.

    Default: every rank on the ``data`` axis (the samples outnumber the
    Gaussians in every configuration).  ``device_type`` is the
    ``DeviceMesh``'s (default ``cuda`` under NCCL, else ``cpu``: gloo's
    collectives take tensors on the card as well).  Without a process group
    the mesh is a :class:`LocalMesh`.
    """
    joined = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if joined else 1
    shape = (world, 1) if shape is None else tuple(int(s) for s in shape)
    if len(shape) != 2 or shape[0] * shape[1] != world:
        raise ValueError(f"mesh shape {shape} does not lay out the {world} "
                         "ranks of the process group as (data, model)")
    if not joined:
        return LocalMesh()
    from torch.distributed.device_mesh import init_device_mesh
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_size(mesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str):
    """The process group of ``axis`` through this rank (None on a
    :class:`LocalMesh`)."""
    return mesh.get_group(axis)


class _ShardRows(torch.autograd.Function):
    """Rows ``[start, stop)`` of a global tensor that every rank holds.

    Backward: the block's gradient, zero-padded to the global shape and
    summed over every rank, so each rank's gradient is the gradient of the
    sum of all ranks' losses (the global loss, when each rank's loss is
    its own data shard's)."""

    @staticmethod
    def forward(ctx, x, start, stop, reduce):
        ctx.shape, ctx.start, ctx.stop, ctx.reduce = (x.shape, start, stop,
                                                      reduce)
        return x[start:stop].clone()

    @staticmethod
    def backward(ctx, grad):
        full = grad.new_zeros(ctx.shape)
        full[ctx.start:ctx.stop] = grad
        if ctx.reduce:
            dist.all_reduce(full)
        return full, None, None, None


class Sharding(NamedTuple):
    """A placement on ``mesh``: called on a global tensor, it returns this
    rank's block of rows along ``axis``, or (``axis`` None, replicated) the
    tensor as the mesh's first rank holds it."""

    mesh: object
    axis: Optional[str]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        local = isinstance(self.mesh, LocalMesh)
        if self.axis is None:
            if local:
                return x
            with torch.no_grad():
                out = x.clone()
                dist.broadcast(out, int(self.mesh.mesh.flatten()[0]))
            return out
        n = axis_size(self.mesh, self.axis)
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows do not divide over the {n} "
                             f"ranks of the {self.axis!r} axis")
        rows = x.shape[0] // n
        start = axis_index(self.mesh, self.axis) * rows
        if x.requires_grad:
            return _ShardRows.apply(x, start, start + rows, not local)
        return x[start:start + rows]


def data_sharding(mesh) -> Sharding:
    """Leading axis split over the ``data`` axis."""
    return Sharding(mesh, DATA_AXIS)


def model_sharding(mesh) -> Sharding:
    """Leading axis split over the ``model`` (Gaussian) axis."""
    return Sharding(mesh, MODEL_AXIS)


def replicated(mesh) -> Sharding:
    """The whole tensor on every rank, broadcast from the mesh's first rank
    (no gradient flows through the broadcast)."""
    return Sharding(mesh, None)
