"""Joining the process group of a multi-process run (port of
:mod:`pigs_tpu.parallel.launch`).

Every process of a run calls :func:`initialize_distributed` first; it is a
no-op in a single process.  ``torch.distributed`` learns of the other
processes only from its arguments or from the environment ``torchrun``
sets (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["initialize_distributed", "is_multihost", "host_summary"]


def _joined() -> bool:
    return dist.is_available() and dist.is_initialized()


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None,
                           device=None) -> bool:
    """Join the process group of a multi-process run.

    Returns True when a group of more than one process already exists, or
    when this call joins one: with ``init_method`` (for example
    ``tcp://localhost:29500`` or ``file:///tmp/store``, with ``world_size``
    and ``rank``), or from ``torchrun``'s environment (``MASTER_ADDR`` set
    and ``WORLD_SIZE`` > 1).  Otherwise it does nothing and returns False.

    ``backend`` defaults to ``nccl`` on the card and ``gloo`` when
    ``device`` is the CPU; ``device`` defaults to ``cuda``.  Under NCCL the
    process then runs on ``device``'s card, or on card ``rank % count``
    when ``device`` names no index.
    """
    if _joined():
        return dist.get_world_size() > 1
    env_says_multiprocess = bool(os.environ.get("MASTER_ADDR")) and int(
        os.environ.get("WORLD_SIZE", "1")) > 1
    if init_method is None and not env_says_multiprocess:
        return False
    device = torch.device("cuda" if device is None else device)
    if backend is None:
        backend = "gloo" if device.type == "cpu" else "nccl"
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank)
    if backend == "nccl":
        torch.cuda.set_device(device.index if device.index is not None else
                              dist.get_rank() % torch.cuda.device_count())
    return True


def is_multihost() -> bool:
    """True when this process belongs to a group of more than one."""
    return _joined() and dist.get_world_size() > 1


def host_summary() -> str:
    """``process r/W, L local / G global devices``: this process's rank
    among W; L the cards it sees (the CPU counts as one device when it
    sees none) and G the devices of the run, one per process."""
    rank, world = ((dist.get_rank(), dist.get_world_size()) if _joined()
                   else (0, 1))
    local = torch.cuda.device_count() or 1
    return (f"process {rank}/{world}, {local} local / {world} global "
            f"devices")
