"""Training checkpoints with ``torch.save`` (port of
:mod:`pigs_tpu.train.checkpoint`, which uses orbax).

A checkpoint is one file ``ckpt_<epoch>.pt`` in a directory, holding
``{epoch, params, opt, ema, training_loss}``: ``params`` and ``ema`` map
state-dict names to tensors, ``opt`` holds the Adam moments by the same
names and the step count.  The newest three are kept.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch

from pigs_tpu_torch.train.optim import AdamState

__all__ = ["Checkpoint", "save_checkpoint", "restore_checkpoint",
           "latest_epoch", "adam_to_dict", "adam_from_dict"]

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")
KEEP = 3


class Checkpoint(NamedTuple):
    epoch: int
    params: Dict[str, torch.Tensor]
    training_loss: List[float]
    opt: Optional[AdamState] = None
    ema: Optional[Dict[str, torch.Tensor]] = None


def adam_to_dict(names: Sequence[str], state: AdamState) -> dict:
    """An :class:`AdamState` (lists in parameter order) -> moments by name."""
    return {"mu": dict(zip(names, state.mu)), "nu": dict(zip(names, state.nu)),
            "count": state.count}


def adam_from_dict(names: Sequence[str], d: dict, device=None) -> AdamState:
    """Inverse of :func:`adam_to_dict`, in the order of ``names``."""
    return AdamState(mu=[d["mu"][k].to(device) for k in names],
                     nu=[d["nu"][k].to(device) for k in names],
                     count=d["count"].to(device=device, dtype=torch.int32))


def _epochs(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(directory)
                  if (m := _NAME.match(f)))


def latest_epoch(directory: str) -> Optional[int]:
    epochs = _epochs(directory)
    return epochs[-1] if epochs else None


def save_checkpoint(directory: str, epoch: int,
                    params: Dict[str, torch.Tensor],
                    opt_state: Optional[AdamState], training_loss,
                    ema: Optional[Dict[str, torch.Tensor]] = None) -> str:
    """Write ``ckpt_<epoch>.pt`` (through a temporary file, so a reader never
    sees half a checkpoint) and drop all but the newest three.  Returns the
    path."""
    os.makedirs(directory, exist_ok=True)
    names = list(params)
    cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}
    payload = {
        "epoch": int(epoch),
        "params": cpu(params),
        "training_loss": [float(x) for x in training_loss],
        "opt": None,
        "ema": None if ema is None else cpu(ema),
    }
    if opt_state is not None:
        opt = adam_to_dict(names, opt_state)
        payload["opt"] = {"mu": cpu(opt["mu"]), "nu": cpu(opt["nu"]),
                          "count": opt["count"].detach().cpu()}
    path = os.path.join(directory, f"ckpt_{epoch:08d}.pt")
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    for old in _epochs(directory)[:-KEEP]:
        os.remove(os.path.join(directory, f"ckpt_{old:08d}.pt"))
    return path


def restore_checkpoint(directory: str, device=None) -> Optional[Checkpoint]:
    """The newest checkpoint in ``directory`` on ``device``, or None."""
    epoch = latest_epoch(directory)
    if epoch is None:
        return None
    d = torch.load(os.path.join(directory, f"ckpt_{epoch:08d}.pt"),
                   map_location="cpu", weights_only=True)
    to = lambda x: {k: v.to(device) for k, v in x.items()}
    names = list(d["params"])
    return Checkpoint(
        epoch=d["epoch"], params=to(d["params"]),
        training_loss=list(d["training_loss"]),
        opt=None if d["opt"] is None else adam_from_dict(names, d["opt"],
                                                         device),
        ema=None if d["ema"] is None else to(d["ema"]))
