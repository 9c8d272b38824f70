"""The card a run measured on, as ``nvidia-smi`` names it."""

from __future__ import annotations

import subprocess
from typing import Optional

import torch

__all__ = ["card_description"]


def card_description(device: torch.device) -> Optional[str]:
    """``nvidia-smi``'s name and power limit of the card ``device`` runs on
    (for example ``NVIDIA H100 80GB HBM3, 700.00 W``); None off CUDA or
    when ``nvidia-smi`` does not answer."""
    if device.type != "cuda":
        return None
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[index] if out.returncode == 0 and index < len(lines) else None
