"""Where the port's entry points run, and what card that is."""
from __future__ import annotations

import shutil
import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the CUDA card, and raises
    when there is none (pass ``device="cpu"`` for the plain PyTorch path)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run "
                           "the plain PyTorch path")
    return torch.device("cuda", torch.cuda.current_device())


def card_label() -> str:
    """The cards' names and power limits as ``nvidia-smi`` reports them
    (a card may be capped below its maximum, and then runs slower)."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "nvidia-smi not found"
    proc = subprocess.run([smi, "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=30, check=False)
    return (proc.stdout.strip() or proc.stderr.strip()).replace("\n", "; ")
