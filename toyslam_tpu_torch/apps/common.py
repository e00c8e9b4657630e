"""What the port's apps share: the device a run asks for, and the line
that names the card beside every time an app prints."""

from __future__ import annotations

import shutil
import subprocess

import torch


def device(name: str) -> torch.device:
    """``"cuda"`` or ``"cpu"``; ``"cuda"`` without a card raises (no
    fallback)."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu to run on "
                           "the host")
    return torch.device(name)


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them, or
    what ran instead."""
    if dev.type != "cuda":
        return "cpu (host clock)"
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return f"{torch.cuda.get_device_name(dev)}, power limit not read"
    out = subprocess.run(
        [smi, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    return out.splitlines()[0] if out else torch.cuda.get_device_name(dev)


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
