"""Device selection of the port's entry points: the card by default.

``resolve_device(None)`` is ``cuda``.  Where no CUDA device is present
it raises: an entry point never falls back to the CPU on its own; the
CPU runs only when the caller asks for it (``device="cpu"``)."""
from __future__ import annotations

import subprocess

import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the card by "
            "default; pass device='cpu' (CLI: --device cpu) to run the "
            "plain versions on the CPU"
        )
    return dev


def card_line(dev: torch.device) -> str | None:
    """The card's ``nvidia-smi --query-gpu=name,power.limit`` line (its
    name and power limit, printed beside every measurement); None on the
    CPU."""
    if dev.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0].strip()
