"""Device selection of the port's entry points: the card by default.

``resolve_device(None)`` is ``cuda``.  Where no CUDA device is present
it raises: an entry point never falls back to the CPU on its own; the
CPU runs only when the caller asks for it (``device="cpu"``)."""
from __future__ import annotations

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
