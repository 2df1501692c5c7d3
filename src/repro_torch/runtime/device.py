"""Device selection of the port's entry points: the card by default.

``resolve_device(None)`` is ``cuda``.  Where no CUDA device is present
it raises: an entry point never falls back to the CPU on its own; the
CPU runs only when the caller asks for it (``device="cpu"``).  The run's
list of device slots is ``runtime/platform.py::local_devices``.  Beside
them, two measurement helpers: :func:`card_line` (the card's name and
power limit) and :class:`BusySampler` (each card's sampled busy share)."""
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


class BusySampler:
    """The cards' busy share over a run, sampled: ``nvidia-smi``'s
    utilization.gpu (the share of each sample period in which a kernel
    ran) every 200 ms in a process of its own, one line a card a sample;
    ``stop()`` returns the mean over every line, each card's mean
    (``per_card_pct``, in nvidia-smi's card order) and the sample count.
    A measurement helper: it needs ``nvidia-smi``."""

    def __init__(self, n_cards: int = 1):
        self.n_cards = n_cards
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=utilization.gpu",
             "--format=csv,noheader,nounits", "-lms", "200"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def stop(self) -> dict:
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        vals = [float(v) for v in out.split() if v.strip().isdigit()]
        n = self.n_cards
        vals = vals[: len(vals) - len(vals) % n]  # whole samples only
        per = [vals[i::n] for i in range(n)]
        return {"mean_pct": sum(vals) / len(vals) if vals else None,
                "per_card_pct": [sum(v) / len(v) if v else None for v in per],
                "samples": len(vals) // n, "period_ms": 200}
