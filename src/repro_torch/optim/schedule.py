"""LR schedules: cosine, WSD (warmup-stable-decay, MiniCPM arXiv:2404.06395),
constant-with-warmup.  Pure functions of the step counter.

The counterpart of the JAX package's ``optim/schedule.py``: the step is an
int32 tensor (the TrainState's counter; a Python int is taken as one),
``step / warmup`` divides it as an int32, and every term is float32, so
the rate equals JAX's in float32.  The result is a 0-d float32 tensor on
the step's device."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.int32)


def make_schedule(kind: str, lr: float, warmup: int, total: int):
    warmup = max(1, warmup)

    def cosine(step):
        step = _step(step)
        w = torch.clamp(step / warmup, max=1.0)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        return lr * w * 0.5 * (1.0 + torch.cos(math.pi * t))

    def wsd(step):
        step = _step(step)
        w = torch.clamp(step / warmup, max=1.0)
        decay_start = int(0.9 * total)  # final 10%: exponential-ish decay
        t = torch.clamp((step - decay_start) / max(total - decay_start, 1), 0.0, 1.0)
        return lr * w * torch.where(step < decay_start, 1.0, torch.pow(0.5, 10.0 * t))

    def constant(step):
        return lr * torch.clamp(_step(step) / warmup, max=1.0)

    return {"cosine": cosine, "wsd": wsd, "constant": constant}[kind]
