"""int8 gradient compression with error feedback (1-bit-Adam family,
arXiv:1811.03617 / 2102.02888 adapted to int8): an opt-in distributed-
optimization trick for the data-parallel all-reduce.

The counterpart of the JAX package's ``optim/grad_compress.py``.  Each
worker quantizes its local gradient to int8 with a per-tensor scale,
keeps the quantization residual in an error-feedback buffer added to the
next step's gradient, and all-reduces the payload.  The local functions
(``quantize``, ``dequantize``, ``compress_residual``,
``init_error_buffers``) are here; ``compressed_psum`` all-reduces over a
data-parallel group, which needs sharding, and raises."""
from __future__ import annotations

import torch


def quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_residual(g: torch.Tensor, err: torch.Tensor):
    """Returns (int8 payload, scale, new error-feedback buffer)."""
    gf = g.float() + err
    q, scale = quantize(gf)
    new_err = gf - dequantize(q, scale)
    return q, scale, new_err


def compressed_psum(g: torch.Tensor, err: torch.Tensor, axis_names):
    """Error-feedback int8 all-reduce of one gradient tensor over the
    data-parallel group ``axis_names``: needs sharding."""
    raise NotImplementedError(
        "compressed_psum all-reduces over a data-parallel group, which needs "
        "sharding, which the port does not have yet"
    )


def init_error_buffers(params: dict) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}
