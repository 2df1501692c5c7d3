"""int8 gradient compression with error feedback (1-bit-Adam family,
arXiv:1811.03617 / 2102.02888 adapted to int8): an opt-in distributed-
optimization trick for the data-parallel all-reduce.

The counterpart of the JAX package's ``optim/grad_compress.py``.  Each
worker quantizes its local gradient to int8 with a per-tensor scale,
keeps the quantization residual in an error-feedback buffer added to the
next step's gradient, and all-reduces the payload.  The local functions
(``quantize``, ``dequantize``, ``compress_residual``,
``init_error_buffers``) are here, and ``compressed_psum`` all-reduces
over a data-parallel ``torch.distributed`` group (JAX: inside
``shard_map`` over mesh axes)."""
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


def compressed_psum(g: torch.Tensor, err: torch.Tensor, group=None):
    """Error-feedback int8 all-reduce of one gradient tensor over the
    data-parallel ``group`` (a ``torch.distributed`` process group, e.g.
    ``mesh.get_group("data")``; None: the default group, or this process
    alone where none is joined).  Returns (mean gradient f32, new err).

    JAX's algorithm: the workers agree on a SHARED scale (a MAX all-reduce
    of max |g + err|), the int8 payloads are summed as int32 (exactly
    decodable), and the mean divides by the world size, so the only error
    is the local quantization, which the error-feedback buffer re-injects
    next step."""
    import torch.distributed as dist

    joined = dist.is_available() and dist.is_initialized()
    gf = g.float() + err
    gmax = torch.max(torch.abs(gf))
    if joined:
        dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
    scale = gmax / 127.0 + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_err = gf - q.float() * scale
    total = q.to(torch.int32)
    if joined:
        dist.all_reduce(total, group=group)
    n = dist.get_world_size(group) if joined else 1
    return total.float() * scale / float(n), new_err


def init_error_buffers(params: dict) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}
