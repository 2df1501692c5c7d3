"""Wrapper of the flash_attn CUDA kernel (``csrc/flash_attn.cu``).

For CUDA tensors it launches the kernel or raises; for CPU tensors it
runs the plain version (``ref.py``).  No fallback from a failed launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels.flash_attn.ref import flash_attn_ref

#: kernel type codes of the C entry point
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D_HEAD = 128

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    lib = kernels.load_library("flash_attn")
    if lib.flash_attn_launch.argtypes is None:
        lib.flash_attn_launch.argtypes = _ARGTYPES
        lib.flash_attn_launch.restype = ctypes.c_int
    return lib


def flash_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool = True) -> torch.Tensor:
    """Attention forward: q (B, Sq, H, dh); k / v (B, Sk, K, dh), H % K == 0
    -> (B, Sq, H, dh) in q's dtype.  Query head h reads kv head h // (H // K);
    causal masks key j for query i < j (top-left aligned).

    On the card: float32 or bfloat16, contiguous, dh <= 128.
    """
    tensors = (q, k, v)
    if all(t.device.type == "cpu" for t in tensors):
        return flash_attn_ref(q, k, v, causal)
    if not (all(t.is_cuda for t in tensors) and q.device == k.device == v.device):
        raise ValueError(
            f"flash_attn: q on {q.device}, k on {k.device}, v on {v.device}; all "
            "must be on one CUDA device (or all on the CPU)"
        )
    if q.dtype not in _DTYPE_CODES or not (k.dtype == v.dtype == q.dtype):
        raise ValueError(
            f"flash_attn takes q, k, v all float32 or all bfloat16; got {q.dtype}, "
            f"{k.dtype}, {v.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"flash_attn takes q (B, Sq, H, dh) and k / v (B, Sk, K, dh); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, Sq, H, dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != dh or H % K != 0:
        raise ValueError(
            f"flash_attn: q {tuple(q.shape)} and k / v {tuple(k.shape)} need the "
            "same batch and head dim, and a query head count divisible by the kv "
            "head count"
        )
    if not 1 <= dh <= MAX_D_HEAD:
        raise ValueError(f"flash_attn kernel takes d_head up to {MAX_D_HEAD}, got {dh}")
    if min(B, Sq, Sk) < 1 or B * H > 65535:
        raise ValueError(f"flash_attn kernel cannot take B {B}, Sq {Sq}, Sk {Sk}, H {H}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attn kernel takes contiguous q, k and v")
    o = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        rc = lib.flash_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _DTYPE_CODES[q.dtype], B, Sq, Sk, H, K, dh, int(causal),
            kernels.current_stream(q.device),
        )
    kernels.check_launch("flash_attn", rc, lib)
    flash_attn.LAUNCHES += 1
    return o


#: kernel launches since the last reset (chip_smoke.py resets and reads it)
flash_attn.LAUNCHES = 0
