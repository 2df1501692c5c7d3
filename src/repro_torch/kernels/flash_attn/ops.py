"""Wrapper of the flash_attn CUDA kernels (``csrc/flash_attn.cu``).

For CUDA tensors it launches a kernel or raises; for CPU tensors it runs
the plain version (``ref.py``).  No fallback from a failed launch.  The
kernel is chosen statically by :func:`flash_route`: bfloat16 at a head
dim that is a multiple of 16 up to 128 goes to the tensor-core kernel
(``flash_attn_wgmma_launch``), every other case to the CUDA-core kernel
(``flash_attn_launch``).

The kernels have no backward.  :class:`FlashAttnFn` is the autograd
Function that trains through them: its forward launches the kernel, its
backward recomputes attention through the plain version query chunk by
query chunk.  A bare :func:`flash_attn` call on CUDA tensors that
require grad, with grad mode on, raises: its output would carry no
autograd history, and q, k and v would silently get no gradient.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels.flash_attn.ref import flash_attn_ref

#: kernel type codes of the C entry point
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D_HEAD = 128
#: query rows of one block of the tensor-core kernel (grid.y counts them)
TC_BLOCK_ROWS = 128

#: the kernel routes of a CUDA call
ROUTES = ("tensor_core", "cuda_core")

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_WGMMA_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    lib = kernels.load_library("flash_attn")
    if lib.flash_attn_launch.argtypes is None:
        lib.flash_attn_launch.argtypes = _ARGTYPES
        lib.flash_attn_launch.restype = ctypes.c_int
        lib.flash_attn_wgmma_launch.argtypes = _WGMMA_ARGTYPES
        lib.flash_attn_wgmma_launch.restype = ctypes.c_int
    return lib


def flash_route(device_type: str, dtype: torch.dtype, d_head: int) -> str:
    """Which version computes a call: ``"plain"`` for CPU tensors,
    ``"tensor_core"`` for bfloat16 with ``d_head`` a multiple of 16 up to
    128, ``"cuda_core"`` for every other CUDA call (float32 -- the gate
    route, which TF32 would break -- and other head dims)."""
    if device_type == "cpu":
        return "plain"
    if dtype == torch.bfloat16 and d_head % 16 == 0 and 16 <= d_head <= MAX_D_HEAD:
        return "tensor_core"
    return "cuda_core"


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
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "flash_attn: the kernel has no backward, and q, k or v requires grad "
            "with grad mode on; train through FlashAttnFn.apply (models.layers."
            "_sdpa does on attn_impl='chunked'), or call it under torch.no_grad()"
        )
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
    route = flash_route(q.device.type, q.dtype, dh)
    # grid.y is B * H on the CUDA-core route, Sq / TC_BLOCK_ROWS on the
    # tensor-core route; CUDA caps it at 65535
    grid_y = B * H if route == "cuda_core" else -(-Sq // TC_BLOCK_ROWS)
    if min(B, Sq, Sk) < 1 or grid_y > 65535:
        raise ValueError(f"flash_attn kernel ({route}) cannot take B {B}, Sq {Sq}, "
                         f"Sk {Sk}, H {H}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attn kernel takes contiguous q, k and v")
    if route == "tensor_core" and any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("flash_attn tensor-core kernel reads q, k and v through "
                         "TMA, which needs 16-byte aligned data pointers")
    o = torch.empty_like(q)
    lib = _lib()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    with torch.cuda.device(q.device):
        stream = kernels.current_stream(q.device)
        if route == "tensor_core":
            rc = lib.flash_attn_wgmma_launch(*ptrs, B, Sq, Sk, H, K, dh,
                                             int(causal), stream)
        else:
            rc = lib.flash_attn_launch(*ptrs, _DTYPE_CODES[q.dtype], B, Sq, Sk,
                                       H, K, dh, int(causal), stream)
    kernels.check_launch(f"flash_attn ({route})", rc, lib)
    flash_attn.ROUTE_LAUNCHES[route] += 1
    return o


#: kernel launches since the last reset, by route (chip_smoke.py resets
#: and reads them; their sum is the kernel's launch count)
flash_attn.ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)


class FlashAttnFn(torch.autograd.Function):
    """Attention that trains: ``FlashAttnFn.apply(q, k, v, causal, chunk)``.

    Forward: :func:`flash_attn` (the kernel on the card, the plain version
    on the CPU); q, k and v are saved.  Backward: the plain version
    (``ref.py``) recomputed under autograd, ``chunk`` query rows at a
    time, each chunk at its query positions (causal: its keys up to the
    chunk's last row, the rest carry zero weight), q / k / v taken in
    float32 so that dk and dv sum over the chunks in float32 -- the
    memory shape and the gradient of JAX's ``_sdpa_chunked``, which
    checkpoints each chunk.  dq, dk, dv come back in the inputs' dtypes.
    No backward kernel: the recompute is plain PyTorch."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True, chunk: int = 1024):
        ctx.causal, ctx.chunk = causal, chunk
        ctx.save_for_backward(q, k, v)
        return flash_attn(q, k, v, causal)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        Sq, Sk = q.shape[1], k.shape[1]
        C = max(1, min(ctx.chunk, Sq))
        kf = k.detach().float().requires_grad_()
        vf = v.detach().float().requires_grad_()
        dq = torch.empty_like(q)
        dk = torch.zeros_like(kf)
        dv = torch.zeros_like(vf)
        go = grad_out.float()
        with torch.enable_grad():
            for lo in range(0, Sq, C):
                hi = min(lo + C, Sq)
                # keys past the chunk's last row carry exactly zero weight
                kh = hi if ctx.causal and Sk == Sq else Sk
                qc = q[:, lo:hi].detach().float().requires_grad_()
                kc, vc = kf[:, :kh], vf[:, :kh]
                q_pos = torch.arange(lo, hi, device=q.device) if ctx.causal else None
                oc = flash_attn_ref(qc, kc, vc, ctx.causal, q_pos)
                gq, gk, gv = torch.autograd.grad(oc, (qc, kf, vf), go[:, lo:hi])
                dq[:, lo:hi] = gq.to(q.dtype)
                dk += gk
                dv += gv
        return dq, dk.to(k.dtype), dv.to(v.dtype), None, None
