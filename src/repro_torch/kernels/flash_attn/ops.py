"""Wrapper of the flash_attn CUDA kernels (``csrc/flash_attn.cu``).

For CUDA tensors it launches a kernel or raises; for CPU tensors it runs
the plain version (``ref.py``).  No fallback from a failed launch.  The
kernel is chosen statically by :func:`flash_route`: bfloat16 at a head
dim that is a multiple of 16 up to 128 goes to the tensor-core kernel
(``flash_attn_wgmma_launch``), every other case to the CUDA-core kernel
(``flash_attn_launch``).

Positions: ``q_pos`` (int32 (Sq,), non-decreasing) gives each query row
its causal position -- row i attends to the keys j <= q_pos[i] -- as the
rows of one rank of sequence-parallel attention need
(``sharding/attention.py``).  :func:`block_positions` makes them on the
device and keeps their host copy beside them (:func:`host_positions`), so
that neither the backward's key bounds nor the operation count read the
device.

The launch is the custom operator ``repro_torch::flash_attn``.  Its fake
form (``register_fake``) returns an empty output of q's shape, so the LM
dry run (``launch/dryrun.py``) traces the kernel's call on fake tensors,
which never reach the ``ctypes`` launch; its operation count
(``register_flop_formula``) counts the causal pairs from the positions
(``launch/roofline.py::flash_counts``), for ``FlopCounterMode`` on the
card and for the dry run's per-device count alike.

The kernels have no backward.  :class:`FlashAttnFn` is the autograd
Function that trains through them: its forward launches the kernel, its
backward recomputes attention through the plain version query chunk by
query chunk.  A bare :func:`flash_attn` call on CUDA tensors that
require grad, with grad mode on, raises: its output would carry no
autograd history, and q, k and v would silently get no gradient.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import kernels
from repro_torch.kernels.flash_attn.ref import flash_attn_ref

#: kernel type codes of the C entry point
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D_HEAD = 128
#: query rows of one block of the tensor-core kernel (grid.y counts them)
TC_BLOCK_ROWS = 128
#: grid.y of one launch chunk: batch-heads on the CUDA-core route, query
#: tiles on the tensor-core route (CUDA caps grid.y at 65,535; a call past
#: it runs in chunks, so any B * H and any Sq run)
GRID_Y_MAX = 65535

#: the kernel routes of a CUDA call
ROUTES = ("tensor_core", "cuda_core")

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p, ctypes.c_int,
                                                          ctypes.c_void_p]
_WGMMA_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]

#: host copies of the position arrays :func:`block_positions` made
_HOST_POS = WeakIdKeyDictionary()


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


def _is_fake(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import is_fake

    return is_fake(t)


def block_positions(n_rows: int, block: int, period: int, offset: int,
                    device) -> torch.Tensor:
    """int32 positions of ``n_rows`` query rows taken ``block`` at a time
    from every ``period`` positions of a sequence, from position
    ``offset`` of each: row i at (i // block) * period + offset + i %
    block (a contiguous run from ``offset``: ``block == n_rows``).  Made on
    ``device``; the host copy is kept beside it (:func:`host_positions`)."""
    i = np.arange(n_rows, dtype=np.int64)
    host = (i // block) * period + offset + i % block
    r = torch.arange(n_rows, dtype=torch.int32, device=device)
    t = (r // block) * period + offset + r % block
    _HOST_POS[t] = host
    return t


def host_positions(q_pos: torch.Tensor) -> np.ndarray:
    """The positions as a host int64 array: the copy :func:`block_positions`
    kept, else read from the tensor (a synchronise on the card; a fake
    tensor has no values and raises)."""
    host = _HOST_POS.get(q_pos)
    if host is not None:
        return host
    if _is_fake(q_pos):
        raise ValueError("flash_attn: fake positions without a host copy; make them "
                         "with block_positions")
    return q_pos.detach().to("cpu", torch.int64).numpy()


def flash_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool = True, q_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention forward: q (B, Sq, H, dh); k / v (B, Sk, K, dh), H % K == 0
    -> (B, Sq, H, dh) in q's dtype.  Query head h reads kv head h // (H // K);
    causal masks key j for query i where q_pos[i] < j (q_pos default 0 ..
    Sq - 1: top-left aligned).

    On the card: float32 or bfloat16, contiguous, dh <= 128; q_pos an
    integer (Sq,) tensor on q's card, non-decreasing.  Fake tensors (the
    LM dry run) stand for the card's, whatever their device.
    """
    tensors = (q, k, v)
    fake = _is_fake(q)
    if all(t.device.type == "cpu" for t in tensors) and not fake:
        return flash_attn_ref(q, k, v, causal, q_pos)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "flash_attn: the kernel has no backward, and q, k or v requires grad "
            "with grad mode on; train through FlashAttnFn.apply (models.layers."
            "_sdpa does on attn_impl='chunked'), or call it under torch.no_grad()"
        )
    if not ((fake or all(t.is_cuda for t in tensors)) and q.device == k.device == v.device):
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
    if min(B, Sq, Sk) < 1 or B * H >= 2**31:
        raise ValueError(f"flash_attn kernel cannot take B {B}, Sq {Sq}, Sk {Sk}, "
                         f"H {H}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attn kernel takes contiguous q, k and v")
    if q_pos is not None and (tuple(q_pos.shape) != (Sq,) or q_pos.dtype.is_floating_point
                              or q_pos.device != q.device):
        raise ValueError(f"flash_attn: q_pos must be an integer ({Sq},) tensor on "
                         f"{q.device}; got {q_pos.dtype} {tuple(q_pos.shape)} on "
                         f"{q_pos.device}")
    return torch.ops.repro_torch.flash_attn(q, k, v, q_pos, causal)


@torch.library.custom_op("repro_torch::flash_attn", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_pos: Optional[torch.Tensor], causal: bool) -> torch.Tensor:
    """The launch of a call :func:`flash_attn` has checked."""
    B, Sq, H, dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    route = flash_route(q.device.type, q.dtype, dh)
    if route == "tensor_core" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attn tensor-core kernel reads q, k and v through "
                         "TMA, which needs 16-byte aligned data pointers")
    pos_ptr = None
    if q_pos is not None:
        q_pos = q_pos.to(torch.int32).contiguous()
        if Sq > 1:  # the tiles' bounds rest on it
            torch._assert_async(torch.all(q_pos[1:] >= q_pos[:-1]),
                                "flash_attn: q_pos must be non-decreasing")
        pos_ptr = q_pos.data_ptr()
    o = torch.empty_like(q)
    lib = _lib()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr())
    with torch.cuda.device(q.device):
        stream = kernels.current_stream(q.device)
        if route == "tensor_core":
            rc = lib.flash_attn_wgmma_launch(*ptrs, B, Sq, Sk, H, K, dh, int(causal),
                                             pos_ptr, GRID_Y_MAX, stream)
        else:
            rc = lib.flash_attn_launch(*ptrs, _DTYPE_CODES[q.dtype], B, Sq, Sk, H, K,
                                       dh, int(causal), pos_ptr, GRID_Y_MAX, stream)
    kernels.check_launch(f"flash_attn ({route})", rc, lib)
    flash_attn.ROUTE_LAUNCHES[route] += 1
    if q_pos is not None:
        flash_attn.POSITION_LAUNCHES[route] += 1
    return o


@_flash_op.register_fake
def _(q, k, v, q_pos, causal):
    return torch.empty_like(q)


def _flash_flops(q, k, v, q_pos, causal, *args, out_val=None, **kwargs) -> int:
    """``FlopCounterMode``'s count of one call: 4 dh operations a (query,
    key it attends to, head), the pairs from the positions."""
    from repro_torch.launch.roofline import flash_counts

    B, Sq, H, dh = q.shape
    pos = host_positions(q_pos) if causal and q_pos is not None else None
    ops, _ = flash_counts(B, Sq, k.shape[1], H, k.shape[2], dh, q.element_size(),
                          causal, q_pos=pos)
    return int(ops)


def _register_flops() -> None:
    from torch.utils.flop_counter import register_flop_formula

    register_flop_formula(torch.ops.repro_torch.flash_attn, get_raw=True)(_flash_flops)


_register_flops()

#: kernel launches since the last reset, by route (chip_smoke.py resets
#: and reads them; their sum is the kernel's launch count); of them, those
#: given positions
flash_attn.ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)
flash_attn.POSITION_LAUNCHES = dict.fromkeys(ROUTES, 0)


class FlashAttnFn(torch.autograd.Function):
    """Attention that trains: ``FlashAttnFn.apply(q, k, v, causal, chunk,
    q_pos)``.

    Forward: :func:`flash_attn` (the kernel on the card, the plain version
    on the CPU); q, k, v and q_pos are saved.  Backward: the plain version
    (``ref.py``) recomputed under autograd, ``chunk`` query rows at a
    time, each chunk at its query positions (causal: its keys up to the
    chunk's last position, ``q_pos``'s host copy or its last row, the rest
    carry zero weight), q / k / v taken in float32 so that dk and dv sum
    over the chunks in float32 -- the memory shape and the gradient of
    JAX's ``_sdpa_chunked``, which checkpoints each chunk.  dq, dk, dv come
    back in the inputs' dtypes.  No backward kernel: the recompute is plain
    PyTorch."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True, chunk: int = 1024, q_pos=None):
        ctx.causal, ctx.chunk = causal, chunk
        ctx.pos_host = host_positions(q_pos) if causal and q_pos is not None else None
        ctx.save_for_backward(q, k, v, q_pos)
        if q_pos is None:
            return flash_attn(q, k, v, causal)
        return flash_attn(q, k, v, causal, q_pos)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, q_pos = ctx.saved_tensors
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
                # keys past the chunk's last position carry exactly zero weight
                if not ctx.causal:
                    kh = Sk
                elif ctx.pos_host is not None:
                    kh = min(Sk, int(ctx.pos_host[hi - 1]) + 1)
                else:
                    kh = hi if Sk == Sq else Sk
                qc = q[:, lo:hi].detach().float().requires_grad_()
                kc, vc = kf[:, :kh], vf[:, :kh]
                if not ctx.causal:
                    pc = None
                elif q_pos is not None:
                    pc = q_pos[lo:hi]
                else:
                    pc = torch.arange(lo, hi, device=q.device)
                oc = flash_attn_ref(qc, kc, vc, ctx.causal, pc)
                gq, gk, gv = torch.autograd.grad(oc, (qc, kf, vf), go[:, lo:hi])
                dq[:, lo:hi] = gq.to(q.dtype)
                dk += gk
                dv += gv
        return dq, dk.to(k.dtype), dv.to(v.dtype), None, None, None
