"""Wrapper of the ccm_lookup CUDA kernel (``csrc/ccm_lookup.cu``).

For a CUDA tensor it launches the kernel or raises; for a CPU tensor it
runs the plain version (``ref.py``).  No fallback from a failed launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels.ccm_lookup.ref import ccm_lookup_ref

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    lib = kernels.load_library("ccm_lookup")
    if lib.ccm_lookup_launch.argtypes is None:
        lib.ccm_lookup_launch.argtypes = _ARGTYPES
        lib.ccm_lookup_launch.restype = ctypes.c_int
    return lib


def ccm_lookup(idx: torch.Tensor, w: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Batched simplex lookup for targets sharing a library table.

    idx (Lq, k) int32, w (Lq, k) float32, Y (B, Lp) float32 -> (B, Lq);
    with a leading table dimension, idx / w (S, Lq, k) -> (S, B, Lq)
    (every table of a chunk in one launch).  Every idx entry must lie in
    [0, Lp): the kernel does not check it.
    """
    if idx.device.type == "cpu" and w.device.type == "cpu" and Y.device.type == "cpu":
        return ccm_lookup_ref(idx, w, Y)
    if not (idx.is_cuda and w.is_cuda and Y.is_cuda
            and idx.device == w.device == Y.device):
        raise ValueError(
            f"ccm_lookup: idx on {idx.device}, w on {w.device}, Y on "
            f"{Y.device}; all must be on one CUDA device (or all on the CPU)"
        )
    if idx.dtype != torch.int32 or w.dtype != torch.float32 or Y.dtype != torch.float32:
        raise ValueError(
            f"ccm_lookup takes idx int32, w and Y float32; got {idx.dtype}, "
            f"{w.dtype}, {Y.dtype}"
        )
    squeeze = idx.dim() == 2
    if idx.dim() not in (2, 3) or w.shape != idx.shape or Y.dim() != 2:
        raise ValueError(
            f"ccm_lookup takes idx / w ([S,] Lq, k) and Y (B, Lp), got "
            f"{tuple(idx.shape)}, {tuple(w.shape)}, {tuple(Y.shape)}"
        )
    if not (idx.is_contiguous() and w.is_contiguous() and Y.is_contiguous()):
        raise ValueError("ccm_lookup takes contiguous idx, w and Y")
    idx3, w3 = (idx[None], w[None]) if squeeze else (idx, w)
    S, Lq, k = idx3.shape
    B, Lp = Y.shape
    out = torch.empty((S, B, Lq), dtype=torch.float32, device=Y.device)
    lib = _lib()
    with torch.cuda.device(Y.device):
        rc = lib.ccm_lookup_launch(
            idx3.data_ptr(), w3.data_ptr(), Y.data_ptr(), out.data_ptr(),
            S, Lq, k, B, Lp, kernels.current_stream(Y.device),
        )
    kernels.check_launch("ccm_lookup", rc, lib)
    ccm_lookup.LAUNCHES += 1
    return out[0] if squeeze else out


#: kernel launches since the last reset (chip_smoke.py resets and reads it)
ccm_lookup.LAUNCHES = 0
