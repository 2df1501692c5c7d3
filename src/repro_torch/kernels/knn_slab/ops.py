"""Wrapper of the knn_slab CUDA kernel (``csrc/knn_slab.cu``): the
dense-slab kNN tables that the kNN selection bench times beside the
streaming ``knn_topk`` kernel.

For CUDA tensors it launches the kernel or raises; for CPU tensors it
runs the plain version (``ref.py``).  No fallback from a failed launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels.knn_slab.ref import check_k, knn_slab_ref, padded_width

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    lib = kernels.load_library("knn_slab")
    if lib.knn_slab_launch.argtypes is None:
        lib.knn_slab_launch.argtypes = _ARGTYPES
        lib.knn_slab_launch.restype = ctypes.c_int
    return lib


def knn_slab(
    Vq: torch.Tensor, Vc: torch.Tensor, k: int, exclude_self: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense-slab kNN tables at every lag count.

    Vq (E_max, Lq), Vc (E_max, Lc) float32 -> (idx int32, dist float32),
    each (E_max, Lq, k), sorted by (value, column); masked columns
    (padding ids in [Lc, Lc_pad) and, with ``exclude_self``, column q of
    row q) carry 3.0e38 and appear only where k exceeds the valid
    candidates.  Any k up to Lc_pad = ceil(Lc / 128) * 128.
    """
    check_k(k, Vc.shape[-1])
    if Vq.device.type == "cpu" and Vc.device.type == "cpu":
        return knn_slab_ref(Vq, Vc, k, exclude_self)
    if not (Vq.is_cuda and Vc.is_cuda and Vq.device == Vc.device):
        raise ValueError(
            f"knn_slab: Vq on {Vq.device} and Vc on {Vc.device}; both must "
            "be on one CUDA device (or both on the CPU for the plain version)"
        )
    if Vq.dtype != torch.float32 or Vc.dtype != torch.float32:
        raise ValueError(f"knn_slab takes float32, got {Vq.dtype} / {Vc.dtype}")
    if Vq.dim() != 2 or Vc.dim() != 2 or Vq.shape[0] != Vc.shape[0]:
        raise ValueError(
            f"knn_slab takes Vq (E_max, Lq) and Vc (E_max, Lc), got "
            f"{tuple(Vq.shape)} and {tuple(Vc.shape)}"
        )
    if not (Vq.is_contiguous() and Vc.is_contiguous()):
        raise ValueError("knn_slab takes contiguous Vq and Vc")
    E_max, Lq = Vq.shape
    Lc = Vc.shape[1]
    lib = _lib()
    slab = torch.empty((Lq, padded_width(Lc)), dtype=torch.float32,
                       device=Vq.device)
    idx = torch.empty((E_max, Lq, k), dtype=torch.int32, device=Vq.device)
    dist = torch.empty((E_max, Lq, k), dtype=torch.float32, device=Vq.device)
    with torch.cuda.device(Vq.device):
        rc = lib.knn_slab_launch(
            Vq.data_ptr(), Vc.data_ptr(), slab.data_ptr(), idx.data_ptr(),
            dist.data_ptr(), E_max, Lq, Lc, k, int(exclude_self),
            kernels.current_stream(Vq.device),
        )
    kernels.check_launch("knn_slab", rc, lib)
    knn_slab.LAUNCHES += 1
    return idx, dist


#: kernel launches since the last reset (chip_smoke.py resets and reads it)
knn_slab.LAUNCHES = 0
