"""Wrapper of the knn_slab CUDA kernel (``csrc/knn_slab.cu``): the
dense-slab kNN tables that the kNN selection bench times beside the
streaming ``knn_topk`` kernel.

For CUDA tensors it launches the kernel or raises; for CPU tensors it
runs the plain version (``ref.py``).  No fallback from a failed launch.
The kernel counts its (row, lag) selections by route in a small device
buffer per card that this module owns (:func:`route_counts`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels.knn_slab.ref import check_k, knn_slab_ref

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]

#: the kernel's counters, in the order of its device buffer: (row, lag)
#: selections that took the ``filter`` route (the keys at or below a
#: threshold, sorted on chip) or the exact ``search`` route (a bitwise
#: search for the k-th key over the whole row, past a full candidate
#: buffer or k above its capacity); ``sample``: selections whose threshold
#: came from a sample of the row (at lag 1, and where the previous lag's
#: winners bound it loosely)
COUNTERS = ("filter", "search", "sample")

_COUNTS: dict[int, torch.Tensor] = {}  # device index -> int64 counters


def _lib() -> ctypes.CDLL:
    lib = kernels.load_library("knn_slab")
    if lib.knn_slab_launch.argtypes is None:
        lib.knn_slab_launch.argtypes = _ARGTYPES
        lib.knn_slab_launch.restype = ctypes.c_int
        lib.knn_slab_spill_cols.argtypes = [ctypes.c_int]
        lib.knn_slab_spill_cols.restype = ctypes.c_int
        for fn in (lib.knn_slab_pad, lib.knn_slab_capacity, lib.knn_slab_counters):
            fn.argtypes = []
            fn.restype = ctypes.c_int
        if lib.knn_slab_counters() != len(COUNTERS):
            raise RuntimeError("knn_slab: the kernel's counters do not match "
                               f"{COUNTERS}")
    return lib


def route_counts() -> dict[str, int]:
    """Selections by counter since the last :func:`reset_route_counts`,
    summed over the cards (reads the device buffers)."""
    total = [0] * len(COUNTERS)
    for buf in _COUNTS.values():
        for i, v in enumerate(buf.tolist()):
            total[i] += v
    return dict(zip(COUNTERS, total))


def reset_route_counts() -> None:
    for buf in _COUNTS.values():
        buf.zero_()


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
    dev = Vq.device
    counts = _COUNTS.get(dev.index)
    if counts is None:
        counts = _COUNTS[dev.index] = torch.zeros(len(COUNTERS), dtype=torch.int64,
                                                  device=dev)
    with torch.cuda.device(dev):
        spill_cols = lib.knn_slab_spill_cols(Lc)
        if spill_cols < 0:
            raise RuntimeError("knn_slab: cannot read the card's shared memory "
                               "limit per block")
        spill = torch.empty((Lq, spill_cols), dtype=torch.float32, device=dev)
        idx = torch.empty((E_max, Lq, k), dtype=torch.int32, device=dev)
        dist = torch.empty((E_max, Lq, k), dtype=torch.float32, device=dev)
        rc = lib.knn_slab_launch(
            Vq.data_ptr(), Vc.data_ptr(), spill.data_ptr(), idx.data_ptr(),
            dist.data_ptr(), counts.data_ptr(), E_max, Lq, Lc, k,
            int(exclude_self), kernels.current_stream(dev),
        )
    kernels.check_launch("knn_slab", rc, lib)
    knn_slab.LAUNCHES += 1
    return idx, dist


#: kernel launches since the last reset (chip_smoke.py resets and reads it)
knn_slab.LAUNCHES = 0
