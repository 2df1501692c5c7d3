"""Wrappers of the knn_topk CUDA kernels: ``knn_topk`` (``csrc/knn_topk.cu``,
the main path's tables) and ``knn_topk_prefix``
(``csrc/knn_topk_prefix.cu``, the convergence diagnostic's prefix tables).

For a CUDA tensor each launches its kernel or raises; for a CPU tensor it
runs the plain version (``ref.py``).  There is no other route: no
fallback from a failed launch to the plain version.  Both kernels take
``dist_dtype`` float32 or bfloat16 (the accumulator of the distance; the
output distances are float32 either way).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.core import knn
from repro_torch.kernels.knn_topk.ref import knn_topk_prefix_ref, knn_topk_ref

#: the kernels' table width and E bound (kMaxK, kMaxE of both sources; the
#: ccm_lookup kernel's kMaxK too): the engine checks a config against them
#: before any work (``CudaEngine.check_limits``)
MAX_K, MAX_E = 32, 32

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
    ctypes.c_uint, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
]
_PREFIX_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
    ctypes.c_uint, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p,
]
_DIST_DTYPES = {"float32": 0, "bfloat16": 1}


def _lib() -> ctypes.CDLL:
    lib = kernels.load_library("knn_topk")
    if lib.knn_topk_launch.argtypes is None:
        lib.knn_topk_launch.argtypes = _ARGTYPES
        lib.knn_topk_launch.restype = ctypes.c_int
        for fn in (lib.knn_topk_max_k, lib.knn_topk_max_e):
            fn.argtypes = []
            fn.restype = ctypes.c_int
    return lib


def _prefix_lib() -> ctypes.CDLL:
    lib = kernels.load_library("knn_topk_prefix")
    if lib.knn_topk_prefix_launch.argtypes is None:
        lib.knn_topk_prefix_launch.argtypes = _PREFIX_ARGTYPES
        lib.knn_topk_prefix_launch.restype = ctypes.c_int
        for fn in (lib.knn_topk_prefix_max_k, lib.knn_topk_prefix_max_e,
                   lib.knn_topk_prefix_max_s):
            fn.argtypes = []
            fn.restype = ctypes.c_int
    return lib


def select_mask(select_Es) -> int:
    """Bit e set <=> E = e + 1 is selected."""
    m = 0
    for e in select_Es:
        m |= 1 << (int(e) - 1)
    return m


def _check_cuda_pair(name: str, Vq, Vc, dist_dtype) -> int:
    """Validate a launch's inputs; returns the kernel's bf16 flag."""
    if not (Vq.is_cuda and Vc.is_cuda and Vq.device == Vc.device):
        raise ValueError(
            f"{name}: Vq on {Vq.device} and Vc on {Vc.device}; both must "
            "be on one CUDA device (or both on the CPU for the plain version)"
        )
    bf16 = _DIST_DTYPES.get(str(dist_dtype).removeprefix("torch."))
    if bf16 is None:
        raise ValueError(
            f"{name} kernel accumulates in float32 or bfloat16, not "
            f"dist_dtype={dist_dtype}"
        )
    if Vq.dtype != torch.float32 or Vc.dtype != torch.float32:
        raise ValueError(f"{name} takes float32, got {Vq.dtype} / {Vc.dtype}")
    if Vq.dim() != 3 or Vc.dim() != 3 or Vq.shape[:2] != Vc.shape[:2]:
        raise ValueError(
            f"{name} takes Vq (S, E_rows, Lq) and Vc (S, E_rows, Lc), got "
            f"{tuple(Vq.shape)} and {tuple(Vc.shape)}"
        )
    if not (Vq.is_contiguous() and Vc.is_contiguous()):
        raise ValueError(f"{name} takes contiguous Vq and Vc")
    return bf16


def knn_topk(
    Vq: torch.Tensor,
    Vc: torch.Tensor,
    k: int,
    exclude_self: bool,
    select_Es,
    dist_dtype="float32",
    col_offset: int = 0,
    col_hi: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """kNN tables at the embedding dimensions ``select_Es``.

    Vq (S, E_rows, Lq), Vc (S, E_rows, Lc) float32 -> (idx int32, dist
    float32), each (S, len(select_Es), Lq, k), sorted by (distance, id);
    masked entries come back as +inf with their own id.  E values below
    max(select_Es) outside the set only accumulate distance.

    Column range (one shard of the library): column c of Vc is global
    candidate ``col_offset + c``, the id the tables hold; global ids at or
    past ``col_hi`` (default ``col_offset + Lc``) are masked, and
    ``exclude_self`` masks the global id equal to the query row.
    """
    select_Es = tuple(int(e) for e in select_Es)
    if Vq.device.type == "cpu" and Vc.device.type == "cpu":
        return knn_topk_ref(Vq, Vc, k, exclude_self, select_Es,
                            dist_dtype=dist_dtype, col_offset=col_offset,
                            col_hi=col_hi)
    bf16 = _check_cuda_pair("knn_topk", Vq, Vc, dist_dtype)
    S, E_rows, Lq = Vq.shape
    Lc = Vc.shape[2]
    knn.check_select_Es(select_Es, E_rows)
    lib = _lib()
    if not 1 <= k <= min(Lc, lib.knn_topk_max_k()):
        raise ValueError(
            f"knn_topk: k={k} must be in [1, min(Lc={Lc}, "
            f"{lib.knn_topk_max_k()})]"
        )
    if select_Es[-1] > lib.knn_topk_max_e():
        raise ValueError(f"knn_topk: E={select_Es[-1]} above {lib.knn_topk_max_e()}")
    col_hi = knn.check_col_range(Lq, Lc, exclude_self, col_offset, col_hi)
    n_sel = len(select_Es)
    idx = torch.empty((S, n_sel, Lq, k), dtype=torch.int32, device=Vq.device)
    dist = torch.empty((S, n_sel, Lq, k), dtype=torch.float32, device=Vq.device)
    with torch.cuda.device(Vq.device):
        rc = lib.knn_topk_launch(
            Vq.data_ptr(), Vc.data_ptr(), idx.data_ptr(), dist.data_ptr(),
            S, E_rows, Lq, Lc, k, select_mask(select_Es), int(exclude_self),
            col_offset, col_hi, bf16, kernels.current_stream(Vq.device),
        )
    kernels.check_launch("knn_topk", rc, lib)
    knn_topk.LAUNCHES += 1
    return idx, dist


#: kernel launches since the last reset (chip_smoke.py resets and reads it)
knn_topk.LAUNCHES = 0


def knn_topk_prefix(
    Vq: torch.Tensor,
    Vc: torch.Tensor,
    k: int,
    exclude_self: bool,
    buckets,
    lib_sizes,
    col_ids: torch.Tensor | None = None,
    dist_dtype="float32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Prefix-snapshot kNN tables for nested library sizes.

    Vq (B, E_rows, Lq), Vc (B, E_rows, Lc) float32; ``col_ids`` (Lc,)
    int32 sweep order (None = natural order); ``lib_sizes`` ascending
    prefix sizes of the sweep -> (idx int32, dist float32), each
    (B, len(lib_sizes), len(buckets), Lq, k), sorted by (distance, sweep
    position), ids original column ids.  Every col_ids entry must lie in
    [0, Lc): the kernel does not check it.
    """
    buckets = tuple(int(e) for e in buckets)
    lib_sizes = tuple(int(s) for s in lib_sizes)
    if Vq.device.type == "cpu" and Vc.device.type == "cpu" and (
            col_ids is None or col_ids.device.type == "cpu"):
        return knn_topk_prefix_ref(Vq, Vc, k, exclude_self, buckets, lib_sizes,
                                   col_ids=col_ids, dist_dtype=dist_dtype)
    bf16 = _check_cuda_pair("knn_topk_prefix", Vq, Vc, dist_dtype)
    B, E_rows, Lq = Vq.shape
    Lc = Vc.shape[2]
    knn._check_prefix_args(Lq, Lc, k, exclude_self, buckets, lib_sizes, E_rows,
                           col_ids)
    if col_ids is not None:
        if col_ids.device != Vq.device or col_ids.dtype != torch.int32:
            raise ValueError(
                f"knn_topk_prefix takes col_ids int32 on {Vq.device}, got "
                f"{col_ids.dtype} on {col_ids.device}"
            )
        if col_ids.shape != (Lc,) or not col_ids.is_contiguous():
            raise ValueError(
                f"knn_topk_prefix takes contiguous col_ids of shape ({Lc},), "
                f"got {tuple(col_ids.shape)}"
            )
    lib = _prefix_lib()
    if k > lib.knn_topk_prefix_max_k():
        raise ValueError(f"knn_topk_prefix: k={k} above {lib.knn_topk_prefix_max_k()}")
    if buckets[-1] > lib.knn_topk_prefix_max_e():
        raise ValueError(f"knn_topk_prefix: E={buckets[-1]} above "
                         f"{lib.knn_topk_prefix_max_e()}")
    if len(lib_sizes) > lib.knn_topk_prefix_max_s():
        raise ValueError(f"knn_topk_prefix: {len(lib_sizes)} library sizes, at "
                         f"most {lib.knn_topk_prefix_max_s()}")
    S, n_sel = len(lib_sizes), len(buckets)
    idx = torch.empty((B, S, n_sel, Lq, k), dtype=torch.int32, device=Vq.device)
    dist = torch.empty((B, S, n_sel, Lq, k), dtype=torch.float32, device=Vq.device)
    sizes = (ctypes.c_int * S)(*lib_sizes)
    with torch.cuda.device(Vq.device):
        rc = lib.knn_topk_prefix_launch(
            Vq.data_ptr(), Vc.data_ptr(),
            None if col_ids is None else col_ids.data_ptr(),
            idx.data_ptr(), dist.data_ptr(), B, E_rows, Lq, Lc, k,
            select_mask(buckets), int(exclude_self), bf16, sizes, S,
            kernels.current_stream(Vq.device),
        )
    kernels.check_launch("knn_topk_prefix", rc, lib)
    knn_topk_prefix.LAUNCHES += 1
    return idx, dist


#: kernel launches since the last reset (chip_smoke.py resets and reads it)
knn_topk_prefix.LAUNCHES = 0
