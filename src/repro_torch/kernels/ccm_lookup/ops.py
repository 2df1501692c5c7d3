"""Wrapper of the ccm_lookup CUDA kernel (``csrc/ccm_lookup.cu``).

For a CUDA tensor it launches the kernel or raises; for a CPU tensor it
runs the plain version (``ref.py``).  No fallback from a failed launch.
The kernel takes any k and any target length Lp (past the two
staged rows of ``ccm_lookup_max_lp(2)`` it stages one row at a time, past
``ccm_lookup_max_lp(1)`` its gather route reads the targets through L2);
a segment list longer than a launch takes is split into launches, each
writing its own targets' rows of the output.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import kernels
from repro_torch.kernels.ccm_lookup.ref import ccm_lookup_ref

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]


def _lib() -> ctypes.CDLL:
    lib = kernels.load_library("ccm_lookup")
    if lib.ccm_lookup_launch.argtypes is None:
        lib.ccm_lookup_launch.argtypes = _ARGTYPES
        lib.ccm_lookup_launch.restype = ctypes.c_int
        lib.ccm_lookup_max_segments.argtypes = []
        lib.ccm_lookup_max_segments.restype = ctypes.c_int
        lib.ccm_lookup_max_lp.argtypes = [ctypes.c_int]
        lib.ccm_lookup_max_lp.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=256)
def _seg_arrays(segs: tuple[tuple[int, int], ...]):
    """The (rows, counts) C arrays of a segment plan, built once per plan."""
    n = len(segs)
    return (ctypes.c_int * n)(*(r for r, _ in segs)), (ctypes.c_int * n)(
        *(c for _, c in segs))


def segment_runs(segs, max_segs: int):
    """The segment list in launches of at most ``max_segs`` segments:
    [(first target, targets, segments), ...], runs of no target left
    out (the launch would have nothing to write)."""
    runs, b0 = [], 0
    for i in range(0, len(segs), max_segs):
        part = segs[i : i + max_segs]
        n = sum(c for _, c in part)
        if n:
            runs.append((b0, n, part))
        b0 += n
    return runs


def ccm_lookup(idx: torch.Tensor, w: torch.Tensor, Y: torch.Tensor,
               segs=None) -> torch.Tensor:
    """Batched simplex lookup for targets sharing library tables.

    idx (Lq, k) int32, w (Lq, k) float32, Y (B, Lp) float32 -> (B, Lq);
    with a leading table dimension, idx / w (S, Lq, k) -> (S, B, Lq)
    (every table of a chunk in one launch).  Segmented: idx / w
    (S, nb, Lq, k), the table sets of a chunk, and ``segs``
    ((table_row, count), ...), the counts summing to B: segment i is the
    next count_i rows of Y, looked up through table row table_row ->
    (S, B, Lq).  Every idx entry must lie in [0, Lp): the kernel does not
    check it.
    """
    if segs is not None:
        segs = tuple((int(r), int(c)) for r, c in segs)
    if idx.device.type == "cpu" and w.device.type == "cpu" and Y.device.type == "cpu":
        return ccm_lookup_ref(idx, w, Y, segs)
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
    if not (w.shape == idx.shape and Y.dim() == 2
            and (idx.dim() == 4 if segs is not None else idx.dim() in (2, 3))):
        raise ValueError(
            f"ccm_lookup takes idx / w ([S,] Lq, k), or (S, nb, Lq, k) with "
            f"segments, and Y (B, Lp); got {tuple(idx.shape)}, {tuple(w.shape)}, "
            f"{tuple(Y.shape)}" + ("" if segs is not None else " without segments")
        )
    if not (idx.is_contiguous() and w.is_contiguous() and Y.is_contiguous()):
        raise ValueError("ccm_lookup takes contiguous idx, w and Y")
    B, Lp = Y.shape
    squeeze = idx.dim() == 2
    if segs is None:  # the nb = 1 case: one segment through the one table
        idx, w = (idx[None, None], w[None, None]) if squeeze else (idx[:, None], w[:, None])
        segs = ((0, B),)
    S, nb, Lq, k = idx.shape
    if sum(c for _, c in segs) != B or any(not 0 <= r < nb or c < 0 for r, c in segs):
        raise ValueError(
            f"ccm_lookup: segments {segs} must cover the B={B} targets with "
            f"table rows in [0, {nb})"
        )
    lib = _lib()
    out = torch.empty((S, B, Lq), dtype=torch.float32, device=Y.device)
    with torch.cuda.device(Y.device):
        for b0, n, part in segment_runs(segs, lib.ccm_lookup_max_segments()):
            rows, counts = _seg_arrays(part)
            rc = lib.ccm_lookup_launch(
                idx.data_ptr(), w.data_ptr(), Y[b0:].data_ptr(),
                out.data_ptr() + b0 * Lq * out.element_size(), S, nb, Lq, k, n, Lp,
                rows, counts, len(part), B, kernels.current_stream(Y.device),
            )
            kernels.check_launch("ccm_lookup", rc, lib)
            ccm_lookup.LAUNCHES += 1
    return out[0] if squeeze else out


#: kernel launches since the last reset (chip_smoke.py resets and reads it)
ccm_lookup.LAUNCHES = 0
