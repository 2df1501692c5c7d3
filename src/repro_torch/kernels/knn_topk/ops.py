"""Wrappers of the knn_topk CUDA kernels: ``knn_topk`` (``csrc/knn_topk.cu``,
the main path's tables) and ``knn_topk_prefix``
(``csrc/knn_topk_prefix.cu``, the convergence diagnostic's prefix tables).

For a CUDA tensor each launches its kernel or raises; for a CPU tensor it
runs the plain version (``ref.py``).  There is no other route: no
fallback from a failed launch to the plain version.  Both kernels take
``dist_dtype`` float32 or bfloat16 (the accumulator of the distance; the
output distances are float32 either way), any E and any k up to the
candidates (the smallest library size for the prefix kernel).

The wrappers pick each launch's route by k, once, in Python
(:func:`route`), and nothing else does: the fast path (one launch that
writes the whole output, at k <= 32 and every selected E at most 32:
:func:`fast_path`); the wide route up to k = ``WIDE_K``, whose launch
holds register lists for one window of the selection: at most
``knn_topk_lists(k)`` selected E whose lags span at most 32, its mask
relative to the window's first lag (:func:`windows`); past ``WIDE_K`` the
key-select route, one block a query row that keeps the row's distances
on chip and selects the k least (distance, id) keys after each selected
E (``common/key_select.cuh``), one launch for every selected E up to lag
``KS_SPAN`` (:func:`ks_windows`).  The wide and key-select routes launch
one kernel a window (and, for the prefix kernel, one a run of at most 64
library sizes), each writing its rows of the output in place.  The C
entry points take the route as their own entry (key-select) or an
argument (fast or wide) and refuse arguments that do not fit it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.core import knn
from repro_torch.kernels.knn_topk.ref import knn_topk_prefix_ref, knn_topk_ref

#: the wide route's table width (kWideK of both sources): past it the
#: key-select route runs
WIDE_K = 128
#: lags a wide launch's selection mask spans (kSpan of both sources: a c_uint)
SPAN = 32
#: the fast path: k and E_hi it takes in one launch (kFastK, kMaxE)
FAST_K = FAST_E = 32
#: lags a key-select launch's mask spans (32 kKsWords of both sources)
KS_SPAN = 2048
#: the launch routes, as :func:`route` names them
ROUTES = ("fast", "wide", "key_select")

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
    ctypes.c_uint] + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_PREFIX_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
    ctypes.c_uint] + [ctypes.c_int] * 5 + [ctypes.c_void_p] + [ctypes.c_int] * 4 + [
    ctypes.c_void_p]
_KS_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [
    ctypes.c_void_p] + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_PREFIX_KS_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [
    ctypes.c_int] * 5 + [ctypes.c_void_p] + [ctypes.c_int] * 5 + [
    ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
_SHAPE_ARGTYPES = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
_DIST_DTYPES = {"float32": 0, "bfloat16": 1}


def _lib() -> ctypes.CDLL:
    lib = kernels.load_library("knn_topk")
    if lib.knn_topk_launch.argtypes is None:
        lib.knn_topk_launch.argtypes = _ARGTYPES
        lib.knn_topk_launch.restype = ctypes.c_int
        for fn, argtypes in ((lib.knn_topk_ks_launch, _KS_ARGTYPES),
                             (lib.knn_topk_ks_shape, _SHAPE_ARGTYPES),
                             (lib.knn_topk_wide_k, []), (lib.knn_topk_span, []),
                             (lib.knn_topk_ks_span, [])):
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.knn_topk_lists.argtypes = [ctypes.c_int]
        lib.knn_topk_lists.restype = ctypes.c_int
    return lib


def _prefix_lib() -> ctypes.CDLL:
    lib = kernels.load_library("knn_topk_prefix")
    if lib.knn_topk_prefix_launch.argtypes is None:
        lib.knn_topk_prefix_launch.argtypes = _PREFIX_ARGTYPES
        lib.knn_topk_prefix_launch.restype = ctypes.c_int
        for fn, argtypes in ((lib.knn_topk_prefix_ks_launch, _PREFIX_KS_ARGTYPES),
                             (lib.knn_topk_prefix_ks_shape, _SHAPE_ARGTYPES),
                             (lib.knn_topk_prefix_wide_k, []),
                             (lib.knn_topk_prefix_max_s, []),
                             (lib.knn_topk_prefix_ks_span, [])):
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.knn_topk_prefix_lists.argtypes = [ctypes.c_int]
        lib.knn_topk_prefix_lists.restype = ctypes.c_int
    return lib


def select_mask(select_Es, e_lo: int = 0) -> int:
    """Bit e set <=> E = e_lo + e + 1 is selected.  Refuses a mask that
    does not fit the kernels' 32-bit ``c_uint`` (ctypes would cut it
    without an error)."""
    m = 0
    for e in select_Es:
        bit = int(e) - 1 - e_lo
        if not 0 <= bit < SPAN:
            raise ValueError(
                f"E={int(e)} lies outside the {SPAN} lags of a launch's "
                f"selection mask from lag {e_lo}: split the selection into "
                "windows (windows())"
            )
        m |= 1 << bit
    return m


def fast_path(select_Es, k: int, n_runs: int = 1) -> bool:
    """True where one fast-path launch writes the whole output: k <= 32,
    every selected E at most 32, and (prefix kernel) one run of library
    sizes."""
    return k <= FAST_K and max(int(e) for e in select_Es) <= FAST_E and n_runs == 1


def route(select_Es, k: int, n_runs: int = 1) -> str:
    """The route of a call: ``fast`` (:func:`fast_path`), ``wide`` (k up
    to ``WIDE_K``) or ``key_select`` (past it)."""
    if fast_path(select_Es, k, n_runs):
        return "fast"
    return "wide" if k <= WIDE_K else "key_select"


def ks_windows(select_Es) -> list[tuple[int, tuple[int, ...]]]:
    """The selection in key-select launches: [(e_lo, Es), ...], each
    window the selected E in lags [e_lo, e_lo + KS_SPAN), e_lo a multiple
    of ``KS_SPAN`` (one launch for every E up to ``KS_SPAN``)."""
    out: dict[int, list[int]] = {}
    for E in select_Es:
        out.setdefault((int(E) - 1) // KS_SPAN * KS_SPAN, []).append(int(E))
    return [(e_lo, tuple(Es)) for e_lo, Es in out.items()]


def ks_mask_words(select_Es, e_lo: int):
    """A key-select launch's mask: KS_SPAN // 32 words, bit e of word w
    set <=> E = e_lo + 32 w + e + 1 is selected."""
    words = [0] * (KS_SPAN // 32)
    for E in select_Es:
        bit = int(E) - 1 - e_lo
        if not 0 <= bit < KS_SPAN:
            raise ValueError(f"E={int(E)} lies outside the {KS_SPAN} lags of a "
                             f"key-select launch from lag {e_lo} (ks_windows())")
        words[bit // 32] |= 1 << (bit % 32)
    return (ctypes.c_uint * len(words))(*words)


def _ks_workspace(shape_fn, rows: int, n: int, k: int, bf16: int, dev, name: str):
    """(grid, device workspace) of a key-select launch over ``rows`` rows
    of ``n`` columns."""
    grid, block_bytes = ctypes.c_longlong(), ctypes.c_longlong()
    rc = shape_fn(rows, n, k, bf16, ctypes.byref(grid), ctypes.byref(block_bytes))
    if rc != 0:
        raise RuntimeError(f"{name}: the key-select route's launch shape failed: "
                           f"CUDA error {rc}")
    work = torch.empty(grid.value * block_bytes.value, dtype=torch.uint8, device=dev)
    return grid.value, work


def windows(select_Es, lists: int, fast: bool = False
            ) -> list[tuple[int, tuple[int, ...]]]:
    """The selection split into launches: [(e_lo, Es), ...] in order.  On
    the fast path (``fast``) one window from lag 0 with every E; on the
    wide route each window at most ``lists`` E whose lags span at most 32,
    e_lo the lag its mask starts at (0 wherever the window's E are all
    <= 32)."""
    select_Es = tuple(int(e) for e in select_Es)
    if fast:
        return [(0, select_Es)]
    out, cur = [], []
    for E in select_Es:
        if cur and (len(cur) == lists or E - cur[0] >= SPAN):
            out.append(tuple(cur))
            cur = []
        cur.append(E)
    out.append(tuple(cur))
    return [(max(0, Es[-1] - SPAN), Es) for Es in out]


def size_runs(lib_sizes, max_s: int) -> list[tuple[int, tuple[int, ...]]]:
    """The library sizes in launches of at most ``max_s``: [(s0, sizes),
    ...].  A size's snapshot depends only on its own prefix of the sweep,
    so each run's launch writes the rows one launch would."""
    lib_sizes = tuple(int(s) for s in lib_sizes)
    return [(s0, lib_sizes[s0 : s0 + max_s]) for s0 in range(0, len(lib_sizes), max_s)]


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
    if not 1 <= k <= Lc:
        raise ValueError(f"knn_topk: k={k} must be in [1, Lc={Lc}]")
    lib = _lib()
    col_hi = knn.check_col_range(Lq, Lc, exclude_self, col_offset, col_hi)
    n_sel = len(select_Es)
    idx = torch.empty((S, n_sel, Lq, k), dtype=torch.int32, device=Vq.device)
    dist = torch.empty((S, n_sel, Lq, k), dtype=torch.float32, device=Vq.device)
    si0 = 0
    kind = route(select_Es, k)
    stream = kernels.current_stream(Vq.device)
    with torch.cuda.device(Vq.device):
        if kind == "key_select":
            grid, work = _ks_workspace(lib.knn_topk_ks_shape, S * Lq, Lc, k, bf16,
                                       Vq.device, "knn_topk")
            for e_lo, Es in ks_windows(select_Es):
                rc = lib.knn_topk_ks_launch(
                    Vq.data_ptr(), Vc.data_ptr(), idx.data_ptr(), dist.data_ptr(),
                    work.data_ptr(), grid, S, E_rows, Lq, Lc, k,
                    ks_mask_words(Es, e_lo), e_lo, si0, n_sel, int(exclude_self),
                    col_offset, col_hi, bf16, stream,
                )
                kernels.check_launch("knn_topk", rc, lib)
                knn_topk.LAUNCHES += 1
                knn_topk.ROUTE_LAUNCHES[kind] += 1
                si0 += len(Es)
            return idx, dist
        for e_lo, Es in windows(select_Es, lib.knn_topk_lists(k), kind == "fast"):
            rc = lib.knn_topk_launch(
                Vq.data_ptr(), Vc.data_ptr(), idx.data_ptr(), dist.data_ptr(),
                S, E_rows, Lq, Lc, k, select_mask(Es, e_lo), e_lo, si0, n_sel,
                int(exclude_self), col_offset, col_hi, bf16, int(kind == "fast"),
                stream,
            )
            kernels.check_launch("knn_topk", rc, lib)
            knn_topk.LAUNCHES += 1
            knn_topk.ROUTE_LAUNCHES[kind] += 1
            si0 += len(Es)
    return idx, dist


#: kernel launches since the last reset (chip_smoke.py resets and reads
#: it), and of them those of each route
knn_topk.LAUNCHES = 0
knn_topk.ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)


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
    S, n_sel = len(lib_sizes), len(buckets)
    idx = torch.empty((B, S, n_sel, Lq, k), dtype=torch.int32, device=Vq.device)
    dist = torch.empty((B, S, n_sel, Lq, k), dtype=torch.float32, device=Vq.device)
    runs = size_runs(lib_sizes, lib.knn_topk_prefix_max_s())
    kind = route(buckets, k, len(runs))
    cids = None if col_ids is None else col_ids.data_ptr()
    stream = kernels.current_stream(Vq.device)
    with torch.cuda.device(Vq.device):
        for s0, run in runs:
            sizes = (ctypes.c_int * len(run))(*run)
            si0 = 0
            if kind == "key_select":
                grid, work = _ks_workspace(lib.knn_topk_prefix_ks_shape, B * Lq,
                                           run[-1], k, bf16, Vq.device,
                                           "knn_topk_prefix")
                for e_lo, Es in ks_windows(buckets):
                    rc = lib.knn_topk_prefix_ks_launch(
                        Vq.data_ptr(), Vc.data_ptr(), cids, idx.data_ptr(),
                        dist.data_ptr(), work.data_ptr(), grid, B, E_rows, Lq, Lc,
                        k, ks_mask_words(Es, e_lo), e_lo, si0, n_sel,
                        int(exclude_self), bf16, sizes, len(run), s0, S, stream,
                    )
                    kernels.check_launch("knn_topk_prefix", rc, lib)
                    knn_topk_prefix.LAUNCHES += 1
                    knn_topk_prefix.ROUTE_LAUNCHES[kind] += 1
                    si0 += len(Es)
                continue
            for e_lo, Es in windows(buckets, lib.knn_topk_prefix_lists(k),
                                    kind == "fast"):
                rc = lib.knn_topk_prefix_launch(
                    Vq.data_ptr(), Vc.data_ptr(), cids, idx.data_ptr(),
                    dist.data_ptr(), B, E_rows, Lq, Lc, k, select_mask(Es, e_lo),
                    e_lo, si0, n_sel, int(exclude_self), bf16, sizes, len(run), s0,
                    S, int(kind == "fast"), stream,
                )
                kernels.check_launch("knn_topk_prefix", rc, lib)
                knn_topk_prefix.LAUNCHES += 1
                knn_topk_prefix.ROUTE_LAUNCHES[kind] += 1
                si0 += len(Es)
    return idx, dist


#: kernel launches since the last reset (chip_smoke.py resets and reads
#: it), and of them those of each route
knn_topk_prefix.LAUNCHES = 0
knn_topk_prefix.ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)
