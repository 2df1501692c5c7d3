"""kNN tables of the port — the plain PyTorch table functions.

These are the plain versions of the ``knn_topk`` CUDA kernel
(``kernels/knn_topk``) and the ``torch-reference`` engine's path.  They
compute the JAX package's ``core/knn.py`` tables exactly: the same
indices and the same float32 distance bits, ties included.

Distances follow the cumulative-E recurrence D_E = D_{E-1} + (lag
difference)^2 with the square-then-add rounding pinned (:func:`_acc_sq`).
Selection streams over candidate tiles of width ``tile_c``: each tile is
sorted to its own top-k and merged into a running sorted (Lq, k) table
(:func:`merge_topk_sorted`), so no (Lq, Lc) matrix wider than one tile
exists.  Both the per-tile selection and the merge are STABLE sorts on
the distance, which resolves equal distances to the lowest candidate id
— the ``lax.top_k`` rule.  ``torch.topk`` is never used: its tie order
is undocumented.

Masked candidates (the self column under ``exclude_self``) carry +inf
and come back as (+inf, own id), which is what the JAX tables hold in
the k == Lc case.

Library sharding (the JAX package's DESIGN.md SS8 / SS14): a table
function given ``col_offset`` / ``col_hi`` selects over one contiguous
shard of the candidates, column j being global candidate ``col_offset +
j``; the shards' tables reduce to the unsharded table bit for bit by
:func:`merge_topk_tree` (in one process, across devices too) or
:func:`merge_topk_collective` (across the ranks of a
``torch.distributed`` group); :func:`merge_shard_tables` is the host
lexsort oracle of both.

Every table function takes the series batch as the leading dimension:
Vq (S, E_rows, Lq), Vc (S, E_rows, Lc) -> idx, dist (S, n_sel, Lq, k).

The prefix-snapshot tables of the convergence diagnostic
(:func:`knn_tables_prefix_streaming`, the plain version of the
``knn_topk_prefix`` kernel) sweep the candidates through a ``col_ids``
permutation and snapshot the running lists at each library size; there
equal distances go to the earliest sweep position, as in the JAX
prefix builders.

:func:`knn_table_single_E` rebuilds one E's table from scratch, the
naive baseline's (``core/baseline.py``); :func:`streaming_bytes` is the
JAX package's working-set formula, which the kNN bench reports.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.stats import simplex_weights

INF = float("inf")

# Working-set budget of the plain table functions' candidate tile: one
# (rows, tile) float32 distance block, its masked copy and the stable
# sort's values + int64 positions.  A bound on host or device memory for
# the plain version only; the CUDA kernel stages its own tiles in shared
# memory and ignores it.
KNN_TILE_BUDGET_BYTES = 256 * 2**20
KNN_TILE_MIN, KNN_TILE_MAX = 128, 16384
_BYTES_PER_TILE_ELEM = 4 + 4 + 4 + 8


def _dtype(d) -> torch.dtype:
    return getattr(torch, d) if isinstance(d, str) else d


def calibrate_knn_tile(
    rows: int, Lc: int, budget_bytes: int = KNN_TILE_BUDGET_BYTES
) -> int:
    """Widest power-of-two tile width in [KNN_TILE_MIN, KNN_TILE_MAX]
    whose (rows, tile) working set fits ``budget_bytes``; stops once the
    tile covers the library (a single tile is the direct selection)."""
    if Lc < 1:
        raise ValueError(f"Lc={Lc} must be positive")
    tile = KNN_TILE_MIN
    while (
        tile < Lc
        and tile < KNN_TILE_MAX
        and rows * 2 * tile * _BYTES_PER_TILE_ELEM <= budget_bytes
    ):
        tile *= 2
    return tile


def resolve_stream_tile(rows: int, Lc: int, cfg) -> int:
    """``cfg.knn_tile_c`` semantics: > 0 forces that width, 0 calibrates
    (:func:`calibrate_knn_tile`), -1 (the removed dense route) raises."""
    if cfg.knn_tile_c > 0:
        return cfg.knn_tile_c
    if cfg.knn_tile_c < 0:
        raise ValueError(
            "knn_tile_c=-1 (the removed dense distance-matrix selection "
            "path) is deprecated: use 0 (calibrated) or a positive width"
        )
    tile = calibrate_knn_tile(rows, Lc)
    _emit_calibration(rows, Lc, tile)
    return tile


# A calibration is pure shape arithmetic: each distinct (Lc, tile,
# profile) is recorded once a process, not once a chunk.
_calibration_seen: set = set()


def _emit_calibration(rows: int, Lc: int, tile: int) -> None:
    """The ``engine``/``knn_tile`` counter the autotuner pins
    ``knn_tile_c`` from; profile ``plain``: the plain table functions'
    budget (the CUDA kernels stage their own tiles and never calibrate)."""
    from repro_torch.runtime import telemetry  # lazy: knn is a leaf module

    if not telemetry.enabled():
        return
    key = (Lc, tile, "plain")
    if key in _calibration_seen:
        return
    _calibration_seen.add(key)
    telemetry.counter(
        "engine", "knn_tile", float(tile), Lc=Lc, profile="plain",
        working_set_bytes=rows * 2 * tile * _BYTES_PER_TILE_ELEM,
    )


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def streaming_bytes(
    Lq: int, k: int, tile_c: int, n_sel: int, dist_dtype=torch.float32
) -> int:
    """Peak distance-working-set bytes of the JAX package's streaming
    selection (its formula, kept so the kNN bench reports the same
    column): one (Lq, tile_c) tile (accumulator + int32 ids), the tile's
    (Lq, k) partial top-k, the doubled (Lq, 2 K) merge-network buffers
    (K = next power of two >= k; distance, id, rank) and the (n_sel, Lq,
    k) running tables.  Independent of Lc."""
    it = torch.empty((), dtype=_dtype(dist_dtype)).element_size()
    K = _next_pow2(k)
    tile = Lq * tile_c * (it + 4)
    tile_topk = Lq * k * (4 + 4)
    merge = Lq * 2 * K * (4 + 4 + 4)
    carry = n_sel * Lq * k * (4 + 4)
    return tile + tile_topk + merge + carry


def _acc_sq(D, vq, vc, dist_dtype):
    """One cumulative-E distance update with pinned square-then-add
    rounding: d = vq - vc, sq = d * d, D + max(sq, 0), each rounded on
    its own (eager PyTorch runs them as separate elementwise ops, so no
    multiply-add contraction can occur) — the float sequence of the JAX
    ``_acc_sq`` and of the CUDA kernel.

    vq (S, Lq), vc (S, tile), D (S, Lq, tile)."""
    d = vq[..., :, None] - vc[..., None, :]
    sq = (d * d).to(dist_dtype)
    return D + torch.clamp_min(sq, 0)


def merge_topk_sorted(run_i, run_d, new_i, new_d, k: int):
    """Merge a running sorted top-k list with a later tile's sorted list.

    Both lists are sorted by (distance, arrival), and every entry of
    ``new`` arrived after every entry of ``run``, so a stable sort of
    [run | new] on the distance orders by (distance, arrival).  Where
    tiles are swept in ascending candidate id (the main path), arrival
    order is id order — the lax.top_k tie rule; the prefix tables sweep
    through a ``col_ids`` permutation, where it is the earliest sweep
    position."""
    d = torch.cat([run_d, new_d], dim=-1)
    i = torch.cat([run_i, new_i], dim=-1)
    d_sorted, order = torch.sort(d, dim=-1, stable=True)
    return torch.gather(i, -1, order[..., :k]), d_sorted[..., :k]


def merge_topk_tree(idx_parts, dist_parts, k: int):
    """Reduce per-shard top-k tables to the global top-k.

    idx_parts / dist_parts: (..., Lq, k_s) shard tables in ASCENDING
    ``col_offset`` order, ids global.  Contiguous pairs fold through
    :func:`merge_topk_sorted` (running = the left block), level by level.
    Every id of a left block is below every id of its right block, so
    running-before-new is the (distance, id) key of ``lax.top_k`` and of
    :func:`merge_shard_tables`: the unsharded table bit for bit, ties
    included.  Each level keeps ``min(k, w_a + w_b)`` entries, so no
    padding entry is ever made.  The right table of a pair moves to the
    left one's device (a device-to-device copy across local cards); the
    result lies on the first shard's device."""
    parts = list(zip(list(idx_parts), list(dist_parts)))
    if not parts:
        raise ValueError("merge_topk_tree needs at least one shard table")
    while len(parts) > 1:
        nxt = []
        for a in range(0, len(parts) - 1, 2):
            (ia, da), (ib, db) = parts[a], parts[a + 1]
            kk = min(k, ia.shape[-1] + ib.shape[-1])
            nxt.append(merge_topk_sorted(ia, da, ib.to(ia.device),
                                         db.to(ia.device), kk))
        if len(parts) % 2:
            nxt.append(parts[-1])
        parts = nxt
    idx, dist = parts[0]
    return idx[..., :k], dist[..., :k]


def _exchange(dist_mod, group, peer: int, tensors):
    """Send ``tensors`` to rank ``peer`` of ``group`` and receive the same
    shapes from it (one batch of point-to-point ops)."""
    outs = [torch.empty_like(t) for t in tensors]
    gpeer = peer if group is None else dist_mod.get_global_rank(group, peer)
    ops = [dist_mod.P2POp(dist_mod.isend, t, gpeer, group) for t in tensors]
    ops += [dist_mod.P2POp(dist_mod.irecv, o, gpeer, group) for o in outs]
    for req in dist_mod.batch_isend_irecv(ops):
        req.wait()
    return outs


def merge_topk_collective(idx, dist, k: int, group=None):
    """Merge the shard tables of a ``torch.distributed`` group: rank r holds
    the r-th contiguous candidate shard's (..., Lq, k_s) table (global
    ids); every rank returns the global (..., Lq, k) table.

    A power-of-two world runs a butterfly: at step s each rank exchanges
    its table with rank ``r ^ s`` and keeps the merge of the two blocks,
    the lower rank's as the running side, so each merge is of contiguous
    ascending blocks and the tie rule of :func:`merge_topk_tree` holds;
    log2(W) steps of one table each.  Other worlds: one ``all_gather`` and
    :func:`merge_topk_tree` on every rank.  Every rank's table has the
    same width (``min(k, shard)``), so the buffers take the sender's shape.

    On a ``gloo`` group the tables go through host memory (gloo's
    point-to-point takes CPU tensors) and come back to ``idx``'s device;
    on NCCL they move card to card."""
    import torch.distributed as dist_mod

    W = dist_mod.get_world_size(group)
    if W == 1:
        return idx[..., :k], dist[..., :k]
    me = dist_mod.get_rank(group)
    dev = idx.device
    host = dist_mod.get_backend(group) == "gloo"
    stage = (lambda t: t.contiguous().cpu()) if host else (lambda t: t.contiguous())
    if W & (W - 1) == 0:
        step = 1
        while step < W:
            oi, od = (t.to(dev) for t in
                      _exchange(dist_mod, group, me ^ step, [stage(idx), stage(dist)]))
            kk = min(k, idx.shape[-1] + oi.shape[-1])
            if me & step == 0:  # the lower block: running side
                idx, dist = merge_topk_sorted(idx, dist, oi, od, kk)
            else:
                idx, dist = merge_topk_sorted(oi, od, idx, dist, kk)
            step *= 2
        return idx[..., :k], dist[..., :k]
    gathered = []
    for t in (stage(idx), stage(dist)):
        bufs = [torch.empty_like(t) for _ in range(W)]
        dist_mod.all_gather(bufs, t, group=group)
        gathered.append([b.to(dev) for b in bufs])
    return merge_topk_tree(gathered[0], gathered[1], k)


def merge_shard_tables(idx_parts, dist_parts, k: int | None = None):
    """Host oracle of the shard merges: numpy (idx, dist) of the global
    top-k under the (distance, id) key — ``np.lexsort`` over the
    concatenated shard tables (ids global).  ``k`` None: the narrowest
    shard table's width."""
    idx = np.concatenate([np.asarray(p) for p in idx_parts], axis=-1)
    dist = np.concatenate([np.asarray(p) for p in dist_parts], axis=-1)
    if k is None:
        k = min(np.asarray(p).shape[-1] for p in idx_parts)
    order = np.lexsort((idx, dist))[..., :k]
    return (np.take_along_axis(idx, order, axis=-1),
            np.take_along_axis(dist, order, axis=-1))


def check_select_Es(select_Es, E_rows: int) -> tuple[int, ...]:
    select_Es = tuple(int(e) for e in select_Es)
    if not select_Es or list(select_Es) != sorted(set(select_Es)) or select_Es[0] < 1:
        raise ValueError(f"select_Es must be ascending, distinct, >= 1: {select_Es}")
    if select_Es[-1] > E_rows:
        raise ValueError(f"selection E {select_Es[-1]} exceeds lag rows {E_rows}")
    return select_Es


def check_col_range(Lq: int, Lc: int, exclude_self: bool, col_offset: int = 0,
                    col_hi: int | None = None) -> int:
    """Validate a column range (the knn_topk kernel's rule); returns
    ``col_hi`` resolved (None = ``col_offset + Lc``).  Without a range,
    ``exclude_self`` needs the query set to be the candidate set, as in the
    JAX package; with one, the query rows must reach ``col_hi``."""
    unsharded = col_offset == 0 and col_hi is None
    col_hi = col_offset + Lc if col_hi is None else int(col_hi)
    if col_offset < 0 or not 0 <= col_hi <= col_offset + Lc:
        raise ValueError(f"column range col_offset={col_offset}, col_hi="
                         f"{col_hi} outside [0, col_offset + Lc={col_offset + Lc}]")
    if exclude_self and unsharded and Lq != Lc:
        raise ValueError("exclude_self requires query set == candidate set")
    if exclude_self and Lq < col_hi:
        raise ValueError(f"exclude_self over global candidates below col_hi="
                         f"{col_hi} needs that many query rows, got Lq={Lq}")
    return col_hi


def _select_tile(D, invalid, k: int, c0: int):
    """Sorted top-min(k, width) of one (S, Lq, width) distance block."""
    Dm = D.float()
    if invalid is not None:
        Dm = Dm.masked_fill(invalid, INF)
    d_sorted, pos = torch.sort(Dm, dim=-1, stable=True)
    m = min(k, D.shape[-1])
    return (pos[..., :m] + c0).to(torch.int32), d_sorted[..., :m]


def _knn_tables_streaming(
    Vq: torch.Tensor,
    Vc: torch.Tensor,
    k: int,
    exclude_self: bool,
    tile_c: int,
    select_Es: tuple[int, ...],
    dist_dtype=torch.float32,
    col_offset: int = 0,
    col_hi: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Candidate-tiled selection at the E values in ``select_Es``; the
    distance recurrence still sweeps every e up to max(select_Es).

    ``col_offset`` / ``col_hi`` (one library shard, the JAX semantics):
    column j of Vc is global candidate ``col_offset + j``; columns at or
    past ``col_hi`` (default ``col_offset + Lc``) are masked to +inf and
    keep their own id, and ``exclude_self`` masks global id == query row.

    Returns (idx int32, dist float32), each (S, len(select_Es), Lq, k)."""
    S, E_rows, Lq = Vq.shape
    Lc = Vc.shape[-1]
    select_Es = check_select_Es(select_Es, E_rows)
    if Vc.shape[:2] != (S, E_rows):
        raise ValueError(f"Vq {tuple(Vq.shape)} and Vc {tuple(Vc.shape)} disagree")
    if k > Lc:
        raise ValueError(f"k={k} exceeds candidate count Lc={Lc}")
    col_hi = check_col_range(Lq, Lc, exclude_self, col_offset, col_hi)
    dist_dtype = _dtype(dist_dtype)
    # The first tile is selected directly, so it must hold >= k columns;
    # balanced widths as in the JAX table functions (any width gives the same
    # tables).
    tile_c = max(k, min(tile_c, Lc))
    n_tiles = -(-Lc // tile_c)
    tile_c = max(k, -(-Lc // n_tiles))
    want = set(select_Es)
    rows = torch.arange(Lq, device=Vq.device)[:, None]
    run_i = run_d = None
    for c0 in range(0, Lc, tile_c):
        c1 = min(c0 + tile_c, Lc)
        gid = torch.arange(col_offset + c0, col_offset + c1, device=Vq.device)[None, :]
        invalid = None
        if col_offset + c1 > col_hi:
            invalid = gid >= col_hi
        if exclude_self:
            self_col = gid == rows
            invalid = self_col if invalid is None else invalid | self_col
        D = torch.zeros((S, Lq, c1 - c0), dtype=dist_dtype, device=Vq.device)
        t_i, t_d = [], []
        for e in range(select_Es[-1]):
            D = _acc_sq(D, Vq[:, e], Vc[:, e, c0:c1], dist_dtype)
            if e + 1 in want:
                i, d = _select_tile(D, invalid, k, col_offset + c0)
                t_i.append(i)
                t_d.append(d)
        T_i, T_d = torch.stack(t_i, dim=1), torch.stack(t_d, dim=1)
        if run_i is None:
            run_i, run_d = T_i, T_d
        else:
            run_i, run_d = merge_topk_sorted(run_i, run_d, T_i, T_d, k)
    return run_i, run_d


def knn_tables_all_E_streaming(
    Vq, Vc, k_max: int, exclude_self: bool, tile_c: int, dist_dtype=torch.float32,
    col_offset: int = 0, col_hi: int | None = None,
):
    """All-E streaming tables: (S, E_rows, Lq, k_max) each — phase 1's
    selection path (and the unbucketed phase 2's); with ``col_offset`` /
    ``col_hi`` one library shard's (:func:`_knn_tables_streaming`)."""
    return _knn_tables_streaming(
        Vq, Vc, k_max, exclude_self, tile_c,
        tuple(range(1, Vq.shape[1] + 1)), dist_dtype, col_offset, col_hi,
    )


def knn_tables_bucketed_streaming(
    Vq, Vc, k: int, exclude_self: bool, buckets, tile_c: int,
    dist_dtype=torch.float32,
):
    """Bucketed streaming tables: (S, len(buckets), Lq, k) each —
    selection only at the bucket dimensions (phase 2)."""
    return _knn_tables_streaming(
        Vq, Vc, k, exclude_self, tile_c, tuple(buckets), dist_dtype
    )


def _check_prefix_args(
    Lq: int, Lc: int, k: int, exclude_self: bool,
    buckets: tuple[int, ...], lib_sizes: tuple[int, ...], E_rows: int,
    col_ids,
) -> None:
    """The JAX package's validation of the prefix tables, message for
    message."""
    if not buckets or list(buckets) != sorted(set(buckets)):
        raise ValueError(f"buckets must be ascending and distinct: {buckets}")
    if buckets[-1] > E_rows:
        raise ValueError(f"bucket E {buckets[-1]} exceeds lag rows {E_rows}")
    if not lib_sizes or list(lib_sizes) != sorted(set(lib_sizes)):
        raise ValueError(
            f"lib_sizes must be ascending and distinct: {lib_sizes}"
        )
    if lib_sizes[-1] > Lc:
        raise ValueError(
            f"lib_sizes[-1]={lib_sizes[-1]} exceeds candidate count Lc={Lc}"
        )
    # Every query row must find k real neighbours inside the smallest
    # library; with self-exclusion one prefix column may be the query
    # itself, so one extra candidate is required.
    need = k + 1 if exclude_self else k
    if lib_sizes[0] < need:
        raise ValueError(
            f"lib_sizes[0]={lib_sizes[0]} too small for k={k} neighbours"
            + (" with self-exclusion" if exclude_self else "")
            + "; raise the smallest library size or shrink k"
        )
    if exclude_self and col_ids is None and Lq != Lc:
        raise ValueError("exclude_self requires query set == candidate set")


def _prefix_tile_bounds(
    lib_sizes: tuple[int, ...], tile_c: int
) -> list[tuple[int, int]]:
    """Candidate-tile [start, stop) spans of sweep positions covering
    [0, lib_sizes[-1]) that never cross a library-size boundary, so the
    running list after the tile ending at each boundary IS that
    prefix's table."""
    bounds = []
    lo = 0
    for hi in lib_sizes:
        for s in range(lo, hi, tile_c):
            bounds.append((s, min(s + tile_c, hi)))
        lo = hi
    return bounds


def knn_tables_prefix_streaming(
    Vq: torch.Tensor,
    Vc: torch.Tensor,
    k: int,
    exclude_self: bool,
    buckets,
    lib_sizes,
    tile_c: int,
    dist_dtype=torch.float32,
    col_ids: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One-sweep prefix-snapshot kNN tables of the convergence diagnostic.

    Vq (B, E_rows, Lq), Vc (B, E_rows, Lc) -> (idx int32, dist float32),
    each (B, S, len(buckets), Lq, k) with S = len(lib_sizes): slice s
    holds, at every bucket E, the top-k over sweep positions
    [0, lib_sizes[s]).  ``col_ids`` (Lc,) routes sweep position p to
    candidate column col_ids[p] (None = natural order); emitted indices
    are the original column ids and ``exclude_self`` masks
    col_ids[p] == query row.

    Tiles are clipped at library-size boundaries and the running list
    is snapshotted at each boundary.  Ties go to the earliest sweep
    position: each tile is sorted stably in sweep order and merged
    running-before-new (:func:`merge_topk_sorted`).  With a permuted
    ``col_ids`` that differs from the main path's lowest-id rule."""
    B, E_rows, Lq = Vq.shape
    Lc = Vc.shape[-1]
    buckets = tuple(int(b) for b in buckets)
    lib_sizes = tuple(int(s) for s in lib_sizes)
    _check_prefix_args(Lq, Lc, k, exclude_self, buckets, lib_sizes, E_rows,
                       col_ids)
    if Vc.shape[:2] != (B, E_rows):
        raise ValueError(f"Vq {tuple(Vq.shape)} and Vc {tuple(Vc.shape)} disagree")
    dist_dtype = _dtype(dist_dtype)
    dev = Vq.device
    E_hi = buckets[-1]
    # The first tile selects directly, so it must hold k real candidates
    # (as in the JAX builder, tiles are never narrowed to lib_sizes[0]).
    tile_c = max(k + 1 if exclude_self else k, tile_c)
    want = set(buckets)
    boundary = set(lib_sizes)
    rows = torch.arange(Lq, device=dev)[:, None]
    if col_ids is not None:
        col_ids = col_ids.to(device=dev, dtype=torch.int64)
    run_i = run_d = None
    snaps_i, snaps_d = [], []
    for start, stop in _prefix_tile_bounds(lib_sizes, tile_c):
        if col_ids is None:
            ids = torch.arange(start, stop, device=dev)
            vc_t = Vc[:, :E_hi, start:stop]
        else:
            ids = col_ids[start:stop]
            vc_t = Vc[:, :E_hi].index_select(-1, ids)
        invalid = (ids[None, :] == rows) if exclude_self else None
        D = torch.zeros((B, Lq, stop - start), dtype=dist_dtype, device=dev)
        t_i, t_d = [], []
        for e in range(E_hi):
            D = _acc_sq(D, Vq[:, e], vc_t[:, e], dist_dtype)
            if e + 1 in want:
                pos, d = _select_tile(D, invalid, k, 0)
                t_i.append(ids[pos.long()].to(torch.int32))
                t_d.append(d)
        T_i, T_d = torch.stack(t_i, dim=1), torch.stack(t_d, dim=1)
        if run_i is None:
            run_i, run_d = T_i, T_d
        else:
            run_i, run_d = merge_topk_sorted(run_i, run_d, T_i, T_d, k)
        if stop in boundary:
            snaps_i.append(run_i)
            snaps_d.append(run_d)
    return torch.stack(snaps_i, dim=1), torch.stack(snaps_d, dim=1)


def knn_tables_prefix_rebuild(
    Vq, Vc, k: int, exclude_self: bool, buckets, lib_sizes, tile_c: int,
    dist_dtype=torch.float32, col_ids=None,
):
    """Per-size oracle of :func:`knn_tables_prefix_streaming`: one
    independent sweep per library size, the same tables."""
    lib_sizes = tuple(int(s) for s in lib_sizes)
    _check_prefix_args(Vq.shape[-1], Vc.shape[-1], k, exclude_self,
                       tuple(buckets), lib_sizes, Vq.shape[1], col_ids)
    outs = [
        knn_tables_prefix_streaming(Vq, Vc, k, exclude_self, buckets, (Ls,),
                                    tile_c, dist_dtype, col_ids)
        for Ls in lib_sizes
    ]
    return (torch.cat([o[0] for o in outs], dim=1),
            torch.cat([o[1] for o in outs], dim=1))


def knn_tables_dense(
    Vq, Vc, k_max: int, exclude_self: bool, impl: str = "scan",
    dist_dtype=torch.float32,
):
    """DENSE ORACLE: the full (S, Lq, Lc) distance matrix, selected at
    every E by one stable sort.  Tests hold the streaming table functions (any
    tile width) and the kernel against it.

    ``impl``, the variants of the JAX function (its ``fig9b`` bench):
      scan, unroll -- the cumulative-E loop, one selection after each lag.
          JAX's are two XLA schedules of it (a ``lax.scan`` and a loop
          XLA may fuse); eager PyTorch has no fusion schedule to tell them
          apart, so both run this one loop.
      rebuild -- each E's distances from scratch in the matrix-product
          form (:func:`_matmul_sq_dists`, TF32 off): the same neighbours
          but at near-ties, the distances to float32 round-off.
      blocked:g -- the cumulative loop with g selections batched into one
          sort over g stacked matrices; where g does not divide E_max,
          ``unroll``, as the JAX function falls back.
    The cumulative variants give the same tables, bit for bit."""
    S, E_rows, Lq = Vq.shape
    Lc = Vc.shape[-1]
    if exclude_self and Lq != Lc:
        raise ValueError("exclude_self requires query set == candidate set")
    g = 1
    if impl.startswith("blocked"):
        g = int(impl.split(":")[1]) if ":" in impl else 4
        if E_rows % g != 0:
            g = 1
    elif impl not in ("scan", "unroll", "rebuild"):
        raise ValueError(f"knn_tables_dense: unknown impl {impl!r} (scan, unroll, "
                         "rebuild, blocked:g)")
    dist_dtype = _dtype(dist_dtype)
    invalid = torch.eye(Lq, dtype=torch.bool, device=Vq.device) if exclude_self else None
    if impl == "rebuild":
        outs = [
            _select_tile(_matmul_sq_dists(Vq[:, :E], Vc[:, :E]).to(dist_dtype),
                         invalid, k_max, 0)
            for E in range(1, E_rows + 1)
        ]
    else:
        D = torch.zeros((S, Lq, Lc), dtype=dist_dtype, device=Vq.device)
        outs = []
        for e0 in range(0, E_rows, g):
            Ds = []
            for e in range(e0, e0 + g):
                D = _acc_sq(D, Vq[:, e], Vc[:, e], dist_dtype)
                Ds.append(D)
            if g == 1:
                outs.append(_select_tile(D, invalid, k_max, 0))
            else:
                i, d = _select_tile(torch.stack(Ds, dim=1), invalid, k_max, 0)
                outs.extend(zip(i.unbind(1), d.unbind(1)))
    return (
        torch.stack([o[0] for o in outs], dim=1),
        torch.stack([o[1] for o in outs], dim=1),
    )


def _matmul_sq_dists(dq: torch.Tensor, dc: torch.Tensor) -> torch.Tensor:
    """|q - c|^2 = |q|^2 + |c|^2 - 2 q.c, the matrix-product form; dq
    (..., E, Lq), dc (..., E, Lc) -> (..., Lq, Lc).  The product runs in
    full float32: TF32 is switched off around it on the card."""
    sq = (dq * dq).sum(dim=-2)[..., :, None] + (dc * dc).sum(dim=-2)[..., None, :]
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        prod = dq.transpose(-1, -2) @ dc
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    return torch.clamp_min(sq - 2.0 * prod, 0.0)


def knn_table_single_E(
    Vq: torch.Tensor,
    Vc: torch.Tensor,
    E: int,
    k: int,
    exclude_self: bool,
    *,
    matmul_form: bool = False,
    candidate_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-E kNN table computed from scratch (cppEDM / Alg. 3): the
    naive baseline's table and an oracle.  Vq (..., E_rows, Lq), Vc (...,
    E_rows, Lc) -> (idx int32, dist float32), each (..., Lq, k).

    ``matmul_form=False`` accumulates the lag terms one by one with
    :func:`_acc_sq`, bit-identical to the cumulative tables;
    ``matmul_form=True`` uses |q|^2 + |c|^2 - 2 q.c (:func:`_matmul_sq_dists`),
    equal to it only up to rounding.  ``candidate_mask`` (Lc,) bool keeps
    the columns where it is True (library subsampling); excluded columns
    and, with ``exclude_self``, the diagonal get +inf.  Ties go to the
    lowest column (a stable sort: the ``lax.top_k`` rule)."""
    dq, dc = Vq[..., :E, :], Vc[..., :E, :]
    Lq, Lc = Vq.shape[-1], Vc.shape[-1]
    if matmul_form:
        D = _matmul_sq_dists(dq, dc)
    else:
        D = torch.zeros(Vq.shape[:-2] + (Lq, Lc), dtype=torch.float32,
                        device=Vq.device)
        for e in range(E):
            D = _acc_sq(D, dq[..., e, :], dc[..., e, :], torch.float32)
    if exclude_self:
        D = D.masked_fill(torch.eye(Lq, Lc, dtype=torch.bool, device=D.device), INF)
    if candidate_mask is not None:
        D = D.masked_fill(~candidate_mask.to(D.device)[None, :], INF)
    d_sorted, pos = torch.sort(D, dim=-1, stable=True)
    return pos[..., :k].to(torch.int32), d_sorted[..., :k]


def tables_with_weights(indices, sq_dists):
    """Stacked all-E tables (..., E_max, Lq, k) -> (indices, weights):
    table e (E = e+1) weights its first E+1 neighbours."""
    E_max = indices.shape[-3]
    k_valid = torch.arange(2, E_max + 2, device=sq_dists.device)[:, None, None]
    return indices, simplex_weights(sq_dists, k_valid)


def tables_with_weights_bucketed(indices, sq_dists, buckets):
    """Bucketed tables (..., nb, Lq, k): row b weights buckets[b] + 1
    neighbours."""
    k_valid = (
        torch.as_tensor(buckets, dtype=torch.int64, device=sq_dists.device)[:, None, None]
        + 1
    )
    return indices, simplex_weights(sq_dists, k_valid)


def simplex_forecast(idx, w, fut_c):
    """Weighted average of candidate futures (paper Alg. 5).

    idx, w: (S, ..., Lq, k); fut_c: (S, Lc) per-series candidate futures
    (or (Lc,) shared by every table).  Returns (S, ..., Lq)."""
    if fut_c.dim() == 1:
        g = fut_c[idx.long()]
    else:
        S = fut_c.shape[0]
        g = torch.gather(fut_c, -1, idx.reshape(S, -1).long()).reshape(idx.shape)
    return (w * g).sum(dim=-1)
