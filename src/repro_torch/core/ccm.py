"""Phase 2 — Convergent Cross Mapping, mpEDM improved algorithm (paper
Alg. 2), over a chunk of library series, in the two table layouts of
the JAX package:

  * bucketed (the default) — each library series gets tables only at the
    distinct optE values (the bucket set); targets are grouped by optE
    (:func:`make_bucket_plan`) and every bucket segment streams through
    its ONE shared table;
  * all-E — tables at every E in 1..E_max (the paper's shape, the A/B
    baseline); each target reads table optE - 1.

The kNN table depends only on the library series, so each library's
tables are built once and reused across all N targets.  The chunk's
series are a leading tensor dimension, so ``ccm_row_tables*`` are also
the reference's ``_block_tables*`` / ``ccm_block_tables*``: one kNN
launch builds the tables of the whole chunk.  The lookup runs in target
blocks of ``cfg.target_block``, one segmented lookup launch and one
Pearson each: a block may cross segment boundaries, each of its
segments going through its own table row.  In the all-E layout a block's
targets are sorted by table row first (:func:`ccm_row_lookup`).

Phase 2 is tileable along the target (column) axis: the tables of a
chunk serve every column tile (:func:`ccm_block_tile_bucketed`,
:func:`ccm_block_tile`), and only the tile's (t, Lp) futures need to be
on the device.  Tiled and untiled maps are equal byte for byte: target
blocks are cut at the same global grid of ``cfg.target_block`` columns
whatever the tile, and each block's Pearson sees the rows of the
untiled block it belongs to (:func:`pearson_layout`), in a buffer laid
out so that neither the chunk size nor a library row's place in its
chunk shows either: a fleet's units of any height give the same bytes.

rho[i, j] = pearson(future of target j, cross-map prediction of j from
library i's manifold).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch import engine as engines
from repro_torch.core import embedding, knn
from repro_torch.core.stats import pearson
from repro_torch.core.types import EDMConfig
from repro_torch.runtime.stream import upload_source


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Static grouping of targets by optimal embedding dimension.

    buckets: ascending distinct E values present in optE;
    counts[b]: number of targets whose optE == buckets[b].
    """

    buckets: tuple[int, ...]
    counts: tuple[int, ...]

    @property
    def offsets(self) -> tuple[int, ...]:
        """Start offset of each bucket's segment in the sorted target order."""
        out, off = [], 0
        for c in self.counts:
            out.append(off)
            off += c
        return tuple(out)

    @property
    def n_targets(self) -> int:
        return sum(self.counts)


def make_bucket_plan(optE: np.ndarray) -> tuple[BucketPlan, np.ndarray]:
    """Group targets by optE: (plan, order), ``order`` a stable host
    permutation into bucket-sorted layout."""
    optE = np.asarray(optE)
    values, counts = np.unique(optE, return_counts=True)
    plan = BucketPlan(
        buckets=tuple(int(v) for v in values),
        counts=tuple(int(c) for c in counts),
    )
    order = np.argsort(optE, kind="stable")
    return plan, order


def make_tile_plans(
    plan: BucketPlan, tile: int
) -> list[tuple[int, tuple[tuple[int, int], ...]]]:
    """Column-tile decomposition of the bucket-sorted target axis:
    [(col0, seg_plan), ...] covering sorted columns [0, N) in tiles of
    ``tile`` (the last may be short); seg_plan is the ((table_row,
    count), ...) intersection of the tile with the bucket segments, as
    :func:`ccm_row_lookup_bucketed` takes it.  The untiled path is the
    one tile of width N."""
    if tile < 1:
        raise ValueError(f"tile must be >= 1, got {tile}")
    N = plan.n_targets
    plans: list[tuple[int, tuple[tuple[int, int], ...]]] = []
    for c0 in range(0, N, tile):
        c1 = min(c0 + tile, N)
        segs = []
        for b, (off, cnt) in enumerate(zip(plan.offsets, plan.counts)):
            lo, hi = max(off, c0), min(off + cnt, c1)
            if hi > lo:
                segs.append((b, hi - lo))
        plans.append((c0, tuple(segs)))
    return plans


def _check_k(k: int, Lp: int, cfg: EDMConfig, where: str) -> None:
    if k < 1:
        raise ValueError(f"{where}: neighbour count k={k} must be >= 1")
    if k > Lp:
        raise ValueError(
            f"{where}: k={k} neighbours requested but only Lp={Lp} library "
            f"points are embeddable (series too short for E_max={cfg.E_max}, "
            f"tau={cfg.tau}, Tp={cfg.Tp}; shrink E_max/k_override or use a "
            "longer series)"
        )


def _bucket_k(cfg: EDMConfig, plan: BucketPlan) -> int:
    """Table width of the bucketed layout (``k_override`` when set)."""
    return plan.buckets[-1] + 1 if cfg.k_override is None else cfg.k_override


def ccm_row_tables(
    rows: torch.Tensor, cfg: EDMConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """All-E kNN tables + weights for a chunk of library series:
    rows (S, L) -> (idx, w), each (S, E_max, Lp, k_max); table e serves
    the targets with optE = e + 1."""
    eng = engines.get_engine(cfg.engine)
    Lp = cfg.n_points(rows.shape[-1])
    _check_k(cfg.k_max, Lp, cfg, "ccm_row_tables")
    V = embedding.lag_matrix(rows, cfg.E_max, cfg.tau, Lp)
    idx, sqd = eng.knn_tables(V, V, cfg.k_max, exclude_self=cfg.exclude_self,
                              cfg=cfg)
    return knn.tables_with_weights(idx, sqd)


def ccm_row_tables_bucketed(
    rows: torch.Tensor, cfg: EDMConfig, plan: BucketPlan
) -> tuple[torch.Tensor, torch.Tensor]:
    """kNN tables + weights for a chunk of library series.

    rows (S, L) -> (idx, w), each (S, len(plan.buckets), Lp, k)."""
    eng = engines.get_engine(cfg.engine)
    Lp = cfg.n_points(rows.shape[-1])
    kb = _bucket_k(cfg, plan)
    _check_k(kb, Lp, cfg, "ccm_row_tables_bucketed")
    V = embedding.lag_matrix(rows, cfg.E_max, cfg.tau, Lp)
    idx, sqd = eng.knn_tables_bucketed(
        V, V, kb, buckets=plan.buckets, exclude_self=cfg.exclude_self, cfg=cfg
    )
    return knn.tables_with_weights_bucketed(idx, sqd, plan.buckets)


@functools.lru_cache(maxsize=256)
def target_blocks(
    seg_plan: tuple[tuple[int, int], ...], block: int, col0: int = 0,
    width: int | None = None,
) -> tuple[tuple[int, int, tuple[tuple[int, int], ...]], ...]:
    """Cut a tile of targets into target blocks that may cross segment
    boundaries: ((b0, b1, segs), ...), [b0, b1) tile positions and segs
    the block's own ((table_row, count), ...).

    ``seg_plan`` ((table_row, count), ...) covers the tile's t targets,
    which are columns [col0, col0 + t) of a ``width``-column target axis
    (default: the tile is the whole axis).  Blocks are cut at the global
    grid of ``block`` columns, so a tile's blocks are pieces of the
    untiled path's blocks.  Built once per plan: plans are static for a
    run."""
    if block < 1:
        raise ValueError(f"target_block must be >= 1, got {block}")
    spans, off = [], 0
    for row, cnt in seg_plan:
        spans.append((off, off + cnt, row))
        off += cnt
    out = []
    b0 = 0
    while b0 < off:
        b1 = min(b0 + block - (col0 + b0) % block, off)
        segs = tuple((row, min(e, b1) - max(s, b0)) for s, e, row in spans
                     if min(e, b1) > max(s, b0))
        out.append((b0, b1, segs))
        b0 = b1
    return tuple(out)


def pearson_layout(col0: int, n: int, block: int) -> tuple[int, int]:
    """(pad, rows): where the n targets of a target block starting at
    column ``col0`` sit in the (S, rows, Lq) buffer its Pearson reduces.

    PyTorch's CUDA reduction sums a row in an order set by the row's
    16-byte alignment and, below 16 rows, by the row count.  So the
    buffer has at least 16 rows and a multiple of 4: every row then has
    the alignment of its target's place in its global grid cell of
    ``block`` columns (pad = that place's offset mod 4), whatever the
    tile that cut the block, the library row s it belongs to and the
    chunk size S.  Tiled, untiled and fleet runs (chunks of any size)
    then sum every row in one order."""
    pad = (col0 % block) % 4
    rows = max(16, pad + n)
    return pad, rows + (-rows) % 4


def _pad_rows(x: torch.Tensor, pad: int, rows: int) -> torch.Tensor:
    """A new (rows, Lp) tensor: ``x`` (n, Lp) at rows [pad, pad + n),
    zeros around it."""
    return torch.nn.functional.pad(x, (0, 0, pad, rows - pad - x.shape[0]))


def ccm_row_lookup_bucketed(
    idx: torch.Tensor, w: torch.Tensor, fut_tile: torch.Tensor,
    cfg: EDMConfig, seg_plan: tuple[tuple[int, int], ...], *,
    col0: int = 0, width: int | None = None,
) -> torch.Tensor:
    """rho of a tile of bucket-sorted targets against a chunk's tables.

    idx/w (S, len(buckets), Lp, k); fut_tile (t, Lp), sorted columns
    [col0, col0 + t) of a ``width``-column target axis (default: the
    whole axis); seg_plan ((table_row, count), ...) with counts summing
    to t.  One segmented lookup and one Pearson per target block
    (:func:`target_blocks`); the padding rows of a block's Pearson layout
    (:func:`pearson_layout`) go through the lookup with the block's first
    and last segments, and are dropped.  Per-target results are
    independent, so neither the blocks nor the tiles show in the values.
    Returns (S, t)."""
    n = sum(cnt for _, cnt in seg_plan)
    if fut_tile.shape[0] != n:
        raise ValueError(
            f"seg_plan covers {n} targets but tile has {fut_tile.shape[0]}"
        )
    width = n if width is None else width
    eng = engines.get_engine(cfg.engine)
    out = []
    for b0, b1, segs in target_blocks(tuple(seg_plan), cfg.target_block,
                                      col0, width):
        pad, rows = pearson_layout(col0 + b0, b1 - b0, cfg.target_block)
        Y = _pad_rows(fut_tile[b0:b1], pad, rows)
        segs = list(segs)
        segs[0] = (segs[0][0], segs[0][1] + pad)
        segs[-1] = (segs[-1][0], segs[-1][1] + rows - pad - (b1 - b0))
        rho = pearson(Y, eng.ccm_lookup(idx, w, Y, tuple(segs)))
        out.append(rho[:, pad : pad + b1 - b0])
    return out[0] if len(out) == 1 else torch.cat(out, dim=-1)


def ccm_row_lookup(
    idx: torch.Tensor, w: torch.Tensor, fut_tile: torch.Tensor, e_idx,
    cfg: EDMConfig, *, col0: int = 0, width: int | None = None,
) -> torch.Tensor:
    """rho of a tile of targets against a chunk's all-E tables.

    idx/w (S, E_max, Lp, k) from :func:`ccm_row_tables`; fut_tile (t, Lp)
    the futures of columns [col0, col0 + t) of a ``width``-column target
    axis (default: the whole axis), natural order; e_idx (t,) the table
    row of each target (optE - 1).  Returns (S, t).

    The reference looks each target up through its own table.  Here each
    target block's targets are stably sorted by table row, the runs of
    equal rows become the ((table_row, count), ...) segments of one
    segmented lookup (the bucketed layout's kernel), and the predictions
    go back to natural order before the Pearson.  Per-target results are
    independent of the other targets of a launch, so this equals the
    per-target lookup."""
    e_idx = np.asarray(e_idx)
    t = fut_tile.shape[0]
    if e_idx.shape != (t,):
        raise ValueError(f"e_idx has shape {e_idx.shape}, tile has {t} targets")
    width = t if width is None else width
    eng = engines.get_engine(cfg.engine)
    dev = fut_tile.device
    out = []
    for b0, b1, _ in target_blocks(((0, t),), cfg.target_block, col0, width):
        n = b1 - b0
        pad, rows = pearson_layout(col0 + b0, n, cfg.target_block)
        perm = np.argsort(e_idx[b0:b1], kind="stable")
        tab, cnt = np.unique(e_idx[b0:b1][perm], return_counts=True)
        segs = tuple((int(r), int(c)) for r, c in zip(tab, cnt))
        perm_d = upload_source(perm, dev).to(dev, non_blocking=True)
        pred = eng.ccm_lookup(idx, w, fut_tile[b0:b1][perm_d].contiguous(), segs)
        full = pred.new_zeros((pred.shape[0], rows, pred.shape[-1]))
        full.index_copy_(1, perm_d + pad, pred)
        rho = pearson(_pad_rows(fut_tile[b0:b1], pad, rows), full)
        out.append(rho[:, pad : pad + n])
    return out[0] if len(out) == 1 else torch.cat(out, dim=-1)


def ccm_block_tile_bucketed(
    idx: torch.Tensor, w: torch.Tensor, fut_tile: torch.Tensor, cfg: EDMConfig,
    seg_plan: tuple[tuple[int, int], ...], col0: int, width: int,
) -> torch.Tensor:
    """One (row-chunk x col-tile) rho block, bucketed layout: tables
    (S, nb, Lp, k), fut_tile (t, Lp) the sorted columns [col0, col0 + t)
    of ``width``, seg_plan from :func:`make_tile_plans` -> (S, t), columns
    in plan order."""
    return ccm_row_lookup_bucketed(idx, w, fut_tile, cfg, seg_plan,
                                   col0=col0, width=width)


def ccm_block_tile(
    idx: torch.Tensor, w: torch.Tensor, fut_tile: torch.Tensor, e_idx,
    cfg: EDMConfig, col0: int, width: int,
) -> torch.Tensor:
    """One (row-chunk x col-tile) rho block, all-E layout: tables
    (S, E_max, Lp, k), fut_tile (t, Lp) and e_idx (t,) of columns
    [col0, col0 + t) of ``width`` -> (S, t), natural column order."""
    return ccm_row_lookup(idx, w, fut_tile, e_idx, cfg, col0=col0, width=width)


def ccm_block_bucketed(
    rows: torch.Tensor, fut_sorted: torch.Tensor, cfg: EDMConfig, plan: BucketPlan
) -> torch.Tensor:
    """Bucketed rho rows: rows (S, L) -> (S, N), columns in plan order."""
    idx, w = ccm_row_tables_bucketed(rows, cfg, plan)
    return ccm_row_lookup_bucketed(
        idx, w, fut_sorted, cfg, tuple(enumerate(plan.counts))
    )


def ccm_block(
    rows: torch.Tensor, ts_fut: torch.Tensor, optE, cfg: EDMConfig
) -> torch.Tensor:
    """All-E rho rows: rows (S, L), ts_fut (N, Lp) -> (S, N), natural
    column order."""
    idx, w = ccm_row_tables(rows, cfg)
    return ccm_row_lookup(idx, w, ts_fut, np.asarray(optE, np.int64) - 1, cfg)


def ccm_library_row(
    x: torch.Tensor, ts_fut: torch.Tensor, optE, cfg: EDMConfig
) -> torch.Tensor:
    """Cross-map every target from one library series (all-E layout):
    x (L,) -> the rho row (N,)."""
    return ccm_block(x[None], ts_fut, optE, cfg)[0]


def all_futures(ts: torch.Tensor, cfg: EDMConfig) -> torch.Tensor:
    """(N, L) -> (N, Lp) future values, the cross-map targets."""
    Lp = cfg.n_points(ts.shape[-1])
    return embedding.future_values(ts, cfg.E_max, cfg.tau, cfg.Tp, Lp)


def ccm_matrix(ts: torch.Tensor, optE, cfg: EDMConfig) -> torch.Tensor:
    """Full (N, N) causal map on one device (small problems, tests), in
    chunks of ``cfg.lib_block`` library series.  Dispatches on
    ``cfg.target_tile`` and ``cfg.bucketed`` as the reference does; every
    combination gives the same map (the bucket permutation is undone on
    the columns, tiles are reassembled in column order)."""
    optE = np.asarray(optE)
    fut = all_futures(ts, cfg)
    if cfg.target_tile:
        return _ccm_matrix_tiled(ts, fut, optE, cfg)
    chunks = range(0, ts.shape[0], cfg.lib_block)
    if not cfg.bucketed:
        return torch.cat([ccm_block(ts[r : r + cfg.lib_block], fut, optE, cfg)
                          for r in chunks])
    plan, order = make_bucket_plan(optE)
    dev = ts.device
    fut_sorted = fut[torch.as_tensor(order, device=dev)]
    rho_sorted = torch.cat(
        [ccm_block_bucketed(ts[r : r + cfg.lib_block], fut_sorted, cfg, plan)
         for r in chunks]
    )
    return rho_sorted[:, torch.as_tensor(np.argsort(order), device=dev)]


def _ccm_matrix_tiled(
    ts: torch.Tensor, fut: torch.Tensor, optE: np.ndarray, cfg: EDMConfig
) -> torch.Tensor:
    """Tiled map on one device: tables once per chunk, targets in column
    tiles of ``cfg.target_tile``."""
    N, T, dev = ts.shape[0], cfg.target_tile, ts.device
    rows_out = []
    if not cfg.bucketed:
        e_idx = optE.astype(np.int64) - 1
        for r in range(0, N, cfg.lib_block):
            idx, w = ccm_row_tables(ts[r : r + cfg.lib_block], cfg)
            rows_out.append(torch.cat([
                ccm_block_tile(idx, w, fut[c0 : c0 + T], e_idx[c0 : c0 + T],
                               cfg, c0, N)
                for c0 in range(0, N, T)
            ], dim=1))
        return torch.cat(rows_out)
    plan, order = make_bucket_plan(optE)
    fut_sorted = fut[torch.as_tensor(order, device=dev)]
    tiles = make_tile_plans(plan, T)
    for r in range(0, N, cfg.lib_block):
        idx, w = ccm_row_tables_bucketed(ts[r : r + cfg.lib_block], cfg, plan)
        rows_out.append(torch.cat([
            ccm_block_tile_bucketed(idx, w, fut_sorted[c0 : c0 + T], cfg,
                                    seg_plan, c0, N)
            for c0, seg_plan in tiles
        ], dim=1))
    return torch.cat(rows_out)[:, torch.as_tensor(np.argsort(order), device=dev)]
