"""Phase 2 — Convergent Cross Mapping, mpEDM improved algorithm (paper
Alg. 2), bucketed layout, over a chunk of library series.

The kNN table depends only on the library series, so each library's
tables are built once and reused across all N targets.  Targets are
grouped by optE (:func:`make_bucket_plan`); each library series gets
tables only at the distinct optE values (the bucket set), and every
bucket segment of targets streams through its ONE shared table in the
batched lookup.  The chunk's series are a leading tensor dimension: one
kNN launch builds the tables of the whole chunk, and one lookup launch
per target block serves every table of the chunk — a block of the
bucket-sorted targets may cross segment boundaries, each of its segments
going through its own table row (the segmented lookup).

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
    :func:`ccm_row_lookup_bucketed` takes it.  The port runs one tile
    (tile = N); the tiled phase 2 is not ported."""
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


@functools.lru_cache(maxsize=64)
def target_blocks(
    seg_plan: tuple[tuple[int, int], ...], block: int
) -> tuple[tuple[int, int, tuple[tuple[int, int], ...]], ...]:
    """Cut the bucket-sorted targets of ``seg_plan`` ((table_row, count),
    ...) into blocks of ``block`` that may cross segment boundaries:
    ((b0, b1, segs), ...), segs the block's own ((table_row, count), ...).
    Built once per plan: the plan is static for a run."""
    if block < 1:
        raise ValueError(f"target_block must be >= 1, got {block}")
    spans, off = [], 0
    for row, cnt in seg_plan:
        spans.append((off, off + cnt, row))
        off += cnt
    out = []
    for b0 in range(0, off, block):
        b1 = min(b0 + block, off)
        segs = tuple((row, min(e, b1) - max(s, b0)) for s, e, row in spans
                     if min(e, b1) > max(s, b0))
        out.append((b0, b1, segs))
    return tuple(out)


def ccm_row_lookup_bucketed(
    idx: torch.Tensor, w: torch.Tensor, fut_sorted: torch.Tensor,
    cfg: EDMConfig, seg_plan: tuple[tuple[int, int], ...],
) -> torch.Tensor:
    """rho of the bucket-sorted targets against a chunk's tables.

    idx/w (S, len(buckets), Lp, k); fut_sorted (t, Lp); seg_plan
    ((table_row, count), ...) with counts summing to t.  Targets go
    through the lookup in blocks of ``cfg.target_block`` that may cross
    segment boundaries, one lookup and one pearson per block; per-target
    results are independent, so the blocking never shows in the values.
    Returns (S, t)."""
    n = sum(cnt for _, cnt in seg_plan)
    if fut_sorted.shape[0] != n:
        raise ValueError(
            f"seg_plan covers {n} targets but tile has {fut_sorted.shape[0]}"
        )
    eng = engines.get_engine(cfg.engine)
    out = [
        pearson(fut_sorted[b0:b1], eng.ccm_lookup(idx, w, fut_sorted[b0:b1], segs))
        for b0, b1, segs in target_blocks(tuple(seg_plan), cfg.target_block)
    ]
    return out[0] if len(out) == 1 else torch.cat(out, dim=-1)


def ccm_block_bucketed(
    rows: torch.Tensor, fut_sorted: torch.Tensor, cfg: EDMConfig, plan: BucketPlan
) -> torch.Tensor:
    """Bucketed rho rows: rows (S, L) -> (S, N), columns in plan order."""
    idx, w = ccm_row_tables_bucketed(rows, cfg, plan)
    return ccm_row_lookup_bucketed(
        idx, w, fut_sorted, cfg, tuple(enumerate(plan.counts))
    )


def all_futures(ts: torch.Tensor, cfg: EDMConfig) -> torch.Tensor:
    """(N, L) -> (N, Lp) future values, the cross-map targets."""
    Lp = cfg.n_points(ts.shape[-1])
    return embedding.future_values(ts, cfg.E_max, cfg.tau, cfg.Tp, Lp)


def ccm_matrix(ts: torch.Tensor, optE, cfg: EDMConfig) -> torch.Tensor:
    """Full (N, N) causal map on one device, bucketed and untiled, built
    in chunks of ``cfg.lib_block`` library series (small problems,
    tests).  The bucket permutation is undone on the columns."""
    if cfg.target_tile or not cfg.bucketed:
        raise NotImplementedError(
            "the port computes the bucketed, untiled map only "
            "(target_tile=0, bucketed=True)"
        )
    plan, order = make_bucket_plan(np.asarray(optE))
    dev = ts.device
    fut_sorted = all_futures(ts, cfg)[torch.as_tensor(order, device=dev)]
    rho_sorted = torch.cat(
        [
            ccm_block_bucketed(ts[r : r + cfg.lib_block], fut_sorted, cfg, plan)
            for r in range(0, ts.shape[0], cfg.lib_block)
        ]
    )
    return rho_sorted[:, torch.as_tensor(np.argsort(order), device=dev)]
