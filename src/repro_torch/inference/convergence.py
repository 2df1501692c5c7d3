"""Batched CCM convergence diagnostic of the port.

CCM evidences causation only when cross-map skill CONVERGES — rho grows
with library size.  As in the JAX package:

  * per chunk of library series, ONE prefix-snapshot table build
    (``Engine.knn_tables_prefix``; the ``knn_topk_prefix`` kernel on the
    card) yields tables for every library size in a single candidate
    sweep — libraries are nested prefixes of a seeded random permutation
    of the library points;
  * the rho rows of every size come from the bucketed lookup path of
    phase 2, with the sizes folded into its table dimension: one lookup
    launch per target block serves the chunk's B series at all S sizes;
  * the (S,) curve per pair is reduced on the device to two statistics:
    drho = rho_max - rho_min and a Kendall-style monotonic-trend score.

The chunk's series are a leading tensor dimension (the JAX side vmaps).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import engine as engines
from repro_torch.core import ccm, embedding, knn
from repro_torch.core.stats import pearson, simplex_weights
from repro_torch.core.types import EDMConfig
from repro_torch.inference import prng


def subsample_permutation(key: torch.Tensor, Lp: int) -> torch.Tensor:
    """The seeded library-subsampling permutation (one per run), int32 on
    the key's device: prefixes of it are the nested random libraries."""
    return prng.permutation(key, Lp).to(torch.int32)


def convergence_stats(curves: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Reduce rho-vs-library-size curves (S, ...) to (drho, trend):
    drho = rho_max - rho_min; trend = mean_{s<t} sign(rho_t - rho_s) in
    [-1, 1] (+1 = strictly increasing with library size)."""
    S = curves.shape[0]
    drho = curves.amax(dim=0) - curves.amin(dim=0)
    i, j = np.triu_indices(S, 1)
    dev = curves.device
    diff = curves[torch.as_tensor(j, device=dev)] - curves[torch.as_tensor(i, device=dev)]
    return drho, torch.sign(diff).mean(dim=0)


def conv_block_tables(
    rows: torch.Tensor,
    cfg: EDMConfig,
    plan: ccm.BucketPlan,
    lib_sizes: tuple[int, ...],
    col_ids: torch.Tensor | None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Prefix-snapshot tables + simplex weights for a chunk of library
    series: rows (B, L) -> (idx, w), each (B, S, len(buckets), Lp, k);
    slice [:, s] is the bucketed table set of the size-lib_sizes[s]
    nested library."""
    eng = engines.get_engine(cfg.engine)
    Lp = cfg.n_points(rows.shape[-1])
    kb = ccm._bucket_k(cfg, plan)
    ccm._check_k(kb, Lp, cfg, "conv_row_tables")
    V = embedding.lag_matrix(rows, cfg.E_max, cfg.tau, Lp)
    idx, sqd = eng.knn_tables_prefix(
        V, V, kb, buckets=plan.buckets, lib_sizes=lib_sizes,
        exclude_self=cfg.exclude_self, cfg=cfg, col_ids=col_ids,
    )
    return knn.tables_with_weights_bucketed(idx, sqd, plan.buckets)


def conv_block_tile(
    idx: torch.Tensor,
    w: torch.Tensor,
    fut_tile: torch.Tensor,
    cfg: EDMConfig,
    seg_plan: tuple[tuple[int, int], ...],
    *,
    col0: int = 0,
    width: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(drho, trend), each (B, t), of one (row-chunk x col-tile) block:
    idx/w (B, S, nb, Lp, k) prefix tables, fut_tile (t, Lp) bucket-sorted
    target futures, sorted columns [col0, col0 + t) of ``width`` (default:
    the whole axis).  The S library sizes ride in the table dimension of
    the lookup, (B * S, nb, Lp, k), so each target block is one launch
    for every size.  The (S, B, t) curves never leave the device."""
    B, S = idx.shape[:2]
    rho = ccm.ccm_row_lookup_bucketed(
        idx.reshape(B * S, *idx.shape[2:]), w.reshape(B * S, *w.shape[2:]),
        fut_tile, cfg, seg_plan, col0=col0, width=width,
    )
    return convergence_stats(rho.reshape(B, S, -1).transpose(0, 1))


def ccm_convergence_pair(
    x: torch.Tensor,
    y: torch.Tensor,
    E: int,
    lib_sizes: tuple[int, ...],
    cfg: EDMConfig,
    key: torch.Tensor,
) -> torch.Tensor:
    """Convergence curve of ONE pair through the prefix path: cross-maps
    y from x's manifold at embedding dimension E over nested random
    libraries (prefixes of the key-seeded permutation).  Returns rho (S,)."""
    eng = engines.get_engine(cfg.engine)
    Lp = cfg.n_points(x.shape[-1])
    perm = subsample_permutation(key, Lp)
    V = embedding.lag_matrix(x, cfg.E_max, cfg.tau, Lp)[None]
    y_fut = embedding.future_values(y, cfg.E_max, cfg.tau, cfg.Tp, Lp)
    idx, sqd = eng.knn_tables_prefix(
        V, V, E + 1, buckets=(E,), lib_sizes=tuple(lib_sizes),
        exclude_self=cfg.exclude_self, cfg=cfg, col_ids=perm,
    )
    idx, sqd = idx[0, :, 0], sqd[0, :, 0]  # (S, Lp, k)
    preds = knn.simplex_forecast(idx, simplex_weights(sqd, E + 1), y_fut)
    return pearson(y_fut[None, :], preds)
