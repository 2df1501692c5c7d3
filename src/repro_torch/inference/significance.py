"""Surrogate p-values, BH-FDR control and causal-edge assembly of the
port: per-pair empirical p-values against the surrogate null, one
Benjamini–Hochberg pass across the whole map, and a significance-masked
edge list as the persisted causal graph.  The numpy functions are copies
of ``repro.inference.significance``; :func:`null_block_pvals` runs on
the device."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import ccm
from repro_torch.core.types import EDMConfig
from repro_torch.inference.types import EDGE_DTYPE


def null_block_pvals(
    idx: torch.Tensor,
    w: torch.Tensor,
    fut_surr: torch.Tensor,
    rho_obs: torch.Tensor,
    cfg: EDMConfig,
    seg_plan_m: tuple[tuple[int, int], ...],
    m: int,
    *,
    col0: int = 0,
    width: int | None = None,
) -> torch.Tensor:
    """Per-pair surrogate p-values of one (row-chunk x col-tile) block.

    idx/w (B, nb, Lp, k): the full-library bucketed tables (phase 2's, so
    the null matches the observed statistic); fut_surr (t*m, Lp) in
    ``surrogate_futures`` layout, rows [col0, col0 + t*m) of a
    ``width``-row surrogate axis (default: the whole axis); rho_obs
    (B, t); seg_plan_m the tile's seg_plan with every count scaled by m.
    Returns (B, t) float32
    p = (1 + #{null >= obs}) / (m + 1), taken as a product with the
    float32 reciprocal of m + 1: XLA rewrites the JAX package's division
    by that constant so, and the product keeps the p-value bits equal
    (36/40 is 0.90000004 there, not float32(0.9))."""
    null = ccm.ccm_row_lookup_bucketed(idx, w, fut_surr, cfg, seg_plan_m,
                                       col0=col0, width=width)
    null = null.reshape(null.shape[0], -1, m)
    exceed = (null >= rho_obs[..., None]).sum(dim=-1)
    inv = torch.tensor(1.0 / (m + 1.0), dtype=torch.float32, device=null.device)
    return (1.0 + exceed.to(torch.float32)) * inv


# ------------------------------------------------------------------ BH-FDR
def bh_threshold(pvals: np.ndarray, alpha: float) -> tuple[float, int]:
    """Benjamini–Hochberg rejection threshold over a flat p-value array:
    (p_star, n_tests), reject every p <= p_star (0.0 when nothing
    passes)."""
    p = np.sort(np.asarray(pvals, np.float64).ravel())
    n = p.size
    if n == 0:
        return 0.0, 0
    crit = alpha * np.arange(1, n + 1) / n
    ok = np.nonzero(p <= crit)[0]
    return (float(p[ok[-1]]), n) if ok.size else (0.0, n)


def bh_threshold_discrete(
    counts: np.ndarray, m: int, alpha: float
) -> tuple[float, int]:
    """BH threshold from per-value counts of discrete empirical p-values:
    ``counts[j-1] = #{p == j/(m+1)}``.  Identical to :func:`bh_threshold`
    on the expanded array, in O(m) memory and with no sort."""
    counts = np.asarray(counts, np.int64)
    if counts.shape != (m + 1,):
        raise ValueError(f"counts must have shape ({m + 1},): {counts.shape}")
    n = int(counts.sum())
    if n == 0:
        return 0.0, 0
    ranks = np.cumsum(counts)  # max rank of each tied value run
    values = np.arange(1, m + 2) / (m + 1.0)
    ok = np.nonzero((counts > 0) & (values <= alpha * ranks / n))[0]
    return (float(values[ok[-1]]), n) if ok.size else (0.0, n)


def bh_adjust(pvals: np.ndarray) -> np.ndarray:
    """BH-adjusted p-values (q-values), same shape as the input:
    q_(i) = min_{j >= i} p_(j) * n / j."""
    p = np.asarray(pvals, np.float64)
    flat = p.ravel()
    n = flat.size
    order = np.argsort(flat)
    scaled = flat[order] * n / np.arange(1, n + 1)
    q_sorted = np.minimum.accumulate(scaled[::-1])[::-1]
    q = np.empty(n, np.float64)
    q[order] = np.minimum(q_sorted, 1.0)
    return q.reshape(p.shape)


# ------------------------------------------------------------ edge assembly
def assemble_edges(
    pvals: np.ndarray,
    rho: np.ndarray,
    drho: np.ndarray | None,
    trend: np.ndarray | None,
    p_threshold: float,
) -> np.ndarray:
    """Significance-masked causal edge list (EDGE_DTYPE, sorted by pval),
    row-streamed over the (possibly memmapped) maps; the diagonal is
    never tested.  rho[i, j] high means j CCM-causes i: edge (src=j,
    dst=i)."""
    N = pvals.shape[0]
    parts = []
    for i in range(N):
        p_row = np.asarray(pvals[i])
        sig = p_row <= p_threshold
        sig[i] = False
        (js,) = np.nonzero(sig)
        if js.size == 0:
            continue
        e = np.empty(js.size, EDGE_DTYPE)
        e["src"] = js
        e["dst"] = i
        e["rho"] = np.asarray(rho[i])[js]
        e["drho"] = np.asarray(drho[i])[js] if drho is not None else 0.0
        e["trend"] = np.asarray(trend[i])[js] if trend is not None else 0.0
        e["pval"] = p_row[js]
        parts.append(e)
    if not parts:
        return np.empty(0, EDGE_DTYPE)
    edges = np.concatenate(parts)
    return edges[np.argsort(edges["pval"], kind="stable")]
