"""cppEDM-style naive CCM (paper Alg. 1): the baseline the improved
algorithm is measured against (the ``table2`` bench) and held equal to
(``tests/test_torch_baseline.py``).

Per (library i, target j) pair the kNN table is rebuilt from scratch at
E = optE[j]: O(N^2 L^2 E).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import embedding, knn
from repro_torch.core.ccm import all_futures
from repro_torch.core.stats import pearson, simplex_weights
from repro_torch.core.types import EDMConfig


def ccm_pair_naive(
    x: torch.Tensor, y_fut: torch.Tensor, E: int, cfg: EDMConfig
) -> torch.Tensor:
    """One cross mapping with its own table rebuild (Alg. 1 lines 14-17):
    library series x (L,), target futures y_fut (Lp,) -> rho (scalar)."""
    Lp = cfg.n_points(x.shape[-1])
    V = embedding.lag_matrix(x, cfg.E_max, cfg.tau, Lp)
    idx, sqd = knn.knn_table_single_E(V, V, E, E + 1, exclude_self=cfg.exclude_self)
    w = simplex_weights(sqd, E + 1)
    pred = knn.simplex_forecast(idx, w, y_fut)
    return pearson(y_fut, pred)


def ccm_naive(ts: torch.Tensor, optE, cfg: EDMConfig) -> torch.Tensor:
    """Full (N, N) causal map from redundant per-pair tables (test scale)."""
    N = ts.shape[0]
    ts_fut = all_futures(ts, cfg)
    optE = np.asarray(optE)
    rho = torch.zeros((N, N), dtype=torch.float32)
    for i in range(N):
        for j in range(N):
            rho[i, j] = ccm_pair_naive(ts[i], ts_fut[j], int(optE[j]), cfg)
    return rho
