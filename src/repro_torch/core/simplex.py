"""Phase 1 — simplex projection: the optimal embedding dimension of each
series (paper Alg. 1 lines 1-11), over an (S, L) batch.

Library = first half of each series, target = second half; for each
E in 1..E_max every target point is forecast from its E+1 nearest
library neighbours, scored with Pearson rho, and the argmax E is kept.
"""
from __future__ import annotations

import torch

from repro_torch import engine as engines
from repro_torch.core import embedding, knn
from repro_torch.core.stats import pearson
from repro_torch.core.types import EDMConfig


def simplex_batch(
    ts: torch.Tensor, cfg: EDMConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """ts (S, L) -> (rhos (S, E_max), optE (S,) int32 in [1, E_max]).

    optE is the FIRST maximal E: ``torch.argmax`` documents that it
    returns the first maximal index, as ``jnp.argmax`` does."""
    eng = engines.get_engine(cfg.engine)
    Lp = cfg.n_points(ts.shape[-1])
    V = embedding.lag_matrix(ts, cfg.E_max, cfg.tau, Lp)  # (S, E_max, Lp)
    fut = embedding.future_values(ts, cfg.E_max, cfg.tau, cfg.Tp, Lp)
    Lh = Lp // 2
    Vc, Vq = V[..., :Lh], V[..., Lh:]
    idx, sqd = eng.knn_tables(Vq, Vc, cfg.k_max, exclude_self=False, cfg=cfg)
    idx, w = knn.tables_with_weights(idx, sqd)
    preds = eng.simplex_forecast(idx, w, fut[:, :Lh])  # (S, E_max, Lq)
    rhos = pearson(fut[:, None, Lh:], preds)
    optE = torch.argmax(rhos, dim=-1).to(torch.int32) + 1
    return rhos, optE
