"""Delay embedding (Takens), batched over series.

Embeddings are aligned on present time: point ``t`` of a length-L series
refers to ``p(t) = t + (E_max - 1) * tau`` for every E <= E_max, so the
tables of all E share one point indexing and the squared distance obeys
the prefix recurrence D_E = D_{E-1} + (lag_{E-1} difference)^2.  Every
function takes the series on the last axis and keeps any leading
(series) dimensions.
"""
from __future__ import annotations

import torch


def lag_matrix(x: torch.Tensor, E_max: int, tau: int, Lp: int) -> torch.Tensor:
    """V[..., k, t] = x[..., p(t) - k*tau] for k in [0, E_max), t in [0, Lp)."""
    offset = (E_max - 1) * tau
    idx = (
        offset
        + torch.arange(Lp, device=x.device)[None, :]
        - tau * torch.arange(E_max, device=x.device)[:, None]
    )
    return x[..., idx]


def delay_embed(x: torch.Tensor, E: int, tau: int, Tp: int = 0) -> torch.Tensor:
    """Classic standalone delay embedding: rows are points, columns lags."""
    Lp = x.shape[-1] - (E - 1) * tau - Tp
    idx = (
        (E - 1) * tau
        + torch.arange(Lp, device=x.device)[:, None]
        - tau * torch.arange(E, device=x.device)[None, :]
    )
    return x[..., idx]


def future_values(
    x: torch.Tensor, E_max: int, tau: int, Tp: int, Lp: int
) -> torch.Tensor:
    """fut[..., t] = x[..., p(t) + Tp]: what a forecast of point t targets."""
    offset = (E_max - 1) * tau
    return x[..., offset + Tp : offset + Tp + Lp]
