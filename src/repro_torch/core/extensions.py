"""EDM extensions of the port — the paper's stated future work (SSV: "EDM
algorithms other than simplex projection and CCM will be implemented in
mpEDM"), the counterpart of ``repro.core.extensions``.

  * S-Map (Sugihara 1994): locally-weighted linear forecasting; the theta
    sweep separates linear (theta=0) from state-dependent nonlinear
    dynamics, and rho(theta) rising above rho(0) is the classic
    nonlinearity test.
  * Time-delayed CCM (Ye et al. 2015, paper ref [8]): cross-map skill as a
    function of prediction lag; the argmax lag's SIGN distinguishes true
    causal direction (negative optimal lag) from synchrony artifacts.

Every function takes one series ``(L,)`` or a batch ``(S, L)`` and runs
on ``device`` (default the card; without one it raises, ``"cpu"`` runs
on the CPU).  The S-Map's ridge-regularised normal equations are a
small dense ``torch.linalg.solve`` per target point, as the JAX package
solves them outside any kernel; the time-delayed CCM's kNN table goes
through the engine (``cfg.engine``: on a card the ``knn_topk`` kernel).
"""
from __future__ import annotations

import torch

from repro_torch import engine as engines
from repro_torch.core import embedding, knn
from repro_torch.core.stats import pearson, simplex_weights
from repro_torch.core.types import EDMConfig
from repro_torch.runtime.device import resolve_device

THETAS = (0.0, 0.1, 0.3, 0.75, 1.5, 3.0, 6.0)
LAGS = (-4, -3, -2, -1, 0, 1, 2, 3, 4)
RIDGE = 1e-4  # the normal equations' regulariser (stable under tiny weights)


def _series(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32).to(resolve_device(device))


def _with_ones(a: torch.Tensor) -> torch.Tensor:
    """[1, a] along the last axis."""
    return torch.cat([torch.ones_like(a[..., :1]), a], dim=-1)


def smap_series(x, theta: float, E: int, cfg: EDMConfig,
                device=None) -> torch.Tensor:
    """S-Map forecast skill of a series at locality ``theta``.

    Solves, per target point, the distance-weighted least squares
    y = [1, coords] @ b with weights exp(-theta * d / d_mean), library =
    first half, target = second half.  Returns Pearson rho: () for one
    series, (S,) for a batch."""
    x = _series(x, device)
    L = x.shape[-1]
    Lp = cfg.n_points(L)
    V = embedding.lag_matrix(x, cfg.E_max, cfg.tau, Lp)  # (..., E_max, Lp)
    fut = embedding.future_values(x, cfg.E_max, cfg.tau, cfg.Tp, Lp)
    Lh = Lp // 2
    lib = V[..., :E, :Lh].transpose(-1, -2)  # (..., Lh, E)
    tgt = V[..., :E, Lh:].transpose(-1, -2)  # (..., Lt, E)
    fut_lib, fut_tgt = fut[..., :Lh], fut[..., Lh:]

    d = torch.sqrt(torch.clamp_min(
        torch.square(tgt[..., :, None, :] - lib[..., None, :, :]).sum(-1), 0.0
    ))  # (..., Lt, Lh)
    dbar = d.mean(dim=-1, keepdim=True)
    w = torch.exp(-theta * d / torch.clamp_min(dbar, 1e-8))

    Aw = _with_ones(lib)[..., None, :, :] * w[..., None]  # (..., Lt, Lh, E+1)
    yw = fut_lib[..., None, :] * w  # (..., Lt, Lh)
    G = Aw.transpose(-1, -2) @ Aw + RIDGE * torch.eye(E + 1, device=x.device)
    B = torch.linalg.solve(G, (Aw.transpose(-1, -2) @ yw[..., None])[..., 0])
    pred = (_with_ones(tgt) * B).sum(dim=-1)
    return pearson(fut_tgt, pred)


def smap_theta_sweep(x, E: int, cfg: EDMConfig, thetas=THETAS,
                     device=None) -> torch.Tensor:
    """rho(theta), theta last: (len(thetas),) or (S, len(thetas)).  rho
    rising above rho(0) => state-dependent (nonlinear) dynamics — the
    S-Map nonlinearity test."""
    x = _series(x, device)
    return torch.stack([smap_series(x, float(t), E, cfg, x.device)
                        for t in thetas], dim=-1)


def ccm_lagged(x, y, E: int, cfg: EDMConfig, lags=LAGS,
               device=None) -> torch.Tensor:
    """Time-delayed CCM: skill of estimating y(t + lag) from M_x.

    For true y -> x causation the best lag is <= 0 (the cause precedes);
    a positive optimal lag flags synchrony/anticipatory artifacts.
    Returns rho per lag, lag last: (len(lags),) or (S, len(lags))."""
    x, y = _series(x, device), _series(y, device)
    one = x.dim() == 1
    if one:
        x, y = x[None], y[None]
    L = x.shape[-1]
    Lp = cfg.n_points(L)
    V = embedding.lag_matrix(x, cfg.E_max, cfg.tau, Lp).contiguous()
    eng = engines.get_engine(cfg.engine)
    eng.check_limits(cfg, x.device)
    idx, sqd = eng.knn_tables_bucketed(V, V, E + 1, buckets=(E,),
                                       exclude_self=cfg.exclude_self, cfg=cfg)
    idx, w = idx[:, 0], simplex_weights(sqd[:, 0], E + 1)  # (S, Lp, E+1)
    offset = (cfg.E_max - 1) * cfg.tau
    max_lag = max(abs(lag) for lag in lags)
    pos = torch.arange(Lp, device=x.device)
    rhos = []
    for lag in lags:
        # y value aligned to each library point's present time + Tp + lag,
        # clipped into range; edge points masked out of the correlation
        t = offset + cfg.Tp + lag + pos
        y_fut = y[:, t.clamp(0, L - 1)]
        pred = knn.simplex_forecast(idx, w, y_fut)
        m = ((t >= 0) & (t < L) & (pos < Lp - max_lag)).to(torch.float32)
        a = (y_fut - (y_fut * m).sum(-1, keepdim=True) / m.sum()) * m
        b = (pred - (pred * m).sum(-1, keepdim=True) / m.sum()) * m
        rhos.append((a * b).sum(-1) / torch.clamp_min(
            torch.sqrt((a * a).sum(-1) * (b * b).sum(-1)), 1e-8))
    out = torch.stack(rhos, dim=-1)
    return out[0] if one else out
