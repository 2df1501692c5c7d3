"""Synthetic nonlinear dynamical systems with known causal structure.

Used for (a) validating that CCM recovers ground-truth causality
(Sugihara et al. 2012 coupled logistic maps) and (b) generating
zebrafish-brain-scale dummy datasets for benchmarks, mirroring the
paper's dummy-dataset scaling studies (Figs. 6-9).
"""
from __future__ import annotations

import numpy as np


def coupled_logistic(
    L: int,
    beta_xy: float = 0.02,
    beta_yx: float = 0.1,
    rx: float = 3.8,
    ry: float = 3.5,
    seed: int = 0,
    transient: int = 300,
) -> tuple[np.ndarray, np.ndarray]:
    """Two coupled logistic maps (Sugihara 2012, Science).

    beta_yx is the effect of x on y (x drives y); beta_xy the reverse.
    Returns (x, y) float32 arrays of length L.
    """
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(0.2, 0.6, size=2)
    xs = np.empty(L + transient, np.float64)
    ys = np.empty(L + transient, np.float64)
    for t in range(L + transient):
        x, y = (
            x * (rx - rx * x - beta_xy * y),
            y * (ry - ry * y - beta_yx * x),
        )
        xs[t], ys[t] = x, y
    return xs[transient:].astype(np.float32), ys[transient:].astype(np.float32)


def logistic_network(
    N: int,
    L: int,
    density: float = 0.05,
    strength: float = 0.08,
    r_range: tuple[float, float] = (3.6, 3.9),
    seed: int = 0,
    transient: int = 200,
) -> tuple[np.ndarray, np.ndarray]:
    """Sparse directed network of coupled logistic maps — a miniature
    'brain' with known ground-truth adjacency.

    Returns (ts (N, L) float32, adj (N, N) bool) where adj[src, dst] means
    src drives dst.
    """
    rng = np.random.default_rng(seed)
    adj = rng.uniform(size=(N, N)) < density
    np.fill_diagonal(adj, False)
    B = np.where(adj, strength, 0.0) / max(1.0, density * N / 4.0)
    r = rng.uniform(*r_range, size=N)
    x = rng.uniform(0.2, 0.6, size=N)
    ts = np.empty((L + transient, N), np.float64)
    for t in range(L + transient):
        drive = B.T @ x  # drive[dst] = sum_src B[src,dst] x[src]
        x = np.clip(x * (r - r * x - drive), 1e-6, 1.0)
        ts[t] = x
    out = ts[transient:].T.astype(np.float32)  # (N, L)
    return out, adj


def dummy_brain(N: int, L: int, seed: int = 0) -> np.ndarray:
    """Fast dummy dataset for scaling benchmarks (paper SSIV-B3): smoothed
    noise with per-series autocorrelation, standardized."""
    rng = np.random.default_rng(seed)
    ts = rng.standard_normal((N, L)).astype(np.float32)
    # AR(1)-style smoothing gives realistic neighbour structure.
    alpha = 0.8
    for t in range(1, L):
        ts[:, t] = alpha * ts[:, t - 1] + (1 - alpha) * ts[:, t]
    ts -= ts.mean(axis=1, keepdims=True)
    ts /= ts.std(axis=1, keepdims=True) + 1e-6
    return ts
