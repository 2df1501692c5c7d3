"""Numerical helpers shared across the port's EDM core: Pearson rho and
simplex weights, with the JAX package's degenerate-case semantics."""
from __future__ import annotations

import torch

_EPS = 1e-8


def pearson(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pearson correlation along the last axis; 0 when either side is
    degenerate: zero variance (a constant series) or non-finite moments
    (a float32 variance overflow).  The norm product is taken as
    sqrt(sum a^2) * sqrt(sum b^2), so it overflows only when one norm
    does.  ``a`` and ``b`` broadcast against each other."""
    a = a - a.mean(dim=-1, keepdim=True)
    b = b - b.mean(dim=-1, keepdim=True)
    num = (a * b).sum(dim=-1)
    den = torch.sqrt((a * a).sum(dim=-1)) * torch.sqrt((b * b).sum(dim=-1))
    good = (den > _EPS) & torch.isfinite(den) & torch.isfinite(num)
    return torch.where(good, num / torch.where(good, den, 1.0), 0.0)


def simplex_weights(sq_dists: torch.Tensor, k_valid) -> torch.Tensor:
    """Exponential simplex weights from *squared* neighbour distances.

    w_j = exp(-d_j / d_1) over the ``k_valid`` nearest neighbours,
    row-normalized.  When d_1 == 0 (duplicate points, dead neurons) the
    weight is uniform over the neighbours tied at distance 0 (cppEDM's
    limit of exp(-d/d_1) as d_1 -> 0).  Masked entries may be +inf: they
    get weight 0 and never reach d_1.

    sq_dists: (..., k_max) sorted ascending.  k_valid: an int or a tensor
    broadcastable to sq_dists[..., :1] (E+1 per table row).
    """
    k_max = sq_dists.shape[-1]
    d = torch.sqrt(torch.clamp_min(sq_dists, 0.0))
    d1 = d[..., :1]
    d1 = torch.where(torch.isfinite(d1), d1, 0.0)
    w = torch.exp(-d / torch.where(d1 > 0, d1, 1.0))
    w = torch.where(torch.isfinite(w), w, 0.0)
    w = torch.where(d1 > 0, w, (d <= 0).to(w.dtype))
    kmask = torch.arange(k_max, device=sq_dists.device) < k_valid
    w = w * kmask
    return w / torch.clamp_min(w.sum(dim=-1, keepdim=True), _EPS)
