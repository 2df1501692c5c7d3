"""Plain PyTorch version of the ccm_lookup kernel.

The sum over neighbours runs in ascending order, one rounded multiply
and one rounded add per step — the order of the CUDA kernel — so on the
card the two agree to the bit as a rule (the comparison still states a
tolerance).  The JAX op sums in its einsum's order, so the port is held
to it within a tolerance (``docs/PORT.md``)."""
from __future__ import annotations

import torch


def ccm_lookup_ref(idx: torch.Tensor, w: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """pred[..., b, t] = sum_j w[..., t, j] * Y[b, idx[..., t, j]].

    idx / w (Lq, k) -> (B, Lq); or (S, Lq, k) -> (S, B, Lq)."""
    squeeze = idx.dim() == 2
    if squeeze:
        idx, w = idx[None], w[None]
    S, Lq, k = idx.shape
    acc = torch.zeros((S, Y.shape[0], Lq), dtype=torch.float32, device=Y.device)
    for j in range(k):
        g = Y[:, idx[:, :, j].long()].transpose(0, 1)  # (S, B, Lq)
        acc = acc + w[:, None, :, j] * g
    return acc[0] if squeeze else acc
