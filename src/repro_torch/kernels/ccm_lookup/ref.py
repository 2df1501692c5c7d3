"""Plain PyTorch version of the ccm_lookup kernel.

The sum over neighbours runs in ascending order, one rounded multiply
and one rounded add per step — the order of the CUDA kernel — so on the
card the two agree to the bit as a rule (the comparison still states a
tolerance).  The JAX op sums in its einsum's order, so the port is held
to it within a tolerance (``docs/PORT.md``)."""
from __future__ import annotations

import torch


def ccm_lookup_ref(idx: torch.Tensor, w: torch.Tensor, Y: torch.Tensor,
                   segs=None) -> torch.Tensor:
    """pred[..., b, t] = sum_j w[..., t, j] * Y[b, idx[..., t, j]].

    idx / w (Lq, k) -> (B, Lq); or (S, Lq, k) -> (S, B, Lq).  Segmented:
    idx / w (S, nb, Lq, k) with ``segs`` ((table_row, count), ...), the
    counts summing to B -> (S, B, Lq); segment i is the next count_i
    targets, looked up through table row table_row — the per-segment
    calls, concatenated."""
    if segs is not None:
        parts, off = [], 0
        for row, cnt in segs:
            parts.append(ccm_lookup_ref(idx[:, row], w[:, row], Y[off : off + cnt]))
            off += cnt
        if off != Y.shape[0]:
            raise ValueError(f"segments cover {off} targets but Y has {Y.shape[0]}")
        return torch.cat(parts, dim=1)
    squeeze = idx.dim() == 2
    if squeeze:
        idx, w = idx[None], w[None]
    S, Lq, k = idx.shape
    acc = torch.zeros((S, Y.shape[0], Lq), dtype=torch.float32, device=Y.device)
    for j in range(k):
        g = Y[:, idx[:, :, j].long()].transpose(0, 1)  # (S, B, Lq)
        acc = acc + w[:, None, :, j] * g
    return acc[0] if squeeze else acc
