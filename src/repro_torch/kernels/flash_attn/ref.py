"""Plain PyTorch version of the flash_attn kernel.

The counterpart of the JAX package's ``flash_attn_ref``: f32 logits of
q (scaled by 1/sqrt(dh)) against every key, the causal mask
``qpos >= kpos`` (top-left aligned) as -1e30, an f32 softmax over the
keys, the product with v in f32, the output in q's dtype.  There are no
padded keys: every key of k enters, and only those.

It is also the model's plain dense attention (``models.layers._sdpa`` on
``attn_impl="xla"`` and wherever ``q_pos`` is given), the counterpart of
the JAX ``_sdpa_dense``: there the causal mask reads ``q_pos``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def flash_attn_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True,
                   q_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, Sq, H, dh); k / v (B, Sk, K, dh), H % K == 0 -> (B, Sq, H, dh).

    q_pos: the key index of each query (decode / prefill into a cache
    longer than Sq; default 0 .. Sq-1); the causal mask then also hides
    unwritten slots.
    """
    B, Sq, H, dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    rep = H // K
    qf = q.float() / math.sqrt(dh)
    logits = torch.einsum("bqkrd,bskd->bkrqs", qf.reshape(B, Sq, K, rep, dh), k.float())
    if causal:
        if q_pos is None:
            q_pos = torch.arange(Sq, device=q.device)
        mask = q_pos[:, None] >= torch.arange(Sk, device=q.device)[None, :]
        logits = logits.masked_fill(~mask, -1e30)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkrqs,bskd->bqkrd", p, v.float())
    return o.reshape(B, Sq, H, dh).to(q.dtype)
