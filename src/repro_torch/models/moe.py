"""Mixture-of-Experts block: top-k router and GShard capacity dispatch.

The counterpart of the JAX package's ``models/moe.py``, computing the
same function in PyTorch's idiom.  JAX builds one-hot (group, token,
expert, capacity) dispatch and combine tensors and contracts them; here
the dispatch is an index form: each kept (token, slot) assignment has a
row of a (G, E, C, d) buffer, the tokens are copied into their rows, the
experts run as batched products over that buffer, and each token gathers
its rows back, weighted by its gates.  The semantics are JAX's:

- tokens flattened batch-major and padded to a multiple of the group
  ``g = min(group_size, B * S)``; padded tokens neither dispatch nor use
  capacity, but their (uniform) router probabilities enter the aux loss;
- router logits and softmax in float32; the top-k gates renormalised over
  the chosen experts; ties go to the lower expert index, as
  ``jax.lax.top_k`` breaks them (a stable descending sort; the order of
  ``torch.topk`` among ties is not specified);
- capacity ``C = g`` under ``no_drop``, else
  ``max(1, int(capacity_factor * g * top_k / E))``, taken slot-major then
  token-major (every token's first choice before any token's second); an
  assignment at position ``>= C`` is dropped;
- combine weights cast to ``x.dtype`` before the combine;
- the Switch aux loss from the kept assignments, averaged over ``g``
  padded rows included.

Each ``MoE`` module counts its routed and dropped (token, slot)
assignments on its device (``drop_counts`` / ``reset_drop_counts``),
without a synchronisation, and keeps its last call's expert choices
(``last_experts``: (G, g, top_k) indices, a reference, no copy).  Each
forward counts once: the recompute pass of activation recomputation
runs under :func:`not_counting`.  The backward goes through the index
dispatch (the copy into the buffer rows, the gates' weighted sum back):
a dropped assignment gets no gradient, as under JAX's one-hot dispatch.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import _param


class MoE(nn.Module):
    """``router`` (d, E) float32 whatever the model's dtype, ``w_up``
    (E, d, f), ``w_down`` (E, f, d) and, for swiglu, ``w_gate`` (E, d, f)."""

    def __init__(self, d_model, d_ff, n_experts, act: str, dtype, device):
        super().__init__()
        self.router = _param((d_model, n_experts), torch.float32, device)
        self.w_up = _param((n_experts, d_model, d_ff), dtype, device)
        self.w_down = _param((n_experts, d_ff, d_model), dtype, device)
        self.w_gate = (_param((n_experts, d_model, d_ff), dtype, device)
                       if act == "swiglu" else None)
        # (token, slot) assignments routed and dropped since the last reset
        self.register_buffer("dropped", torch.zeros((), dtype=torch.int64,
                                                    device=device), persistent=False)
        self.routed = 0
        self.last_experts = None


_COUNT = threading.local()


@contextlib.contextmanager
def not_counting():
    """MoE layers called inside (on this thread) do not add to their
    routed and dropped counts: the recompute pass of a checkpointed layer
    computes a forward that was counted already."""
    prev = getattr(_COUNT, "off", False)
    _COUNT.off = True
    try:
        yield
    finally:
        _COUNT.off = prev


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_fwd(
    p: MoE,
    x: torch.Tensor,
    n_experts: int,
    top_k: int,
    act: str,
    capacity_factor: float = 1.25,
    group_size: int = 1024,
    no_drop: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d) in x's dtype, aux loss (f32 scalar)).

    ``no_drop`` sets the capacity to the group size (nothing is dropped),
    as the one-token decode path does."""
    B, S, d = x.shape
    E = n_experts
    T0 = B * S
    g = min(group_size, T0)
    T = -(-T0 // g) * g  # tokens padded to a group multiple
    G = T // g
    xt = F.pad(x.reshape(T0, d), (0, 0, 0, T - T0)).reshape(G, g, d)

    probs = torch.softmax(xt.float() @ p.router, dim=-1)  # (G, g, E)
    gates, experts = _top_k(probs, top_k)  # (G, g, k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    C = g if no_drop else max(1, int(capacity_factor * g * top_k / E))
    # slot-major order of the (token, slot) assignments: a = slot * g + token
    e_sm = experts.transpose(1, 2).reshape(G, top_k * g)
    valid = (torch.arange(T, device=x.device) < T0).reshape(G, g)
    valid_sm = valid.repeat(1, top_k)  # (G, k * g)
    onehot = F.one_hot(e_sm, E) * valid_sm[..., None]  # (G, k * g, E)
    # position in the expert's buffer: the assignments to it before this one
    pos = (onehot.cumsum(1) - onehot).gather(-1, e_sm[..., None])[..., 0]
    keep = valid_sm & (pos < C)  # (G, k * g)

    # dispatch: kept assignment -> row (group, expert, position) of the buffer
    grp = torch.arange(G, device=x.device)[:, None].expand(G, top_k * g)
    tok = torch.arange(g, device=x.device).repeat(top_k)[None].expand(G, top_k * g)
    row = (grp * E + e_sm) * C + pos
    kg, kt, kr = grp[keep], tok[keep], row[keep]
    xe = x.new_zeros((G * E * C, d))
    xe[kr] = xt[kg, kt]

    # experts: (E, G * C, d) batched products
    xe = xe.view(G, E, C, d).transpose(0, 1).reshape(E, G * C, d)
    if act == "swiglu":
        h = F.silu(torch.bmm(xe, p.w_gate)) * torch.bmm(xe, p.w_up)
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(torch.bmm(xe, p.w_up), approximate="tanh")
    ye = torch.bmm(h, p.w_down).view(E, G, C, d).transpose(0, 1).reshape(G * E * C, d)

    # combine: each token sums its kept rows, weighted by its gates cast to
    # x's dtype (in f32, rounded once, as one contraction would)
    w = gates.transpose(1, 2).reshape(G, top_k * g).to(x.dtype)[keep]
    y = torch.zeros((G, g, d), dtype=torch.float32, device=x.device)
    y.index_put_((kg, kt), w.float()[:, None] * ye[kr].float(), accumulate=True)
    y = y.to(x.dtype)

    # Switch load-balancing loss: E * sum_e fraction_e * router_prob_e
    kept = torch.zeros((G, E), dtype=torch.float32, device=x.device)
    kept.scatter_add_(1, e_sm, keep.float())
    aux = E * ((kept / g) * probs.mean(1)).sum(-1).mean()

    p.last_experts = experts
    if not getattr(_COUNT, "off", False):
        p.routed += T0 * top_k
        p.dropped += T0 * top_k - keep.sum()
    return y.reshape(T, d)[:T0].reshape(B, S, d), aux


def _moe_modules(model: nn.Module):
    return [m for m in model.modules() if isinstance(m, MoE)]


def reset_drop_counts(model: nn.Module) -> None:
    """Every MoE layer's routed and dropped counts to 0."""
    for m in _moe_modules(model):
        m.routed = 0
        m.dropped.zero_()


def drop_counts(model: nn.Module) -> tuple[int, int]:
    """(routed, dropped) (token, slot) assignments over every MoE layer of
    ``model`` since the last reset (reads the card)."""
    mods = _moe_modules(model)
    return (sum(m.routed for m in mods), sum(int(m.dropped) for m in mods))
