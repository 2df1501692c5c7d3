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
(``last_experts``: (G, g, top_k) indices of every token, padded ones
last).

Sharded (a DTensor x; ``moe_fwd``'s docstring): experts parallel on
"model" where it divides ``n_experts``, else each expert's ``f`` on
"model"; the routing of every token is gathered over the data axes, so
a group that spans the data shards keeps one process's capacity
positions; the combine is a partial sum over "model".  A rank counts
its own tokens, and only the rank at index 0 of "model" counts, so the
counts summed over the ranks are one process's.  Each
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


def _model_shard(w: torch.Tensor):
    """The placement of DTensor ``w`` on the "model" mesh dim, or None."""
    from repro_torch.models.layers import _is_dt

    if not _is_dt(w):
        return None
    names = w.device_mesh.mesh_dim_names
    return w.placements[names.index("model")] if "model" in names else None


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
    as the one-token decode path does.

    On a DTensor x (batch on the data axes, replicated on "model"; the
    weights placed by ``sharding/policy.py``) each rank routes its own
    tokens, gathers every token's expert choices over the data axes (a
    group may span the data shards: capacity positions are the one
    process's), dispatches its tokens to its local experts (expert-
    parallel: ``Shard(0)`` on "model") or to every expert's local ``f``
    columns (tensor-parallel inside each expert), and returns its share
    of the combine as a partial sum over "model", reduced into the
    activation layout (``sharding/local.py``).  Each token shard is
    counted once: on the rank at index 0 of "model"."""
    from repro_torch.models.layers import as_activation
    from repro_torch.sharding.local import Local

    B, S, d = x.shape
    E = n_experts
    T0 = B * S
    g = min(group_size, T0)
    T = -(-T0 // g) * g  # tokens padded to a group multiple
    G = T // g
    plc = _model_shard(p.w_up)
    lc = Local(x, split=plc is not None and plc.is_shard())
    b0, _ = lc.token_rank()
    xl = lc.x_local(x)
    B_l = xl.shape[0]
    t0, T_l = b0 * B_l * S, B_l * S  # this rank's tokens, batch-major
    xt = xl.reshape(T_l, d)
    dev = x.device

    probs = torch.softmax(xt.float() @ lc.param(p.router), dim=-1)  # (T_l, E)
    gates, experts = _top_k(probs, top_k)  # (T_l, k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    # every token's choices; padded tokens (zero rows: uniform probabilities)
    # last, which never dispatch
    pad = torch.softmax(torch.zeros((1, E), device=dev), dim=-1)
    e_all = lc.gather_tokens(experts.reshape(B_l, S * top_k)).reshape(T0, top_k)
    e_all = torch.cat([e_all, _top_k(pad, top_k)[1].expand(T - T0, top_k)])
    e_all = e_all.reshape(G, g, top_k)
    C = g if no_drop else max(1, int(capacity_factor * g * top_k / E))
    # slot-major order of the (token, slot) assignments: a = slot * g + token
    e_sm = e_all.transpose(1, 2).reshape(G, top_k * g)
    valid = (torch.arange(T, device=dev) < T0).reshape(G, g)
    valid_sm = valid.repeat(1, top_k)  # (G, k * g)
    onehot = F.one_hot(e_sm, E) * valid_sm[..., None]  # (G, k * g, E)
    # position in the expert's buffer: the assignments to it before this one
    pos = (onehot.cumsum(1) - onehot).gather(-1, e_sm[..., None])[..., 0]
    keep = valid_sm & (pos < C)  # (G, k * g)
    kept = torch.zeros((G, E), dtype=torch.float32, device=dev)
    kept.scatter_add_(1, e_sm, keep.float())

    # this rank's assignments: (token, slot) -> (group, slot-major index)
    t = torch.arange(t0, t0 + T_l, device=dev)
    grp = (t // g)[:, None].expand(T_l, top_k)
    a = torch.arange(top_k, device=dev)[None] * g + (t % g)[:, None]
    keep_l, pos_l = keep[grp, a], pos[grp, a]  # (T_l, k)
    w_up = lc.param(p.w_up)
    if plc is not None and plc.is_shard() and plc.dim == 0:  # expert-parallel
        E_l = w_up.shape[0]
        e0 = lc.split_rank()[0] * E_l
    else:
        E_l, e0 = E, 0
    mine = keep_l & (experts >= e0) & (experts < e0 + E_l)
    g_lo = t0 // g
    nG = (t0 + T_l - 1) // g - g_lo + 1  # the groups this rank's tokens fall in
    row = ((grp - g_lo) * E_l + (experts - e0)) * C + pos_l
    kt = torch.arange(T_l, device=dev)[:, None].expand(T_l, top_k)[mine]
    kr = row[mine]
    xe = xt.new_zeros((nG * E_l * C, d))
    xe[kr] = xt[kt]

    # experts: (E_l, nG * C, d) batched products
    xe = xe.view(nG, E_l, C, d).transpose(0, 1).reshape(E_l, nG * C, d)
    if act == "swiglu":
        h = F.silu(torch.bmm(xe, lc.param(p.w_gate))) * torch.bmm(xe, w_up)
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(torch.bmm(xe, w_up), approximate="tanh")
    ye = torch.bmm(h, lc.param(p.w_down))
    ye = ye.view(E_l, nG, C, d).transpose(0, 1).reshape(nG * E_l * C, d)

    # combine: each token sums its kept rows, weighted by its gates cast to
    # x's dtype (in f32, rounded once, as one contraction would)
    w = gates.to(x.dtype)[mine]
    y = torch.zeros((T_l, d), dtype=torch.float32, device=dev)
    y.index_put_((kt,), w.float()[:, None] * ye[kr].float(), accumulate=True)
    y = as_activation(lc.out(y.reshape(B_l, S, d), (B, S, d))).to(x.dtype)

    # Switch load-balancing loss: E * sum_e fraction_e * router_prob_e, the
    # probabilities summed per group over this rank's tokens (padded tokens'
    # uniform ones on the rank that holds the last token)
    psum = torch.zeros((G, E), dtype=torch.float32, device=dev)
    psum = psum.index_add(0, t // g, probs)
    if T > T0 and t0 + T_l == T0:
        psum = psum.index_add(0, torch.full((T - T0,), G - 1, device=dev),
                              pad.expand(T - T0, E))
    aux = E * ((kept / g) * (psum / g)).sum(-1).sum() / G / lc.split_rank()[1]
    aux = lc.scalar_sum(aux)

    p.last_experts = e_all
    if not getattr(_COUNT, "off", False) and lc.counts():
        p.routed += T_l * top_k
        p.dropped += T_l * top_k - keep_l.sum()
    return y, aux


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
