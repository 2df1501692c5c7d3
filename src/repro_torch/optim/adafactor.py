"""Adafactor (Shazeer & Stern 2018): factored second moment for >=2D params
(row+col accumulators instead of a full moment tensor) — the optimizer of
choice for the 100B+ MoE archs where AdamW moments would not fit HBM.

The counterpart of the JAX package's ``optim/adafactor.py``.  Its
factoring, its RMS update clip and its weight decay read whole JAX
leaves, and JAX stacks a model's layers into one leaf: a stacked norm
scale (n_layers, d) is factored over its layers, and the RMS is taken
over every layer of a leaf.  So the port works leaf group by leaf
group: ``groups`` maps a group name to (the stacked shape, the names of
its tensors in row-major order of their stack index)
(``models.transformer.jax_leaf_groups``); each group's gradients are
stacked into the JAX leaf's shape, updated as JAX updates it, and
written back slice by slice.  The accumulators are kept in the stacked
shapes, keyed by group.  Without ``groups`` every tensor is a group of
its own.  ``update`` writes the parameters in place (under no_grad)."""
from __future__ import annotations

from typing import Optional

import torch


def _factored(shape) -> bool:
    return len(shape) >= 2


def _groups(params: dict, groups: Optional[dict]) -> dict:
    return groups if groups is not None else {k: ((), [k]) for k in params}


def _shape(params: dict, stack, names) -> tuple:
    return tuple(stack) + tuple(params[names[0]].shape)


def _stacked(tensors, shape) -> torch.Tensor:
    if len(tensors) == 1 and tuple(tensors[0].shape) == tuple(shape):
        return tensors[0].float()
    return torch.stack([t.float() for t in tensors]).reshape(shape)


def init(params: dict, groups: Optional[dict] = None) -> dict:
    dev = next(iter(params.values())).device
    zeros = lambda shape: torch.zeros(shape, dtype=torch.float32, device=dev)
    acc = {}
    for name, (stack, names) in _groups(params, groups).items():
        shape = _shape(params, stack, names)
        if _factored(shape):
            acc[name] = {"vr": zeros(shape[:-1]),  # row accum
                         "vc": zeros(shape[:-2] + shape[-1:])}
        else:
            acc[name] = {"v": zeros(shape)}
    return {"acc": acc, "count": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def update(grads: dict, state: dict, params: dict, lr, decay=0.8, eps=1e-30,
           clip_thresh=1.0, weight_decay=0.0, groups: Optional[dict] = None):
    count = state["count"] + 1
    beta = 1.0 - torch.pow(count.float(), -decay)
    for name, (stack, names) in _groups(params, groups).items():
        shape = _shape(params, stack, names)
        acc = state["acc"][name]
        gf = _stacked([grads[n] for n in names], shape)
        g2 = gf * gf + eps
        if _factored(shape):
            vr = beta * acc["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
            vc = beta * acc["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
            denom = torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=eps)
            vhat = (vr[..., None] / denom[..., None]) * vc[..., None, :]
            acc["vr"].copy_(vr)
            acc["vc"].copy_(vc)
        else:
            vhat = beta * acc["v"] + (1 - beta) * g2
            acc["v"].copy_(vhat)
        u = gf / torch.sqrt(torch.clamp(vhat, min=eps))
        # update clipping (RMS threshold)
        rms = torch.sqrt(torch.mean(u * u))
        u = u / torch.clamp(rms / clip_thresh, min=1.0)
        step = lr * u
        pf = _stacked([params[n] for n in names], shape)
        if weight_decay > 0.0 and len(shape) >= 2:
            step = step + lr * weight_decay * pf
        new = (pf - step).reshape((len(names),) + tuple(params[names[0]].shape))
        for i, n in enumerate(names):
            params[n].copy_(new[i].to(params[n].dtype))
    state["count"] = count
    return params, state
