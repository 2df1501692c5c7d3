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
its own.  ``update`` writes the parameters in place (under no_grad).

The update runs on plain (local) tensors.  A group whose tensors have
two or more dims is updated tensor by tensor (its factoring dims are the
tensor's own last two; only the RMS clip spans the whole leaf, so it
takes two passes: the accumulators and the leaf's sum of squared
updates, then the update, recomputed), so no stacked copy of a large
leaf is built; a group of 0-d or 1-d tensors is stacked into the JAX
leaf's shape.  On DTensor parameters (their gradients in the same
placements, the accumulators placed by ``policy.opt_specs``: each drops
the dim it reduces) each rank works on its shards: a mean over a dim
sharded on some mesh dims is the local sum all-reduced over them, over
the dim's whole size, and the RMS's sum is all-reduced over every mesh
dim that shards the leaf."""
from __future__ import annotations

from typing import Optional

import torch


def _factored(shape) -> bool:
    return len(shape) >= 2


def _groups(params: dict, groups: Optional[dict]) -> dict:
    return groups if groups is not None else {k: ((), [k]) for k in params}


def _shape(params: dict, stack, names) -> tuple:
    return tuple(stack) + tuple(params[names[0]].shape)


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


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


class _Layout:
    """Where a tensor's dims are sharded: {dim: [process groups of the mesh
    dims that shard it]}, ``lead`` stacked dims first (never sharded)."""

    def __init__(self, t: torch.Tensor, lead: int = 0):
        self.by_dim: dict = {}
        if hasattr(t, "placements"):
            mesh = t.device_mesh
            for m, p in enumerate(t.placements):
                if p.is_shard():
                    self.by_dim.setdefault(lead + p.dim, []).append(mesh.get_group(m))
        self.all = [g for gs in self.by_dim.values() for g in gs]

    @staticmethod
    def _reduce(x: torch.Tensor, groups) -> torch.Tensor:
        if groups:
            import torch.distributed as dist

            for grp in groups:
                dist.all_reduce(x, group=grp)
        return x

    def mean(self, x: torch.Tensor, dim: int, size: int, keepdim=False) -> torch.Tensor:
        """The mean over tensor dim ``dim`` (of global ``size``) of local ``x``."""
        s = x.sum(dim, keepdim=keepdim)
        return self._reduce(s, self.by_dim.get(dim % (x.ndim), [])) / size

    def total(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, self.all)


def _update_group(gs, ps, acc, shape, lay, beta, lr, eps, clip_thresh, weight_decay):
    """One JAX leaf of global ``shape``: ``gs`` / ``ps`` its local
    gradient and parameter pieces (functions of the piece index, float32
    gradient / the parameter to write), ``acc`` its accumulators' local
    pieces, each piece factored over its own last two dims where
    ``shape`` is."""
    n = len(acc)
    factored = _factored(shape)
    ss = torch.zeros((), dtype=torch.float32, device=acc[0][next(iter(acc[0]))].device)
    denoms = []

    def vhat(i):
        a = acc[i]
        if not factored:
            return a["v"]
        return (a["vr"][..., None] / denoms[i][..., None]) * a["vc"][..., None, :]

    for i in range(n):  # accumulators, and the leaf's sum of squared updates
        gf = gs(i)
        g2 = gf * gf + eps
        a = acc[i]
        if factored:
            vr = beta * a["vr"] + (1 - beta) * lay.mean(g2, -1, shape[-1])
            vc = beta * a["vc"] + (1 - beta) * lay.mean(g2, -2, shape[-2])
            a["vr"].copy_(vr)
            a["vc"].copy_(vc)
            denoms.append(torch.clamp(lay.mean(vr, -1, shape[-2], keepdim=True), min=eps))
        else:
            a["v"].copy_(beta * a["v"] + (1 - beta) * g2)
        u = gf / torch.sqrt(torch.clamp(vhat(i), min=eps))
        ss = ss + (u * u).sum()
    numel = 1
    for d in shape:
        numel *= d
    # update clipping (RMS threshold)
    rms = torch.sqrt(lay.total(ss) / numel)
    scale = torch.clamp(rms / clip_thresh, min=1.0)
    for i in range(n):
        u = gs(i) / torch.sqrt(torch.clamp(vhat(i), min=eps)) / scale
        step = lr * u
        p = ps(i)
        pf = p.float()
        if weight_decay > 0.0 and len(shape) >= 2:
            step = step + lr * weight_decay * pf
        p.copy_((pf - step).reshape(p.shape).to(p.dtype))


@torch.no_grad()
def update(grads: dict, state: dict, params: dict, lr, decay=0.8, eps=1e-30,
           clip_thresh=1.0, weight_decay=0.0, groups: Optional[dict] = None):
    count = state["count"] + 1
    beta = 1.0 - torch.pow(count.float(), -decay)
    for name, (stack, names) in _groups(params, groups).items():
        shape = _shape(params, stack, names)
        acc = {k: _local(t) for k, t in state["acc"][name].items()}
        p0 = params[names[0]]
        if p0.ndim >= 2:  # tensor by tensor
            lay = _Layout(p0)
            pieces = [{k: t.reshape((len(names),) + t.shape[len(stack):])[i]
                       for k, t in acc.items()} for i in range(len(names))]
            _update_group(lambda i: _local(grads[names[i]]).float(),
                          lambda i: _local(params[names[i]]), pieces, shape, lay,
                          beta, lr, eps, clip_thresh, weight_decay)
        else:  # the group stacked into the leaf's shape
            lay = _Layout(p0, lead=len(stack))
            local_shape = tuple(stack) + tuple(_local(p0).shape)
            gf = torch.stack([_local(grads[n]).float() for n in names]).reshape(local_shape)
            pf = torch.stack([_local(params[n]).float() for n in names]).reshape(local_shape)
            _update_group(lambda i: gf, lambda i: pf, [acc], shape, lay, beta, lr, eps,
                          clip_thresh, weight_decay)
            new = pf.reshape((len(names),) + tuple(_local(p0).shape))
            for i, n in enumerate(names):
                _local(params[n]).copy_(new[i].to(params[n].dtype))
    state["count"] = count
    return params, state
