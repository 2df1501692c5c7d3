"""AdamW with decoupled weight decay and global-norm gradient clipping.

The counterpart of the JAX package's ``optim/adamw.py``, as plain
functions on dicts of tensors (``torch.optim.AdamW`` places eps, the
bias correction and the decay otherwise).  Moments live in a
configurable dtype (fp32 default; bf16 for the very large archs); the
update is computed in float32 and cast back to each parameter's dtype.

The port's parameters are one tensor a layer where JAX stacks the layers
into one leaf.  JAX decays only leaves with ``ndim >= 2``, counted on
its stacked leaf, so a block's norm scale (d,) is decayed there, as a
(n_layers, d) leaf; ``leaf_ndim`` gives each tensor the ndim of the JAX
leaf it is a slice of (``models.transformer.jax_leaf_ndims``).

``update`` writes the parameters and moments in place (under no_grad)
and returns them with the new count."""
from __future__ import annotations

from typing import Optional

import torch


def init(params: dict, moment_dtype=torch.float32) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
    dev = next(iter(params.values())).device
    return {
        "m": {k: zeros(p) for k, p in params.items()},
        "v": {k: zeros(p) for k, p in params.items()},
        "count": torch.zeros((), dtype=torch.int32, device=dev),
    }


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor reduction's value (all-reduced); a tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def global_norm(tree) -> torch.Tensor:
    """The norm over every leaf; over every shard of DTensor leaves."""
    leaves = tree.values() if isinstance(tree, dict) else tree
    return torch.sqrt(sum(_whole(torch.sum(torch.square(x.float()))) for x in leaves))


def clip_by_global_norm(grads: dict, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, norm


@torch.no_grad()
def update(grads: dict, state: dict, params: dict, lr, b1=0.9, b2=0.95, eps=1e-8,
           weight_decay=0.01, leaf_ndim: Optional[dict] = None):
    count = state["count"] + 1
    c1 = 1.0 - torch.pow(b1, count.float())
    c2 = 1.0 - torch.pow(b2, count.float())
    for k, p in params.items():
        m, v = state["m"][k], state["v"][k]
        gf = grads[k].float()
        m_new = b1 * m.float() + (1 - b1) * gf
        v_new = b2 * v.float() + (1 - b2) * gf * gf
        step = lr * (m_new / c1) / (torch.sqrt(v_new / c2) + eps)
        ndim = p.ndim if leaf_ndim is None else leaf_ndim[k]
        if weight_decay > 0.0 and ndim >= 2:  # no decay on norms/biases
            step = step + lr * weight_decay * p.float()
        p.copy_((p.float() - step).to(p.dtype))
        m.copy_(m_new.to(m.dtype))
        v.copy_(v_new.to(v.dtype))
    state["count"] = count
    return params, state
