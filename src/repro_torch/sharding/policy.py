"""Divisibility-aware sharding policy: parameter, optimizer, batch and
cache specs.

The counterpart of the JAX package's ``sharding/policy.py``, rule for
rule:
  * batch dims -> all data-parallel axes ("pod", "data");
  * weights: Megatron column / row tensor-parallel on "model" (column:
    d_ff and head projections; row: their inverses); vocab-parallel
    embedding and LM head;
  * FSDP (ZeRO-3): for large models the non-TP weight dim is also sharded
    on "data";
  * MoE: expert-parallel on "model" when n_experts divides the axis, else
    tensor-parallel inside each expert;
  * decode caches: KV sharded along the *sequence* dim on "model"
    (flash-decode), SSM states on heads;
  * every rule degrades to replication when a dim is not divisible by the
    axis size.

A spec is a tuple with one entry per tensor dim: a mesh-axis name, a
tuple of names, or None (``place.placements`` turns it into DTensor
placements).  JAX keys its specs by the leaf path of its stacked tree;
the port holds a stacked leaf as one tensor a layer
(``models.transformer.jax_leaf_groups``), so a port parameter's spec is
its JAX leaf's spec with the leading stacked dims dropped
(:func:`param_specs`; :func:`leaf_specs` gives the leaves' own).

A mesh is a ``torch.distributed`` ``DeviceMesh`` with named dims, or any
object with ``axis_names`` and a ``shape`` mapping of them (a stand-in
mesh for specs alone).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or a stand-in mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    mesh: Any
    fsdp: bool = False  # shard weights on "data" too (ZeRO-3)
    seq_shard_cache: bool = True  # decode KV cache sharded along seq
    # dp_only: replicate weights, use the model axis as EXTRA batch
    # parallelism (sub-1B archs, where TP only replicates attention)
    dp_only: bool = False

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(axis_sizes(self.mesh))

    @property
    def dp(self) -> tuple[str, ...]:
        return tuple(a for a in self.axis_names if a in ("pod", "data"))

    @property
    def tp(self):
        return None if self.dp_only else "model"

    @property
    def batch_axes(self) -> tuple[str, ...]:
        return self.dp + (("model",) if self.dp_only else ())

    def axis_size(self, name) -> int:
        if isinstance(name, tuple):
            return math.prod(self.axis_size(a) for a in name)
        return axis_sizes(self.mesh)[name]

    def _fit(self, axis, dim: int):
        """axis if dim divides the axis size, else None (replicate)."""
        if axis is None:
            return None
        return axis if dim % self.axis_size(axis) == 0 else None

    @property
    def fsdp_axis(self) -> Optional[str]:
        return "data" if self.fsdp else None


def auto_policy(cfg: ModelConfig, mesh, n_params: int | None = None) -> ShardingPolicy:
    """FSDP kicks in when replicated-over-data weights would not fit:
    > ~2B params."""
    if n_params is None:
        n_params = estimate_params(cfg)
    return ShardingPolicy(mesh=mesh, fsdp=n_params > 2_000_000_000)


def estimate_params(cfg: ModelConfig) -> int:
    """Parameter count of the model built on the meta device (nothing is
    allocated)."""
    from repro_torch.models import transformer as T

    return sum(p.numel() for p in T.LM(cfg, torch.device("meta")).parameters())


# --------------------------------------------------------------------------
# parameter specs
# --------------------------------------------------------------------------
_COL_PARENTS = {"wq", "wk", "wv", "w_gate", "w_up", "in_proj"}  # (din, dout): TP on dout
_ROW_PARENTS = {"wo", "w_down", "out_proj"}  # (din, dout): TP on din
_REPLICATED_LEAVES = {
    "scale", "bias", "A_log", "D", "dt_bias", "norm_scale",
    "gate_attn", "gate_mlp", "router",
}


def param_spec(policy: ShardingPolicy, names, ndim: int, shape) -> tuple:
    """The spec of the JAX leaf at path ``names`` (its keys, stacked axes
    not spelled out) of ``shape``."""
    names = list(names)
    leaf = names[-1]
    parent = names[-2] if len(names) > 1 else ""
    fsdp, tp = policy.fsdp_axis, policy.tp
    in_moe = "moe" in names
    fit = policy._fit

    def lead(spec_tail: tuple) -> tuple:
        # leading scan/stack dims (layers, units, per-unit) stay unsharded
        return (None,) * (ndim - len(spec_tail)) + tuple(spec_tail)

    if leaf in _REPLICATED_LEAVES:
        return (None,) * ndim
    if leaf == "tok":  # (vocab, d): vocab-parallel embedding
        return lead((fit(tp, shape[-2]), fit(fsdp, shape[-1])))
    if leaf == "lm_head":  # (d, vocab)
        return lead((fit(fsdp, shape[-2]), fit(tp, shape[-1])))
    if leaf in ("pos", "enc_pos"):  # (S, d)
        return lead((None, fit(tp, shape[-1])))
    if in_moe and leaf in ("w_up", "w_gate", "w_down"):  # (E, d, f) / (E, f, d)
        E = shape[-3]
        if E % policy.axis_size(tp) == 0:  # expert-parallel
            return lead((tp, fit(fsdp, shape[-2]), None))
        if leaf == "w_down":  # TP inside experts: contract dim f
            return lead((None, fit(tp, shape[-2]), fit(fsdp, shape[-1])))
        return lead((None, fit(fsdp, shape[-2]), fit(tp, shape[-1])))
    if leaf == "conv_w":  # (d_conv, conv_dim)
        return lead((None, fit(tp, shape[-1])))
    if leaf == "conv_b":
        return lead((fit(tp, shape[-1]),))
    if leaf.startswith("a_"):  # lora in: (2d, r)
        return lead((fit(fsdp, shape[-2]), None))
    if leaf.startswith("b_"):  # lora out: (r, dout)
        return lead((None, fit(tp, shape[-1])))
    if leaf == "w" and parent in _COL_PARENTS:
        return lead((fit(fsdp, shape[-2]), fit(tp, shape[-1])))
    if leaf == "w" and parent in _ROW_PARENTS:
        return lead((fit(tp, shape[-2]), fit(fsdp, shape[-1])))
    if leaf == "b" and parent in _COL_PARENTS:
        return lead((fit(tp, shape[-1]),))
    if leaf == "b":
        return lead((None,))
    # default: replicate (and make it visible in reviews)
    return (None,) * ndim


def leaf_specs(policy: ShardingPolicy, model) -> dict:
    """{JAX leaf path: its spec} of an ``LM`` module (its stacked shape)."""
    from repro_torch.models import transformer as T

    out = {}
    for key, (stack, names) in T.jax_leaf_groups(model).items():
        shape = tuple(stack) + tuple(model.get_parameter(names[0]).shape)
        out[key] = param_spec(policy, key.split("."), len(shape), shape)
    return out


def param_specs(policy: ShardingPolicy, model) -> dict:
    """{port parameter name: spec}: its JAX leaf's spec without the leading
    stacked dims."""
    from repro_torch.models import transformer as T

    leaves = leaf_specs(policy, model)
    return {name: leaves[key][len(stack):]
            for key, (stack, names) in T.jax_leaf_groups(model).items()
            for name in names}


def opt_specs(policy: ShardingPolicy, p_specs: dict, model, tc: TrainConfig) -> dict:
    """The optimizer state's specs, shaped like ``steps.init_opt``'s dict:
    AdamW's moments share their parameter's spec; Adafactor's factored
    accumulators (kept in the JAX leaves' stacked shapes) drop one dim of
    the leaf's spec each (``vr`` the last, ``vc`` the one before)."""
    if tc.optimizer == "adamw":
        return {"m": dict(p_specs), "v": dict(p_specs), "count": ()}
    acc = {}
    for key, spec in leaf_specs(policy, model).items():
        if len(spec) >= 2:
            acc[key] = {"vr": spec[:-1], "vc": spec[:-2] + spec[-1:]}
        else:
            acc[key] = {"v": spec}
    return {"acc": acc, "count": ()}


def train_state_specs(policy: ShardingPolicy, model, tc: TrainConfig) -> dict:
    """{"params", "opt", "step"} specs of a ``TrainState``."""
    p_specs = param_specs(policy, model)
    return {"params": p_specs, "opt": opt_specs(policy, p_specs, model, tc),
            "step": ()}


# --------------------------------------------------------------------------
# batch / cache specs
# --------------------------------------------------------------------------
def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _map(fn, tree, prefix=()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, prefix + (k,)) for k, v in tree.items()}
    return fn(prefix, tree)


def batch_specs(policy: ShardingPolicy, batch_tree: dict, kind: str) -> dict:
    """Batch dim on the batch axes (where they divide it); ``pos`` a
    replicated scalar."""

    def spec(path, x):
        leaf = path[-1]
        shape = tuple(x.shape)
        if leaf == "pos":
            return ()
        dp = policy._fit(policy.batch_axes, shape[0])
        if leaf in ("tokens", "token"):
            return (dp, None)
        if leaf in ("audio", "image_embeds"):
            return (dp, None, None)
        return (None,) * len(shape)

    return _map(spec, batch_tree)


def cache_specs_tree(policy: ShardingPolicy, cache_tree: dict, cfg: ModelConfig) -> dict:
    """Decode caches.  KV: (layers..., B, S, K, dh) -> seq sharded on model.
    SSM states: heads sharded on model.  Cross-KV: source-seq sharded."""
    tp = policy.tp

    def spec(path, x):
        leaf = path[-1]
        shape = tuple(x.shape)
        nd = len(shape)
        if leaf in ("k", "v", "xk", "xv"):
            lead = nd - 4  # stacked layer/unit dims before (B, S, K, dh)
            dp = policy._fit(policy.batch_axes, shape[lead])
            seq_ax = policy._fit(tp, shape[-3]) if policy.seq_shard_cache else None
            kv_ax = None if seq_ax else policy._fit(tp, shape[-2])
            return (None,) * lead + (dp, seq_ax, kv_ax, None)
        if leaf == "ssm":  # (..., B, H, P, N)
            dp = policy._fit(policy.batch_axes, shape[nd - 4])
            return (None,) * (nd - 4) + (dp, policy._fit(tp, shape[-3]), None, None)
        if leaf == "conv":  # (..., B, w, conv_dim)
            dp = policy._fit(policy.batch_axes, shape[nd - 3])
            return (None,) * (nd - 3) + (dp, None, policy._fit(tp, shape[-1]))
        if leaf == "x0":
            dp = policy._fit(policy.batch_axes, shape[nd - 3])
            return (None,) * (nd - 3) + (dp, None, None)
        return (None,) * nd

    return _map(spec, cache_tree)
