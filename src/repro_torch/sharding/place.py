"""Placement of the port's LM state and batches on a mesh, as DTensors.

JAX places with ``jax.device_put`` / ``jit(out_shardings=)``; the port
turns each tensor into a ``torch.distributed.tensor.DTensor`` by its
spec (``policy.py``):

  * :func:`placements` -- a spec (one mesh-axis name, tuple of names or
    None per tensor dim) as DTensor placements: ``Shard(d)`` on each mesh
    dim that names tensor dim d, ``Replicate()`` elsewhere;
  * :func:`place` -- a tensor that every rank holds whole (the same seed,
    the same host batch) as a DTensor: each rank keeps its own slice, no
    collective;
  * :func:`shard_module`, :func:`shard_train_state`, :func:`shard_batch`
    -- an ``LM``, a ``TrainState`` and a batch by their specs;
  * :func:`full` -- the whole tensor back (a gather) from a DTensor.

A dim the axis does not divide is replicated (``ShardingPolicy._fit``);
:func:`shard_module` records each such degradation in the module's
``placement_record``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.sharding import policy as POL


def _dt():
    from torch.distributed import tensor as dtensor

    return dtensor


def is_sharded(t) -> bool:
    """True for a DTensor."""
    return isinstance(t, _dt().DTensor)


def placements(spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``'s named dims."""
    dt = _dt()
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, ax in enumerate(spec)
                if ax == name or (isinstance(ax, tuple) and name in ax)]
        out.append(dt.Shard(dims[0]) if dims else dt.Replicate())
    return out


def mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def place(t: torch.Tensor, mesh, plc) -> torch.Tensor:
    """``t`` (the same whole tensor on every rank) as a DTensor of
    placements ``plc``: each rank keeps its slice (a copy), mesh dim by
    mesh dim in mesh order, as DTensor lays shards out."""
    dt = _dt()
    local = t.detach().to(mesh_device(mesh))
    coord = mesh.get_coordinate()
    for mdim, p in enumerate(plc):
        if isinstance(p, dt.Shard):
            n = mesh.size(mdim)
            size = local.shape[p.dim] // n
            local = local.narrow(p.dim, coord[mdim] * size, size)
    local = local.clone().contiguous()
    return dt.DTensor.from_local(local, mesh, plc, run_check=False,
                                 shape=t.shape, stride=t.contiguous().stride())


def place_spec(t: torch.Tensor, policy: POL.ShardingPolicy, spec) -> torch.Tensor:
    return place(t, policy.mesh, placements(spec, policy.mesh))


def full(t):
    """The whole tensor of a DTensor (gathered on every rank); any other
    value as it is."""
    return t.full_tensor() if is_sharded(t) else t


def local(t):
    """A DTensor's local shard; any other value as it is."""
    return t.to_local() if is_sharded(t) else t


class _UnitMesh:
    """A stand-in mesh whose every axis has size 1: the specs that no
    divisibility rule degrades."""

    def __init__(self, names):
        self.axis_names = tuple(names)
        self.shape = dict.fromkeys(self.axis_names, 1)


def _degraded(policy: POL.ShardingPolicy, model) -> list:
    """[(parameter, wanted spec, spec placed)] where a dim was replicated
    because its axis did not divide it."""
    import dataclasses

    free = dataclasses.replace(policy, mesh=_UnitMesh(policy.axis_names))
    want = POL.param_specs(free, model)
    got = POL.param_specs(policy, model)
    return [(k, want[k], got[k]) for k in got if want[k] != got[k]]


def shard_module(lm: nn.Module, policy: POL.ShardingPolicy) -> nn.Module:
    """Every parameter of ``lm`` (the same values on every rank) replaced
    in place by a DTensor parameter placed by its spec; returns ``lm``,
    with ``placement_record``: the parameter count, how many are sharded
    on some axis, and the degradations."""
    specs = POL.param_specs(policy, lm)
    degraded = _degraded(policy, lm)
    n_sharded = 0
    for name, spec in specs.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = lm.get_submodule(mod_name) if mod_name else lm
        old = getattr(mod, leaf)
        new = place_spec(old.data, policy, spec)
        n_sharded += any(ax is not None for ax in spec)
        mod.register_parameter(leaf, nn.Parameter(new, requires_grad=old.requires_grad))
    lm.placement_record = {"n_params": len(specs), "n_sharded": n_sharded,
                           "degraded": degraded}
    lm.sharding_policy = policy
    return lm


def shard_train_state(state, policy: POL.ShardingPolicy, tc):
    """A ``TrainState`` (whole on every rank) with its parameters and
    optimizer tensors placed by their specs (``policy.opt_specs``); the
    count and the step stay plain (replicated) 0-d tensors on the mesh's
    device."""
    import dataclasses

    specs = POL.train_state_specs(policy, state.params, tc)
    shard_module(state.params, policy)
    dev = mesh_device(policy.mesh)

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        if tree.ndim == 0:
            return tree.to(dev)
        return place_spec(tree, policy, spec)

    return dataclasses.replace(state, opt=walk(state.opt, specs["opt"]),
                               step=state.step.to(dev))


def zeros(shape, dtype, policy: POL.ShardingPolicy, spec) -> torch.Tensor:
    """A zero DTensor of global ``shape`` placed by ``spec``: each rank
    allocates only its shard."""
    mesh = policy.mesh
    plc = placements(spec, mesh)
    local_shape = list(shape)
    dt = _dt()
    for mdim, p in enumerate(plc):
        if isinstance(p, dt.Shard):
            local_shape[p.dim] //= mesh.size(mdim)
    t = torch.zeros(local_shape, dtype=dtype, device=mesh_device(mesh))
    return dt.DTensor.from_local(t, mesh, plc, run_check=False, shape=torch.Size(shape),
                                 stride=torch.empty(shape, device="meta").stride())


def sharded_cache(cfg, B: int, cache_len: int, policy: POL.ShardingPolicy,
                  dtype=None) -> dict:
    """``init_cache``'s zero cache as DTensors placed by
    ``policy.cache_specs_tree`` (dense: KV along the sequence on "model",
    batch on the data axes)."""
    from repro_torch.models import transformer as T

    meta = T.init_cache(cfg, B, cache_len, dtype=dtype, device="meta")
    specs = POL.cache_specs_tree(policy, meta, cfg)

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        return zeros(tuple(tree.shape), tree.dtype, policy, spec)

    return walk(meta, specs)


def grow_cache(cache: dict, cfg, S_new: int, policy: POL.ShardingPolicy) -> dict:
    """A sharded dense cache made room for decode steps: a cache of S_new
    positions placed by the cache specs, with ``cache``'s positions on the
    sequence axis (a gather of the old cache, then each rank's slice)."""
    k = full(cache["k"])
    B = k.shape[1]
    new = sharded_cache(cfg, B, S_new, policy, dtype=k.dtype)
    for name in ("k", "v"):
        whole = torch.zeros(tuple(new[name].shape), dtype=k.dtype, device=k.device)
        whole[:, :, : k.shape[2]] = full(cache[name])
        new[name] = place(whole, policy.mesh, new[name].placements)
    return new


def shard_batch(batch: dict, policy: POL.ShardingPolicy, kind: str = "train") -> dict:
    """A batch (the same host arrays on every rank) placed by its batch
    specs; ``pos`` stays an int."""
    specs = POL.batch_specs(policy, {k: v for k, v in batch.items() if k != "pos"}, kind)
    out = {}
    for k, v in batch.items():
        if k == "pos":
            out[k] = v
            continue
        t = torch.as_tensor(v)
        out[k] = place_spec(t, policy, specs[k])
    return out
