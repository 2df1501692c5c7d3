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
  * :func:`init_sharded`, :func:`build_sharded`, :func:`zero_opt` -- the
    state created shard by shard: the module built on the meta device,
    each leaf made whole on the rank's device one at a time (drawn as
    ``init_params`` draws it, or loaded) and only the rank's slice kept,
    so no rank ever holds the whole model; the optimizer's zeros
    allocated shard by shard;
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
    local = t.detach()
    coord = mesh.get_coordinate()
    for mdim, p in enumerate(plc):
        if isinstance(p, dt.Shard):
            n = mesh.size(mdim)
            size = local.shape[p.dim] // n
            local = local.narrow(p.dim, coord[mdim] * size, size)
    local = local.to(mesh_device(mesh)).clone(memory_format=torch.contiguous_format)
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


def _replace_leaves(lm: nn.Module, policy: POL.ShardingPolicy, whole) -> nn.Module:
    """Every parameter of ``lm``, in ``named_parameters`` order, replaced by
    a DTensor parameter placed by its spec from ``whole(name, parameter)``
    (the leaf whole, on any device; dropped once the rank's slice is
    kept); returns ``lm`` with ``placement_record`` (the parameter count,
    how many are sharded on some axis, the degradations) and
    ``sharding_policy``."""
    specs = POL.param_specs(policy, lm)
    degraded = _degraded(policy, lm)
    n_sharded = 0
    with torch.no_grad():
        for name, old in list(lm.named_parameters()):
            mod_name, _, leaf = name.rpartition(".")
            mod = lm.get_submodule(mod_name) if mod_name else lm
            new = place_spec(whole(name, old), policy, specs[name])
            n_sharded += any(ax is not None for ax in specs[name])
            mod.register_parameter(leaf, nn.Parameter(new, requires_grad=old.requires_grad))
    lm.placement_record = {"n_params": len(specs), "n_sharded": n_sharded,
                           "degraded": degraded}
    lm.sharding_policy = policy
    return lm


def shard_module(lm: nn.Module, policy: POL.ShardingPolicy) -> nn.Module:
    """Every parameter of ``lm`` (the same values on every rank) replaced
    in place by a DTensor parameter placed by its spec; returns ``lm``,
    with ``placement_record``."""
    return _replace_leaves(lm, policy, lambda name, p: p.data)


def build_sharded(cfg, policy: POL.ShardingPolicy, whole) -> nn.Module:
    """An ``LM`` of ``cfg`` built shard by shard: the module on the meta
    device, each parameter made whole by ``whole(name, meta parameter)``
    one at a time, in ``named_parameters`` order, and only the rank's
    slice kept; buffers made on the rank's device."""
    from repro_torch.models import transformer as T

    dev = mesh_device(policy.mesh)
    lm = T.LM(cfg, torch.device("meta"))
    for mod in lm.modules():
        for name, buf in list(mod._buffers.items()):
            if buf is not None:
                mod._buffers[name] = torch.zeros(buf.shape, dtype=buf.dtype, device=dev)
    return _replace_leaves(lm, policy, whole)


def init_sharded(cfg, policy: POL.ShardingPolicy, generator=None) -> nn.Module:
    """``init_params`` shard by shard: the same leaves drawn from the same
    generator in the same order (so the gathered module equals
    ``init_params``'s bit for bit), each whole on the rank's device only
    while its slice is taken.  ``generator``: default one seeded with 0."""
    from repro_torch.models import transformer as T

    dev = mesh_device(policy.mesh)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    return build_sharded(cfg, policy, lambda name, p: T.init_leaf(
        name, p.shape, p.dtype, generator, dev))


def zero_opt(model: nn.Module, tc, policy: POL.ShardingPolicy) -> dict:
    """The optimizer's zero state of ``model`` (``steps.init_opt``'s tree)
    placed by ``policy.opt_specs``, each rank allocating only its shards;
    0-d tensors (the count) plain on the mesh's device."""
    from repro_torch.launch.steps import init_opt
    from repro_torch.models import transformer as T

    meta = T.LM(model.cfg, torch.device("meta"))
    specs = POL.opt_specs(policy, POL.param_specs(policy, meta), meta, tc)
    dev = mesh_device(policy.mesh)

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        if tree.ndim == 0:
            return torch.zeros((), dtype=tree.dtype, device=dev)
        return zeros(tuple(tree.shape), tree.dtype, policy, spec)

    return walk(init_opt(meta, tc), specs)


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
    """``init_cache``'s zero cache, nested as it is (the hybrid's ``ssm``
    and ``attn`` dicts), as DTensors placed by ``policy.cache_specs_tree``
    (self-attention KV along the sequence on "model"; cross keys and
    values along the source sequence where "model" divides it, else on kv
    heads; Mamba2 ``ssm`` states on heads, ``conv`` windows on channels;
    batch, ``x0`` included, on the data axes), each rank allocating only
    its shards."""
    from repro_torch.models import transformer as T

    meta = T.init_cache(cfg, B, cache_len, dtype=dtype, device="meta")
    specs = POL.cache_specs_tree(policy, meta, cfg)

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        return zeros(tuple(tree.shape), tree.dtype, policy, spec)

    return walk(meta, specs)


def grow_cache(cache: dict, cfg, S_new: int, policy: POL.ShardingPolicy) -> dict:
    """A sharded cache made room for decode steps: its self-attention KV
    (``k`` / ``v``, under ``attn`` in the hybrid's cache; (layers..., B, S,
    K, dh), the vlm's two stacked axes included) grown to S_new positions
    placed by the cache specs, ``cache``'s positions first (a gather of
    the old KV, then each rank's slice); every other entry (cross keys
    and values, Mamba2 states, ``x0``) as it is.  An ssm cache comes back
    as it is."""
    from repro_torch.models import transformer as T

    kv = cache.get("attn", cache)
    if "k" not in kv:
        return cache
    k = kv["k"]
    lead = k.ndim - 4  # stacked layer / unit dims before (B, S, K, dh)
    meta = T.init_cache(cfg, k.shape[lead], S_new, dtype=k.dtype, device="meta")
    specs = POL.cache_specs_tree(policy, meta, cfg)
    if "attn" in meta:
        meta, specs = meta["attn"], specs["attn"]
    grown = {}
    for name in ("k", "v"):
        whole = torch.zeros(tuple(meta[name].shape), dtype=k.dtype, device=local(k).device)
        whole.narrow(lead + 1, 0, k.shape[lead + 1]).copy_(full(kv[name]))
        grown[name] = place_spec(whole, policy, specs[name])
        del whole
    if "attn" in cache:
        return {**cache, "attn": grown}
    return {**cache, **grown}


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
