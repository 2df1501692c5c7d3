"""LM dry run of the port: one step of an arch x shape cell x mesh, traced on
fake tensors over a fake world of ranks, and what one card of it would
hold, compute, move and exchange.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b --cell train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch minicpm-2b \\
      --cell prefill_32k --optimized            # attn_seq_shard on (12 % 16 != 0)
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--optimized]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --edm subject11   # on the card

The counterpart of the JAX package's ``launch/dryrun.py``, which lowers
and compiles each cell over 512 fake XLA devices and reads XLA's memory
and cost analyses.  PyTorch compiles nothing ahead of time, so here the
port's own step (``launch/steps.py``: the train step, the prefill, one
decode step) runs eagerly on fake tensors (``FakeTensorMode``: shapes and
dtypes, nothing allocated, nothing computed) over a fake process group of
256 ranks (16 x 16, ("data", "model")) or 512 (2 x 16 x 16, ("pod",
"data", "model")), the production mesh of ``launch/mesh.py``.  The state
is created shard by shard (``TrainState.create(policy=)``,
``place.init_sharded``), the batch from ``configs.input_specs`` and the
decode cache from ``place.sharded_cache``, as rank 0 would hold them.
The fake tensors lie on the CPU device (the CPU build of PyTorch cannot
index a fake CUDA tensor) and stand for the card's: the flash kernel's
custom operator takes its fake form on any fake tensor, so the traced
path is the card's.  The fake group comes from
``torch.testing._internal.distributed.fake_pg`` (PyTorch's testing
package).

:class:`DeviceCounter` reads what rank 0 runs: the local operators that
DTensor desugars into (not the global ones its sharding propagation
traces: those are skipped), with ``torch.utils.flop_counter``'s formulas
(the flash operator's counts its causal pairs from the positions), the
operands and results of those operators (the products and the attention)
as the bytes the step must move, each read or written once: the traffic
if every elementwise operator were fused into a product, so the memory
term stays below what the card takes (a count of every eager operator's
operands is no bound: for minicpm-2b's training step it is more than HBM
could move in the time the card takes), every collective by
kind and mesh axis (count, and bytes as the larger of operand and
result, the JAX package's rule), and the live bytes of the storages the
step makes, rounded up to the card's 512-byte allocation granule.  The
arguments (the state's, batch's and cache's local shards), the output
(what the step returns that it made), the peak (arguments + the largest
live total) and temp = peak - argument are the counterparts of XLA's
``memory_analysis``; the roofline (``launch/roofline.py::LMRoofline``)
takes the H100's peaks and, by mesh axis, NVLink inside an eight-card
node or InfiniBand across nodes.  Eager mode counts every layer, so a
cell runs at its full depth (``"depth": "full"``) by default, where JAX
extrapolates from depth-1 and depth-2 programs; ``extrapolate=True``
(``--extrapolate``) runs one and two repeating units and extrapolates
every count and byte, the memory's too, to the full depth, as JAX does
its costs (``"depth": "extrapolated"``): exact where every unit is alike
(a dense step's operations and peak: the same to 0.01% at minicpm-2b's
40 layers).

The JSON has the JAX dry run's keys (``memory``, ``roofline``,
``model_flops_*``, ``useful_flops_ratio``, ``n_params``, ...) plus the
collectives by axis and count, the links, and ``trace_s``; it goes to
``build/dryrun/<arch>__<cell>__<mesh>[__opt].json`` (or ``--out``).  A
skipped cell carries ``cell_applicable``'s reason.  ``--edm`` hands over
to ``launch/edm_dryrun.py``, which runs one chunk on the card.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import pathlib
import time
import traceback
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import (ARCHS, cell_applicable, get_config, input_specs,
                                 shape_cell)
from repro_torch.configs.base import SHAPE_CELLS, ModelConfig, TrainConfig
from repro_torch.launch import roofline as RL

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
RESULTS_DIR = REPO_ROOT / "build" / "dryrun"
#: the card's allocation granule (PyTorch's caching allocator rounds every
#: block up to it)
GRANULE = 512

# Giant MoE archs train with Adafactor (factored moments).
_ADAFACTOR_ARCHS = {"dbrx-132b", "grok-1-314b"}


# --------------------------------------------------------------------------
# the JAX dry run's configurations, field for field
# --------------------------------------------------------------------------
def optimized_cfg(cfg: ModelConfig, cell) -> ModelConfig:
    """The optimized configuration of a cell: chunked attention (the flash
    kernel, chunks of 1,024), sequence-parallel attention for the prefill
    of archs whose heads 16 does not divide, the last position's logits
    only in a serving prefill, SSD chunks of 64 in training."""
    kw = {}
    if cfg.n_heads > 0:
        kw["attn_impl"] = "chunked"
        kw["attn_chunk"] = 1024
        if cfg.n_heads % 16 != 0 and cell.kind == "prefill":
            kw["attn_seq_shard"] = True
    if cfg.ssm_state > 0 and cell.kind == "train":
        kw["ssm_chunk"] = 64
    if cell.kind == "prefill":
        kw["prefill_last_only"] = True
    return dataclasses.replace(cfg, **kw)


def optimized_policy_kw(cfg: ModelConfig, cell) -> dict:
    """Sub-1B archs at a train cell whose batch 256 divides: weights
    replicated, the model axis as more batch parallelism."""
    from repro_torch.sharding.policy import estimate_params

    if (cell.kind == "train" and cell.global_batch % 256 == 0
            and estimate_params(cfg) < 1_000_000_000):
        return {"dp_only": True, "fsdp": False}
    return {}


def train_config_for(arch: str) -> TrainConfig:
    return TrainConfig(
        optimizer="adafactor" if arch in _ADAFACTOR_ARCHS else "adamw",
        schedule="wsd" if arch == "minicpm-2b" else "cosine",
        remat=True,
    )


def optimized_train_config_for(arch: str) -> TrainConfig:
    return dataclasses.replace(train_config_for(arch), moment_dtype="bfloat16")


# --------------------------------------------------------------------------
# per-device counting
# --------------------------------------------------------------------------
#: collective operators -> JAX's kind names
_COLL_KINDS = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all", "broadcast": "broadcast", "broadcast_": "broadcast",
}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _fake(t: torch.Tensor) -> bool:
    from torch._subclasses.fake_tensor import is_fake

    return is_fake(t)


def moe_select_fraction(cfg: ModelConfig, policy=None) -> float:
    """The share of a MoE layer's (token, slot) assignments one rank
    dispatches, with the router balanced over the experts and nothing
    dropped: 1 / (model axis) where the experts are spread over it
    (expert-parallel), else 1."""
    if not cfg.n_experts or policy is None or policy.dp_only:
        return 1.0
    n = policy.axis_size("model")
    return 1.0 / n if cfg.n_experts % n == 0 else 1.0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_name(x) -> str | None:
    """The group name of a collective's group argument: a name (functional
    collectives) or a boxed ``ProcessGroup`` (the c10d operators)."""
    if isinstance(x, str):
        return x
    if isinstance(x, torch.ScriptObject):
        from torch.distributed import ProcessGroup

        try:
            return ProcessGroup.unbox(x).group_name
        except (RuntimeError, TypeError, AttributeError):
            return None
    return None


def _leaves(tree):
    """The tensors of a tree of tensors, dicts, lists, tuples, dataclasses
    (a ``TrainState``) and modules (their parameters and buffers)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def local_tensors(tree):
    """Every tensor of a tree (:func:`_leaves`), a DTensor as its local
    shard."""
    from torch.distributed.tensor import DTensor

    for t in _leaves(tree):
        yield t.to_local() if isinstance(t, DTensor) else t


def storage_bytes(tree, granule: int = GRANULE) -> int:
    """The bytes of the distinct storages under ``tree`` (local shards),
    each rounded up to ``granule``."""
    seen, total = set(), 0
    for t in local_tensors(tree):
        st = t.untyped_storage()
        key = st._cdata
        if key in seen:
            continue
        seen.add(key)
        total += -(-st.nbytes() // granule) * granule
    return total


class DeviceCounter(TorchDispatchMode):
    """Counts one rank's work while it is on (module docstring): ``flops``,
    ``bytes``, ``coll`` {(kind, axis): [count, bytes]}, ``live`` / ``peak``
    (bytes of the storages made while on), ``made`` (their keys).

    An operator on DTensors is left to DTensor (``NotImplemented``), which
    runs it as local operators that come back here; the operators of
    DTensor's sharding propagation (global shapes) are skipped.  ``mesh``
    names the axis of each collective's group.  On fake tensors a
    data-dependent selection (``nonzero``: the MoE layer's dispatch of its
    kept assignments to this rank's experts) keeps ``select_fraction`` of
    its elements (:func:`moe_select_fraction`)."""

    def __init__(self, mesh=None, granule: int = GRANULE, select_fraction: float = 1.0):
        super().__init__()
        self.granule = granule
        self.select_fraction = select_fraction
        self.flops = 0
        self.bytes = 0
        self.coll: dict = {}
        self.live = self.peak = 0
        self.made: dict = {}
        self._prop = 0
        self._axes = {}
        if mesh is not None:
            for i, name in enumerate(mesh.mesh_dim_names):
                self._axes[mesh.get_group(i).group_name] = name
        from torch.utils.flop_counter import flop_registry

        self._flops = flop_registry

    # DTensor's sharding propagation runs the global operator on fake
    # tensors to learn the output's shape (and decompositions on meta
    # tensors, which _track and the counts skip): not this rank's work
    def __enter__(self):
        self._depth = getattr(self, "_depth", 0) + 1
        if self._depth == 1:
            from torch.distributed.tensor._sharding_prop import ShardingPropagator

            inner = ShardingPropagator._propagate_tensor_meta_non_cached
            counter = self

            def propagate(prop, op_schema):
                counter._prop += 1
                try:
                    return inner(prop, op_schema)
                finally:
                    counter._prop -= 1

            self._restore = (ShardingPropagator, inner)
            ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if self._depth == 0:
            cls, inner = self._restore
            cls._propagate_tensor_meta_non_cached = inner
        return super().__exit__(*exc)

    def _free(self, key, size):
        if self.made.pop(key, None) is not None:
            self.live -= size

    def _track(self, t: torch.Tensor) -> None:
        if t.device.type == "meta":  # a shape (DTensor's strides): no memory
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self.made:
            return
        size = -(-st.nbytes() // self.granule) * self.granule
        self.made[key] = weakref.ref(st, lambda _r, k=key, n=size: self._free(k, n))
        self.live += size
        self.peak = max(self.peak, self.live)

    def _selection(self, func, args):
        """A fake data-dependent selection's result, ``select_fraction`` of
        its elements kept: ``nonzero(mask)``, or ``x[mask]`` (an index by
        one boolean mask); None for any other call."""
        if func is torch.ops.aten.nonzero.default and _fake(args[0]):
            n = math.ceil(args[0].numel() * self.select_fraction)
            return torch.empty((n, args[0].dim()), dtype=torch.long, device=args[0].device)
        if func is torch.ops.aten.index.Tensor and _fake(args[0]):
            idx = [i for i in args[1] if i is not None]
            if len(idx) == 1 and idx[0].dtype == torch.bool and args[1][0] is not None:
                m, x = idx[0], args[0]
                n = math.ceil(m.numel() * self.select_fraction)
                return torch.empty((n,) + tuple(x.shape[m.dim():]), dtype=x.dtype,
                                   device=x.device)
        return None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        sel = self._selection(func, args)
        if sel is not None:
            if not self._prop:
                self._track(sel)
            return sel
        packet = func._overloadpacket
        aliases = any(r.alias_info is not None for r in func._schema.returns)
        if (not self._prop and packet not in self._flops and not aliases
                and func is not torch.ops.prim.device.default):
            # a composite operator (inference mode lets some through whole):
            # count its parts, as FlopCounterMode does
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        if self._prop:
            return out
        name = packet.__name__
        kind = _COLL_KINDS.get(name) if func.namespace in ("_c10d_functional", "c10d") else None
        if kind is not None:
            ins = sum(_nbytes(t) for t in _tensors(args))
            outs = sum(_nbytes(t) for t in _tensors(out))
            group = next((g for g in map(_group_name, list(args) + list(kwargs.values()))
                          if g is not None and g in self._axes), None)
            key = (kind, self._axes.get(group, "world"))
            c = self.coll.setdefault(key, [0, 0])
            c[0] += 1
            c[1] += max(ins, outs)
        elif name != "wait_tensor" and not any(t.device.type == "meta"
                                               for t in _tensors(out)):
            f = self._flops.get(packet)
            if f is not None:
                self.flops += int(f(*args, **kwargs, out_val=out))
                self.bytes += sum(_nbytes(t) for t in _tensors(args))
                self.bytes += sum(_nbytes(t) for t in _tensors(out))
        # a result that aliases an input (a view, an in-place or out= op)
        # holds no new storage
        if not aliases:
            for t in _tensors(out):
                self._track(t)
        return out

    def coll_summary(self) -> dict:
        """:func:`coll_summary` of the counts."""
        return coll_summary(self.coll)


def coll_summary(coll: dict) -> dict:
    """{"by_kind": {kind: bytes}, "by_axis": {axis: bytes},
    "counts": {kind: {axis: count}}, "bytes": {kind: {axis: bytes}}} of
    {(kind, axis): [count, bytes]}."""
    by_kind, by_axis, counts, nbytes = {}, {}, {}, {}
    for (kind, axis), (n, b) in sorted(coll.items()):
        by_kind[kind] = by_kind.get(kind, 0) + b
        by_axis[axis] = by_axis.get(axis, 0) + b
        counts.setdefault(kind, {})[axis] = n
        nbytes.setdefault(kind, {})[axis] = b
    return {"by_kind": by_kind, "by_axis": by_axis, "counts": counts, "bytes": nbytes}


# --------------------------------------------------------------------------
# the fake world
# --------------------------------------------------------------------------
@contextlib.contextmanager
def fake_world(shape: tuple, names: tuple):
    """A fake process group of prod(shape) ranks (this process is rank 0)
    and its ``DeviceMesh`` over CPU fake tensors; the group is destroyed
    on exit.  Refused inside a joined group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run's fake world needs a process without a "
                           "process group")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(math.prod(shape)))
    try:
        yield init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(names))
    finally:
        dist.destroy_process_group()


def mesh_of(multi_pod: bool) -> tuple[str, tuple, tuple]:
    """(name, shape, axis names) of the production mesh."""
    if multi_pod:
        return "2x16x16", (2, 16, 16), ("pod", "data", "model")
    return "16x16", (16, 16), ("data", "model")


def _fake_batch(cfg: ModelConfig, cell) -> dict:
    return {k: torch.zeros(tuple(v.shape), dtype=v.dtype)
            for k, v in input_specs(cfg, cell).items()}


def batch_bytes(cfg: ModelConfig, cell, policy=None, granule: int = GRANULE) -> int:
    """A device's bytes of the cell's batch: each input's local shard by the
    batch specs (the whole input on one card), rounded up to ``granule``;
    a decode's ``pos`` is a host int."""
    from repro_torch.sharding import policy as POL

    specs = input_specs(cfg, cell)
    specs.pop("pos", None)
    plc = POL.batch_specs(policy, specs, cell.kind) if policy is not None else {}
    total = 0
    for k, v in specs.items():
        shape = list(v.shape)
        for d, ax in enumerate(plc.get(k, ())):
            if ax is not None:
                shape[d] //= policy.axis_size(ax)
        n = int(np.prod(shape)) * v.element_size()
        total += -(-n // granule) * granule
    return total


def param_shapes(cfg: ModelConfig) -> dict:
    """{parameter name: global shape} of the model on the meta device."""
    from repro_torch.models import transformer as T

    return {k: tuple(p.shape) for k, p in T.LM(cfg, torch.device("meta")).named_parameters()}


def build_step(cfg: ModelConfig, cell, tc: TrainConfig, policy=None):
    """Inside a ``FakeTensorMode`` (and a fake world for a ``policy``):
    (the step's device arguments -- the state, or the parameters and a
    decode's cache --, the host batch, the call that runs the step)."""
    from repro_torch.launch import steps as S
    from repro_torch.models import transformer as T
    from repro_torch.sharding import place as PL

    gen = torch.Generator("cpu").manual_seed(tc.seed)
    batch = _fake_batch(cfg, cell)
    if cell.kind == "train":
        state = S.TrainState.create(cfg, tc, gen, device="cpu", policy=policy)
        step = S.make_train_step(cfg, tc, device="cpu")
        return state, batch, lambda: step(state, batch)
    params = (PL.init_sharded(cfg, policy, gen) if policy is not None
              else T.init_params(cfg, gen, "cpu"))
    if cell.kind == "prefill":
        step = S.make_prefill_step(cfg, policy, device="cpu")
        return params, batch, lambda: step(params, batch)
    cache = (PL.sharded_cache(cfg, cell.global_batch, cell.seq_len, policy)
             if policy is not None
             else T.init_cache(cfg, cell.global_batch, cell.seq_len, device="cpu"))
    step = S.make_decode_step(cfg, device="cpu")
    return ((params, cache), batch,
            lambda: step(params, {"token": batch["token"], "pos": cell.seq_len - 1}, cache))


def run_step(cfg: ModelConfig, cell, tc: TrainConfig, policy=None, mesh=None) -> dict:
    """One step of ``cell`` on fake tensors (inside a fake world for a
    ``policy``; plain tensors without one: one card), counted with
    :class:`DeviceCounter`: the counter, the argument and output bytes
    (the batch as the batch specs place it: the step itself takes the host
    batch and places each micro-batch), the trace seconds."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        args, batch, call = build_step(cfg, cell, tc, policy)
        arg_bytes = storage_bytes(args) + batch_bytes(cfg, cell, policy)
        counter = DeviceCounter(mesh, select_fraction=moe_select_fraction(cfg, policy))
        t0 = time.perf_counter()
        with counter:
            out = call()
        trace_s = time.perf_counter() - t0
        out_bytes, seen = 0, set()
        for t in local_tensors(out):
            key = t.untyped_storage()._cdata
            if key in counter.made and key not in seen:
                seen.add(key)
                out_bytes += -(-t.untyped_storage().nbytes() // GRANULE) * GRANULE
        del out
    return {"counter": counter, "argument_bytes": arg_bytes, "output_bytes": out_bytes,
            "trace_s": trace_s}


def unit_layers(cfg: ModelConfig) -> int:
    """Layers a repeating unit (the JAX dry run's ``_unit_layers``)."""
    if cfg.family == "hybrid":
        return len(cfg.hybrid_pattern)
    if cfg.family == "vlm":
        return cfg.cross_attn_period
    return 1


def n_units(cfg: ModelConfig) -> int:
    """Repeating units of ``cfg`` (audio: encoder and decoder together)."""
    if cfg.family == "audio":
        return cfg.n_layers
    return cfg.n_layers // unit_layers(cfg)


def depth_cfg(cfg: ModelConfig, units: int) -> ModelConfig:
    """``cfg`` at ``units`` repeating units."""
    if cfg.family == "audio":
        return dataclasses.replace(cfg, n_layers=units, n_enc_layers=units)
    return dataclasses.replace(cfg, n_layers=units * unit_layers(cfg))


def _counts(cfg, cell, tc, shape, names, policy_kw, n_params) -> dict:
    """One step's counts on rank 0 (:func:`run_step` inside the fake
    world of ``shape``; one card without): operations, bytes, collectives
    {(kind, axis): [count, bytes]}, argument, output and peak bytes, trace
    seconds; and the policy (``auto_policy`` at the whole model's
    ``n_params``, at any depth)."""
    from repro_torch.sharding import policy as POL

    policy = None
    if shape:
        with fake_world(shape, names) as dmesh:
            policy = POL.auto_policy(cfg, dmesh, n_params=n_params)
            if policy_kw:
                policy = dataclasses.replace(policy, **policy_kw)
            run = run_step(cfg, cell, tc, policy, dmesh)
    else:
        run = run_step(cfg, cell, tc)
    c = run["counter"]
    return {"flops": c.flops, "bytes": c.bytes, "coll": dict(c.coll),
            "argument": run["argument_bytes"], "output": run["output_bytes"],
            "peak": run["argument_bytes"] + c.peak, "trace_s": run["trace_s"],
            "policy": policy}


def _extrapolated(m1: dict, m2: dict, units: int) -> dict:
    """The counts of ``units`` repeating units from those of one and two:
    m1 + (units - 1) (m2 - m1), each count and byte; the traces' seconds
    summed."""
    def ext(a, b):
        return a + (units - 1) * (b - a)

    coll = {k: [ext(m1["coll"].get(k, [0, 0])[i], m2["coll"].get(k, [0, 0])[i])
                for i in (0, 1)] for k in set(m1["coll"]) | set(m2["coll"])}
    out = {k: ext(m1[k], m2[k]) for k in ("flops", "bytes", "argument", "output", "peak")}
    return {**out, "coll": coll, "trace_s": m1["trace_s"] + m2["trace_s"],
            "policy": m2["policy"]}


def dry_cell(arch: str, cell_name, multi_pod: bool = False, cfg=None,
             policy_kw: dict | None = None, variant: str = "", tc=None,
             mesh: tuple | None = None, extrapolate: bool = False) -> dict:
    """One arch x cell x mesh: JAX's ``lower_cell`` keys from one step on
    fake tensors (module docstring).  ``cell_name``: a shape cell's name,
    or a ``ShapeCell`` of another batch; ``mesh``: (shape, names) of
    another fake world than the production mesh (a world of one: ``((),
    ())``, no policy, plain tensors); ``tc``: the train config (default
    :func:`train_config_for`); ``extrapolate``: from one and two repeating
    units (module docstring)."""
    from repro_torch.configs.base import ShapeCell

    cfg = cfg or get_config(arch)
    cell = cell_name if isinstance(cell_name, ShapeCell) else shape_cell(cell_name)
    cell_name = cell.name
    if mesh is None:
        mesh_name, shape, names = mesh_of(multi_pod)
    else:
        shape, names = tuple(mesh[0]), tuple(mesh[1])
        mesh_name = "x".join(map(str, shape)) or "1"
    ok, why = cell_applicable(cfg, cell)
    if not ok:
        return {"arch": arch, "cell": cell_name, "skipped": why, "mesh": mesh_name}
    tc = tc or train_config_for(arch)
    n_chips = int(math.prod(shape)) if shape else 1
    shapes = param_shapes(cfg)
    n_params = sum(int(np.prod(s)) for s in shapes.values())
    if extrapolate:
        m = _extrapolated(*(_counts(depth_cfg(cfg, u), cell, tc, shape, names, policy_kw,
                                    n_params) for u in (1, 2)), n_units(cfg))
    else:
        m = _counts(cfg, cell, tc, shape, names, policy_kw, n_params)
    policy = m["policy"]
    coll = coll_summary(m["coll"])
    links = RL.axis_links(shape, names) if shape else {}
    if "world" in coll["by_axis"]:  # a collective over the whole world
        links["world"] = RL.axis_links((n_chips,), ("world",))["world"]
    rl = RL.LMRoofline(flops_per_chip=float(m["flops"]), bytes_per_chip=float(m["bytes"]),
                       coll_by_kind=coll["by_kind"], coll_by_axis=coll["by_axis"],
                       links=links, peak_flops=RL.lm_peak_flops(cfg.dtype))
    n_active = RL.active_params(cfg, shapes)
    n_tokens = cell.global_batch * (cell.seq_len if cell.kind in ("train", "prefill") else 1)
    mf = RL.model_flops(cfg, n_tokens, n_params, n_active)
    if cell.kind != "train":
        mf /= 3.0  # forward only: 2 N D
    arg, peak = m["argument"], m["peak"]
    return {
        "arch": arch,
        "cell": cell_name,
        "mesh": mesh_name,
        "n_chips": n_chips,
        "n_params": int(n_params),
        "n_active_params": int(n_active),
        "fsdp": None if policy is None else policy.fsdp,
        "dp_only": None if policy is None else policy.dp_only,
        "variant": variant,
        "attn_impl": cfg.attn_impl,
        "attn_seq_shard": cfg.attn_seq_shard,
        "optimizer": tc.optimizer if cell.kind == "train" else None,
        "microbatch": tc.microbatch if cell.kind == "train" else None,
        "device": "NVIDIA H100 SXM 80GB (modelled: fake tensors, no card)",
        "depth": "extrapolated" if extrapolate else "full",
        "trace_s": m["trace_s"],
        "lower_s": m["trace_s"],
        "compile_s": 0.0,
        "memory": {
            "argument_bytes": int(arg),
            "output_bytes": int(m["output"]),
            "temp_bytes": int(peak - arg),
            "peak_bytes_per_device": int(peak),
            "granule_bytes": GRANULE,
        },
        "roofline": rl.to_dict(),
        "collectives": {"counts": coll["counts"], "bytes": coll["bytes"]},
        "model_flops_global": mf,
        "model_flops_per_chip": mf / n_chips,
        "useful_flops_ratio": (mf / n_chips) / max(rl.flops_per_chip, 1.0),
    }


def optimized_cell(arch: str, cell: str, multi_pod: bool = False, smoke: bool = False,
                   extrapolate: bool = False) -> dict:
    """:func:`dry_cell` with :func:`optimized_cfg` and
    :func:`optimized_policy_kw` (variant "optimized")."""
    base = get_config(arch, smoke=smoke)
    sc = shape_cell(cell)
    return dry_cell(arch, cell, multi_pod=multi_pod, cfg=optimized_cfg(base, sc),
                    policy_kw=optimized_policy_kw(base, sc), variant="optimized",
                    extrapolate=extrapolate)


def save_result(res: dict, tag: str = "", out: str | None = None) -> pathlib.Path:
    path = (pathlib.Path(out) if out else
            RESULTS_DIR / f"{res['arch']}__{res['cell']}__{res.get('mesh', 'na')}{tag}.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(res, indent=2))
    return path


def summary_line(res: dict) -> str:
    if "skipped" in res:
        return f"SKIP {res['arch']} x {res['cell']}: {res['skipped']}"
    rl = res["roofline"]
    return (f"OK {res['arch']} x {res['cell']} [{res['mesh']}] trace={res['trace_s']:.1f}s "
            f"peak_mem={res['memory']['peak_bytes_per_device'] / 2**30:.2f}GiB "
            f"t_comp={rl['t_compute_s']:.4f}s t_mem={rl['t_memory_s']:.4f}s "
            f"t_coll={rl['t_collective_s']:.4f}s bottleneck={rl['bottleneck']}")


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--cell", choices=[c.name for c in SHAPE_CELLS])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--edm", choices=["fish1_normo", "subject6", "subject11"],
                    help="the EDM dry run on the card (launch/edm_dryrun.py)")
    ap.add_argument("--optimized", action="store_true",
                    help="the optimized configs (optimized_cfg, optimized_policy_kw)")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config at the cell's shapes (a quick check)")
    ap.add_argument("--out", default=None,
                    help="JSON path of a single cell, or a directory for --all "
                         "(default build/dryrun/)")
    ap.add_argument("--extrapolate", action="store_true",
                    help="trace one and two repeating units and extrapolate to the "
                         "full depth (as the JAX dry run does its costs)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="--all: cells traced at once, each in a process of its own")
    args = ap.parse_args(argv)
    if args.edm:
        from repro_torch.launch import edm_dryrun

        edm_argv = ["--dataset", args.edm] + (["--out", args.out] if args.out else [])
        return [edm_dryrun.main(edm_argv)]
    if not args.all and not (args.arch and args.cell):
        ap.error("give --arch and --cell, or --all, or --edm")
    cells = ([(a, c.name) for a in ARCHS for c in SHAPE_CELLS] if args.all
             else [(args.arch, args.cell)])
    if args.all and args.jobs > 1:
        return _run_jobs(cells, args)
    results = []
    for arch, cell in cells:
        t0 = time.perf_counter()
        try:
            if args.optimized:
                res, tag = optimized_cell(arch, cell, args.multi_pod, args.smoke,
                                          args.extrapolate), "__opt"
            else:
                res = dry_cell(arch, cell, multi_pod=args.multi_pod,
                               cfg=get_config(arch, smoke=args.smoke),
                               extrapolate=args.extrapolate)
                tag = ""
        except Exception as e:  # the cell's JSON says what failed; --all goes on
            traceback.print_exc()
            res = {"arch": arch, "cell": cell, "mesh": mesh_of(args.multi_pod)[0],
                   "failed": f"{type(e).__name__}: {e}"}
            tag = "__opt" if args.optimized else ""
        res["wall_s"] = time.perf_counter() - t0
        if args.smoke:
            res["smoke"] = True
        out = (str(pathlib.Path(args.out) / f"{arch}__{cell}__{res['mesh']}{tag}.json")
               if args.all and args.out else None if args.all else args.out)
        path = save_result(res, tag, out)
        print(summary_line(res) if "failed" not in res else
              f"FAIL {arch} x {cell}: {res['failed']}", f"-> {path}", flush=True)
        results.append(res)
    if any("failed" in r for r in results):
        raise SystemExit(1)
    return results


def _run_jobs(cells, args) -> list[dict]:
    """--all over ``args.jobs`` processes, one cell each (the fake world is
    one a process); the results as each wrote them."""
    import subprocess
    import sys

    mesh = mesh_of(args.multi_pod)[0]
    tag = "__opt" if args.optimized else ""
    outdir = pathlib.Path(args.out) if args.out else RESULTS_DIR
    flags = ((["--multi-pod"] if args.multi_pod else []) + (["--optimized"] if args.optimized else [])
             + (["--smoke"] if args.smoke else [])
             + (["--extrapolate"] if args.extrapolate else []))
    todo, running, paths = list(cells), [], []
    while todo or running:
        while todo and len(running) < args.jobs:
            arch, cell = todo.pop(0)
            path = outdir / f"{arch}__{cell}__{mesh}{tag}.json"
            paths.append((arch, cell, path))
            running.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                 "--cell", cell, "--out", str(path)] + flags))
        running[0].wait()
        running = [p for p in running if p.poll() is None]
    results = []
    for arch, cell, path in paths:
        if path.exists():
            results.append(json.loads(path.read_text()))
        else:
            res = {"arch": arch, "cell": cell, "mesh": mesh, "failed": "the process wrote no JSON"}
            save_result(res, tag, str(path))
            results.append(res)
    if any("failed" in r for r in results):
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
