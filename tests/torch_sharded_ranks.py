"""Rank-side jobs of tests/test_torch_sharded_step.py: one process a rank
of a gloo world on the CPU, joined through the EDM_* contract.

    python tests/torch_sharded_ranks.py <job> <dir>

``main`` (four ranks, mesh (2, 2)): qwen2-1.5b smoke's sharded train step
from the state in ``<dir>/train_in.npz``, its sharded prefill and four
decode steps from ``<dir>/serve_in.npz``, ``compressed_psum`` of the
per-rank gradients in ``<dir>/psum_in.npz``, and the Prefetcher placing
batches by a policy.  ``tp4`` (four ranks, mesh (1, 4)): qwen2.5-3b
smoke's sharded prefill and decode, its two kv heads replicated under
four query-head shards.  ``moe_ssm`` and ``hybrid_cross`` (four ranks,
the mesh and the cases in ``<dir>/cases.json``; for
tests/test_torch_sharded_moe_ssm.py and
tests/test_torch_sharded_hybrid_cross.py): a family's sharded train
steps, prefills and decodes from the JAX states and batches (tokens,
audio frames, image patches) in ``<dir>/<case>_in.npz``, the state
created shard by shard, and a checkpoint saved at one mesh and restored
at another; a serve case with ``watch`` records the shapes of the
DTensors redistributed during its decode steps.  Each rank writes
``<dir>/<job>_rank<r>.npz``.
"""
import dataclasses
import json
import pathlib
import sys

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import Prefetcher, TokenStream
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.steps import (TrainState, make_decode_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.optim.grad_compress import compressed_psum
from repro_torch.runtime.platform import init_distributed
from repro_torch.sharding import place as PL
from repro_torch.sharding import policy as POL

#: the JAX sharded test's step (tests/test_sharding.py)
TRAIN_KW = dict(remat=False, lr=1e-3, warmup_steps=1, total_steps=5)
TRAIN_B, TRAIN_S = 4, 16
SERVE_B, SERVE_P, SERVE_DECODE = 4, 8, 4
#: a case's batch keys besides the parameters
BATCH_KEYS = ("tokens", "audio", "image_embeds")


def _load_params(model, flat: dict) -> None:
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(flat[name]))


def _serve(cfg, policy, d: pathlib.Path) -> dict:
    """Sharded prefill (the flash path: cache sized to the prompt), the
    cache grown to P + SERVE_DECODE, and the decode steps on the given
    tokens -> the whole logits of each."""
    data = np.load(d / "serve_in.npz")
    params = T.LM(cfg, torch.device("cpu"))
    _load_params(params, {k[2:]: data[k] for k in data.files if k.startswith("p.")})
    PL.shard_module(params, policy)
    logits, cache = make_prefill_step(cfg, policy=policy, device="cpu")(
        params, {"tokens": data["tokens"]})
    out = {"prefill": PL.full(logits).numpy(),
           "cache_local_k": PL.local(cache["k"]).shape}
    cache = PL.grow_cache(cache, cfg, SERVE_P + SERVE_DECODE, policy)
    decode = make_decode_step(cfg, device="cpu")
    for i in range(SERVE_DECODE):
        lg, cache = decode(params, {"token": data["dec_tokens"][i], "pos": SERVE_P + i},
                           cache)
        out[f"decode{i}"] = PL.full(lg).numpy()
    return out


def main_job(rank: int, d: pathlib.Path) -> dict:
    mesh = make_local_mesh(model=2, device="cpu")
    out = {}
    # the train step, from the JAX state's parameters (zero moments, step 0)
    cfg = get_config("qwen2-1.5b", smoke=True)
    tc = TrainConfig(**TRAIN_KW)
    pol = POL.ShardingPolicy(mesh=mesh, fsdp=True)
    data = np.load(d / "train_in.npz")
    state = TrainState.create(cfg, tc, device="cpu")
    _load_params(state.params, {k[2:]: data[k] for k in data.files if k.startswith("p.")})
    state = PL.shard_train_state(state, pol, tc)
    state, metrics = make_train_step(cfg, tc, device="cpu")(state, {"tokens": data["tokens"]})
    for name, p in state.params.named_parameters():
        out[f"p.{name}"] = PL.full(p).detach().numpy()
    out["loss"] = float(metrics["loss"])
    out["grad_norm"] = float(metrics["grad_norm"])
    out["n_degraded"] = len(state.params.placement_record["degraded"])
    out["local_tok_shape"] = tuple(PL.local(state.params.embed.tok).shape)
    # serving, the flash-decode over the sequence-sharded cache
    scfg = dataclasses.replace(cfg, attn_impl="chunked")
    out.update({f"serve.{k}": v for k, v in _serve(scfg, POL.ShardingPolicy(mesh=mesh),
                                                  d).items()})
    # compressed_psum over the data group... and over the whole world
    g = np.load(d / "psum_in.npz")
    mean, err = compressed_psum(torch.from_numpy(g["g"][rank]),
                                torch.from_numpy(g["err"][rank]))
    out["psum_mean"], out["psum_err"] = mean.numpy(), err.numpy()
    # the Prefetcher places each batch by the batch specs
    stream = TokenStream(cfg.vocab_size, 4, 8, seed=3)
    got = list(Prefetcher(stream, policy=pol, n_steps=3))
    out["prefetch_n"] = len(got)
    out["prefetch_local"] = tuple(PL.local(got[0]["tokens"]).shape)
    out["prefetch_equal"] = all(
        np.array_equal(PL.full(b["tokens"]).numpy(), stream.batch_at(i)["tokens"])
        for i, b in enumerate(got))
    return out


def tp4_job(rank: int, d: pathlib.Path) -> dict:
    mesh = make_local_mesh(model=4, device="cpu")
    cfg = dataclasses.replace(get_config("qwen2.5-3b", smoke=True), attn_impl="chunked")
    return {f"serve.{k}": v for k, v in _serve(cfg, POL.ShardingPolicy(mesh=mesh),
                                              d).items()}


def _case_cfg(case: dict):
    return dataclasses.replace(get_config(case["arch"], smoke=True), **case.get("over", {}))


def _flat(data) -> dict:
    return {k[2:]: data[k] for k in data.files if k.startswith("p.")}


def _batch(data) -> dict:
    return {k: data[k] for k in BATCH_KEYS if k in data.files}


class _Watch:
    """The global shapes of the DTensors redistributed while it is on, an
    explicit ``redistribute`` or one an operator's sharding asks for."""

    def __init__(self):
        from torch.distributed.tensor import _dispatch, _redistribute

        self.on, self.shapes = False, []
        self._mods = (_dispatch, _redistribute)
        inner = _redistribute.redistribute_local_tensor

        def recorded(local_tensor, current_spec, *a, **kw):
            if self.on:
                self.shapes.append(tuple(current_spec.shape))
            return inner(local_tensor, current_spec, *a, **kw)

        for mod in self._mods:
            mod.redistribute_local_tensor = recorded
        self._inner = inner

    def close(self):
        for mod in self._mods:
            mod.redistribute_local_tensor = self._inner


def _from_flat(cfg, pol, flat: dict):
    """The module built shard by shard from whole numpy leaves."""
    return PL.build_sharded(cfg, pol, lambda k, p: torch.from_numpy(flat[k]).to(p.dtype))


def _whole_state(state, rank: int) -> dict:
    """Every parameter and optimizer tensor gathered (a collective: every
    rank calls it); rank 0 keeps them."""
    out = {}
    for k, p in state.params.named_parameters():
        w = PL.full(p).detach().numpy()
        if rank == 0:
            out[f"p.{k}"] = w
    for k, t in sorted(_opt_leaves(state.opt).items()):
        w = PL.full(t).numpy()
        if rank == 0:
            out[f"opt.{k}"] = w
        out[f"opt_local.{k}"] = tuple(PL.local(t).shape)
    return out


def _opt_leaves(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_opt_leaves(v, f"{prefix}{k}:"))
        return out
    return {prefix[:-1]: tree}


def _counts(params) -> dict:
    routed, dropped = MOE.drop_counts(params)
    return {"routed": routed, "dropped": dropped}


def _train_case(case, mesh, rank, d) -> dict:
    cfg = _case_cfg(case)
    tc = TrainConfig(optimizer=case["opt"], **TRAIN_KW)
    pol = POL.ShardingPolicy(mesh=mesh, fsdp=True)
    data = np.load(d / f"{case['name']}_in.npz")
    params = _from_flat(cfg, pol, _flat(data))
    state = TrainState(params, PL.zero_opt(params, tc, pol), torch.zeros((), dtype=torch.int32))
    MOE.reset_drop_counts(params)
    state, metrics = make_train_step(cfg, tc, device="cpu")(state, _batch(data))
    out = {"loss": float(metrics["loss"]), **_counts(params), **_whole_state(state, rank)}
    if cfg.n_experts:
        out["local_w_up"] = tuple(PL.local(params.blocks[0].moe.w_up).shape)
    for name in case.get("local", ()):
        out[f"local.{name}"] = tuple(PL.local(params.get_parameter(name)).shape)
    if case.get("save"):
        CheckpointManager(d / "ckpt").save(1, state, blocking=True)
    return out


def _serve_case(case, mesh, rank, d) -> dict:
    cfg = dataclasses.replace(_case_cfg(case), attn_impl="chunked")
    pol = POL.ShardingPolicy(mesh=mesh)
    data = np.load(d / f"{case['name']}_in.npz")
    params = _from_flat(cfg, pol, _flat(data))
    MOE.reset_drop_counts(params)
    P = data["tokens"].shape[1]
    logits, cache = make_prefill_step(cfg, policy=pol, device="cpu")(params, _batch(data))
    out = {"prefill": PL.full(logits).numpy(),
           **{f"cache_local.{k}": tuple(PL.local(v).shape)
              for k, v in _opt_leaves(cache).items()}}
    n = len(data["dec_tokens"])
    cache = PL.grow_cache(cache, cfg, P + n, pol)
    out.update({f"grown_local.{k}": tuple(PL.local(v).shape)
                for k, v in _opt_leaves(cache).items()})
    decode = make_decode_step(cfg, device="cpu")
    watch = _Watch() if case.get("watch") else None
    try:
        for i in range(n):
            if watch:
                watch.on = True
            lg, cache = decode(params, {"token": data["dec_tokens"][i], "pos": P + i}, cache)
            if watch:
                watch.on = False
            out[f"decode{i}"] = PL.full(lg).numpy()
    finally:
        if watch:
            watch.close()
    if watch:
        out["decode_redistributed"] = json.dumps(watch.shapes)
    return {**out, **_counts(params)}


def _init_case(case, mesh, rank, d) -> dict:
    cfg = _case_cfg(case)
    tc = TrainConfig(optimizer=case["opt"], **TRAIN_KW)
    pol = POL.ShardingPolicy(mesh=mesh, fsdp=True)
    state = TrainState.create(cfg, tc, torch.Generator("cpu").manual_seed(0), device="cpu",
                              policy=pol)
    return _whole_state(state, rank)


def _restore_case(case, mesh, rank, d) -> dict:
    """The checkpoint another mesh saved, restored into this one's layout."""
    cfg = _case_cfg(case)
    tc = TrainConfig(optimizer=case["opt"], **TRAIN_KW)
    pol = POL.ShardingPolicy(mesh=mesh, fsdp=True)
    like = TrainState.create(cfg, tc, torch.Generator("cpu").manual_seed(1), device="cpu",
                             policy=pol)
    state = CheckpointManager(pathlib.Path(case["from"]) / "ckpt").restore(1, like)
    out = _whole_state(state, rank)
    if cfg.n_experts:
        out["local_w_up"] = tuple(PL.local(state.params.blocks[0].moe.w_up).shape)
    for name in case.get("local", ()):
        out[f"local.{name}"] = tuple(PL.local(state.params.get_parameter(name)).shape)
    return out


def cases_job(rank: int, d: pathlib.Path) -> dict:
    spec = json.loads((d / "cases.json").read_text())
    mesh = make_local_mesh(model=spec["model"], device="cpu")
    jobs = {"train": _train_case, "serve": _serve_case, "init": _init_case,
            "restore": _restore_case}
    out = {}
    for case in spec["cases"]:
        got = jobs[case["kind"]](case, mesh, rank, d)
        out.update({f"{case['name']}.{k}": v for k, v in got.items()})
    return out


if __name__ == "__main__":
    job, d = sys.argv[1], pathlib.Path(sys.argv[2])
    torch.set_num_threads(1)
    info = init_distributed(device="cpu")
    rank = info["process_id"]
    out = {"main": main_job, "tp4": tp4_job, "moe_ssm": cases_job,
           "hybrid_cross": cases_job}[job](rank, d)
    np.savez(d / f"{job}_rank{rank}.npz", **{k: np.asarray(v) for k, v in out.items()})
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
