"""Step functions of the port's LM: train step, prefill and decode.

The counterparts of ``TrainState``, ``make_train_step``,
``_accumulated_grads``, ``make_prefill_step`` and ``make_decode_step``
of the JAX package's ``launch/steps.py``: one function per step kind,
closed over the ModelConfig (and TrainConfig), on the device given to
``make_*`` (default the card; ``make_*`` raises without one).  Serving
steps run under ``torch.inference_mode()``; the train step takes the
gradient of ``models.transformer.loss_fn`` with autograd and updates
the state's tensors in place.  ``train_state_from_jax`` carries a JAX
TrainState across.

Sharded (every family, ``sharding/``): ``make_train_step`` takes a
state created shard by shard (``TrainState.create(policy=)``) or placed
by ``place.shard_train_state``: each micro-batch's tokens and frontend
frames or patches are placed by the batch specs, the loss's mean runs
over every rank's tokens, the gradients reduce over the data axes
inside DTensor's backward (the hybrid's shared block summed over its
units), the global-norm clip spans every shard, AdamW updates each
rank's local shards in place, and Adafactor's factored means and RMS
reduce over the mesh dims that shard them.  ``make_prefill_step(cfg,
policy)`` places its cache by ``cache_specs_tree`` (KV along the
sequence on "model", cross keys and values along the source sequence or
on kv heads, Mamba2 states on heads and conv channels, batch on the
data axes); ``make_decode_step`` attends over that cache with the
flash-decode all-reduce (``sharding/attention.py``) and takes no
frontend input.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import transformer as T
from repro_torch.optim import adafactor, adamw
from repro_torch.optim.schedule import make_schedule
from repro_torch.runtime.device import resolve_device
from repro_torch.sharding.place import full, local


@dataclasses.dataclass
class TrainState:
    """params: the ``LM`` module; opt: the optimizer's dict of tensors
    (AdamW: {"m", "v": {parameter name: moment}, "count"}; Adafactor:
    {"acc": {JAX leaf path: {"vr", "vc"} or {"v"}}, "count"}); step: the
    int32 step counter (0-d, on the params' device)."""

    params: Any
    opt: Any
    step: torch.Tensor

    @staticmethod
    def create(cfg: ModelConfig, tc: TrainConfig,
               generator: Optional[torch.Generator] = None, device=None,
               policy=None) -> "TrainState":
        """``init_params`` on ``device`` (default the card; raises without
        one), the optimizer's zero state, step 0.  ``generator``: default
        one seeded with ``tc.seed``.  ``policy`` (a ``ShardingPolicy``;
        ``device`` is then the rank's): the state created shard by shard
        (``place.init_sharded``, ``place.zero_opt``), equal to
        ``shard_train_state`` of the whole one, bit for bit, without any
        rank holding the whole model (JAX's ``jit(TrainState.create,
        out_shardings=)``)."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(dev).manual_seed(tc.seed)
        if policy is not None:
            from repro_torch.sharding import place as PL

            params = PL.init_sharded(cfg, policy, generator)
            return TrainState(params=params, opt=PL.zero_opt(params, tc, policy),
                              step=torch.zeros((), dtype=torch.int32, device=dev))
        params = T.init_params(cfg, generator, dev)
        return TrainState(params=params, opt=init_opt(params, tc),
                          step=torch.zeros((), dtype=torch.int32, device=dev))


def init_opt(params: T.LM, tc: TrainConfig) -> dict:
    named = dict(params.named_parameters())
    if tc.optimizer == "adamw":
        return adamw.init(named, moment_dtype=getattr(torch, tc.moment_dtype))
    if tc.optimizer == "adafactor":
        return adafactor.init(named, groups=T.jax_leaf_groups(params))
    raise ValueError(f"optimizer {tc.optimizer!r}: adamw or adafactor")


def make_train_step(cfg: ModelConfig, tc: TrainConfig, device=None):
    """train_step(state, batch) -> (state, metrics), JAX's step: the loss
    and its gradient (float32 accumulated over micro-batches of
    ``tc.microbatch`` rows where it is > 0), the gradient clipped to
    ``tc.grad_clip`` by its global norm, the optimizer's update at
    ``sched(state.step)``.  The state's parameters and optimizer tensors
    are updated in place; the returned state holds them and the next
    step.  metrics: {"loss", "ce", "moe_aux", "grad_norm", "lr"}, 0-d
    float32 tensors on the device (no synchronisation)."""
    resolve_device(device)
    sched = make_schedule(tc.schedule, tc.lr, tc.warmup_steps, tc.total_steps)
    if tc.optimizer not in ("adamw", "adafactor"):
        raise ValueError(f"optimizer {tc.optimizer!r}: adamw or adafactor")

    def loss_of(params, batch):
        return T.loss_fn(params, batch, cfg, tc)

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        model = state.params
        if T.is_sharded(model):
            # the whole host batch: each micro-batch is placed by the batch specs
            batch = {k: full(v) if torch.is_tensor(v) else v for k, v in batch.items()}
        if tc.microbatch > 0:
            grads, (loss, metrics) = _accumulated_grads(loss_of, model, batch,
                                                        tc.microbatch)
        else:
            loss, metrics = loss_of(model, batch)
            grads = _grads(loss, model)
            loss = loss.detach()
            metrics = {k: v.detach() for k, v in metrics.items()}
        grads, gnorm = adamw.clip_by_global_norm(grads, tc.grad_clip)
        lr = sched(state.step)
        named = dict(model.named_parameters())
        # the leaf rules read the JAX leaf each tensor is a slice of
        if tc.optimizer == "adamw":  # elementwise: on each rank's local shards
            opt = state.opt
            lopt = {"m": {k: local(t) for k, t in opt["m"].items()},
                    "v": {k: local(t) for k, t in opt["v"].items()},
                    "count": opt["count"]}
            adamw.update({k: local(g) for k, g in grads.items()}, lopt,
                         {k: local(p) for k, p in named.items()}, lr,
                         weight_decay=tc.weight_decay, leaf_ndim=T.jax_leaf_ndims(model))
            opt["count"] = lopt["count"]
        else:
            _, opt = adafactor.update(grads, state.opt, named, lr,
                                      weight_decay=tc.weight_decay,
                                      groups=T.jax_leaf_groups(model))
        del grads
        metrics = {**metrics, "loss": loss, "grad_norm": gnorm, "lr": lr}
        return TrainState(model, opt, state.step + 1), metrics

    return train_step


def _grads(loss: torch.Tensor, model: T.LM) -> dict:
    """{name: d loss / d parameter} in the parameters' dtypes (a DTensor
    parameter's gradient in the parameter's placements)."""
    named = dict(model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    if T.is_sharded(model):
        grads = {k: g if list(g.placements) == list(named[k].placements)
                 else g.redistribute(named[k].device_mesh, named[k].placements)
                 for k, g in grads.items()}
    return grads


def _accumulated_grads(loss_of, params: T.LM, batch: dict, microbatch: int):
    """Gradient accumulation over micro-batches (batch axis 0 split):
    float32 gradient sums divided by their count, the mean loss, the
    other metrics of the last micro-batch."""
    B = int(np.shape(batch["tokens"])[0])
    if B % microbatch:
        raise ValueError(f"batch {B} is not a multiple of the micro-batch {microbatch}")
    n_micro = B // microbatch
    dev = params.embed.tok.device
    g_sum = {k: torch.zeros_like(p, dtype=torch.float32)
             for k, p in params.named_parameters()}
    l_sum = torch.zeros((), dtype=torch.float32, device=dev)
    metrics = {}
    for i in range(n_micro):
        micro = {k: v[i * microbatch : (i + 1) * microbatch] for k, v in batch.items()}
        loss, metrics = loss_of(params, micro)
        for k, g in _grads(loss, params).items():
            g_sum[k] += g.float()
        l_sum = l_sum + loss.detach()
        del loss
    grads = {k: g / n_micro for k, g in g_sum.items()}
    metrics = {k: v.detach() for k, v in metrics.items()}
    return grads, (l_sum / n_micro, metrics)


def train_state_from_jax(state_tree, cfg: ModelConfig, tc: TrainConfig,
                         device=None) -> TrainState:
    """The port's TrainState from a JAX one (its ``params``, ``opt`` and
    ``step`` as numpy leaves): params through
    ``params_from_jax``; AdamW's ``m`` / ``v`` unstacked on the params'
    stacked axes, in ``tc.moment_dtype``; Adafactor's accumulators as
    they are (its groups keep JAX's stacked shapes); ``count`` and
    ``step`` as int32."""
    dev = resolve_device(device)
    params = T.params_from_jax(state_tree.params, cfg, dev)
    jopt = state_tree.opt
    opt = init_opt(params, tc)
    with torch.no_grad():
        if tc.optimizer == "adamw":
            for key in ("m", "v"):
                flat = T.unstack_jax_tree(jopt[key])
                if set(flat) != set(opt[key]):
                    raise ValueError(f"JAX AdamW {key} and the port's parameters differ")
                for name, t in opt[key].items():
                    t.copy_(torch.from_numpy(flat[name]))
        else:
            for name, acc in opt["acc"].items():
                node = jopt["acc"]
                for part in name.split("."):
                    node = node[part]
                for k, t in acc.items():
                    arr = np.asarray(node[k], dtype=np.float32)
                    if tuple(arr.shape) != tuple(t.shape):
                        raise ValueError(f"adafactor {name}.{k}: JAX shape {arr.shape}, "
                                         f"port shape {tuple(t.shape)}")
                    t.copy_(torch.tensor(arr))
        opt["count"] = torch.tensor(int(np.asarray(jopt["count"])), dtype=torch.int32,
                                    device=dev)
    step = torch.tensor(int(np.asarray(state_tree.step)),
                        dtype=torch.int32, device=dev)
    return TrainState(params=params, opt=opt, step=step)


def make_prefill_step(cfg: ModelConfig, policy=None, device=None):
    """prefill_step(params, batch) -> (logits, cache): the cache is sized
    to the prompt, as in JAX (the full-cache branch of attention).  The
    batch's audio frames or image patches go to the device in the
    config's dtype.  ``policy`` (a ``ShardingPolicy``, on params placed
    under it): the cache is placed by its ``cache_specs_tree`` (module
    docstring), the frames or patches by the batch specs, and the logits
    come back as a DTensor."""
    dev = resolve_device(device)

    def prefill_step(params, batch):
        with torch.inference_mode():
            B, S = tuple(batch["tokens"].shape)
            if policy is not None:
                from repro_torch.sharding.place import sharded_cache

                cache = sharded_cache(cfg, B, S, policy)
            else:
                cache = T.init_cache(cfg, B, S, device=dev)
            return T.prefill(params, T.frontend_batch(batch, cfg, dev), cache, cfg)

    return prefill_step


def make_decode_step(cfg: ModelConfig, device=None):
    """decode_step(params, batch, cache) -> (logits (B, 1, V_pad), cache);
    a sharded cache (``make_prefill_step(policy=)``, or
    ``place.sharded_cache``) is attended with the flash-decode all-reduce
    and written at ``pos`` on the rank that owns it."""
    resolve_device(device)

    def decode_step(params, batch, cache):
        with torch.inference_mode():
            return T.decode_step(params, batch, cache, cfg)

    return decode_step
