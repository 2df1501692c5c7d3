"""Serving steps of the port's LM: prefill and decode.

The counterparts of ``make_prefill_step`` / ``make_decode_step`` of the
JAX package's ``launch/steps.py``: one function per step kind, closed
over the ModelConfig.  The steps run under ``torch.inference_mode()``
on the device given to ``make_*`` (default the card; ``make_*`` raises
without one).  Sharding policies and the training step are not ported
yet.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.runtime.device import resolve_device


def make_prefill_step(cfg: ModelConfig, policy=None, device=None):
    """prefill_step(params, batch) -> (logits, cache): the cache is sized
    to the prompt, as in JAX (the full-cache branch of attention).  The
    batch's audio frames or image patches go to the device in the
    config's dtype."""
    if policy is not None:
        raise NotImplementedError(
            "a sharding policy for the prefill cache needs sharding, which the "
            "port does not have yet"
        )
    dev = resolve_device(device)

    def prefill_step(params, batch):
        with torch.inference_mode():
            B, S = batch["tokens"].shape
            cache = T.init_cache(cfg, B, S, device=dev)
            return T.prefill(params, T.frontend_batch(batch, cfg, dev), cache, cfg)

    return prefill_step


def make_decode_step(cfg: ModelConfig, device=None):
    """decode_step(params, batch, cache) -> (logits (B, 1, V_pad), cache)."""
    resolve_device(device)

    def decode_step(params, batch, cache):
        with torch.inference_mode():
            return T.decode_step(params, batch, cache, cfg)

    return decode_step
