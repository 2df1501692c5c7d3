"""The port's LM: the dense decoder-only family.

The counterpart of the dense family of the JAX package's
``models/transformer.py``: init, full-sequence forward, KV cache,
prefill and one-token decode, with the same public functions
(``init_params``, ``forward``, ``init_cache``, ``prefill``,
``decode_step``).  The parameters are a ``DenseLM`` module whose
state-dict keys are the JAX tree's paths with the stacked layer axis
spelled out (``blocks.3.attn.wq.w``); ``params_from_jax`` loads a JAX
tree.  Layers are an ``nn.ModuleList`` walked in a Python loop (JAX
scans).  The cache keeps JAX's stacked layout {"k", "v"} of shape
(n_layers, B, S, K, dh); prefill and decode write it in place.

The other families (moe, ssm, hybrid, audio, vlm) are not ported yet and
raise ``NotImplementedError`` naming the family.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.runtime.device import resolve_device

_INIT_STD = 0.02


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------
def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.name}) is not ported yet; the "
            "port has the dense family only"
        )
    if cfg.n_experts > 0:
        raise NotImplementedError(
            f"{cfg.name}: a dense config with n_experts = {cfg.n_experts} needs the "
            "MoE layer, which is not ported yet"
        )


def _attn_dims(cfg: ModelConfig) -> L.AttnDims:
    """Self-attention dims of a decoder block (cross-attention comes with
    the audio and vlm families)."""
    return L.AttnDims(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        d_head=cfg.head_dim,
        qkv_bias=cfg.qkv_bias,
        rope_theta=cfg.rope_theta,
        use_rope=cfg.pos == "rope",
        impl=cfg.attn_impl,
        seq_shard=cfg.attn_seq_shard,
    )


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------
class Embed(nn.Module):
    """``tok`` (V_pad, d), ``lm_head`` (d, V_pad) unless tied, ``ln_f``,
    ``pos`` (65536, d) for learned positions."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        dt = _dtype(cfg)
        self.tok = L._param((cfg.padded_vocab, cfg.d_model), dt, device)
        self.lm_head = (None if cfg.tie_embeddings
                        else L._param((cfg.d_model, cfg.padded_vocab), dt, device))
        self.ln_f = L.Norm(cfg.norm, cfg.d_model, dt, device)
        self.pos = (L._param((65536, cfg.d_model), dt, device)
                    if cfg.pos == "learned" else None)


class DenseBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        dt = _dtype(cfg)
        self.ln1 = L.Norm(cfg.norm, cfg.d_model, dt, device)
        self.attn = L.Attention(_attn_dims(cfg), dt, device)
        self.ln2 = L.Norm(cfg.norm, cfg.d_model, dt, device)
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, cfg.mlp_act, dt, device)


class DenseLM(nn.Module):
    """Parameters of a dense-family model (uninitialised; see
    ``init_params`` and ``params_from_jax``)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        self.embed = Embed(cfg, device)
        self.blocks = nn.ModuleList(DenseBlock(cfg, device) for _ in range(cfg.n_layers))


def _dense_block_fwd(p: DenseBlock, cfg: ModelConfig, x, positions=None,
                     cache=None, cache_pos=None):
    """One decoder block; a given cache is written in place."""
    h, _ = L.attention_fwd(
        p.attn, _attn_dims(cfg), L.apply_norm(cfg.norm, p.ln1, x),
        positions=positions, cache=cache, cache_pos=cache_pos,
    )
    x = x + h
    h = L.mlp_fwd(p.mlp, L.apply_norm(cfg.norm, p.ln2, x), cfg.mlp_act)
    return x + h


def _embed(p: Embed, cfg: ModelConfig, tokens: torch.Tensor, pos_offset: int = 0):
    x = p.tok[tokens]
    if cfg.pos == "learned":
        x = x + p.pos[pos_offset : pos_offset + tokens.shape[1]]
    return x


def _head(p: Embed, cfg: ModelConfig, x):
    x = L.apply_norm(cfg.norm, p.ln_f, x)
    w = p.tok.t() if cfg.tie_embeddings else p.lm_head
    return (x @ w).float()


def _prefill_head(params: DenseLM, cfg: ModelConfig, x):
    """Serving prefill: optionally emit only the final position's logits."""
    if cfg.prefill_last_only:
        x = x[:, -1:]
    return _head(params.embed, cfg, x)


def _tokens(params: DenseLM, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=params.embed.tok.device).long()


def _layer_cache(cache: dict, i: int) -> dict:
    return {"k": cache["k"][i], "v": cache["v"][i]}


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------
def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None) -> DenseLM:
    """Random init on ``device`` (default the card; raises without one):
    N(0, 0.02) drawn in f32 and cast to ``cfg.dtype``, norm scales at
    one, biases at zero (the JAX ``_normal`` scheme; the draws differ).
    ``generator``: a ``torch.Generator`` on that device (default: one
    seeded with 0)."""
    dev = resolve_device(device)
    model = DenseLM(cfg, dev)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "scale":
                prm.fill_(1.0)
            elif leaf in ("b", "bias"):
                prm.zero_()
            else:
                w = torch.empty(prm.shape, dtype=torch.float32, device=dev)
                prm.copy_(w.normal_(0.0, _INIT_STD, generator=generator))
    return model


def _flatten(tree: dict, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def params_from_jax(tree: dict, cfg: ModelConfig, device=None) -> DenseLM:
    """The port's module with the weights of a JAX parameter tree.

    ``tree``: the JAX ``init_params`` tree as numpy arrays (``blocks``
    with its stacked layer axis; float32 or bfloat16 values), loaded in
    ``cfg.dtype`` on ``device`` (default the card).  Every leaf must
    match a parameter of the port's module, shape for shape."""
    dev = resolve_device(device)
    model = DenseLM(cfg, dev)
    flat = {}
    for path, arr in _flatten(tree):
        arr = np.array(arr, dtype=np.float32)  # a writable copy
        if path[0] == "blocks":
            for i in range(cfg.n_layers):
                flat[".".join(("blocks", str(i)) + path[1:])] = arr[i]
        else:
            flat[".".join(path)] = arr
    params = dict(model.named_parameters())
    if set(flat) != set(params):
        raise ValueError(
            f"JAX tree and port module differ: only in the tree "
            f"{sorted(set(flat) - set(params))}, only in the port "
            f"{sorted(set(params) - set(flat))}"
        )
    with torch.no_grad():
        for name, prm in params.items():
            if tuple(flat[name].shape) != tuple(prm.shape):
                raise ValueError(f"{name}: JAX shape {flat[name].shape}, port "
                                 f"shape {tuple(prm.shape)}")
            prm.copy_(torch.from_numpy(flat[name]))
    return model


def forward(params: DenseLM, batch: dict, cfg: ModelConfig):
    """Full-sequence forward -> (logits (B, S, V_pad) f32, aux loss 0)."""
    _check_ported(cfg)
    tokens = _tokens(params, batch["tokens"])
    x = _embed(params.embed, cfg, tokens)
    for blk in params.blocks:
        x = _dense_block_fwd(blk, cfg, x)
    return _head(params.embed, cfg, x), torch.zeros((), device=x.device)


def init_cache(cfg: ModelConfig, B: int, cache_len: int, dtype=None,
               device=None) -> dict:
    """Zero KV cache {"k", "v"}, each (n_layers, B, cache_len, K, dh), on
    ``device`` (default the card; raises without one)."""
    _check_ported(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, B, cache_len, cfg.n_kv_heads, cfg.head_dim)
    dtype = dtype or _dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def prefill(params: DenseLM, batch: dict, cache: dict, cfg: ModelConfig):
    """Fill the cache from a full prompt -> (logits (B, S, V_pad), or
    (B, 1, V_pad) with ``prefill_last_only``; the cache, written in place)."""
    _check_ported(cfg)
    tokens = _tokens(params, batch["tokens"])
    x = _embed(params.embed, cfg, tokens)
    for i, blk in enumerate(params.blocks):
        x = _dense_block_fwd(blk, cfg, x, cache=_layer_cache(cache, i), cache_pos=0)
    return _prefill_head(params, cfg, x), cache


def decode_step(params: DenseLM, batch: dict, cache: dict, cfg: ModelConfig):
    """One-token decode.  batch: {'token': (B, 1), 'pos': int} -> (logits
    (B, 1, V_pad), the cache with the token's keys and values written at
    ``pos`` in place).  A ``pos`` at or past the cache length raises."""
    _check_ported(cfg)
    token = _tokens(params, batch["token"])
    pos = int(batch["pos"])
    x = _embed(params.embed, cfg, token, pos_offset=pos)
    for i, blk in enumerate(params.blocks):
        x = _dense_block_fwd(blk, cfg, x, cache=_layer_cache(cache, i), cache_pos=pos)
    return _head(params.embed, cfg, x), cache
