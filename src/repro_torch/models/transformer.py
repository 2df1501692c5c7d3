"""The port's LM: the decoder-only families dense, moe and ssm.

The counterpart of those families of the JAX package's
``models/transformer.py``: init, full-sequence forward (with the MoE aux
loss), cache, prefill and one-token decode, with the same public
functions (``init_params``, ``forward``, ``init_cache``, ``prefill``,
``decode_step``), dispatching on the family as JAX's do.  The parameters
are an ``LM`` module whose state-dict keys are the JAX tree's paths with
the stacked layer axis spelled out (``blocks.3.attn.wq.w``,
``blocks.3.mixer.A_log``); ``params_from_jax`` loads a JAX tree.  Layers
are an ``nn.ModuleList`` walked in a Python loop (JAX scans).

- dense / moe: decoder blocks; a block's MLP is the MoE layer
  (``models/moe.py``) whenever ``n_experts > 0``, whatever the family.
  The cache keeps JAX's stacked layout {"k", "v"} of shape (n_layers, B,
  S, K, dh).
- ssm (mamba2): Mamba2 blocks (``models/ssm.py``).  The cache is
  {"conv": (n_layers, B, d_conv - 1, conv_dim), "ssm": (n_layers, B, H,
  P, N) float32}, whatever the cache length; prefill starts from a zero
  state (the incoming cache's contents are ignored) and a decode takes
  any ``pos``.

Prefill and decode write the cache in place.  The families still to
come (hybrid, audio, vlm) raise ``NotImplementedError`` naming the
family.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.runtime.device import resolve_device

_INIT_STD = 0.02


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------
def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


_FAMILIES = ("dense", "moe", "ssm")


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.name}) is not ported yet; the "
            "port has the dense, moe and ssm families (hybrid, audio and vlm "
            "are still to come)"
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


def _ssm_dims(cfg: ModelConfig) -> SSM.SSMDims:
    return SSM.SSMDims(
        d_model=cfg.d_model,
        d_state=cfg.ssm_state,
        d_conv=cfg.ssm_conv,
        expand=cfg.ssm_expand,
        head_dim=cfg.ssm_head_dim,
        chunk=cfg.ssm_chunk,
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
    """A decoder block: ``moe`` in place of ``mlp`` when ``n_experts > 0``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        dt = _dtype(cfg)
        self.ln1 = L.Norm(cfg.norm, cfg.d_model, dt, device)
        self.attn = L.Attention(_attn_dims(cfg), dt, device)
        self.ln2 = L.Norm(cfg.norm, cfg.d_model, dt, device)
        if cfg.n_experts > 0:
            self.moe = MOE.MoE(cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.mlp_act,
                               dt, device)
        else:
            self.mlp = L.MLP(cfg.d_model, cfg.d_ff, cfg.mlp_act, dt, device)


class MambaBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        dt = _dtype(cfg)
        self.ln = L.Norm(cfg.norm, cfg.d_model, dt, device)
        self.mixer = SSM.Mamba(_ssm_dims(cfg), dt, device)


class LM(nn.Module):
    """Parameters of a model of a ported family (uninitialised; see
    ``init_params`` and ``params_from_jax``)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        self.embed = Embed(cfg, device)
        block = MambaBlock if cfg.family == "ssm" else DenseBlock
        self.blocks = nn.ModuleList(block(cfg, device) for _ in range(cfg.n_layers))


def _dense_block_fwd(p: DenseBlock, cfg: ModelConfig, x, positions=None,
                     cache=None, cache_pos=None):
    """One decoder block -> (x, aux loss); a given cache is written in
    place."""
    h, _ = L.attention_fwd(
        p.attn, _attn_dims(cfg), L.apply_norm(cfg.norm, p.ln1, x),
        positions=positions, cache=cache, cache_pos=cache_pos,
    )
    x = x + h
    hn = L.apply_norm(cfg.norm, p.ln2, x)
    if cfg.n_experts > 0:
        h, aux = MOE.moe_fwd(
            p.moe, hn, cfg.n_experts, cfg.experts_per_tok, cfg.mlp_act,
            cfg.capacity_factor, cfg.moe_group_size,
            no_drop=(x.shape[1] == 1),  # one-token decode: never drop
        )
        return x + h, aux
    return x + L.mlp_fwd(p.mlp, hn, cfg.mlp_act), None


def _embed(p: Embed, cfg: ModelConfig, tokens: torch.Tensor, pos_offset: int = 0):
    x = p.tok[tokens]
    if cfg.pos == "learned":
        x = x + p.pos[pos_offset : pos_offset + tokens.shape[1]]
    return x


def _head(p: Embed, cfg: ModelConfig, x):
    x = L.apply_norm(cfg.norm, p.ln_f, x)
    w = p.tok.t() if cfg.tie_embeddings else p.lm_head
    return (x @ w).float()


def _prefill_head(params: LM, cfg: ModelConfig, x):
    """Serving prefill: optionally emit only the final position's logits."""
    if cfg.prefill_last_only:
        x = x[:, -1:]
    return _head(params.embed, cfg, x)


def _tokens(params: LM, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=params.embed.tok.device).long()


def _layer_cache(cache: dict, i: int) -> dict:
    return {name: val[i] for name, val in cache.items()}


# ==========================================================================
# dense / moe decoder-only family
# ==========================================================================
def _fwd_dense(params: LM, cfg: ModelConfig, x):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in params.blocks:
        x, a = _dense_block_fwd(blk, cfg, x)
        if a is not None:
            aux = aux + a
    return x, aux


def _dense_cache(cfg: ModelConfig, B, cache_len, dtype, dev) -> dict:
    shape = (cfg.n_layers, B, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _prefill_dense(params: LM, cfg: ModelConfig, x, cache: dict):
    for i, blk in enumerate(params.blocks):
        x, _ = _dense_block_fwd(blk, cfg, x, cache=_layer_cache(cache, i), cache_pos=0)
    return x


def _decode_dense(params: LM, cfg: ModelConfig, x, cache: dict, pos: int):
    for i, blk in enumerate(params.blocks):
        x, _ = _dense_block_fwd(blk, cfg, x, cache=_layer_cache(cache, i), cache_pos=pos)
    return x


# ==========================================================================
# ssm (mamba2) family
# ==========================================================================
def _fwd_ssm(params: LM, cfg: ModelConfig, x):
    dims = _ssm_dims(cfg)
    for blk in params.blocks:
        x = x + SSM.mamba_fwd(blk.mixer, dims, L.apply_norm(cfg.norm, blk.ln, x))
    return x


def _ssm_cache(cfg: ModelConfig, B, dtype, dev) -> dict:
    """O(1) state: the cache length plays no part."""
    st = SSM.mamba_init_state(_ssm_dims(cfg), B, dtype, dev)
    return {name: val.new_zeros((cfg.n_layers,) + val.shape) for name, val in st.items()}


def _write_state(cache: dict, i: int, st: dict) -> None:
    for name, val in st.items():
        cache[name][i] = val


def _prefill_ssm(params: LM, cfg: ModelConfig, x, cache: dict):
    """From a zero state; the cache's contents are overwritten, not read."""
    dims = _ssm_dims(cfg)
    for i, blk in enumerate(params.blocks):
        y, st = SSM.mamba_fwd(blk.mixer, dims, L.apply_norm(cfg.norm, blk.ln, x),
                              return_state=True)
        _write_state(cache, i, st)
        x = x + y
    return x


def _decode_ssm(params: LM, cfg: ModelConfig, x, cache: dict):
    dims = _ssm_dims(cfg)
    for i, blk in enumerate(params.blocks):
        y, st = SSM.mamba_decode_step(blk.mixer, dims, L.apply_norm(cfg.norm, blk.ln, x),
                                      _layer_cache(cache, i))
        _write_state(cache, i, st)
        x = x + y
    return x


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------
_ONES = ("scale", "norm_scale", "D")
_ZEROS = ("b", "bias", "conv_b", "dt_bias")
_STD = {"conv_w": 0.1}


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None) -> LM:
    """Random init on ``device`` (default the card; raises without one),
    JAX's scheme leaf by leaf: N(0, 0.02) drawn in f32 and cast to the
    parameter's dtype (``conv_w`` N(0, 0.1)), norm scales and ``D`` at
    one, biases, ``conv_b`` and ``dt_bias`` at zero, ``A_log`` =
    log(linspace(1, 16, H)) (the draws differ from JAX's).
    ``generator``: a ``torch.Generator`` on that device (default: one
    seeded with 0)."""
    dev = resolve_device(device)
    model = LM(cfg, dev)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in _ONES:
                prm.fill_(1.0)
            elif leaf in _ZEROS:
                prm.zero_()
            elif leaf == "A_log":
                prm.copy_(torch.linspace(1.0, 16.0, prm.shape[0], dtype=torch.float32,
                                         device=dev).log())
            else:
                w = torch.empty(prm.shape, dtype=torch.float32, device=dev)
                prm.copy_(w.normal_(0.0, _STD.get(leaf, _INIT_STD), generator=generator))
    return model


def _flatten(tree: dict, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def params_from_jax(tree: dict, cfg: ModelConfig, device=None) -> LM:
    """The port's module with the weights of a JAX parameter tree.

    ``tree``: the JAX ``init_params`` tree as numpy arrays (``blocks``
    with its stacked layer axis; float32 or bfloat16 values), each leaf
    loaded in the dtype of the port's parameter (``cfg.dtype``, or
    float32 for the MoE router and the Mamba2 ``A_log``, ``D`` and
    ``dt_bias``) on ``device`` (default the card).  Every leaf must
    match a parameter of the port's module, shape for shape."""
    dev = resolve_device(device)
    model = LM(cfg, dev)
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


def forward(params: LM, batch: dict, cfg: ModelConfig):
    """Full-sequence forward -> (logits (B, S, V_pad) f32, the sum of the
    layers' MoE aux losses (f32; 0 without experts))."""
    _check_ported(cfg)
    tokens = _tokens(params, batch["tokens"])
    x = _embed(params.embed, cfg, tokens)
    if cfg.family == "ssm":
        x, aux = _fwd_ssm(params, cfg, x), torch.zeros((), device=x.device)
    else:
        x, aux = _fwd_dense(params, cfg, x)
    return _head(params.embed, cfg, x), aux


def init_cache(cfg: ModelConfig, B: int, cache_len: int, dtype=None,
               device=None) -> dict:
    """Zero cache on ``device`` (default the card; raises without one):
    dense / moe {"k", "v"}, each (n_layers, B, cache_len, K, dh) in
    ``dtype`` (default ``cfg.dtype``); ssm {"conv": (n_layers, B,
    d_conv - 1, conv_dim) in ``dtype``, "ssm": (n_layers, B, H, P, N)
    float32}, whatever ``cache_len``."""
    _check_ported(cfg)
    dev = resolve_device(device)
    dtype = dtype or _dtype(cfg)
    if cfg.family == "ssm":
        return _ssm_cache(cfg, B, dtype, dev)
    return _dense_cache(cfg, B, cache_len, dtype, dev)


def prefill(params: LM, batch: dict, cache: dict, cfg: ModelConfig):
    """Fill the cache from a full prompt -> (logits (B, S, V_pad), or
    (B, 1, V_pad) with ``prefill_last_only``; the cache, written in place)."""
    _check_ported(cfg)
    tokens = _tokens(params, batch["tokens"])
    x = _embed(params.embed, cfg, tokens)
    if cfg.family == "ssm":
        x = _prefill_ssm(params, cfg, x, cache)
    else:
        x = _prefill_dense(params, cfg, x, cache)
    return _prefill_head(params, cfg, x), cache


def decode_step(params: LM, batch: dict, cache: dict, cfg: ModelConfig):
    """One-token decode.  batch: {'token': (B, 1), 'pos': int} -> (logits
    (B, 1, V_pad), the cache, written in place: the token's keys and values
    at ``pos``, or the new ssm state).  Dense / moe: a ``pos`` at or past
    the cache length raises; ssm takes any ``pos``."""
    _check_ported(cfg)
    token = _tokens(params, batch["token"])
    pos = int(batch["pos"])
    x = _embed(params.embed, cfg, token, pos_offset=pos)
    if cfg.family == "ssm":
        x = _decode_ssm(params, cfg, x, cache)
    else:
        x = _decode_dense(params, cfg, x, cache, pos)
    return _head(params.embed, cfg, x), cache
