"""The port's LM: all six families, dense, moe, ssm, hybrid, audio, vlm.

The counterpart of the JAX package's ``models/transformer.py``: init,
full-sequence forward (with the MoE aux loss), cache, prefill and
one-token decode, with the same public functions (``init_params``,
``forward``, ``init_cache``, ``prefill``, ``decode_step``), dispatching
on the family as JAX's do.  The parameters are an ``LM`` module whose
state-dict keys are the JAX tree's paths with every stacked axis spelled
out (``blocks.3.attn.wq.w``, ``mamba.2.1.mixer.A_log``,
``selfs.0.3.attn.wq.w``); ``params_from_jax`` loads a JAX tree.  Layers
are ``nn.ModuleList``s walked in Python loops (JAX scans).

- dense / moe: decoder blocks; a block's MLP is the MoE layer
  (``models/moe.py``) whenever ``n_experts > 0``, whatever the family.
  The cache is {"k", "v"} of shape (n_layers, B, S, K, dh).
- ssm (mamba2): Mamba2 blocks (``models/ssm.py``).  The cache is
  {"conv": (n_layers, B, d_conv - 1, conv_dim), "ssm": (n_layers, B, H,
  P, N) float32}, whatever the cache length; prefill starts from a zero
  state (the incoming cache's contents are ignored) and a decode takes
  any ``pos``.
- hybrid (zamba2): units of ``cfg.hybrid_pattern`` ("m" a Mamba2 block,
  "a" ONE shared attention + MLP block reading concat(h, h0), with the
  unit's LoRA on q / k / v).  Parameters ``mamba`` (n_units x
  m_per_unit blocks), ``shared``, ``lora`` (one a unit).  The cache is
  {"ssm": {"conv", "ssm"} of shape (n_units, m_per_unit, ...), "attn":
  {"k", "v"} of shape (n_units, B, S, K, dh), "x0": (B, 1, d)}; a decode
  takes its own token's embedding as x0 and never reads ``x0``, as JAX
  does.
- audio (whisper): an encoder (non-causal self-attention over the
  precomputed frame embeddings ``batch["audio"]`` plus ``enc_pos``) and
  a decoder (causal self-attention, cross-attention over the encoder's
  keys and values, MLP).  The cache is {"k", "v": (n_layers, B, S, K,
  dh), "xk", "xv": (n_layers, B, n_frames, K, dh)}: prefill stores each
  layer's cross keys and values, decode reads them.
- vlm (llama-3.2-vision): units of ``cross_attn_period - 1`` decoder
  blocks with a gated cross-attention block over the image embeddings
  ``batch["image_embeds"]`` before the unit's last one.  The cache is
  {"k", "v": (n_units, period - 1, B, S, K, dh), "xk", "xv": (n_units,
  B, n_patches, K, dh)}.

Prefill and decode write the cache in place.

Training: ``forward(..., remat=True)`` runs each of JAX's scan bodies
(one block for dense, moe and ssm; one unit for hybrid and vlm; one
encoder or decoder layer for audio) under ``torch.utils.checkpoint``
when grad mode is on, as JAX wraps its scan body in ``jax.checkpoint``;
the recompute pass does not count MoE assignments again.
``loss_fn`` is JAX's next-token loss.  ``jax_leaf_groups`` names the
JAX leaf each parameter is a slice of, for the optimizers' leaf rules.

Sharded: every family runs on DTensor parameters
(``sharding/place.py::shard_module`` or ``init_sharded``): tokens and the
frontend's frames or patches are placed by the batch specs, the
embedding and head gather their FSDP axis, the attention blocks (the
hybrid's shared block with its LoRA, the cross-attention of audio and
vlm) run in the Megatron layouts of ``models/layers.py``, the MoE layer
expert-parallel (or tensor-parallel inside each expert) and the Mamba2
block on head-split local tensors (``models/moe.py``, ``models/ssm.py``,
``sharding/local.py``).  A prefill writes its Mamba2 states and cross
keys and values into a sharded cache as each rank's shard of them
(``_write_layer``); a decode reads a cross cache where it lies, along
the source sequence or on kv heads (``sharding/attention.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.runtime.device import resolve_device

_INIT_STD = 0.02
FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------
def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _family(cfg: ModelConfig) -> str:
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)
    return cfg.family


def _attn_dims(cfg: ModelConfig, cross: bool = False) -> L.AttnDims:
    """Attention dims of a decoder block; ``cross``: cross-attention over
    a source of width d_model, no RoPE, not causal."""
    return L.AttnDims(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        d_head=cfg.head_dim,
        qkv_bias=cfg.qkv_bias,
        rope_theta=cfg.rope_theta,
        use_rope=cfg.pos == "rope" and not cross,
        causal=not cross,
        kv_d_model=cfg.d_model if cross else None,
        impl=cfg.attn_impl,
        chunk=cfg.attn_chunk,
        seq_shard=cfg.attn_seq_shard,
    )


def _enc_dims(cfg: ModelConfig) -> L.AttnDims:
    """The audio encoder's self-attention: not causal, no RoPE."""
    return dataclasses.replace(_attn_dims(cfg), causal=False, use_rope=False)


def _ssm_dims(cfg: ModelConfig) -> SSM.SSMDims:
    return SSM.SSMDims(
        d_model=cfg.d_model,
        d_state=cfg.ssm_state,
        d_conv=cfg.ssm_conv,
        expand=cfg.ssm_expand,
        head_dim=cfg.ssm_head_dim,
        chunk=cfg.ssm_chunk,
    )


def _hybrid_counts(cfg: ModelConfig) -> tuple[int, int]:
    """(n_units, Mamba2 blocks a unit)."""
    unit = len(cfg.hybrid_pattern)
    if unit == 0 or cfg.n_layers % unit:
        raise ValueError(f"n_layers {cfg.n_layers} must tile hybrid_pattern "
                         f"{cfg.hybrid_pattern}")
    return cfg.n_layers // unit, cfg.hybrid_pattern.count("m")


def _vlm_counts(cfg: ModelConfig) -> tuple[int, int]:
    """(n_units, period)."""
    p = cfg.cross_attn_period
    if p < 2 or cfg.n_layers % p:
        raise ValueError(f"n_layers {cfg.n_layers} must tile cross_attn_period {p}")
    return cfg.n_layers // p, p


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


class SharedBlock(nn.Module):
    """The hybrid's shared attention + MLP block, reading concat(h, h0):
    ``ln1`` / ``ln2`` of width 2d, ``wq`` / ``wk`` / ``wv`` (2d -> heads),
    ``wo``, ``w_up`` (2d -> d_ff), ``w_down``, no biases."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        dt, d2, hd = _dtype(cfg), 2 * cfg.d_model, cfg.head_dim
        self.ln1 = L.Norm(cfg.norm, d2, dt, device)
        self.wq = L.Linear(d2, cfg.n_heads * hd, dt, device)
        self.wk = L.Linear(d2, cfg.n_kv_heads * hd, dt, device)
        self.wv = L.Linear(d2, cfg.n_kv_heads * hd, dt, device)
        self.wo = L.Linear(cfg.n_heads * hd, cfg.d_model, dt, device)
        self.ln2 = L.Norm(cfg.norm, d2, dt, device)
        self.w_up = L.Linear(d2, cfg.d_ff, dt, device)
        self.w_down = L.Linear(cfg.d_ff, cfg.d_model, dt, device)


class LoRA(nn.Module):
    """A unit's adapters on the shared block's q / k / v: ``a_q`` (2d,
    r), ``b_q`` (r, H dh), and the same for k and v (K dh)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        dt, d2, hd, r = _dtype(cfg), 2 * cfg.d_model, cfg.head_dim, cfg.lora_rank
        for nm, nh in (("q", cfg.n_heads), ("k", cfg.n_kv_heads), ("v", cfg.n_kv_heads)):
            setattr(self, f"a_{nm}", L._param((d2, r), dt, device))
            setattr(self, f"b_{nm}", L._param((r, nh * hd), dt, device))


class CrossBlock(nn.Module):
    """The vlm's cross-attention block: ``ln1``, ``xattn``, ``ln2``,
    ``mlp``; gated, ``gate_attn`` / ``gate_mlp`` float32 scalars."""

    def __init__(self, cfg: ModelConfig, device, gated: bool):
        super().__init__()
        dt = _dtype(cfg)
        self.ln1 = L.Norm(cfg.norm, cfg.d_model, dt, device)
        self.xattn = L.Attention(_attn_dims(cfg, cross=True), dt, device)
        self.ln2 = L.Norm(cfg.norm, cfg.d_model, dt, device)
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, cfg.mlp_act, dt, device)
        self.gate_attn = L._param((), torch.float32, device) if gated else None
        self.gate_mlp = L._param((), torch.float32, device) if gated else None


class EncBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        dt = _dtype(cfg)
        self.ln1 = L.Norm(cfg.norm, cfg.d_model, dt, device)
        self.attn = L.Attention(_enc_dims(cfg), dt, device)
        self.ln2 = L.Norm(cfg.norm, cfg.d_model, dt, device)
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, cfg.mlp_act, dt, device)


class DecBlock(nn.Module):
    """The audio decoder's block: causal ``attn``, cross ``xattn``, ``mlp``
    behind ``ln1`` / ``ln2`` / ``ln3``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        dt = _dtype(cfg)
        self.ln1 = L.Norm(cfg.norm, cfg.d_model, dt, device)
        self.attn = L.Attention(_attn_dims(cfg), dt, device)
        self.ln2 = L.Norm(cfg.norm, cfg.d_model, dt, device)
        self.xattn = L.Attention(_attn_dims(cfg, cross=True), dt, device)
        self.ln3 = L.Norm(cfg.norm, cfg.d_model, dt, device)
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, cfg.mlp_act, dt, device)


def _stack(make, n: int) -> nn.ModuleList:
    return nn.ModuleList(make() for _ in range(n))


class LM(nn.Module):
    """Parameters of a model of any family (uninitialised; see
    ``init_params`` and ``params_from_jax``)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        fam = _family(cfg)
        self.cfg = cfg
        self.embed = Embed(cfg, device)
        if fam in ("dense", "moe", "ssm"):
            block = MambaBlock if fam == "ssm" else DenseBlock
            self.blocks = _stack(lambda: block(cfg, device), cfg.n_layers)
        elif fam == "hybrid":
            n_units, m_per_unit = _hybrid_counts(cfg)
            self.mamba = _stack(lambda: _stack(lambda: MambaBlock(cfg, device),
                                               m_per_unit), n_units)
            self.shared = SharedBlock(cfg, device)
            self.lora = _stack(lambda: LoRA(cfg, device), n_units)
        elif fam == "audio":
            self.enc_pos = L._param((cfg.n_frontend_tokens, cfg.d_model),
                                    _dtype(cfg), device)
            self.enc_blocks = _stack(lambda: EncBlock(cfg, device), cfg.n_enc_layers)
            self.enc_ln_f = L.Norm(cfg.norm, cfg.d_model, _dtype(cfg), device)
            self.dec_blocks = _stack(lambda: DecBlock(cfg, device), cfg.n_layers)
        else:  # vlm
            n_units, period = _vlm_counts(cfg)
            self.selfs = _stack(lambda: _stack(lambda: DenseBlock(cfg, device),
                                               period - 1), n_units)
            self.cross = _stack(lambda: CrossBlock(cfg, device, gated=True), n_units)


#: the stacked axes of each JAX subtree (``params_from_jax``)
_STACKED = {"blocks": 1, "mamba": 2, "selfs": 2, "lora": 1, "cross": 1,
            "enc_blocks": 1, "dec_blocks": 1}


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


def _cross_block_fwd(p: CrossBlock, cfg: ModelConfig, x, src_kv: dict):
    """src_kv: precomputed {'k', 'v'} of the image embeddings."""
    h, _ = L.attention_fwd(p.xattn, _attn_dims(cfg, cross=True),
                           L.apply_norm(cfg.norm, p.ln1, x), cache=src_kv)
    if p.gate_attn is not None:
        h = torch.tanh(p.gate_attn).to(h.dtype) * h
    x = x + h
    h = L.mlp_fwd(p.mlp, L.apply_norm(cfg.norm, p.ln2, x), cfg.mlp_act)
    if p.gate_mlp is not None:
        h = torch.tanh(p.gate_mlp).to(h.dtype) * h
    return x + h


def _cross_kv(p_attn: L.Attention, cfg: ModelConfig, src: torch.Tensor) -> dict:
    """Cross-attention keys and values of a source, once a sequence (a
    DTensor source: its kv heads in the column layout, gathered where the
    model axis does not divide them)."""
    a = _attn_dims(cfg, cross=True)
    return {"k": L.split_heads(L.linear(p_attn.wk, src), a.n_kv_heads, a.d_head),
            "v": L.split_heads(L.linear(p_attn.wv, src), a.n_kv_heads, a.d_head)}


def _embed(p: Embed, cfg: ModelConfig, tokens: torch.Tensor, pos_offset: int = 0):
    # a gather; F.embedding's backward sums each row's uses in a fixed
    # order on the card, where indexing's (index_put_) accumulates atomically
    x = L.embedding(p.tok, tokens)
    if cfg.pos == "learned":
        x = x + L.replicate(L.rows(p.pos, pos_offset, pos_offset + tokens.shape[1]))
    return x


def _head(p: Embed, cfg: ModelConfig, x):
    x = L.apply_norm(cfg.norm, p.ln_f, x)
    w = L.gather_fsdp(p.tok).t() if cfg.tie_embeddings else L.gather_fsdp(p.lm_head)
    return (x @ w).float()


def _prefill_head(params: LM, cfg: ModelConfig, x):
    """Serving prefill: optionally emit only the final position's logits."""
    if cfg.prefill_last_only:
        x = x[:, -1:]
    return _head(params.embed, cfg, x)


def _tokens(params: LM, tokens) -> torch.Tensor:
    """Token ids as a long tensor on the parameters' device; for a sharded
    module, a DTensor placed by the batch specs (the same host tokens on
    every rank)."""
    tok = params.embed.tok
    if not L._is_dt(tok):
        return torch.as_tensor(tokens, device=tok.device).long()
    if L._is_dt(tokens):
        return tokens.long()
    from repro_torch.sharding import place as PL

    t = torch.as_tensor(tokens).long()
    return PL.shard_batch({"tokens": t}, params.sharding_policy)["tokens"]


def is_sharded(params: LM) -> bool:
    """True where the module's parameters are DTensors."""
    return L._is_dt(params.embed.tok)


#: the frontend's precomputed embeddings a batch of each family carries
FRONTEND = {"audio": "audio", "vlm": "image_embeds"}


def frontend_batch(batch: dict, cfg: ModelConfig, device) -> dict:
    """``batch`` with the frontend's embeddings (audio frames, image
    patches) as a tensor on ``device`` in the config's dtype (a DTensor
    stays one, cast)."""
    key = FRONTEND.get(cfg.family)
    if key is None:
        return batch
    src = batch[key]
    if L._is_dt(src):
        return {**batch, key: src.to(_dtype(cfg))}
    return {**batch, key: torch.as_tensor(src).to(device=device, dtype=_dtype(cfg))}


def _frontend(params: LM, cfg: ModelConfig, batch: dict) -> torch.Tensor:
    """The batch's frames or patches (``frontend_batch``); for a sharded
    module, a DTensor placed by the batch specs (batch on the data axes),
    as ``_tokens`` places tokens."""
    key = FRONTEND[cfg.family]
    x = frontend_batch(batch, cfg, params.embed.tok.device)[key]
    if L._is_dt(x) or not is_sharded(params):
        return x
    from repro_torch.sharding import place as PL

    return PL.shard_batch({key: x}, params.sharding_policy)[key]


def _layer_cache(cache: dict, *i: int) -> dict:
    """The views of one layer's entries (index ``i`` on the stacked axes;
    of a DTensor entry, its local shard's view as a DTensor)."""
    return {name: _layer_view(val, i) if L._is_dt(val) else val[i]
            for name, val in cache.items()}


def _layer_view(val, i: tuple):
    """A DTensor cache entry's layer ``i`` (its stacked dims replicated):
    the local shard's view, its placements shifted past the dropped dims."""
    from torch.distributed.tensor import DTensor, Shard

    n = len(i)
    plc = [Shard(p.dim - n) if isinstance(p, Shard) else p for p in val.placements]
    shape = tuple(val.shape[n:])
    return DTensor.from_local(val.to_local()[i], val.device_mesh, plc, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def _write_layer(cache: dict, i: tuple, st: dict) -> None:
    """One layer's entries (a Mamba2 state, cross keys and values) into
    their slot ``i``, cast to the cache's dtypes; into a DTensor cache,
    each entry redistributed to the slot's layout and each rank's shard
    written (no DTensor ``__setitem__``)."""
    for name, val in st.items():
        c = cache[name]
        if L._is_dt(c):
            view = _layer_view(c, i)
            if list(val.placements) != list(view.placements):
                val = val.redistribute(val.device_mesh, view.placements)
            view.to_local().copy_(val.to_local())
        else:
            c[i] = val


def _remat(remat: bool, fn, *args):
    """``fn(*args)``: one of JAX's scan bodies.  With ``remat`` and grad
    mode on, under activation recomputation (JAX's ``jax.checkpoint``):
    only the inputs are kept, and the backward runs ``fn`` again; that
    recompute runs with the MoE counters off, so each forward counts
    once.  No random numbers are drawn, so no RNG state is kept."""
    if not (remat and torch.is_grad_enabled()):
        return fn(*args)
    ran = []

    def body(*a):
        if ran:  # the backward's recompute
            with MOE.not_counting():
                return fn(*a)
        ran.append(True)
        return fn(*a)

    return checkpoint(body, *args, use_reentrant=False, preserve_rng_state=False)


# ==========================================================================
# dense / moe decoder-only family
# ==========================================================================
def _fwd_dense(params: LM, cfg: ModelConfig, x, remat: bool = False):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in params.blocks:
        x, a = _remat(remat, _dense_block_fwd, blk, cfg, x)
        if a is not None:
            aux = aux + a
    return x, aux


def _kv_cache(shape, dtype, dev) -> dict:
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def _dense_cache(cfg: ModelConfig, B, cache_len, dtype, dev) -> dict:
    return _kv_cache((cfg.n_layers, B, cache_len, cfg.n_kv_heads, cfg.head_dim),
                     dtype, dev)


def _step_dense(params: LM, cfg: ModelConfig, x, cache: dict, pos: int):
    """Prefill (pos 0) or decode through every block's cache."""
    for i, blk in enumerate(params.blocks):
        x, _ = _dense_block_fwd(blk, cfg, x, cache=_layer_cache(cache, i), cache_pos=pos)
    return x


# ==========================================================================
# ssm (mamba2) family
# ==========================================================================
def _fwd_ssm(params: LM, cfg: ModelConfig, x, remat: bool = False):
    for blk in params.blocks:
        x = _remat(remat, _mamba_step, blk, cfg, x, None, (), False)
    return x


def _ssm_state(cfg: ModelConfig, lead: tuple, B, dtype, dev) -> dict:
    """Zero Mamba2 states with the leading axes ``lead``."""
    st = SSM.mamba_init_state(_ssm_dims(cfg), B, dtype, dev)
    return {name: val.new_zeros(lead + val.shape) for name, val in st.items()}


def _mamba_step(blk: MambaBlock, cfg: ModelConfig, x, cache: Optional[dict],
                i: tuple, decode: bool):
    """x + one Mamba2 block: forward (no cache), prefill (the new state
    written to ``cache`` at ``i``, from a zero state) or decode (the
    state at ``i`` read and replaced)."""
    dims = _ssm_dims(cfg)
    hn = L.apply_norm(cfg.norm, blk.ln, x)
    if cache is None:
        return x + SSM.mamba_fwd(blk.mixer, dims, hn)
    if decode:
        y, st = SSM.mamba_decode_step(blk.mixer, dims, hn, _layer_cache(cache, *i))
    else:
        y, st = SSM.mamba_fwd(blk.mixer, dims, hn, return_state=True)
    _write_layer(cache, i, st)
    return x + y


def _step_ssm(params: LM, cfg: ModelConfig, x, cache: dict, decode: bool):
    """Prefill (from a zero state; the cache's contents are overwritten,
    not read) or decode."""
    for i, blk in enumerate(params.blocks):
        x = _mamba_step(blk, cfg, x, cache, (i,), decode)
    return x


# ==========================================================================
# hybrid (zamba2) family: units of cfg.hybrid_pattern, "a" = shared block
# ==========================================================================
def _shared_block_fwd(sp: SharedBlock, lora: LoRA, cfg: ModelConfig, x, x0,
                      cache: Optional[dict] = None, cache_pos: Optional[int] = None):
    """The shared block with a unit's LoRA: q / k / v = h w + (h a) b, RoPE
    at cache_pos + arange(S), causal attention (through the cache when
    one is given), then the gelu MLP over concat(x, x0).  Sharded: w and
    b in the column layout (heads on "model"), a gathered on its FSDP
    axis, as the dense block's projections."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    h = L.apply_norm(cfg.norm, sp.ln1, torch.cat([x, x0], dim=-1))

    def proj(nm, lin, nh):
        a, b = getattr(lora, f"a_{nm}"), getattr(lora, f"b_{nm}")
        return L.split_heads(L.linear(lin, h) + (h @ L.gather_fsdp(a)) @ b, nh, hd)

    start = 0 if cache_pos is None else cache_pos
    positions = torch.arange(start, start + S, device=x.device)
    q = L.rope(proj("q", sp.wq, cfg.n_heads), positions, cfg.rope_theta)
    k = L.rope(proj("k", sp.wk, cfg.n_kv_heads), positions, cfg.rope_theta)
    v = proj("v", sp.wv, cfg.n_kv_heads)
    kw = dict(impl=cfg.attn_impl, chunk=cfg.attn_chunk)
    if cache is not None:
        o = L.cached_attention(q, k, v, cache, cache_pos, **kw)
    else:
        o = L._sdpa(q, k, v, causal=True, **kw)
    x = x + L.as_activation(L.linear(sp.wo, o.reshape(B, S, cfg.n_heads * hd)))
    h2 = L.apply_norm(cfg.norm, sp.ln2, torch.cat([x, x0], dim=-1))
    return x + L.as_activation(
        L.linear(sp.w_down, F.gelu(L.linear(sp.w_up, h2), approximate="tanh")))


def _hybrid_unit(params: LM, cfg: ModelConfig, u: int, x, x0,
                 cache: Optional[dict] = None, pos: Optional[int] = None,
                 decode: bool = False):
    """Unit ``u``: its Mamba2 blocks and the shared block with its LoRA."""
    mi = 0
    for sym in cfg.hybrid_pattern:
        if sym == "m":
            x = _mamba_step(params.mamba[u][mi], cfg, x,
                            None if cache is None else cache["ssm"], (u, mi), decode)
            mi += 1
        else:
            x = _shared_block_fwd(
                params.shared, params.lora[u], cfg, x, x0,
                cache=None if cache is None else _layer_cache(cache["attn"], u),
                cache_pos=pos)
    return x


def _step_hybrid(params: LM, cfg: ModelConfig, x, cache: Optional[dict] = None,
                 pos: Optional[int] = None, decode: bool = False,
                 remat: bool = False):
    """Every unit: forward (no cache; a unit under ``remat``), prefill
    (pos 0) or decode.  x0 is the embedding this call starts from."""
    x0 = x
    for u in range(len(params.lora)):
        if cache is None:
            x = _remat(remat, _hybrid_unit, params, cfg, u, x, x0)
        else:
            x = _hybrid_unit(params, cfg, u, x, x0, cache, pos, decode)
    return x


def _hybrid_cache(cfg: ModelConfig, B, cache_len, dtype, dev) -> dict:
    n_units, m_per_unit = _hybrid_counts(cfg)
    return {
        "ssm": _ssm_state(cfg, (n_units, m_per_unit), B, dtype, dev),
        "attn": _kv_cache((n_units, B, cache_len, cfg.n_kv_heads, cfg.head_dim),
                          dtype, dev),
        "x0": torch.zeros((B, 1, cfg.d_model), dtype=dtype, device=dev),
    }


# ==========================================================================
# audio (whisper) encoder-decoder family
# ==========================================================================
def _enc_block_fwd(blk: EncBlock, cfg: ModelConfig, x):
    h, _ = L.attention_fwd(blk.attn, _enc_dims(cfg), L.apply_norm(cfg.norm, blk.ln1, x))
    x = x + h
    return x + L.mlp_fwd(blk.mlp, L.apply_norm(cfg.norm, blk.ln2, x), cfg.mlp_act)


def _encode_audio(params: LM, cfg: ModelConfig, audio: torch.Tensor,
                  remat: bool = False):
    x = audio + L.replicate(params.enc_pos)
    for blk in params.enc_blocks:
        x = _remat(remat, _enc_block_fwd, blk, cfg, x)
    return L.apply_norm(cfg.norm, params.enc_ln_f, x)


def _dec_block_fwd(p: DecBlock, cfg: ModelConfig, x, enc_kv: dict, cache=None,
                   cache_pos=None):
    h, _ = L.attention_fwd(p.attn, _attn_dims(cfg), L.apply_norm(cfg.norm, p.ln1, x),
                           cache=cache, cache_pos=cache_pos)
    x = x + h
    h, _ = L.attention_fwd(p.xattn, _attn_dims(cfg, cross=True),
                           L.apply_norm(cfg.norm, p.ln2, x), cache=enc_kv)
    x = x + h
    return x + L.mlp_fwd(p.mlp, L.apply_norm(cfg.norm, p.ln3, x), cfg.mlp_act)


def _dec_layer(blk: DecBlock, cfg: ModelConfig, x, enc):
    """A decoder layer of the forward: its cross keys and values, then the block."""
    return _dec_block_fwd(blk, cfg, x, _cross_kv(blk.xattn, cfg, enc))


def _step_audio(params: LM, cfg: ModelConfig, x, audio=None, cache=None, pos=None,
                remat: bool = False):
    """The decoder: forward (``audio``, no cache; an encoder or decoder
    layer under ``remat``), prefill (``audio`` and the cache: each layer's
    cross keys and values stored) or decode (no ``audio``: they are read
    from the cache)."""
    enc = None if audio is None else _encode_audio(params, cfg, audio,
                                                   remat and cache is None)
    for i, blk in enumerate(params.dec_blocks):
        if cache is None:
            x = _remat(remat, _dec_layer, blk, cfg, x, enc)
            continue
        if enc is not None:
            enc_kv = _cross_kv(blk.xattn, cfg, enc)
            _write_layer(cache, (i,), {"xk": enc_kv["k"], "xv": enc_kv["v"]})
        else:
            enc_kv = _cross_view(cache, i)
        x = _dec_block_fwd(blk, cfg, x, enc_kv, cache=_self_view(cache, i), cache_pos=pos)
    return x


def _self_view(cache: dict, *i: int) -> dict:
    """Layer ``i``'s self-attention {"k", "v"} of an audio or vlm cache."""
    return _layer_cache({"k": cache["k"], "v": cache["v"]}, *i)


def _cross_view(cache: dict, i: int) -> dict:
    """Layer or unit ``i``'s cross keys and values {"k", "v"} of a cache."""
    return _layer_cache({"k": cache["xk"], "v": cache["xv"]}, i)


def _cross_cache(cfg: ModelConfig, n: int, B, dtype, dev) -> dict:
    xk = _kv_cache((n, B, cfg.n_frontend_tokens, cfg.n_kv_heads, cfg.head_dim),
                   dtype, dev)
    return {"xk": xk["k"], "xv": xk["v"]}


def _audio_cache(cfg: ModelConfig, B, cache_len, dtype, dev) -> dict:
    return {**_dense_cache(cfg, B, cache_len, dtype, dev),
            **_cross_cache(cfg, cfg.n_layers, B, dtype, dev)}


# ==========================================================================
# vlm (llama-3.2-vision) family: units of cross_attn_period decoder layers,
# in-unit position period - 2 is a gated cross-attention block
# ==========================================================================
def _vlm_unit(params: LM, cfg: ModelConfig, u: int, x, img=None, cache=None, pos=None):
    """Unit ``u``: period - 1 decoder blocks with the gated cross block
    before the last one, over ``img``'s keys and values (or the cache's)."""
    _, period = _vlm_counts(cfg)
    cross = params.cross[u]
    if img is not None:
        img_kv = _cross_kv(cross.xattn, cfg, img)
        if cache is not None:
            _write_layer(cache, (u,), {"xk": img_kv["k"], "xv": img_kv["v"]})
    else:
        img_kv = _cross_view(cache, u)
    for j, blk in enumerate(params.selfs[u]):
        if j == period - 2:
            x = _cross_block_fwd(cross, cfg, x, img_kv)
        cl = None if cache is None else _self_view(cache, u, j)
        x, _ = _dense_block_fwd(blk, cfg, x, cache=cl, cache_pos=pos)
    return x


def _step_vlm(params: LM, cfg: ModelConfig, x, img=None, cache=None, pos=None,
              remat: bool = False):
    """Every unit: forward (``img``, no cache; a unit under ``remat``),
    prefill (``img`` and the cache: each unit's image keys and values
    stored) or decode (no ``img``: read from the cache)."""
    for u in range(len(params.cross)):
        if cache is None:
            x = _remat(remat, _vlm_unit, params, cfg, u, x, img)
        else:
            x = _vlm_unit(params, cfg, u, x, img, cache, pos)
    return x


def _vlm_cache(cfg: ModelConfig, B, cache_len, dtype, dev) -> dict:
    n_units, period = _vlm_counts(cfg)
    return {**_kv_cache((n_units, period - 1, B, cache_len, cfg.n_kv_heads,
                         cfg.head_dim), dtype, dev),
            **_cross_cache(cfg, n_units, B, dtype, dev)}


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------
_ONES = ("scale", "norm_scale", "D")
_ZEROS = ("b", "bias", "conv_b", "dt_bias", "b_q", "b_k", "b_v", "gate_attn",
          "gate_mlp")
_STD = {"conv_w": 0.1}


def init_leaf(name: str, shape, dtype, generator: torch.Generator, device) -> torch.Tensor:
    """Parameter ``name``'s initial value, whole, on ``device`` (the
    scheme of ``init_params``'s docstring); a drawn leaf takes its draws
    from ``generator``."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in _ONES:
        return torch.ones(shape, dtype=dtype, device=device)
    if leaf in _ZEROS:
        return torch.zeros(shape, dtype=dtype, device=device)
    if leaf == "A_log":
        return torch.linspace(1.0, 16.0, shape[0], dtype=torch.float32,
                              device=device).log().to(dtype)
    w = torch.empty(shape, dtype=torch.float32, device=device)
    return w.normal_(0.0, _STD.get(leaf, _INIT_STD), generator=generator).to(dtype)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                device=None) -> LM:
    """Random init on ``device`` (default the card; raises without one),
    JAX's scheme leaf by leaf: N(0, 0.02) drawn in f32 and cast to the
    parameter's dtype (``conv_w`` N(0, 0.1)), norm scales and ``D`` at
    one, biases, ``conv_b``, ``dt_bias``, the LoRA ``b_q`` / ``b_k`` /
    ``b_v`` and the vlm gates at zero, ``A_log`` = log(linspace(1, 16,
    H)) (the draws differ from JAX's).  ``generator``: a
    ``torch.Generator`` on that device (default: one seeded with 0).
    ``sharding/place.py::init_sharded`` draws the same leaves in the same
    order, one at a time, and keeps each rank's slice."""
    dev = resolve_device(device)
    model = LM(cfg, dev)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            prm.copy_(init_leaf(name, prm.shape, prm.dtype, generator, dev))
    return model


def _flatten(tree: dict, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def unstack_jax_tree(tree: dict) -> dict:
    """{port parameter name: float32 numpy array} of a JAX parameter tree
    (or of a tree shaped like it: AdamW's moments), its stacked subtrees
    unstacked on their stacked axes (``_STACKED``)."""
    flat = {}
    for path, arr in _flatten(tree):
        arr = np.array(arr, dtype=np.float32)  # a writable copy
        n = _STACKED.get(path[0], 0)
        for i in np.ndindex(arr.shape[:n]):
            flat[".".join((path[0], *map(str, i)) + path[1:])] = arr[i + (...,)]
    return flat


def jax_leaf_groups(model: LM) -> dict:
    """{JAX leaf path: (its stacked shape, the port parameter names that
    are its slices, in row-major order of their stack index)}: JAX keeps
    ``blocks.3.attn.wq.w`` as slice 3 of leaf ``blocks.attn.wq.w`` of
    shape (n_layers, d, H dh).  Unstacked parameters are groups of one
    with shape ()."""
    groups: dict = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        n = _STACKED.get(parts[0], 0)
        idx = tuple(int(i) for i in parts[1 : 1 + n])
        key = ".".join(parts[:1] + parts[1 + n :])
        groups.setdefault(key, []).append((idx, name))
    out = {}
    for key, members in groups.items():
        members.sort()
        stack = tuple(max(i[a] for i, _ in members) + 1
                      for a in range(len(members[0][0])))
        out[key] = (stack, [name for _, name in members])
    return out


def jax_leaf_ndims(model: LM) -> dict:
    """{port parameter name: ndim of the JAX leaf it is a slice of}."""
    return {name: len(stack) + prm.ndim
            for stack, names in jax_leaf_groups(model).values()
            for name, prm in ((n, model.get_parameter(n)) for n in names)}


def params_from_jax(tree: dict, cfg: ModelConfig, device=None) -> LM:
    """The port's module with the weights of a JAX parameter tree.

    ``tree``: the JAX ``init_params`` tree as numpy arrays (float32 or
    bfloat16 values), its stacked subtrees unstacked on their stacked
    axes (``blocks``, ``lora``, ``cross``, ``enc_blocks``, ``dec_blocks``
    one; ``mamba``, ``selfs`` two), each leaf loaded in the dtype of the
    port's parameter (``cfg.dtype``, or float32 for the MoE router, the
    Mamba2 ``A_log``, ``D`` and ``dt_bias`` and the vlm gates) on
    ``device`` (default the card).  Every leaf must match a parameter of
    the port's module, shape for shape."""
    dev = resolve_device(device)
    model = LM(cfg, dev)
    flat = unstack_jax_tree(tree)
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


def forward(params: LM, batch: dict, cfg: ModelConfig, remat: bool = True):
    """Full-sequence forward -> (logits (B, S, V_pad) f32, the sum of the
    layers' MoE aux losses (f32; 0 without experts)).  batch: {'tokens'},
    and 'audio' / 'image_embeds' (B, n_frontend_tokens, d) for the audio
    / vlm families.  ``remat``: each scan body under activation
    recomputation where grad mode is on (module docstring)."""
    fam = _family(cfg)
    tokens = _tokens(params, batch["tokens"])
    x = _embed(params.embed, cfg, tokens)
    aux = torch.zeros((), device=x.device)
    if fam in ("dense", "moe"):
        x, aux = _fwd_dense(params, cfg, x, remat)
    elif fam == "ssm":
        x = _fwd_ssm(params, cfg, x, remat)
    elif fam == "hybrid":
        x = _step_hybrid(params, cfg, x, remat=remat)
    elif fam == "audio":
        x = _step_audio(params, cfg, x, audio=_frontend(params, cfg, batch), remat=remat)
    else:
        x = _step_vlm(params, cfg, x, img=_frontend(params, cfg, batch), remat=remat)
    return _head(params.embed, cfg, x), aux


def loss_fn(params: LM, batch: dict, cfg: ModelConfig, tc: TrainConfig):
    """JAX's next-token loss -> (loss, {"ce", "moe_aux"}): a float32
    log-softmax over the padded vocabulary, the labels ``tokens[:, 1:]``,
    the mean cross-entropy (``nll_loss``: each row's gradient written
    once, no atomic sum), plus ``tc.moe_aux_weight`` times the aux loss."""
    logits, aux = forward(params, batch, cfg, remat=tc.remat)
    labels = _tokens(params, batch["tokens"])[:, 1:]
    lp = F.log_softmax(logits[:, :-1].float(), dim=-1)
    ce = F.nll_loss(lp.reshape(-1, lp.shape[-1]), labels.reshape(-1))
    if L._is_dt(ce):  # the mean over every rank's tokens
        ce = ce.full_tensor()
    loss = ce + tc.moe_aux_weight * aux
    return loss, {"ce": ce, "moe_aux": aux}


def init_cache(cfg: ModelConfig, B: int, cache_len: int, dtype=None,
               device=None) -> dict:
    """Zero cache on ``device`` (default the card; raises without one) in
    ``dtype`` (default ``cfg.dtype``; the Mamba2 ``ssm`` states float32),
    JAX's layout key for key (module docstring)."""
    fam = _family(cfg)
    dev = resolve_device(device)
    dtype = dtype or _dtype(cfg)
    if fam == "ssm":
        return _ssm_state(cfg, (cfg.n_layers,), B, dtype, dev)
    make = {"dense": _dense_cache, "moe": _dense_cache, "hybrid": _hybrid_cache,
            "audio": _audio_cache, "vlm": _vlm_cache}[fam]
    return make(cfg, B, cache_len, dtype, dev)


def prefill(params: LM, batch: dict, cache: dict, cfg: ModelConfig):
    """Fill the cache from a full prompt -> (logits (B, S, V_pad), or
    (B, 1, V_pad) with ``prefill_last_only``; the cache, written in place)."""
    fam = _family(cfg)
    tokens = _tokens(params, batch["tokens"])
    x = _embed(params.embed, cfg, tokens)
    if fam in ("dense", "moe"):
        x = _step_dense(params, cfg, x, cache, 0)
    elif fam == "ssm":
        x = _step_ssm(params, cfg, x, cache, decode=False)
    elif fam == "hybrid":
        x = _step_hybrid(params, cfg, x, cache, 0)
    elif fam == "audio":
        x = _step_audio(params, cfg, x, _frontend(params, cfg, batch), cache, 0)
    else:
        x = _step_vlm(params, cfg, x, _frontend(params, cfg, batch), cache, 0)
    return _prefill_head(params, cfg, x), cache


def decode_step(params: LM, batch: dict, cache: dict, cfg: ModelConfig):
    """One-token decode.  batch: {'token': (B, 1), 'pos': int} -> (logits
    (B, 1, V_pad), the cache, written in place: the token's keys and values
    at ``pos``, and the new Mamba2 states).  A ``pos`` at or past the
    cache length raises, except in the ssm family, which takes any."""
    fam = _family(cfg)
    token = _tokens(params, batch["token"])
    pos = int(batch["pos"])
    x = _embed(params.embed, cfg, token, pos_offset=pos)
    if fam in ("dense", "moe"):
        x = _step_dense(params, cfg, x, cache, pos)
    elif fam == "ssm":
        x = _step_ssm(params, cfg, x, cache, decode=True)
    elif fam == "hybrid":
        x = _step_hybrid(params, cfg, x, cache, pos, decode=True)
    elif fam == "audio":
        x = _step_audio(params, cfg, x, cache=cache, pos=pos)
    else:
        x = _step_vlm(params, cfg, x, cache=cache, pos=pos)
    return _head(params.embed, cfg, x), cache
