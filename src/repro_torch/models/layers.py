"""Primitive layers of the port's LM side: norms, rotary embeddings,
linear, attention, MLP.

The counterparts of the JAX package's ``models/layers.py``.  Parameters
live in small ``nn.Module``s whose attribute names are the JAX tree's
keys (``wq.w``, ``ln1.scale``, ...) and whose weights keep the JAX
layout (a linear's ``w`` is (d_in, d_out), applied as ``x @ w``); the
``*_fwd`` / plain functions apply them as the JAX functions do.

Attention routing (``_sdpa``) keeps JAX's knob: ``impl="xla"`` is the
plain dense version (``flash_attn_ref``, the counterpart of JAX's
``_sdpa_dense``); ``impl="chunked"`` with more than one query and no
``q_pos`` is the flash-attention kernel (``kernels.flash_attn``), which
computes that same function for any length; where it trains (grad mode
on and q, k or v requiring grad) it goes through ``FlashAttnFn``, whose
backward recomputes the plain version ``chunk`` query rows at a time,
the memory shape of JAX's checkpointed chunks (JAX's unroll flag has no
counterpart).  ``q_pos`` (decode, prefill into a longer cache) is the
dense version, as in JAX.  Every self-attention with a cache goes
through :func:`cached_attention`.  Sequence-parallel attention needs
sharding and raises.

Parameters are trainable (``requires_grad``); serving runs under
``torch.inference_mode()`` (``launch/steps.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attn.ops import FlashAttnFn, flash_attn
from repro_torch.kernels.flash_attn.ref import flash_attn_ref


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


# --------------------------------------------------------------------------
# basics
# --------------------------------------------------------------------------
class Linear(nn.Module):
    """``w`` (d_in, d_out) and, with ``bias``, ``b`` (d_out,)."""

    def __init__(self, d_in, d_out, dtype, device, bias=False):
        super().__init__()
        self.w = _param((d_in, d_out), dtype, device)
        self.b = _param((d_out,), dtype, device) if bias else None


def linear(p: Linear, x: torch.Tensor) -> torch.Tensor:
    y = x @ p.w
    if p.b is not None:
        y = y + p.b
    return y


class Norm(nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``scale``, ``bias``)."""

    def __init__(self, kind: str, d, dtype, device):
        super().__init__()
        self.scale = _param((d,), dtype, device)
        self.bias = _param((d,), dtype, device) if kind == "layernorm" else None


def rms_norm_scale(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with a bare scale tensor (the Mamba2 block's gated norm)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def rms_norm(p: Norm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return rms_norm_scale(p.scale, x, eps)


def layer_norm(p: Norm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p.scale.float() + p.bias.float()).to(x.dtype)


def apply_norm(kind: str, p: Norm, x: torch.Tensor) -> torch.Tensor:
    return rms_norm(p, x) if kind == "rmsnorm" else layer_norm(p, x)


# --------------------------------------------------------------------------
# rotary position embedding
# --------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, d_head); positions: (S,) or (B, S).  Split halves,
    f32 angles, cast back."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., None].float() * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# attention (GQA, optional cross-attention, optional KV cache)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AttnDims:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    qkv_bias: bool = False
    rope_theta: float = 1.0e4
    use_rope: bool = True
    causal: bool = True
    kv_d_model: Optional[int] = None  # cross-attn source width
    impl: str = "xla"  # xla (dense S^2) | chunked (the flash kernel)
    chunk: int = 1024  # query rows of a chunk of the flash backward
    seq_shard: bool = False  # sequence-parallel attention: needs sharding


class Attention(nn.Module):
    def __init__(self, a: AttnDims, dtype, device):
        super().__init__()
        kv_d = a.kv_d_model or a.d_model
        self.wq = Linear(a.d_model, a.n_heads * a.d_head, dtype, device, a.qkv_bias)
        self.wk = Linear(kv_d, a.n_kv_heads * a.d_head, dtype, device, a.qkv_bias)
        self.wv = Linear(kv_d, a.n_kv_heads * a.d_head, dtype, device, a.qkv_bias)
        self.wo = Linear(a.n_heads * a.d_head, a.d_model, dtype, device, False)


def _sdpa(q, k, v, causal: bool, q_pos=None, impl: str = "xla",
          chunk: int = 1024, seq_shard: bool = False):
    if seq_shard:
        raise NotImplementedError(
            "sequence-parallel attention (attn_seq_shard) needs sharding, which "
            "the port does not have yet"
        )
    if impl == "chunked" and q.shape[1] > 1 and q_pos is None:
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            return FlashAttnFn.apply(q, k, v, causal, chunk)
        return flash_attn(q, k, v, causal)
    return flash_attn_ref(q, k, v, causal, q_pos)


def cached_attention(q, k, v, cache: dict, cache_pos: int, impl: str = "xla",
                     chunk: int = 1024, seq_shard: bool = False) -> torch.Tensor:
    """Causal self-attention through a KV cache, every family's cache
    branch (the dense blocks' and the hybrid's shared block).

    q (B, Sq, H, dh); k / v (B, Sq, K, dh) the new keys and values, written
    IN PLACE into cache {'k', 'v'} (B, S_max, K, dh) at cache_pos ..
    cache_pos + Sq - 1 (JAX returns an updated copy); a write past S_max
    raises (JAX clamps the start index).  A prefill filling the whole
    cache attends over the fresh k / v without ``q_pos`` -- causal, top-left:
    the function JAX computes there, with or without its q_pos =
    arange(S) -- so it reaches the flash kernel on ``chunked``; any other
    write (decode, a prefill into a longer cache) attends over the cache
    with ``q_pos``, which hides the unwritten slots, on the plain version.
    """
    Sq, S_max = q.shape[1], cache["k"].shape[1]
    if not 0 <= cache_pos <= S_max - Sq:
        raise ValueError(
            f"cache write at positions {cache_pos}..{cache_pos + Sq - 1} runs "
            f"past the cache of length {S_max}"
        )
    cache["k"][:, cache_pos : cache_pos + Sq] = k.to(cache["k"].dtype)
    cache["v"][:, cache_pos : cache_pos + Sq] = v.to(cache["v"].dtype)
    if Sq == S_max:
        return _sdpa(q, k, v, causal=True, impl=impl, chunk=chunk, seq_shard=seq_shard)
    q_pos = torch.arange(cache_pos, cache_pos + Sq, device=q.device)
    return _sdpa(q, cache["k"], cache["v"], causal=True, q_pos=q_pos, impl=impl,
                 chunk=chunk, seq_shard=seq_shard)


def attention_fwd(
    p: Attention,
    a: AttnDims,
    x: torch.Tensor,
    kv_src: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    cache: Optional[dict] = None,
    cache_pos: Optional[int] = None,
) -> tuple[torch.Tensor, Optional[dict]]:
    """Self- or cross-attention, the JAX ``attention_fwd``'s branches.

    cache: {'k': (B, S_max, K, dh), 'v': ...}.  With ``cache_pos`` (an
    int) the cache is written in place (:func:`cached_attention`) and the
    same dict is returned.  Without ``cache_pos`` the cache is a
    cross-attention source, and no key or value is projected from ``x``.
    """
    B, Sq, _ = x.shape
    q = linear(p.wq, x).reshape(B, Sq, a.n_heads, a.d_head)
    kw = dict(impl=a.impl, chunk=a.chunk, seq_shard=a.seq_shard)
    self_cache = cache is not None and cache_pos is not None and kv_src is None
    if cache is not None and not self_cache:  # cross-attn, precomputed source kv
        o = _sdpa(q, cache["k"], cache["v"], causal=False, **kw)
        return linear(p.wo, o.reshape(B, Sq, a.n_heads * a.d_head)), cache

    src = x if kv_src is None else kv_src
    k = linear(p.wk, src).reshape(B, src.shape[1], a.n_kv_heads, a.d_head)
    v = linear(p.wv, src).reshape(B, src.shape[1], a.n_kv_heads, a.d_head)
    if a.use_rope and kv_src is None:
        if positions is None:
            start = 0 if cache_pos is None else cache_pos
            positions = torch.arange(start, start + Sq, device=x.device)
        q = rope(q, positions, a.rope_theta)
        k = rope(k, positions, a.rope_theta)

    if self_cache:
        o = cached_attention(q, k, v, cache, cache_pos, **kw)
    else:
        o = _sdpa(q, k, v, causal=a.causal and kv_src is None, **kw)
    y = linear(p.wo, o.reshape(B, Sq, a.n_heads * a.d_head))
    return y, cache if self_cache else None


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------
class MLP(nn.Module):
    """swiglu: ``w_gate``, ``w_up``, ``w_down`` (no bias); gelu: ``w_up``,
    ``w_down`` with bias."""

    def __init__(self, d_model, d_ff, act: str, dtype, device):
        super().__init__()
        if act == "swiglu":
            self.w_gate = Linear(d_model, d_ff, dtype, device)
            self.w_up = Linear(d_model, d_ff, dtype, device)
            self.w_down = Linear(d_ff, d_model, dtype, device)
        else:
            self.w_up = Linear(d_model, d_ff, dtype, device, bias=True)
            self.w_down = Linear(d_ff, d_model, dtype, device, bias=True)


def mlp_fwd(p: MLP, x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "swiglu":
        return linear(p.w_down, F.silu(linear(p.w_gate, x)) * linear(p.w_up, x))
    # jax.nn.gelu's default is the tanh approximation
    return linear(p.w_down, F.gelu(linear(p.w_up, x), approximate="tanh"))
