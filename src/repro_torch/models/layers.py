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
through :func:`cached_attention`.  Sequence-parallel attention
(``attn_seq_shard``) is not ported and raises.

Sharded (the dense family under a ``ShardingPolicy``, ``sharding/``):
the parameters are DTensors.  A linear gathers the weight's FSDP axis
(:func:`gather_fsdp`, JAX's per-layer all-gather) and multiplies in the
Megatron layout its spec gives (column: the output sharded on "model";
row: a partial sum); :func:`as_activation` brings a block's output back
to the activation layout (batch on the data axes, the rest replicated:
the row-parallel all-reduce); an attention whose q is a DTensor goes to
``sharding/attention.py`` (each rank on its own heads, the flash-decode
over a sequence-sharded cache, self or cross).

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


def _is_dt(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def gather_fsdp(w: torch.Tensor) -> torch.Tensor:
    """A DTensor weight with its data-parallel mesh dims ("pod", "data")
    replicated (the FSDP all-gather); any other tensor as it is."""
    if not _is_dt(w):
        return w
    from torch.distributed.tensor import Replicate

    names = w.device_mesh.mesh_dim_names
    plc = [Replicate() if n in ("pod", "data") else p
           for n, p in zip(names, w.placements)]
    return w if plc == list(w.placements) else redistribute(w, plc)


def redistribute(w: torch.Tensor, plc) -> torch.Tensor:
    """DTensor ``w`` redistributed to ``plc``.  With grad mode off a weight
    that requires grad is first rewrapped from its local tensor, which
    does not: the redistribute of one would detach its output in place,
    which DTensor has no strategy for (and ``detach`` of a DTensor fails
    under inference mode)."""
    if w.requires_grad and not torch.is_grad_enabled():
        from torch.distributed.tensor import DTensor

        w = DTensor.from_local(w.to_local(), w.device_mesh, w.placements,
                               run_check=False, shape=w.shape, stride=w.stride())
    return w.redistribute(w.device_mesh, plc)


def replicate(w: torch.Tensor) -> torch.Tensor:
    """A DTensor with every mesh dim replicated (a small parameter added to
    an activation: the learned positions, whisper's ``enc_pos``); any
    other tensor as it is."""
    if not _is_dt(w):
        return w
    from torch.distributed.tensor import Replicate

    plc = [Replicate()] * w.device_mesh.ndim
    return w if list(w.placements) == plc else redistribute(w, plc)


def rows(w: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """``w[a:b]`` of a weight whose dim 0 is not sharded; of a DTensor, its
    local rows with its placements (DTensor's own slice of a weight that
    requires grad fails under inference mode)."""
    if not _is_dt(w):
        return w[a:b]
    from torch.distributed.tensor import DTensor

    shape = (b - a,) + tuple(w.shape[1:])
    return DTensor.from_local(w.to_local()[a:b], w.device_mesh, w.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def as_activation(x: torch.Tensor) -> torch.Tensor:
    """A DTensor activation with every placement but a batch shard (dim 0)
    replicated: partial sums reduced, heads or features gathered; any
    other tensor as it is."""
    if not _is_dt(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    plc = [p if isinstance(p, Shard) and p.dim == 0 else Replicate()
           for p in x.placements]
    return x if plc == list(x.placements) else x.redistribute(x.device_mesh, plc)


def embedding(w: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``F.embedding(ids, w)``.  For a DTensor table, vocab-parallel: the
    FSDP axis gathered, each rank looks up the ids in its vocab rows (zero
    elsewhere), and the partial sums are reduced into the activation
    layout."""
    if not _is_dt(w):
        return F.embedding(ids, w)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    w = gather_fsdp(w)  # vocab on "model" or replicated, d replicated
    mesh = w.device_mesh
    vocab = [m for m, p in enumerate(w.placements) if isinstance(p, Shard) and p.dim == 0]
    id_plc = [Replicate() if m in vocab or not (isinstance(p, Shard) and p.dim == 0)
              else p for m, p in enumerate(ids.placements)]
    ids_l = (ids if list(ids.placements) == id_plc
             else ids.redistribute(mesh, id_plc)).to_local()
    # each rank's rows' gradient: a partial sum over the batch shards
    wl = w.to_local(grad_placements=[Partial() if p.is_shard() else w.placements[m]
                                     for m, p in enumerate(id_plc)])
    V_l = wl.shape[0]
    coord = mesh.get_coordinate()
    v0 = 0
    for m in vocab:  # the first vocab row of this rank
        v0 = v0 * mesh.size(m) + coord[m]
    v0 *= V_l
    rows = ids_l - v0
    inside = (rows >= 0) & (rows < V_l)
    out = F.embedding(rows.clamp(0, V_l - 1), wl) * inside[..., None].to(wl.dtype)
    plc = [Partial() if m in vocab else p for m, p in enumerate(id_plc)]
    shape = tuple(ids.shape) + (w.shape[1],)
    return as_activation(DTensor.from_local(out, mesh, plc, run_check=False,
                                            shape=torch.Size(shape),
                                            stride=torch.empty(shape, device="meta").stride()))


def split_heads(y: torch.Tensor, n: int, d_head: int) -> torch.Tensor:
    """(B, S, n d_head) -> (B, S, n, d_head).  A DTensor feature shard that
    does not fall on head boundaries (the model axis does not divide n) is
    gathered first."""
    if _is_dt(y):
        from torch.distributed.tensor import Replicate, Shard

        mesh = y.device_mesh
        plc = [Replicate() if isinstance(p, Shard) and p.dim == 2 and n % mesh.size(m)
               else p for m, p in enumerate(y.placements)]
        if plc != list(y.placements):
            y = y.redistribute(mesh, plc)
    return y.reshape(y.shape[0], y.shape[1], n, d_head)


def linear(p: Linear, x: torch.Tensor) -> torch.Tensor:
    y = x @ gather_fsdp(p.w)
    if p.b is not None:
        y = y + gather_fsdp(p.b)
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
    if _is_dt(x):  # replicated factors of a sharded x
        from torch.distributed.tensor import DTensor, Replicate

        rep = [Replicate()] * x.device_mesh.ndim
        cos = DTensor.from_local(cos, x.device_mesh, rep, run_check=False)
        sin = DTensor.from_local(sin, x.device_mesh, rep, run_check=False)
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
    seq_shard: bool = False  # sequence-parallel attention: not ported


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
            "sequence-parallel attention (attn_seq_shard) is not ported: its "
            "sequence sharding comes with the LM dry run (ROADMAP queue 1)"
        )
    if _is_dt(q):
        from repro_torch.sharding import attention as SA

        return SA.sdpa(q, k, v, causal, q_pos=q_pos, impl=impl, chunk=chunk)
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
    if seq_shard:
        raise NotImplementedError(
            "sequence-parallel attention (attn_seq_shard) is not ported: its "
            "sequence sharding comes with the LM dry run (ROADMAP queue 1)"
        )
    if _is_dt(cache["k"]):
        from repro_torch.sharding import attention as SA

        return SA.cached_attention(q, k, v, cache, cache_pos, impl=impl, chunk=chunk)
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
    q = split_heads(linear(p.wq, x), a.n_heads, a.d_head)
    kw = dict(impl=a.impl, chunk=a.chunk, seq_shard=a.seq_shard)
    self_cache = cache is not None and cache_pos is not None and kv_src is None
    if cache is not None and not self_cache:  # cross-attn, precomputed source kv
        if _is_dt(q) and not a.seq_shard:
            from repro_torch.sharding import attention as SA

            o = SA.cross_attention(q, cache["k"], cache["v"], impl=a.impl, chunk=a.chunk)
        else:
            o = _sdpa(q, cache["k"], cache["v"], causal=False, **kw)
        return as_activation(linear(p.wo, o.reshape(B, Sq, a.n_heads * a.d_head))), cache

    src = x if kv_src is None else kv_src
    k = split_heads(linear(p.wk, src), a.n_kv_heads, a.d_head)
    v = split_heads(linear(p.wv, src), a.n_kv_heads, a.d_head)
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
    y = as_activation(linear(p.wo, o.reshape(B, Sq, a.n_heads * a.d_head)))
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
        return as_activation(linear(p.w_down, F.silu(linear(p.w_gate, x))
                                    * linear(p.w_up, x)))
    # jax.nn.gelu's default is the tanh approximation
    return as_activation(linear(p.w_down, F.gelu(linear(p.w_up, x), approximate="tanh")))
