"""Attention on DTensor activations: each rank on its own heads, and the
flash-decode over a sequence-sharded KV cache.

``models.layers`` sends here every attention whose q is a DTensor:

  * :func:`sdpa` -- q, k, v of the tensor-parallel projections: each
    rank runs the attention (the flash kernel, ``FlashAttnFn`` where it
    trains, or the plain version) on its local query heads and the kv
    heads they read.  Where k / v are replicated because the model axis
    does not divide the kv heads (qwen2.5-3b: H 16, K 2 on a model axis
    of 4) the rank slices the kv heads its query heads read -- query head
    h reads kv head h // (H // K) -- and, for the gradient, hands k / v
    back as partial sums over the model axis.
  * :func:`cross_attention` -- non-causal attention over a cross-attention
    source's cached keys and values: over a cache sharded along the
    source (a decode over whisper's cross cache, its frames on "model")
    the split softmax of :func:`_flash_decode` without a mask, over each
    rank's shard where it lies (no k / v moves); otherwise :func:`sdpa`.
  * :func:`cached_attention` -- writes the new keys and values into a
    cache placed by ``policy.cache_specs_tree`` (each position to the rank
    that owns it) and attends: a prefill that fills the cache attends
    over the fresh k / v (:func:`sdpa`); otherwise, over a cache sharded
    along the sequence, each rank holds a partial softmax over its
    positions (max, sum, weighted values) and the stats are all-reduced
    over the model axis (JAX's flash-decode layout); over a cache sharded
    on heads, or not at all, each rank attends over its local heads.

Sequence-parallel attention (``attn_seq_shard``, JAX's
``constrain_seq_parallel`` inside ``_sdpa`` / ``_sdpa_chunked``): under a
sharding context (``sharding/ctx.py``) whose policy has a model axis of
n > 1 and is not ``dp_only``, :func:`sdpa` gives each rank of "model" its
own query rows -- on ``impl="chunked"`` C / n rows of every ``attn_chunk``
block of C (JAX's layout: each rank holds a share of every chunk, which
balances the causal work), on ``impl="xla"`` a contiguous run of Sq / n --
where n divides the chunk (the sequence); elsewhere the sequence stays
whole and the heads route above runs, as the constraint decides.  k and v
stay whole on "model" (gathered where they were on kv heads); each rank
runs the kernel on its rows at their positions (:func:`seq_rank_attention`,
a plain function of one rank, which one card can call for each); the
output comes back replicated on "model", one all-gather: the only
collective the route adds to a forward.  Training: q's gradient comes
back through the constraint (an all-gather), k's and v's as partial sums
over "model".  Cross attention takes the route with ``causal=False``; a
decode (Sq == 1) or a prefill into a longer cache (``q_pos`` given) does
not.

Outputs keep q's placements (the sequence-parallel route: replicated on
"model").  The values equal the plain version's on the whole tensors up
to the summation order of the split softmax.
"""
from __future__ import annotations

import math

import torch


def _dt():
    from torch.distributed import tensor as dtensor

    return dtensor


def _from_local(t, mesh, plc, shape):
    """A contiguous local shard as a DTensor of global ``shape``."""
    return _dt().DTensor.from_local(t.contiguous(), mesh, plc, run_check=False,
                                    shape=torch.Size(shape),
                                    stride=torch.empty(shape, device="meta").stride())


def _to_plain(t, plc):
    """``t`` redistributed to ``plc`` when it differs."""
    return t if list(t.placements) == list(plc) else t.redistribute(t.device_mesh, plc)


def _q_layout(q):
    """q's placements with anything but a batch shard (dim 0) or a head
    shard (dim 2) replicated."""
    dt = _dt()
    return [p if isinstance(p, dt.Shard) and p.dim in (0, 2) else dt.Replicate()
            for p in q.placements]


def _kv_heads(kl, h0: int, H_l: int, g: int):
    """The kv heads local query heads h0 .. h0 + H_l - 1 read (head h reads
    h // g), sliced from the rank's whole kv heads ``kl``: a contiguous
    range where the kernel's grouping rule holds on it, else one kv head a
    query head."""
    lo, hi = h0 // g, (h0 + H_l - 1) // g + 1
    K_l = hi - lo
    if H_l % K_l == 0 and all((h0 + j) // g - lo == j // (H_l // K_l) for j in range(H_l)):
        return kl[:, :, lo:hi]
    idx = torch.tensor([(h0 + j) // g for j in range(H_l)], device=kl.device)
    return kl.index_select(2, idx)


def seq_layout(Sq: int, n: int, impl: str, chunk: int):
    """(rows a block, period) of a rank's rows in sequence-parallel
    attention over n ranks: rank r holds rows r * block .. (r + 1) * block
    - 1 of every ``period`` rows; None where the sequence stays whole (n
    does not divide the chunk, or on ``chunked`` the chunk does not divide
    Sq: JAX's dense fallback)."""
    if n <= 1 or Sq <= 1:
        return None
    if impl == "chunked":
        C = min(chunk, Sq)
        if Sq % C or C % n:
            return None
        return C // n, C
    return (Sq // n, Sq) if Sq % n == 0 else None


def seq_rank_rows(x: torch.Tensor, rank: int, n: int, block: int, period: int):
    """Rank ``rank``'s rows (dim 1) of a whole (B, Sq, ...) tensor."""
    B, Sq = x.shape[:2]
    v = x.reshape(B, Sq // period, period, *x.shape[2:])
    return v[:, :, rank * block:(rank + 1) * block].reshape(B, Sq // n, *x.shape[2:])


def seq_stitch(outs, n: int, block: int, period: int) -> torch.Tensor:
    """The whole (B, Sq, ...) tensor from every rank's rows, rank order."""
    B, rows = outs[0].shape[:2]
    tail = outs[0].shape[2:]
    parts = [o.reshape(B, rows // block, block, *tail) for o in outs]
    return torch.cat(parts, dim=2).reshape(B, rows * n, *tail)


def _rows_attention(rows, k, v, rank: int, block: int, period: int, chunk: int,
                    causal: bool, impl: str):
    """Attention of a rank's query rows (B, rows, H, dh) over whole k / v at
    the rows' positions (``block`` of every ``period``, from ``rank *
    block``): on ``chunked`` the flash kernel (``FlashAttnFn`` where it
    trains), on ``xla`` the plain dense version."""
    from repro_torch.kernels.flash_attn.ops import FlashAttnFn, block_positions, flash_attn
    from repro_torch.kernels.flash_attn.ref import flash_attn_ref

    rows = rows.contiguous()
    pos = (block_positions(rows.shape[1], block, period, rank * block, rows.device)
           if causal else None)
    if impl != "chunked":
        return flash_attn_ref(rows, k, v, causal, pos)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (rows, k, v)):
        return FlashAttnFn.apply(rows, k, v, causal, chunk, pos)
    return flash_attn(rows, k, v, causal, pos)


def seq_rank_attention(q, k, v, rank: int, n: int, chunk: int, causal: bool = True,
                       impl: str = "chunked"):
    """One rank of sequence-parallel attention on plain tensors: q (B, Sq,
    H, dh) whole, k / v (B, Sk, K, dh) whole -> the rank's output rows (B,
    Sq / n, H, dh), at their positions (:func:`_rows_attention`).  The
    layout is :func:`seq_layout`'s, which must not be None;
    :func:`seq_stitch` puts the ranks' rows back together."""
    block, period = seq_layout(q.shape[1], n, impl, chunk)
    return _rows_attention(seq_rank_rows(q, rank, n, block, period), k.contiguous(),
                           v.contiguous(), rank, block, period, chunk, causal, impl)


def _seq_sdpa(q, k, v, causal: bool, impl: str, chunk: int):
    """:func:`sdpa`'s sequence-parallel route (module docstring), or None
    where the sequence stays whole."""
    from repro_torch.sharding.ctx import constrain_seq_parallel, current_policy

    dt = _dt()
    policy = current_policy()
    mesh = q.device_mesh
    if policy is None or policy.dp_only or "model" not in mesh.mesh_dim_names:
        return None
    mdim = mesh.mesh_dim_names.index("model")
    n = mesh.size(mdim)
    B, Sq, H, dh = q.shape
    lay = seq_layout(Sq, n, impl, chunk)
    if lay is None:
        return None
    block, period = lay
    # q as (B, Sq / period, period, H, dh), its period dim on "model"
    q5 = constrain_seq_parallel(q.reshape(B, Sq // period, period, H, dh), seq_axis=2)
    if not (isinstance(q5.placements[mdim], dt.Shard) and q5.placements[mdim].dim == 2):
        return None
    kv_plc = [dt.Replicate() if m == mdim or not (isinstance(p, dt.Shard) and p.dim == 0)
              else p for m, p in enumerate(q5.placements)]
    grad_plc = [dt.Partial() if m == mdim else p for m, p in enumerate(kv_plc)]
    kl = _to_plain(k, kv_plc).to_local(grad_placements=grad_plc)
    vl = _to_plain(v, kv_plc).to_local(grad_placements=grad_plc)
    ql = q5.to_local()
    Bl = ql.shape[0]
    ol = _rows_attention(ql.reshape(Bl, -1, H, dh), kl.contiguous(), vl.contiguous(),
                         mesh.get_local_rank(mdim), block, period, chunk, causal, impl)
    o5 = _from_local(ol.reshape(Bl, Sq // period, block, H, dh), mesh, q5.placements,
                     (B, Sq // period, period, H, dh))
    rep = [dt.Replicate() if m == mdim else p for m, p in enumerate(o5.placements)]
    return _to_plain(o5, rep).reshape(B, Sq, H, dh)


def sdpa(q, k, v, causal: bool, q_pos=None, impl: str = "xla", chunk: int = 1024,
         seq_shard: bool = False):
    """Attention of DTensor q (B, Sq, H, dh), k / v (B, Sk, K, dh): each rank
    on its local query heads, or with ``seq_shard`` on its own query rows
    (module docstring)."""
    if seq_shard and q_pos is None:
        o = _seq_sdpa(q, k, v, causal, impl, chunk)
        if o is not None:
            return o
    dt = _dt()
    mesh = q.device_mesh
    H, K = q.shape[2], k.shape[2]
    g = H // K
    q_plc = _q_layout(q)
    kv_plc, grad_plc, head_dims = [], [], []
    for mdim, p in enumerate(q_plc):
        n = mesh.size(mdim)
        if isinstance(p, dt.Shard) and p.dim == 2:
            if K % n == 0 and (H // n) % (K // n) == 0:
                kv_plc.append(dt.Shard(2))
                grad_plc.append(dt.Shard(2))
            else:  # replicated kv: this rank reads some of its heads
                kv_plc.append(dt.Replicate())
                grad_plc.append(dt.Partial())
                head_dims.append(mdim)
        else:
            kv_plc.append(p)
            grad_plc.append(p)
    q = _to_plain(q, q_plc)
    k, v = _to_plain(k, kv_plc), _to_plain(v, kv_plc)
    ql = q.to_local()
    kl = k.to_local(grad_placements=grad_plc)
    vl = v.to_local(grad_placements=grad_plc)
    if head_dims:
        # the global index of this rank's first query head
        coord = mesh.get_coordinate()
        H_l = ql.shape[2]
        h0, stride = 0, H
        for mdim, p in enumerate(q_plc):
            if isinstance(p, dt.Shard) and p.dim == 2:
                stride //= mesh.size(mdim)
                h0 += coord[mdim] * stride
        kl, vl = _kv_heads(kl, h0, H_l, g), _kv_heads(vl, h0, H_l, g)
    from repro_torch.models import layers as L

    ol = L._sdpa(ql.contiguous(), kl.contiguous(), vl.contiguous(), causal,
                 q_pos=q_pos, impl=impl, chunk=chunk)
    return _from_local(ol, mesh, q_plc, q.shape)


def _seq_shard_dim(ck):
    """The mesh dim that shards the cache's sequence (dim 1), or None."""
    dt = _dt()
    for mdim, p in enumerate(ck.placements):
        if isinstance(p, dt.Shard) and p.dim == 1:
            return mdim
    return None


def _write(cache_t, new, cache_pos: int, seq_mdim):
    """``new`` (B, Sq, K, dh) into the DTensor cache layer at positions
    cache_pos .. cache_pos + Sq - 1: every rank gets ``new`` in the cache's
    layout with the sequence replicated, and writes the positions its
    shard owns."""
    dt = _dt()
    mesh = cache_t.device_mesh
    plc = [dt.Replicate() if mdim == seq_mdim else p
           for mdim, p in enumerate(cache_t.placements)]
    nl = _to_plain(new.to(cache_t.dtype), plc).to_local()
    cl = cache_t.to_local()
    S_l = cl.shape[1]
    lo = 0 if seq_mdim is None else mesh.get_coordinate()[seq_mdim] * S_l
    a, b = max(cache_pos, lo), min(cache_pos + nl.shape[1], lo + S_l)
    if a < b:
        cl[:, a - lo : b - lo] = nl[:, a - cache_pos : b - cache_pos]


def _flash_decode(q, ck, cv, q_pos, seq_mdim):
    """Attention of q (B, Sq, H, dh) over a cache sharded along the
    sequence on mesh dim ``seq_mdim``, causal at positions ``q_pos`` (None:
    not causal, every key): each rank's partial softmax over its
    positions, the max, sum and weighted values all-reduced over that mesh
    dim; the plain version's arithmetic (float32 logits scaled by
    1/sqrt(dh), masked keys at -1e30).  Serving only: the raw
    all-reduces carry no gradient across ranks."""
    import torch.distributed as dist

    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, ck, cv)):
        raise NotImplementedError(
            "the flash-decode over a sequence-sharded cache has no backward "
            "across ranks; run it under torch.inference_mode()"
        )

    dt = _dt()
    mesh = q.device_mesh
    q_plc = [dt.Replicate() if mdim == seq_mdim else p
             for mdim, p in enumerate(_q_layout(q))]
    q_plc = [dt.Replicate() if isinstance(p, dt.Shard) and p.dim == 2 else p
             for p in q_plc]
    ql = _to_plain(q, q_plc).to_local()
    kl, vl = ck.to_local(), cv.to_local()
    B, Sq, H, dh = ql.shape
    S_l, K = kl.shape[1], kl.shape[2]
    rep = H // K
    lo = mesh.get_coordinate()[seq_mdim] * S_l
    qf = ql.float() / math.sqrt(dh)
    logits = torch.einsum("bqkrd,bskd->bkrqs", qf.reshape(B, Sq, K, rep, dh), kl.float())
    if q_pos is not None:
        kpos = torch.arange(lo, lo + S_l, device=ql.device)
        logits = logits.masked_fill(~(q_pos[:, None] >= kpos[None, :]), -1e30)
    m = logits.amax(dim=-1, keepdim=True)
    group = mesh.get_group(seq_mdim)
    m_all = m.clone()
    dist.all_reduce(m_all, op=dist.ReduceOp.MAX, group=group)
    p = torch.exp(logits - m_all)
    s = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkrqs,bskd->bkrqd", p, vl.float())
    dist.all_reduce(s, group=group)
    dist.all_reduce(o, group=group)
    o = (o / s).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, dh).to(ql.dtype)
    return _from_local(o, mesh, q_plc, q.shape)


def cached_attention(q, k, v, cache: dict, cache_pos: int, impl: str = "xla",
                     chunk: int = 1024, seq_shard: bool = False):
    """``layers.cached_attention`` on a DTensor cache layer (module
    docstring); the same range check."""
    ck, cv = cache["k"], cache["v"]
    Sq, S_max = q.shape[1], ck.shape[1]
    if not 0 <= cache_pos <= S_max - Sq:
        raise ValueError(
            f"cache write at positions {cache_pos}..{cache_pos + Sq - 1} runs "
            f"past the cache of length {S_max}"
        )
    seq_mdim = _seq_shard_dim(ck)
    _write(ck, k, cache_pos, seq_mdim)
    _write(cv, v, cache_pos, seq_mdim)
    if Sq == S_max:
        return sdpa(q, k, v, causal=True, impl=impl, chunk=chunk, seq_shard=seq_shard)
    q_pos = torch.arange(cache_pos, cache_pos + Sq, device=ck.to_local().device)
    if seq_mdim is not None:
        return _flash_decode(q, ck, cv, q_pos, seq_mdim)
    return sdpa(q, ck, cv, causal=True, q_pos=q_pos, impl=impl, chunk=chunk)


def cross_attention(q, ck, cv, impl: str = "xla", chunk: int = 1024):
    """Non-causal attention of DTensor q over a cross-attention source's
    keys and values ``ck`` / ``cv`` (B, S_src, K, dh): over a cache
    sharded along the source, the split softmax on each rank's shard;
    otherwise each rank on its heads (module docstring)."""
    seq_mdim = _seq_shard_dim(ck)
    if seq_mdim is not None:
        return _flash_decode(q, ck, cv, None, seq_mdim)
    return sdpa(q, ck, cv, causal=False, impl=impl, chunk=chunk)
