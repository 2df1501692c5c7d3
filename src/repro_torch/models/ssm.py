"""Mamba2 block: the chunked SSD forward (arXiv:2405.21060) and the
one-token decode step.

The counterpart of the JAX package's ``models/ssm.py``.  The forward
splits the sequence into chunks of Q steps: within a chunk a
decay-masked quadratic term, across chunks a loop over per-chunk
states.  The decode state is the (B, H, P, N) SSM state (float32) and
the (B, d_conv - 1, conv_dim) window of raw conv inputs, independent of
the context length.

Contraction order of the intra-chunk term (JAX writes it as one
four-operand einsum): the decay tensor is built in (b, c, h, q, j)
order, masked before ``exp`` (above the diagonal the exponent is
positive and could overflow), then scaled in place by the C.B scores
and by dt, and contracted with x as one batched product over
(b, c, h).  Its (B, nc, H, Q, Q) float32 is the largest temporary; no
(b, c, q, j, h, p) tensor is built.

One difference from the JAX function: the conv tail of a prompt shorter
than ``d_conv - 1`` steps is its raw rows after zero rows (the state a
zero start leaves), where JAX's slice wraps around and returns a
shorter window that its decode cannot take.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import Linear, _param, as_activation, rms_norm_scale
from repro_torch.sharding.local import Local


@dataclasses.dataclass(frozen=True)
class SSMDims:
    d_model: int
    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128
    n_groups: int = 1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


class Mamba(nn.Module):
    """``in_proj``, ``conv_w`` (d_conv, conv_dim), ``conv_b``, ``A_log``,
    ``D``, ``dt_bias`` (H,) float32 whatever the model's dtype,
    ``norm_scale`` (d_inner,), ``out_proj``."""

    def __init__(self, s: SSMDims, dtype, device):
        super().__init__()
        d_in_proj = 2 * s.d_inner + 2 * s.n_groups * s.d_state + s.n_heads
        self.in_proj = Linear(s.d_model, d_in_proj, dtype, device)
        self.conv_w = _param((s.d_conv, s.conv_dim), dtype, device)
        self.conv_b = _param((s.conv_dim,), dtype, device)
        self.A_log = _param((s.n_heads,), torch.float32, device)
        self.D = _param((s.n_heads,), torch.float32, device)
        self.dt_bias = _param((s.n_heads,), torch.float32, device)
        self.norm_scale = _param((s.d_inner,), dtype, device)
        self.out_proj = Linear(s.d_inner, s.d_model, dtype, device)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C), window d_conv (unrolled shifts)."""
    d_conv, S = w.shape[0], x.shape[1]
    y = x * w[-1]
    for i in range(1, d_conv):
        shifted = F.pad(x, (0, 0, i, 0))[:, :S]
        y = y + shifted * w[d_conv - 1 - i]
    return y + b


@dataclasses.dataclass
class _Heads:
    """A rank's share of a Mamba2 block (``sharding/local.py``): its heads
    h0 .. h0 + H_l - 1 and the local tensors it computes them with.
    ``cols``: its in_proj columns (z and x of its heads, all of B and C,
    its dt), ``ch``: its conv channels (x of its heads, B, C); None on one
    device, where they are every column and channel."""

    lc: Local
    h0: int
    H_l: int
    in_w: torch.Tensor
    conv_w: torch.Tensor
    conv_b: torch.Tensor
    A_log: torch.Tensor
    D: torch.Tensor
    dt_bias: torch.Tensor
    norm_scale: torch.Tensor
    out_w: torch.Tensor
    ch: Optional[torch.Tensor] = None


def _heads(p: Mamba, s: SSMDims, u: torch.Tensor) -> _Heads:
    """The rank's heads and local tensors.  On a DTensor u the heads are
    split on "model" where its size divides them (the ``ssm`` cache's
    layout), else every rank computes all of them.  in_proj's column shard
    cuts across the z / x / B / C / dt segments and the conv channel shard
    across the heads, so both weights are gathered and sliced; out_proj's
    row shard is the rank's heads' rows, used as it is."""
    H, P = s.n_heads, s.head_dim
    mesh = getattr(u, "device_mesh", None)
    split = (mesh is not None and "model" in mesh.mesh_dim_names
             and H % mesh.size(mesh.mesh_dim_names.index("model")) == 0)
    lc = Local(u, split=split)
    if not lc.sharded:
        return _Heads(lc, 0, H, p.in_proj.w, p.conv_w, p.conv_b, p.A_log, p.D,
                      p.dt_bias, p.norm_scale, p.out_proj.w)
    j, n = lc.split_rank()
    H_l = H // n
    h0 = j * H_l
    di, N = s.d_inner, s.n_groups * s.d_state
    dev = u.device
    rows = torch.arange(h0 * P, (h0 + H_l) * P, device=dev)
    ch = torch.cat([rows, di + torch.arange(2 * N, device=dev)])
    cols = torch.cat([rows, di + ch, 2 * di + 2 * N + torch.arange(h0, h0 + H_l, device=dev)])
    heads = slice(h0, h0 + H_l)
    out_plc = lc.param(p.out_proj.w, keep_shard=True)
    out_w = out_plc if out_plc.shape[0] == H_l * P else out_plc[h0 * P : (h0 + H_l) * P]
    return _Heads(
        lc, h0, H_l, lc.param(p.in_proj.w, keep_shard=False)[:, cols],
        lc.param(p.conv_w, keep_shard=False)[:, ch],
        lc.param(p.conv_b, keep_shard=False)[ch],
        lc.param(p.A_log)[heads], lc.param(p.D)[heads], lc.param(p.dt_bias)[heads],
        lc.param(p.norm_scale)[h0 * P : (h0 + H_l) * P], out_w, ch)


def _split_in_proj(zxbcdt: torch.Tensor, s: SSMDims, H_l: int):
    """z, xBC, dt of the in_proj output of ``H_l`` heads."""
    di, ds, ng = H_l * s.head_dim, s.d_state, s.n_groups
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di : 2 * di + 2 * ng * ds]
    dt = zxbcdt[..., 2 * di + 2 * ng * ds :]
    return z, xBC, dt


def _gated_out(hd: _Heads, s: SSMDims, y: torch.Tensor, z: torch.Tensor, shape):
    """Gated RMSNorm over the whole d_inner (a rank's sum of squares summed
    over the split heads), then the output projection (a partial sum over
    them, reduced into the activation layout)."""
    lc = hd.lc
    yz = y * F.silu(z)
    if lc.sharded:
        xf = yz.float()
        var = lc.sum_split(xf.square().sum(-1, keepdim=True)) / s.d_inner
        yz = (xf * torch.rsqrt(var + 1e-5) * hd.norm_scale.float()).to(yz.dtype)
    else:
        yz = rms_norm_scale(hd.norm_scale, yz)
    return as_activation(lc.out(yz @ hd.out_w, shape))


def _conv_tail_state(hd: _Heads, s: SSMDims, tail: torch.Tensor) -> torch.Tensor:
    """A rank's raw conv rows (its channels) -> every channel's: x of the
    split heads gathered, then B and C."""
    if not hd.lc.sharded:
        return tail
    x = hd.lc.gather_split(tail[..., : hd.H_l * s.head_dim].contiguous(), 2)
    return torch.cat([x, tail[..., hd.H_l * s.head_dim :]], dim=-1)


def mamba_fwd(p: Mamba, s: SSMDims, u: torch.Tensor, return_state: bool = False):
    """Chunked SSD forward.  u: (B, S, d_model) -> (B, S, d_model); with
    ``return_state`` also the decode state {"conv": the last d_conv - 1 raw
    conv inputs, "ssm": the final state (B, H, P, N) f32} (on a DTensor u,
    DTensors: the heads on "model" where they are split, every conv
    channel on every rank)."""
    hd = _heads(p, s, u)
    ul = hd.lc.x_local(u)
    B, S0, _ = ul.shape
    Q = min(s.chunk, S0)
    H, P, N = hd.H_l, s.head_dim, s.d_state
    d_x = H * P

    z, xBC, dt = _split_in_proj(ul @ hd.in_w, s, H)
    w = s.d_conv - 1
    tail = F.pad(xBC[:, max(S0 - w, 0):], (0, 0, max(w - S0, 0), 0))
    xBC = F.silu(_causal_conv(xBC, hd.conv_w, hd.conv_b))

    # pad to a chunk multiple; padded steps get dt = 0 (identity update)
    S = -(-S0 // Q) * Q
    pad = S - S0
    if pad:
        xBC = F.pad(xBC, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc = S // Q

    x = xBC[..., :d_x].reshape(B, S, H, P)
    Bm = xBC[..., d_x : d_x + N]  # n_groups 1: shared by the heads
    Cm = xBC[..., d_x + N :]

    dt = F.softplus(dt.float() + hd.dt_bias)  # (B, S, H)
    if pad:
        dt = dt * (torch.arange(S, device=ul.device) < S0).float()[None, :, None]
    A = -torch.exp(hd.A_log)  # (H,)

    # chunk views, heads before steps: (b, c, h, q, ...)
    xc = x.reshape(B, nc, Q, H, P).float().permute(0, 1, 3, 2, 4)  # (b,c,h,j,p)
    Bc = Bm.reshape(B, nc, Q, N).float()
    Cc = Cm.reshape(B, nc, Q, N).float()
    dtc = dt.reshape(B, nc, Q, H).permute(0, 1, 3, 2)  # (b,c,h,q)
    csum = torch.cumsum(dtc * A[:, None], dim=-1)  # inclusive log-decay

    # intra-chunk: decay[b,c,h,t,j] = exp(csum_t - csum_j) for j <= t
    M = csum[..., :, None] - csum[..., None, :]  # (b,c,h,t,j)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=ul.device).tril()
    scores = (Cc @ Bc.transpose(-1, -2))[:, :, None]  # (b,c,1,t,j)
    if torch.is_grad_enabled():  # autograd keeps exp's output: no in-place
        M = torch.exp(M.masked_fill(~tri, -1e30)) * scores * dtc[..., None, :]
    else:  # the same terms in place (serving: one (b,c,h,Q,Q) buffer)
        M.masked_fill_(~tri, -1e30).exp_()
        M.mul_(scores)
        M.mul_(dtc[..., None, :])  # dt_j
    y = M @ xc  # (b,c,h,q,p)
    del M

    # inter-chunk: a loop over per-chunk states
    decay_to_end = torch.exp(csum[..., -1:] - csum)  # (b,c,h,j)
    chunk_state = (xc * (dtc * decay_to_end)[..., None]).transpose(-1, -2) @ Bc[:, :, None]
    chunk_decay = torch.exp(csum[..., -1])  # (b,c,h)
    S_prev = torch.zeros((B, H, P, N), dtype=torch.float32, device=ul.device)
    S_in = []
    for c in range(nc):
        S_in.append(S_prev)  # the state entering chunk c
        S_prev = chunk_decay[:, c, :, None, None] * S_prev + chunk_state[:, c]
    S_in = torch.stack(S_in, 1)  # (b,c,h,p,n)
    y_inter = (S_in @ Cc[:, :, None].transpose(-1, -2)).transpose(-1, -2)  # (b,c,h,q,p)
    y += y_inter * torch.exp(csum)[..., None]

    y = y.permute(0, 1, 3, 2, 4).reshape(B, S, H, P) + hd.D[:, None] * x.float()
    y = y.reshape(B, S, d_x)[:, :S0].to(ul.dtype)
    out = _gated_out(hd, s, y, z, u.shape)
    if return_state:
        lc = hd.lc
        return out, {"conv": lc.state(_conv_tail_state(hd, s, tail)),
                     "ssm": lc.state(S_prev, 1)}
    return out


def mamba_init_state(s: SSMDims, B: int, dtype, device=None) -> dict:
    return {
        "conv": torch.zeros((B, s.d_conv - 1, s.conv_dim), dtype=dtype, device=device),
        "ssm": torch.zeros((B, s.n_heads, s.head_dim, s.d_state), dtype=torch.float32,
                           device=device),
    }


def mamba_decode_step(p: Mamba, s: SSMDims, u: torch.Tensor, state: dict):
    """One-token decode.  u: (B, 1, d_model) -> (y (B, 1, d_model), the new
    state {"conv", "ssm"}; ``state`` is not written).  On a DTensor u the
    state's DTensors are read in any layout and the new state is
    ``mamba_fwd``'s."""
    hd = _heads(p, s, u)
    lc = hd.lc
    ul = lc.x_local(u)
    B = ul.shape[0]
    H, P, N = hd.H_l, s.head_dim, s.d_state
    d_x = H * P
    conv = lc.local_state(state["conv"])  # every channel
    ssm = lc.local_state(state["ssm"], 1)  # the rank's heads
    z, xBC, dt = _split_in_proj(ul @ hd.in_w, s, H)
    xBC = xBC.to(conv.dtype)
    window = torch.cat([conv if hd.ch is None else conv[..., hd.ch], xBC], dim=1)
    conv_out = (torch.einsum("bwc,wc->bc", window.float(), hd.conv_w.float())
                + hd.conv_b.float())
    xBC_t = F.silu(conv_out)[:, None].to(ul.dtype)  # (B, 1, conv channels)

    x = xBC_t[..., :d_x].reshape(B, H, P).float()
    Bm = xBC_t[:, 0, d_x : d_x + N].float()
    Cm = xBC_t[:, 0, d_x + N :].float()
    dt = F.softplus(dt[:, 0].float() + hd.dt_bias)  # (B, H)
    a = torch.exp(dt * -torch.exp(hd.A_log))  # (B, H)

    S_new = (a[:, :, None, None] * ssm
             + (dt[:, :, None] * x)[..., None] * Bm[:, None, None, :])
    y = (S_new @ Cm[:, None, :, None])[..., 0] + hd.D[:, None] * x
    y = y.reshape(B, 1, d_x).to(ul.dtype)
    new_conv = torch.cat([conv[:, 1:], _conv_tail_state(hd, s, xBC)], dim=1)
    return (_gated_out(hd, s, y, z, u.shape),
            {"conv": lc.state(new_conv), "ssm": lc.state(S_new, 1)})
