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

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import Linear, _param, linear, rms_norm_scale


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


def _split_in_proj(zxbcdt: torch.Tensor, s: SSMDims):
    di, ds, ng = s.d_inner, s.d_state, s.n_groups
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di : 2 * di + 2 * ng * ds]
    dt = zxbcdt[..., 2 * di + 2 * ng * ds :]
    return z, xBC, dt


def _gated_out(p: Mamba, s: SSMDims, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Gated RMSNorm, then the output projection."""
    return linear(p.out_proj, rms_norm_scale(p.norm_scale, y * F.silu(z)))


def mamba_fwd(p: Mamba, s: SSMDims, u: torch.Tensor, return_state: bool = False):
    """Chunked SSD forward.  u: (B, S, d_model) -> (B, S, d_model); with
    ``return_state`` also the decode state {"conv": the last d_conv - 1 raw
    conv inputs, "ssm": the final state (B, H, P, N) f32}."""
    B, S0, _ = u.shape
    Q = min(s.chunk, S0)
    H, P, N = s.n_heads, s.head_dim, s.d_state

    z, xBC, dt = _split_in_proj(linear(p.in_proj, u), s)
    w = s.d_conv - 1
    tail = F.pad(xBC[:, max(S0 - w, 0):], (0, 0, max(w - S0, 0), 0))
    xBC = F.silu(_causal_conv(xBC, p.conv_w, p.conv_b))

    # pad to a chunk multiple; padded steps get dt = 0 (identity update)
    S = -(-S0 // Q) * Q
    pad = S - S0
    if pad:
        xBC = F.pad(xBC, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    nc = S // Q

    x = xBC[..., : s.d_inner].reshape(B, S, H, P)
    Bm = xBC[..., s.d_inner : s.d_inner + N]  # n_groups 1: shared by the heads
    Cm = xBC[..., s.d_inner + N :]

    dt = F.softplus(dt.float() + p.dt_bias)  # (B, S, H)
    if pad:
        dt = dt * (torch.arange(S, device=u.device) < S0).float()[None, :, None]
    A = -torch.exp(p.A_log)  # (H,)

    # chunk views, heads before steps: (b, c, h, q, ...)
    xc = x.reshape(B, nc, Q, H, P).float().permute(0, 1, 3, 2, 4)  # (b,c,h,j,p)
    Bc = Bm.reshape(B, nc, Q, N).float()
    Cc = Cm.reshape(B, nc, Q, N).float()
    dtc = dt.reshape(B, nc, Q, H).permute(0, 1, 3, 2)  # (b,c,h,q)
    csum = torch.cumsum(dtc * A[:, None], dim=-1)  # inclusive log-decay

    # intra-chunk: decay[b,c,h,t,j] = exp(csum_t - csum_j) for j <= t
    M = csum[..., :, None] - csum[..., None, :]  # (b,c,h,t,j)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=u.device).tril()
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
    S_prev = torch.zeros((B, H, P, N), dtype=torch.float32, device=u.device)
    S_in = []
    for c in range(nc):
        S_in.append(S_prev)  # the state entering chunk c
        S_prev = chunk_decay[:, c, :, None, None] * S_prev + chunk_state[:, c]
    S_in = torch.stack(S_in, 1)  # (b,c,h,p,n)
    y_inter = (S_in @ Cc[:, :, None].transpose(-1, -2)).transpose(-1, -2)  # (b,c,h,q,p)
    y += y_inter * torch.exp(csum)[..., None]

    y = y.permute(0, 1, 3, 2, 4).reshape(B, S, H, P) + p.D[:, None] * x.float()
    y = y.reshape(B, S, s.d_inner)[:, :S0].to(u.dtype)
    out = _gated_out(p, s, y, z)
    if return_state:
        return out, {"conv": tail, "ssm": S_prev}
    return out


def mamba_init_state(s: SSMDims, B: int, dtype, device=None) -> dict:
    return {
        "conv": torch.zeros((B, s.d_conv - 1, s.conv_dim), dtype=dtype, device=device),
        "ssm": torch.zeros((B, s.n_heads, s.head_dim, s.d_state), dtype=torch.float32,
                           device=device),
    }


def mamba_decode_step(p: Mamba, s: SSMDims, u: torch.Tensor, state: dict):
    """One-token decode.  u: (B, 1, d_model) -> (y (B, 1, d_model), the new
    state {"conv", "ssm"}; ``state`` is not written)."""
    B = u.shape[0]
    H, P, N = s.n_heads, s.head_dim, s.d_state
    z, xBC, dt = _split_in_proj(linear(p.in_proj, u), s)
    window = torch.cat([state["conv"], xBC.to(state["conv"].dtype)], dim=1)
    conv_out = (torch.einsum("bwc,wc->bc", window.float(), p.conv_w.float())
                + p.conv_b.float())
    xBC_t = F.silu(conv_out)[:, None].to(u.dtype)  # (B, 1, conv_dim)

    x = xBC_t[..., : s.d_inner].reshape(B, H, P).float()
    Bm = xBC_t[:, 0, s.d_inner : s.d_inner + N].float()
    Cm = xBC_t[:, 0, s.d_inner + N :].float()
    dt = F.softplus(dt[:, 0].float() + p.dt_bias)  # (B, H)
    a = torch.exp(dt * -torch.exp(p.A_log))  # (B, H)

    S_new = (a[:, :, None, None] * state["ssm"]
             + (dt[:, :, None] * x)[..., None] * Bm[:, None, None, :])
    y = (S_new @ Cm[:, None, :, None])[..., 0] + p.D[:, None] * x
    y = y.reshape(B, 1, s.d_inner).to(u.dtype)
    return _gated_out(p, s, y, z), {"conv": window[:, 1:], "ssm": S_new}
