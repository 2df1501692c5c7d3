"""Plain PyTorch version of the knn_slab kernel: the dense-slab kNN tables
of the kNN selection bench, on any device."""
from __future__ import annotations

import torch

from repro_torch.core import knn

#: the finite stand-in of a masked column (padding, self), as the TPU
#: kernel's ``_BIG``: masked entries come back with this value and their id
BIG = 3.0e38
#: the library is padded to a multiple of this many columns (the TPU
#: kernel's lane width); padding ids lie in [Lc, Lc_pad)
PAD = 128


def padded_width(Lc: int) -> int:
    return -(-Lc // PAD) * PAD


def check_k(k: int, Lc: int) -> None:
    """k may be anything up to the padded library width (no register list
    bounds it); a larger k names the limit before any work."""
    if not 1 <= k <= padded_width(Lc):
        raise ValueError(
            f"knn_slab: k={k} must be in [1, Lc_pad={padded_width(Lc)}] "
            f"(Lc={Lc} padded to a multiple of {PAD})"
        )


def knn_slab_ref(
    Vq: torch.Tensor, Vc: torch.Tensor, k: int, exclude_self: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """Vq (E_max, Lq), Vc (E_max, Lc) float32 -> (idx int32, dist float32),
    each (E_max, Lq, k).

    The library is zero-padded to Lc_pad columns, one (Lq, Lc_pad) slab
    accumulates the pinned square-then-add (``core/knn.py::_acc_sq``)
    across the lags, and after each lag padding columns and (with
    ``exclude_self``) column q of query row q read ``BIG``; a stable sort
    then keeps the first k.  That is the TPU kernel's k-pass masked
    argmin: every real distance lies below ``BIG``, and a stable sort
    breaks ties to the earliest column, as argmin does.
    """
    E_max, Lq = Vq.shape
    Lc = Vc.shape[1]
    check_k(k, Lc)
    Lc_pad = padded_width(Lc)
    Vc_p = torch.nn.functional.pad(Vc, (0, Lc_pad - Lc))
    col = torch.arange(Lc_pad, device=Vq.device)
    invalid = (col >= Lc)[None, :].expand(Lq, Lc_pad)
    if exclude_self:
        invalid = invalid | (col[None, :] == torch.arange(Lq, device=Vq.device)[:, None])
    D = torch.zeros((1, Lq, Lc_pad), dtype=torch.float32, device=Vq.device)
    idxs, dists = [], []
    for e in range(E_max):
        D = knn._acc_sq(D, Vq[e][None], Vc_p[e][None], torch.float32)
        d_sorted, pos = torch.sort(D[0].masked_fill(invalid, BIG), dim=-1,
                                   stable=True)
        idxs.append(pos[:, :k].to(torch.int32))
        dists.append(d_sorted[:, :k])
    return torch.stack(idxs), torch.stack(dists)
