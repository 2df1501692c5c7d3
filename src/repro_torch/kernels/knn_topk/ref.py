"""Plain PyTorch version of the knn_topk kernel: the function the kernel
computes, on any device, built from the streaming table functions of
``repro_torch.core.knn`` (stable sorts, no ``torch.topk``)."""
from __future__ import annotations

import torch

from repro_torch.core import knn


def knn_topk_ref(
    Vq: torch.Tensor,
    Vc: torch.Tensor,
    k: int,
    exclude_self: bool,
    select_Es,
    tile_c: int | None = None,
    dist_dtype="float32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Vq (S, E_rows, Lq), Vc (S, E_rows, Lc) -> (idx int32, dist
    float32), each (S, len(select_Es), Lq, k).  ``tile_c`` None selects
    over the whole library at once; every width gives the same tables."""
    Lc = Vc.shape[-1]
    return knn._knn_tables_streaming(
        Vq, Vc, k, exclude_self, Lc if tile_c is None else tile_c,
        tuple(select_Es), dist_dtype,
    )
