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
    col_offset: int = 0,
    col_hi: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Vq (S, E_rows, Lq), Vc (S, E_rows, Lc) -> (idx int32, dist
    float32), each (S, len(select_Es), Lq, k).  ``tile_c`` None selects
    over the whole library at once; every width gives the same tables.
    ``col_offset`` / ``col_hi``: the kernel's column range (global ids
    ``col_offset + c``, ids >= ``col_hi`` masked)."""
    Lc = Vc.shape[-1]
    return knn._knn_tables_streaming(
        Vq, Vc, k, exclude_self, Lc if tile_c is None else tile_c,
        tuple(select_Es), dist_dtype, col_offset, col_hi,
    )


def knn_topk_prefix_ref(
    Vq: torch.Tensor,
    Vc: torch.Tensor,
    k: int,
    exclude_self: bool,
    buckets,
    lib_sizes,
    col_ids: torch.Tensor | None = None,
    tile_c: int | None = None,
    dist_dtype="float32",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the knn_topk_prefix kernel: Vq (B, E_rows, Lq),
    Vc (B, E_rows, Lc) -> (idx int32, dist float32), each
    (B, len(lib_sizes), len(buckets), Lq, k).  ``tile_c`` None takes one
    tile per library-size segment; every width gives the same tables."""
    Lc = Vc.shape[-1]
    return knn.knn_tables_prefix_streaming(
        Vq, Vc, k, exclude_self, buckets, lib_sizes,
        Lc if tile_c is None else tile_c, dist_dtype, col_ids,
    )
