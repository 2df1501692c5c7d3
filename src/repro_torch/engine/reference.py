"""``torch-reference`` engine: the plain PyTorch versions on any device
(the CPU or a CUDA card).  kNN tables, prefix tables included, come from
the streaming table functions of ``core/knn.py`` at the resolved tile
width; lookups from the plain ``ccm_lookup`` version."""
from __future__ import annotations

from repro_torch.engine.base import Engine
from repro_torch.kernels.ccm_lookup.ref import ccm_lookup_ref
from repro_torch.kernels.knn_topk.ref import knn_topk_prefix_ref, knn_topk_ref


class ReferenceEngine(Engine):
    name = "torch-reference"

    def _select_tables(self, Vq, Vc, k, exclude_self, select_Es, cfg,
                       col_offset=0, col_hi=None):
        tile = self.knn_selection_tile(Vq.shape[0] * Vq.shape[2], Vc.shape[2], cfg)
        return knn_topk_ref(
            Vq, Vc, k, exclude_self, select_Es, tile_c=tile,
            dist_dtype=cfg.dist_dtype, col_offset=col_offset, col_hi=col_hi,
        )

    def knn_tables_prefix(self, Vq, Vc, k, *, buckets, lib_sizes,
                          exclude_self, cfg, col_ids=None):
        tile = self.knn_selection_tile(Vq.shape[0] * Vq.shape[2], Vc.shape[2], cfg)
        return knn_topk_prefix_ref(
            Vq, Vc, k, exclude_self, buckets, lib_sizes, col_ids=col_ids,
            tile_c=tile, dist_dtype=cfg.dist_dtype,
        )

    def ccm_lookup(self, idx, w, Y_fut, segs):
        return ccm_lookup_ref(idx, w, Y_fut, segs)
