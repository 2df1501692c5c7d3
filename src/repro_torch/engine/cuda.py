"""``cuda`` engine: the hand-written kernels for CUDA tensors.

kNN tables go through ``kernels/knn_topk`` (the selection set is passed
to the kernel, so E values outside the bucket set only accumulate
distance), the convergence diagnostic's prefix tables through its
``knn_topk_prefix`` kernel, and the batched lookup through
``kernels/ccm_lookup``.  For a CPU tensor each wrapper runs its plain
version; for a CUDA tensor it launches its kernel or raises.  The card
takes any config the CPU takes: any E_max, any series length and tables
of any width (past 128 neighbours the kNN kernels' key-select route), so
the engine keeps the base class's :meth:`Engine.check_limits`, which
refuses nothing.
"""
from __future__ import annotations

from repro_torch.engine.base import Engine
from repro_torch.kernels.ccm_lookup.ops import ccm_lookup
from repro_torch.kernels.knn_topk.ops import knn_topk, knn_topk_prefix


class CudaEngine(Engine):
    name = "cuda"

    def _select_tables(self, Vq, Vc, k, exclude_self, select_Es, cfg,
                       col_offset=0, col_hi=None):
        return knn_topk(
            Vq.contiguous(), Vc.contiguous(), k, exclude_self, select_Es,
            dist_dtype=cfg.dist_dtype, col_offset=col_offset, col_hi=col_hi,
        )

    def knn_tables_prefix(self, Vq, Vc, k, *, buckets, lib_sizes,
                          exclude_self, cfg, col_ids=None):
        return knn_topk_prefix(
            Vq.contiguous(), Vc.contiguous(), k, exclude_self, buckets,
            lib_sizes, col_ids=col_ids, dist_dtype=cfg.dist_dtype,
        )

    def ccm_lookup(self, idx, w, Y_fut, segs):
        return ccm_lookup(idx.contiguous(), w.contiguous(), Y_fut.contiguous(),
                          segs)
