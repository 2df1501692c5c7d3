"""``cuda`` engine: the hand-written kernels for CUDA tensors.

kNN tables go through ``kernels/knn_topk`` (the selection set is passed
to the kernel, so E values outside the bucket set only accumulate
distance), the convergence diagnostic's prefix tables through its
``knn_topk_prefix`` kernel, and the batched lookup through
``kernels/ccm_lookup``.  For a
CPU tensor each wrapper runs its plain version; for a CUDA tensor it
launches its kernel or raises.  On the card the kernels take tables of
at most ``MAX_K`` neighbours at any E_max and any series length
(:meth:`CudaEngine.check_limits`).
"""
from __future__ import annotations

import torch

from repro_torch.engine.base import Engine
from repro_torch.kernels.ccm_lookup.ops import ccm_lookup
from repro_torch.kernels.knn_topk.ops import MAX_K, knn_topk, knn_topk_prefix


class CudaEngine(Engine):
    name = "cuda"

    def check_limits(self, cfg, device) -> None:
        """On a card, the widest table of the run (``cfg.k_max``: phase 1
        and the all-E layout; the bucketed and prefix tables are no
        wider) must fit the kernels' MAX_K neighbours; any E_max runs.
        On the CPU the wrappers run the plain versions, which take any
        config."""
        if torch.device("cuda" if device is None else device).type != "cuda":
            return
        if cfg.k_max > MAX_K:
            raise ValueError(
                f"the cuda engine's kernels build tables of at most {MAX_K} "
                f"neighbours; this config needs k={cfg.k_max} at "
                f"E_max={cfg.E_max} (k_override={cfg.k_override}).  Run it "
                "on the CPU (device='cpu', CLI --device cpu) or with "
                "engine='torch-reference'"
            )

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
