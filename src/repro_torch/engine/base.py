"""Execution-engine interface of the port: the named EDM ops that
dominate runtime — kNN-table construction, simplex forecast and the
batched CCM lookup — behind one interface, as in ``repro.engine``.

Ops take the series batch as a leading tensor dimension (the JAX engines
take one series and are vmapped):

  knn_tables          Vq (S, E_rows, Lq), Vc (S, E_rows, Lc) ->
                      idx, dist (S, E_rows, Lq, k); with col_offset /
                      col_hi, one library shard's (global ids)
  knn_tables_bucketed same, only at the bucket E values ->
                      (S, len(buckets), Lq, k)
  knn_tables_prefix   same, per nested library size ->
                      (S, len(lib_sizes), len(buckets), Lq, k)
  simplex_forecast    idx, w (S, ..., Lq, k), fut_c (S, Lc) -> (S, ..., Lq)
  ccm_lookup          idx, w (S, nb, Lq, k), Y (B, Lp), segs
                      ((table_row, count), ...) -> (S, B, Lq)
"""
from __future__ import annotations

from repro_torch.core import knn


class Engine:
    """Base engine; subclasses implement :meth:`_select_tables` and
    :meth:`ccm_lookup`."""

    #: registry key; subclasses must set this.
    name: str = "base"

    @staticmethod
    def knn_selection_tile(rows: int, Lc: int, cfg) -> int:
        """Candidate-tile width of the plain streaming table functions
        (``cfg.knn_tile_c``; 0 = calibrated).  Invisible in the output."""
        return knn.resolve_stream_tile(rows, Lc, cfg)

    def check_limits(self, cfg, device) -> None:
        """Raise ``ValueError`` where this engine cannot run ``cfg`` on
        ``device`` (None = the card); entry points call it before any
        work.  The plain versions take any config."""

    def _select_tables(self, Vq, Vc, k, exclude_self, select_Es, cfg,
                       col_offset=0, col_hi=None):
        raise NotImplementedError

    def knn_tables(self, Vq, Vc, k, *, exclude_self, cfg, col_offset=0,
                   col_hi=None):
        """kNN tables for every embedding dimension 1..E_rows; with
        ``col_offset`` / ``col_hi`` over one library shard (column c is
        global candidate ``col_offset + c``, ids >= ``col_hi`` masked)."""
        return self._select_tables(
            Vq, Vc, k, exclude_self, tuple(range(1, Vq.shape[1] + 1)), cfg,
            col_offset, col_hi,
        )

    def knn_tables_bucketed(self, Vq, Vc, k, *, buckets, exclude_self, cfg):
        """kNN tables only at the embedding dimensions in ``buckets``
        (ascending, distinct); lags above max(buckets) are never read."""
        return self._select_tables(Vq, Vc, k, exclude_self, tuple(buckets), cfg)

    def knn_tables_prefix(self, Vq, Vc, k, *, buckets, lib_sizes,
                          exclude_self, cfg, col_ids=None):
        """Per-library-size kNN tables of the convergence diagnostic:
        prefixes [0, Ls) of the sweep order ``col_ids`` (None = natural
        order).  Default: the per-size rebuild oracle, one independent
        sweep per size; both engines override it with one sweep."""
        tile = self.knn_selection_tile(Vq.shape[0] * Vq.shape[2], Vc.shape[2], cfg)
        return knn.knn_tables_prefix_rebuild(
            Vq, Vc, k, exclude_self, buckets, lib_sizes, tile,
            dist_dtype=cfg.dist_dtype, col_ids=col_ids,
        )

    def simplex_forecast(self, idx, w, fut_c):
        """Weighted neighbour-future average (paper Alg. 5)."""
        return knn.simplex_forecast(idx, w, fut_c)

    def ccm_lookup(self, idx, w, Y_fut, segs):
        """Batched simplex lookup: bucket segments ``segs`` of the
        targets, each through its own row of every series' table set."""
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<Engine {self.name}>"
