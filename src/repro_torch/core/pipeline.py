"""The port's causal-inference pipeline on one device.

  phase 1 (simplex projection): the series in chunks of ``lib_block``,
    each chunk one batched kNN-table build + forecast + rho; optE comes
    back to the host once (N int32 — the one whole-run broadcast).
  phase 2 (CCM, :class:`Phase2Runner`): per chunk of ``lib_block``
    library series, one kNN launch builds every table of the chunk — at
    the bucket E values (bucketed, the default) or at every E
    (``bucketed=False``) — and the targets stream through the segmented
    lookup.  Untiled (``target_tile=0``), a chunk's rho rows are full
    width and the targets' futures live on the device for the whole
    run; tiled, the tables of a chunk serve every column tile of
    ``target_tile`` targets, whose futures are uploaded per tile from
    the host, so the device holds O(chunk x buckets x Lp x k + tile x
    Lp).  Finished blocks go through a :class:`ChunkStreamer` (the next
    one is queued on the card while the last is copied out) into the
    :class:`TileWriter` store, which doubles as the resume manifest.
    Tiled and untiled maps are equal byte for byte.

Entry points run on the card unless the caller passes ``device="cpu"``;
without a card they raise (``runtime/device.py``).  Splitting chunks
across several local cards is not ported yet.
"""
from __future__ import annotations

from time import perf_counter as _perf
from typing import Optional

import numpy as np
import torch

from repro_torch import engine as engines
from repro_torch.core import ccm, simplex
from repro_torch.core.types import CausalMap, EDMConfig
from repro_torch.data.store import TileWriter
from repro_torch.runtime import integrity, telemetry
from repro_torch.runtime.device import resolve_device
from repro_torch.runtime.stream import ChunkStreamer, upload_source


def check_run(cfg: EDMConfig, device=None) -> torch.device:
    """The run's device (:func:`resolve_device`), after the engine's
    limits for it are checked — before any work."""
    engines.get_engine(cfg.engine).check_limits(cfg, device)
    return resolve_device(device)


def run_phase1(
    ts: np.ndarray, cfg: EDMConfig, device=None, on_chunk=None
) -> tuple[np.ndarray, np.ndarray]:
    """Phase 1 alone: (simplex_rhos (N, E_max) float32, optE (N,) int32).
    ``on_chunk(row0)`` fires before each chunk."""
    dev = check_run(cfg, device)
    ts_d = torch.as_tensor(np.asarray(ts, np.float32)).to(dev)
    rhos_parts, optE_parts = [], []
    for row0 in range(0, ts_d.shape[0], cfg.lib_block):
        if on_chunk is not None:
            on_chunk(row0)
        with telemetry.span("phase1", "chunk", row0=row0,
                            chunk_rows=cfg.lib_block):
            rhos_c, optE_c = simplex.simplex_batch(
                ts_d[row0 : row0 + cfg.lib_block], cfg)
        rhos_parts.append(rhos_c)
        optE_parts.append(optE_c)
    simplex_rhos = torch.cat(rhos_parts).cpu().numpy()
    optE = torch.cat(optE_parts).cpu().numpy().astype(np.int32)
    return simplex_rhos, optE


class Phase2Runner:
    """Phase 2 over any (row0, nrows) chunk plans, untiled or tiled
    (``cfg.target_tile``), bucketed or all-E (``cfg.bucketed``), its
    per-run state set up once: the bucket plan and, untiled, the
    targets' futures on the device; tiled, pinned host copies of the
    series and of the futures (in tile order), from which a chunk's rows
    and a tile's futures are uploaded when used, so the device holds no
    (N, L) or (N, Lp) array.  A fleet worker keeps one runner and calls
    :meth:`run` per claimed unit.  Values do not depend on the plan or
    the tiles: tables are per library row, targets per column."""

    def __init__(self, ts: np.ndarray, ts_fut: np.ndarray, optE: np.ndarray,
                 cfg: EDMConfig, device=None):
        self.dev = dev = check_run(cfg, device)
        self.cfg = cfg
        ts = np.asarray(ts, np.float32)
        self.N = N = ts.shape[0]
        self.optE = np.asarray(optE)
        self.order = self.plan = None
        if cfg.bucketed:
            self.plan, self.order = ccm.make_bucket_plan(self.optE)
        fut = ts_fut if self.order is None else ts_fut[self.order]
        if cfg.target_tile:
            T = cfg.target_tile
            self.tile_plans = (
                ccm.make_tile_plans(self.plan, T) if cfg.bucketed
                else [(c0, None) for c0 in range(0, N, T)]
            )
            self.ts_h = upload_source(ts, dev)
            self.fut_h = upload_source(fut, dev)
            return
        self.ts_d = torch.as_tensor(ts).to(dev)
        self.fut_d = torch.as_tensor(np.ascontiguousarray(fut)).to(dev)
        if cfg.bucketed:
            self.inv = torch.as_tensor(np.argsort(self.order)).to(dev)

    def _rows_untiled(self, rows: torch.Tensor) -> torch.Tensor:
        """Full-width (S, N) rho rows in natural column order."""
        if not self.cfg.bucketed:
            return ccm.ccm_block(rows, self.fut_d, self.optE, self.cfg)
        return ccm.ccm_block_bucketed(rows, self.fut_d, self.cfg,
                                      self.plan)[:, self.inv]

    def run(self, chunk_plan: list[tuple[int, int]],
            writer: Optional[TileWriter] = None,
            rho: Optional[np.ndarray] = None, progress: bool = False,
            on_chunk=None) -> None:
        """Compute the chunks; blocks go to ``writer`` or, without one,
        into the host map ``rho``.  Returns once every block is drained
        (and, with a writer, committed to its manifest).  ``on_chunk(row0)``
        fires before each chunk."""
        if self.cfg.target_tile:
            self._run_tiled(chunk_plan, writer, rho, progress, on_chunk)
            return
        N = self.N

        def drain(tag, rho_rows):
            row0, valid = tag
            if writer is not None:
                writer.write_block(row0, rho_rows[:valid])
            else:
                rho[row0 : row0 + valid] = rho_rows[:valid]
            if progress:
                print(f"ccm rows {row0}..{row0 + valid} / {N}")

        with ChunkStreamer(drain, depth=self.cfg.stream_depth,
                           stage="phase2") as streamer:
            for row0, valid in chunk_plan:
                if on_chunk is not None:
                    on_chunk(row0)
                with telemetry.span("phase2", "chunk", row0=row0, rows=valid,
                                    tiled=False):
                    block = self._rows_untiled(self.ts_d[row0 : row0 + valid])
                streamer.submit((row0, valid), block)

    def _run_tiled(self, chunk_plan, writer, rho, progress, on_chunk):
        """(row-chunk x col-tile) phase 2: tables once per chunk, targets
        in column tiles of ``cfg.target_tile``, blocks streamed with (row0,
        col0, valid) tags.  Bucketed tiles are in the sorted column order
        (``col_order.npy`` in the store), all-E tiles in the natural one."""
        cfg, dev, N, order = self.cfg, self.dev, self.N, self.order
        T = cfg.target_tile
        if writer is not None:
            writer.ensure_col_order(order)

        def drain(tag, block):
            row0, col0, valid = tag
            blk = block[:valid]
            last_tile = col0 + blk.shape[1] >= N
            if writer is not None:
                # one manifest commit per row chunk: drains run in order,
                # so when the last tile lands every tile of the chunk is
                # durable
                writer.write_tile(row0, col0, blk, commit=last_tile)
            elif order is not None:
                rho[row0 : row0 + valid][:, order[col0 : col0 + blk.shape[1]]] = blk
            else:
                rho[row0 : row0 + valid, col0 : col0 + blk.shape[1]] = blk
            if progress and last_tile:
                print(f"ccm rows {row0}..{row0 + valid} / {N} (tiles of {T})")

        with ChunkStreamer(drain, depth=cfg.stream_depth,
                           stage="phase2") as streamer:
            for row0, valid in chunk_plan:
                if on_chunk is not None:
                    on_chunk(row0)
                with telemetry.span("phase2", "chunk", row0=row0, rows=valid,
                                    tiled=True, tile=T,
                                    n_tiles=len(self.tile_plans)):
                    with telemetry.span("phase2", "device_put", row0=row0):
                        rows = self.ts_h[row0 : row0 + valid].to(
                            dev, non_blocking=True)
                    if order is not None:
                        idx, w = ccm.ccm_row_tables_bucketed(rows, cfg, self.plan)
                    else:
                        idx, w = ccm.ccm_row_tables(rows, cfg)
                    for c0, seg_plan in self.tile_plans:
                        fut_tile = self.fut_h[c0 : c0 + T].to(dev,
                                                               non_blocking=True)
                        if order is not None:
                            block = ccm.ccm_block_tile_bucketed(
                                idx, w, fut_tile, cfg, seg_plan, c0, N)
                        else:
                            block = ccm.ccm_block_tile(
                                idx, w, fut_tile, self.optE[c0 : c0 + T] - 1,
                                cfg, c0, N)
                        streamer.submit((row0, c0, valid), block)
        if writer is not None:
            writer.commit()  # no deferred entry is left behind


def run_causal_inference(
    ts: np.ndarray,
    cfg: EDMConfig,
    device=None,
    out_dir: Optional[str] = None,
    progress: bool = False,
    timings: Optional[dict] = None,
) -> CausalMap:
    """Full pipeline on one device (the card unless ``device="cpu"``).

    With ``out_dir`` the phase-2 blocks stream to a :class:`TileWriter`
    and the returned map is a memmap at <out_dir>/causal_map/data.npy;
    the store is fingerprint-stamped first and checked on every resume.
    A resume may change ``lib_block`` and ``target_tile``: only rows the
    store does not cover are recomputed.  ``timings``, when given,
    receives phase1_s / phase2_s / assemble_s."""
    dev = check_run(cfg, device)
    ts = np.asarray(ts, np.float32)
    N = ts.shape[0]
    if out_dir is not None:
        integrity.stamp_fingerprint(out_dir, integrity.fingerprint_of(ts, cfg))

    t0 = _perf()
    simplex_rhos, optE = run_phase1(ts, cfg, dev)
    t1 = _perf()

    ts_fut = ccm.all_futures(torch.as_tensor(ts), cfg).numpy()
    writer = TileWriter(out_dir, N) if out_dir else None
    rho = None if writer is not None else np.zeros((N, N), np.float32)
    if writer is not None:
        chunk_plan = writer.chunk_plan(cfg.lib_block)
    else:
        chunk_plan = [(r, min(cfg.lib_block, N - r)) for r in range(0, N, cfg.lib_block)]
    Phase2Runner(ts, ts_fut, optE, cfg, dev).run(chunk_plan, writer, rho,
                                                 progress)
    t2 = _perf()
    if writer is not None:
        rho = writer.assemble(mmap_path=writer.dir / "causal_map" / "data.npy")
    if timings is not None:
        timings.update(phase1_s=t1 - t0, phase2_s=t2 - t1,
                       assemble_s=_perf() - t2)
    return CausalMap(rho=rho, optE=optE, simplex_rho=simplex_rhos)
