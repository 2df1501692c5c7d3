"""The port's causal-inference pipeline on one device.

  phase 1 (simplex projection): the series in chunks of ``lib_block``,
    each chunk one batched kNN-table build + forecast + rho; optE comes
    back to the host once (N int32 — the one whole-run broadcast).
  phase 2 (CCM): per chunk of ``lib_block`` library series, one kNN
    launch builds every table of the chunk — at the bucket E values
    (bucketed, the default) or at every E (``bucketed=False``) — and the
    targets stream through the segmented lookup.  Untiled
    (``target_tile=0``), a chunk's rho rows are full width and the
    targets' futures live on the device for the whole run; tiled, the
    tables of a chunk serve every column tile of ``target_tile``
    targets, whose futures are uploaded per tile from the host, so the
    device holds O(chunk x buckets x Lp x k + tile x Lp).  Finished
    blocks go through a :class:`ChunkStreamer` (the next one is queued on
    the card while the last is copied out) into the :class:`TileWriter`
    store, which doubles as the resume manifest.  Tiled and untiled maps
    are equal byte for byte.

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
from repro_torch.runtime import integrity
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
        rhos_c, optE_c = simplex.simplex_batch(ts_d[row0 : row0 + cfg.lib_block], cfg)
        rhos_parts.append(rhos_c)
        optE_parts.append(optE_c)
    simplex_rhos = torch.cat(rhos_parts).cpu().numpy()
    optE = torch.cat(optE_parts).cpu().numpy().astype(np.int32)
    return simplex_rhos, optE


def _phase2_untiled(ts_d, ts_fut, optE, cfg, dev):
    """Full-width (chunk, N) rho rows in natural column order:
    ``compute(rows) -> (S, N)``, the targets' futures on the device for
    the whole run."""
    if not cfg.bucketed:
        fut = torch.as_tensor(ts_fut).to(dev)
        return lambda rows: ccm.ccm_block(rows, fut, optE, cfg)
    plan, order = ccm.make_bucket_plan(optE)
    fut_sorted = torch.as_tensor(np.ascontiguousarray(ts_fut[order])).to(dev)
    inv = torch.as_tensor(np.argsort(order)).to(dev)
    return lambda rows: ccm.ccm_block_bucketed(rows, fut_sorted, cfg, plan)[:, inv]


def run_phase2_chunks(
    ts: np.ndarray,
    ts_fut: np.ndarray,
    optE: np.ndarray,
    cfg: EDMConfig,
    chunk_plan: list[tuple[int, int]],
    writer: Optional[TileWriter] = None,
    rho: Optional[np.ndarray] = None,
    progress: bool = False,
    device=None,
    on_chunk=None,
) -> None:
    """Phase 2 over an explicit (row0, nrows) chunk plan, untiled or tiled
    (``cfg.target_tile``), bucketed or all-E (``cfg.bucketed``).  Blocks go
    to ``writer`` or, without one, into the host map ``rho``.  Values do
    not depend on the plan or the tiles: tables are per library row,
    targets per column."""
    dev = check_run(cfg, device)
    N = ts.shape[0]
    ts = np.asarray(ts, np.float32)
    if cfg.target_tile:
        _phase2_tiled(ts, ts_fut, optE, cfg, chunk_plan, writer, rho,
                      progress, dev, on_chunk)
        return
    ts_d = torch.as_tensor(ts).to(dev)
    compute = _phase2_untiled(ts_d, ts_fut, optE, cfg, dev)

    def drain(tag, rho_rows):
        row0, valid = tag
        if writer is not None:
            writer.write_block(row0, rho_rows[:valid])
        else:
            rho[row0 : row0 + valid] = rho_rows[:valid]
        if progress:
            print(f"ccm rows {row0}..{row0 + valid} / {N}")

    with ChunkStreamer(drain, depth=cfg.stream_depth) as streamer:
        for row0, valid in chunk_plan:
            if on_chunk is not None:
                on_chunk(row0)
            streamer.submit((row0, valid), compute(ts_d[row0 : row0 + valid]))


def _phase2_tiled(ts, ts_fut, optE, cfg, chunk_plan, writer, rho, progress,
                  dev, on_chunk):
    """(row-chunk x col-tile) phase 2: tables once per chunk, targets in
    column tiles of ``cfg.target_tile``, blocks streamed with (row0, col0,
    valid) tags.  A chunk's rows and a tile's futures are uploaded when
    they are used, as asynchronous copies from one pinned host copy each
    (the futures in tile order), so the device holds no (N, L) or
    (N, Lp) array.  Bucketed tiles are in the sorted column order
    (``col_order.npy`` in the store), all-E tiles in the natural one."""
    N, T = ts.shape[0], cfg.target_tile
    if cfg.bucketed:
        plan, order = ccm.make_bucket_plan(optE)
        tile_plans = ccm.make_tile_plans(plan, T)
    else:
        order = None
        tile_plans = [(c0, None) for c0 in range(0, N, T)]
        e_idx = optE.astype(np.int64) - 1
    if writer is not None:
        writer.ensure_col_order(order)
    ts_h = upload_source(ts, dev)
    fut_h = upload_source(ts_fut if order is None else ts_fut[order], dev)

    def drain(tag, block):
        row0, col0, valid = tag
        blk = block[:valid]
        last_tile = col0 + blk.shape[1] >= N
        if writer is not None:
            # one manifest commit per row chunk: drains run in order, so
            # when the last tile lands every tile of the chunk is durable
            writer.write_tile(row0, col0, blk, commit=last_tile)
        elif order is not None:
            rho[row0 : row0 + valid][:, order[col0 : col0 + blk.shape[1]]] = blk
        else:
            rho[row0 : row0 + valid, col0 : col0 + blk.shape[1]] = blk
        if progress and last_tile:
            print(f"ccm rows {row0}..{row0 + valid} / {N} (tiles of {T})")

    with ChunkStreamer(drain, depth=cfg.stream_depth) as streamer:
        for row0, valid in chunk_plan:
            if on_chunk is not None:
                on_chunk(row0)
            rows = ts_h[row0 : row0 + valid].to(dev, non_blocking=True)
            if order is not None:
                idx, w = ccm.ccm_row_tables_bucketed(rows, cfg, plan)
            else:
                idx, w = ccm.ccm_row_tables(rows, cfg)
            for c0, seg_plan in tile_plans:
                fut_tile = fut_h[c0 : c0 + T].to(dev, non_blocking=True)
                if order is not None:
                    block = ccm.ccm_block_tile_bucketed(idx, w, fut_tile, cfg,
                                                        seg_plan, c0, N)
                else:
                    block = ccm.ccm_block_tile(idx, w, fut_tile, e_idx[c0 : c0 + T],
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
    run_phase2_chunks(ts, ts_fut, optE, cfg, chunk_plan, writer, rho,
                      progress, dev)
    t2 = _perf()
    if writer is not None:
        rho = writer.assemble(mmap_path=writer.dir / "causal_map" / "data.npy")
    if timings is not None:
        timings.update(phase1_s=t1 - t0, phase2_s=t2 - t1,
                       assemble_s=_perf() - t2)
    return CausalMap(rho=rho, optE=optE, simplex_rho=simplex_rhos)
