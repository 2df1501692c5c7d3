"""The port's causal-inference pipeline on one device.

  phase 1 (simplex projection): the series in chunks of ``lib_block``,
    each chunk one batched kNN-table build + forecast + rho; optE comes
    back to the host once (N int32 — the one whole-run broadcast).
  phase 2 (CCM, bucketed, untiled): targets grouped by optE; per chunk
    of ``lib_block`` library series, one kNN launch builds every table of
    the chunk at the bucket E values, then each bucket segment of targets
    streams through the lookup.  Finished (chunk, N) row blocks go
    through a :class:`ChunkStreamer` (the next chunk is queued on the
    card while the last one is copied out) into the :class:`TileWriter`
    store, which doubles as the resume manifest.

Entry points run on the card unless the caller passes ``device="cpu"``;
without a card they raise (``runtime/device.py``).  Splitting chunks
across several local cards is not ported yet.
"""
from __future__ import annotations

from time import perf_counter as _perf
from typing import Optional

import numpy as np
import torch

from repro_torch.core import ccm, simplex
from repro_torch.core.types import CausalMap, EDMConfig
from repro_torch.data.store import TileWriter
from repro_torch.runtime import integrity
from repro_torch.runtime.device import resolve_device
from repro_torch.runtime.stream import ChunkStreamer


def _check_main_path(cfg: EDMConfig) -> None:
    if cfg.target_tile or not cfg.bucketed:
        raise NotImplementedError(
            "the port runs the bucketed, untiled phase 2 only "
            "(target_tile=0, bucketed=True)"
        )


def run_phase1(
    ts: np.ndarray, cfg: EDMConfig, device=None, on_chunk=None
) -> tuple[np.ndarray, np.ndarray]:
    """Phase 1 alone: (simplex_rhos (N, E_max) float32, optE (N,) int32).
    ``on_chunk(row0)`` fires before each chunk."""
    dev = resolve_device(device)
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
    """Phase 2 over an explicit (row0, nrows) chunk plan.  Blocks go to
    ``writer`` or, without one, into the host map ``rho``.  Values do not
    depend on the plan: tables are per library row, targets per column."""
    _check_main_path(cfg)
    dev = resolve_device(device)
    N = ts.shape[0]
    plan, order = ccm.make_bucket_plan(optE)
    fut_sorted = torch.as_tensor(np.ascontiguousarray(ts_fut[order])).to(dev)
    inv = torch.as_tensor(np.argsort(order)).to(dev)
    ts_d = torch.as_tensor(np.asarray(ts, np.float32)).to(dev)

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
            rho_sorted = ccm.ccm_block_bucketed(
                ts_d[row0 : row0 + valid], fut_sorted, cfg, plan
            )
            streamer.submit((row0, valid), rho_sorted[:, inv])


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
    ``timings``, when given, receives phase1_s / phase2_s / assemble_s."""
    _check_main_path(cfg)
    dev = resolve_device(device)
    ts = np.asarray(ts, np.float32)
    N = ts.shape[0]
    if out_dir is not None:
        integrity.stamp_fingerprint(out_dir, integrity.fingerprint_of(ts, cfg))
        if TileWriter(out_dir, N).has_tiles:
            raise ValueError(
                f"{out_dir} holds column tiles (a --target-tile store); the "
                "port's phase 2 writes and resumes full-width row blocks only"
            )

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
