"""The port's causal-inference pipeline over the run's device slots.

  phase 1 (simplex projection): the series in chunks of ``D x lib_block``
    (D device slots, :func:`repro_torch.runtime.platform.local_devices`),
    slot d taking rows ``[row0 + d * lib_block, ...)``; each slot's rows
    one batched kNN-table build + forecast + rho on its device; optE comes
    back to the host once (N int32 — the one whole-run broadcast).
  phase 2 (CCM, :class:`Phase2Runner`): per chunk, split across the slots
    the same way, each slot's library series build every table in one
    kNN launch — at the bucket E values (bucketed, the default) or at
    every E (``bucketed=False``) — and the targets stream through the
    segmented lookup.  Untiled (``target_tile=0``), a chunk's rho rows
    are full width and the targets' futures live on every device for
    the whole run; tiled, the tables of a chunk serve every column tile
    of ``target_tile`` targets, whose futures are uploaded per tile from
    the host, so each device holds O(lib_block x buckets x Lp x k + tile
    x Lp).  Every slot's block of a chunk is dispatched before any is
    drained; the parts go through one :class:`ChunkStreamer` (the next
    chunk is queued on the cards while the last is copied out) into the
    :class:`TileWriter` store, in row order, which doubles as the resume
    manifest.  The map is the same byte for byte for any device count,
    tiled or untiled, and a resume may change the device count.
  rows across ranks (``group``, ``runtime/ranks.py``): W processes of n
    slots each split every chunk of ``W x n x lib_block`` rows as the
    JAX package's global mesh does, rank r taking global slots ``r*n ..
    r*n + n - 1`` (:func:`rank_plan`); optE is gathered to every rank
    after phase 1, each rank writes its own manifest shard, and rank 0
    alone writes the store's shared files.  The bytes equal one
    process's for any world size, and a resume may change it.
  library-sharded kNN (:func:`knn_tables_library_sharded`): the
    candidate axis cut into contiguous shards, one a device slot or a
    rank of a ``torch.distributed`` group, merged to the unsharded table
    bit for bit (the JAX package's DESIGN.md SS8 / SS14).

Entry points run on every visible card unless the caller passes
``device="cpu"`` (or a device list); without a card they raise
(``runtime/device.py``).
"""
from __future__ import annotations

from time import perf_counter as _perf
from typing import Optional

import numpy as np
import torch

from repro_torch import engine as engines
from repro_torch.core import ccm, knn, simplex
from repro_torch.core.types import CausalMap, EDMConfig
from repro_torch.data.store import TileWriter
from repro_torch.runtime import integrity, telemetry
from repro_torch.runtime.platform import local_devices
from repro_torch.runtime.ranks import Ranks
from repro_torch.runtime.stream import ChunkStreamer, upload_source


def check_run(cfg: EDMConfig, device=None) -> list[torch.device]:
    """The run's device slots (:func:`local_devices`: ``device`` a device,
    a name or a list), after the engine's limits are checked for each
    device asked for — before any work, and before a card is looked for."""
    eng = engines.get_engine(cfg.engine)
    for d in device if isinstance(device, (list, tuple)) else [device]:
        eng.check_limits(cfg, d)
    return local_devices(device)


def slot_spans(row0: int, valid: int, n_slots: int,
               lib_block: int) -> list[tuple[int, int, int]]:
    """(slot, r0, r1) of a chunk's rows [row0, row0 + valid): slot d takes
    ``h`` rows from ``row0 + d * h``, h = lib_block for a chunk of at most
    ``n_slots x lib_block`` rows (the JAX mesh's split), larger for a
    larger one; slots past the rows get none."""
    h = max(lib_block, -(-valid // n_slots))
    return [(d, row0 + d * h, row0 + min((d + 1) * h, valid))
            for d in range(n_slots) if d * h < valid]


def _on_each(devs, make) -> dict:
    """{device: make(device)} over the distinct devices of ``devs``: slots
    on one device share its state."""
    return {d: make(d) for d in dict.fromkeys(devs)}


def _host_in_row_order(parts) -> list[np.ndarray]:
    """Parts (device, tensor, ...) in row order -> host arrays, each the
    rows of every part in that order; one copy per device."""
    by_dev: dict = {}
    for dev, *ts in parts:
        by_dev.setdefault(dev, []).append(ts)
    host = {dev: [torch.cat(col).cpu() for col in zip(*lst)]
            for dev, lst in by_dev.items()}
    at = dict.fromkeys(host, 0)
    out = [[] for _ in parts[0][1:]]
    for dev, *ts in parts:
        n = ts[0].shape[0]
        for j, h in enumerate(host[dev]):
            out[j].append(h[at[dev] : at[dev] + n])
        at[dev] += n
    return [torch.cat(o).numpy() for o in out]


def rank_shares(chunk_plan, n_local: int, lib_block: int, rank: int = 0,
                world: int = 1) -> list[tuple[int, int, int]]:
    """This rank's share of each (row0, valid) chunk of a plan made for a
    world of ``world`` ranks of ``n_local`` slots each (chunks of at most
    ``world x n_local x lib_block`` rows): the rows of global slots
    ``rank * n_local .. (rank + 1) * n_local - 1`` (:func:`slot_spans`
    over the world's slots, process-major as the JAX package's global
    mesh), one contiguous (row0, nrows, valid) a chunk — ``valid`` the
    world's chunk's rows —, chunks where the rank has no rows left out.
    A share splits over the rank's own slots as the world split it."""
    out = []
    for row0, valid in chunk_plan:
        mine = [(r0, r1) for d, r0, r1 in
                slot_spans(row0, valid, world * n_local, lib_block)
                if rank * n_local <= d < (rank + 1) * n_local]
        if mine:
            out.append((mine[0][0], mine[-1][1] - mine[0][0], valid))
    return out


def rank_plan(chunk_plan, n_local: int, lib_block: int, rank: int = 0,
              world: int = 1) -> list[tuple[int, int]]:
    """This rank's (row0, nrows) share of each chunk (:func:`rank_shares`)."""
    return [(r0, n) for r0, n, _ in
            rank_shares(chunk_plan, n_local, lib_block, rank, world)]


def _spans(plan) -> list[tuple[int, int]]:
    return [(r0, r0 + n) for r0, n in plan]


def chunk_checks(ranks: Ranks, chunk_plan, n_local: int, lib_block: int,
                 what: str):
    """``ranks.chunk_checks`` over the chunks of ``chunk_plan`` that every
    rank has a share of (:func:`rank_plan`): an ``on_chunk`` hook that
    meets the ranks within the stage, or None for one process."""
    if ranks.world == 1:
        return None
    return ranks.chunk_checks(min(
        len(rank_plan(chunk_plan, n_local, lib_block, r, ranks.world))
        for r in range(ranks.world)), what)


def run_phase1(
    ts: np.ndarray, cfg: EDMConfig, device=None, on_chunk=None, group=None
) -> tuple[np.ndarray, np.ndarray]:
    """Phase 1 alone: (simplex_rhos (N, E_max) float32, optE (N,) int32),
    in chunks of ``len(devices) x lib_block`` rows.  ``on_chunk(row0)``
    fires before each chunk.  With a ``torch.distributed`` ``group``
    (:class:`~repro_torch.runtime.ranks.Ranks`) each rank computes its
    share of chunks of ``ranks x len(devices) x lib_block`` rows
    (:func:`rank_plan`) and every rank gets all N rows back."""
    devs, ranks = check_run(cfg, device), Ranks(group)
    ts = np.asarray(ts, np.float32)
    N = ts.shape[0]
    chunk = ranks.world * len(devs) * cfg.lib_block
    world_plan = [(r, min(chunk, N - r)) for r in range(0, N, chunk)]
    plan = rank_plan(world_plan, len(devs), cfg.lib_block, ranks.rank,
                     ranks.world)
    check = chunk_checks(ranks, world_plan, len(devs), cfg.lib_block, "phase 1")
    parts, ts_d, host = [], None, None
    for i, (row0, valid) in enumerate(plan):
        if on_chunk is not None:
            on_chunk(row0)
        if check is not None:
            check(row0)
        with telemetry.span("phase1", "chunk", row0=row0, chunk_rows=chunk) as t:
            if ts_d is None:  # the series go to each device once, in the first chunk
                with telemetry.span("phase1", "device_put", row0=row0):
                    ts_d = _on_each(devs, lambda d: torch.as_tensor(ts).to(d))
            for d, r0, r1 in slot_spans(row0, valid, len(devs), cfg.lib_block):
                parts.append((devs[d], *simplex.simplex_batch(
                    ts_d[devs[d]][r0:r1], cfg)))
            # every chunk's results come back in one copy a device, in the
            # last chunk: its wait for the device is the phase's gather
            t0 = _perf()
            if i == len(plan) - 1:
                host = _host_in_row_order(parts)
            t["gather_s"] = _perf() - t0
    simplex_rhos = np.zeros((N, cfg.E_max), np.float32)
    optE = np.zeros(N, np.int32)
    if host is not None:  # this rank's rows, in row order
        rhos_mine, optE_mine = host
        at = 0
        for r0, r1 in _spans(plan):
            simplex_rhos[r0:r1] = rhos_mine[at : at + r1 - r0]
            optE[r0:r1] = optE_mine[at : at + r1 - r0]
            at += r1 - r0
    ranks.gather_rows([simplex_rhos, optE], _spans(plan), "phase-1 optE")
    return simplex_rhos, optE


class Phase2Runner:
    """Phase 2 over any (row0, nrows) chunk plans, untiled or tiled
    (``cfg.target_tile``), bucketed or all-E (``cfg.bucketed``), across
    the device slots (``device``: a device, a name or a list; chunks of
    ``len(devices) x lib_block`` rows split as :func:`slot_spans`), its
    per-run state set up once: the bucket plan on the host and, untiled,
    the series and the targets' futures on every device; tiled, pinned
    host copies of the series and of the futures (in tile order), from
    which a slot's rows and a tile's futures are uploaded to its device
    when used, so no device holds an (N, L) or (N, Lp) array.  A fleet
    worker keeps one runner and calls :meth:`run` per claimed unit.
    Values do not depend on the plan, the tiles or the device count:
    tables are per library row, targets per column."""

    def __init__(self, ts: np.ndarray, ts_fut: np.ndarray, optE: np.ndarray,
                 cfg: EDMConfig, device=None, world: int = 1):
        self.devs = check_run(cfg, device)
        self.dev = dev = self.devs[0]
        self.cfg = cfg
        #: the rows of one chunk of the world's plan (``world`` ranks of
        #: these slots), recorded on every chunk span
        self.chunk_rows = world * len(self.devs) * cfg.lib_block
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
        self._host = (ts, np.ascontiguousarray(fut))
        self.ts_d = None  # uploaded in the first chunk (:meth:`_put`)

    def _put(self) -> None:
        """Untiled: the series, the targets' futures and (bucketed) the
        inverse column order onto every device, once a runner."""
        ts, fut = self._host
        self.ts_d = _on_each(self.devs, lambda d: torch.as_tensor(ts).to(d))
        self.fut_d = _on_each(self.devs, lambda d: torch.as_tensor(fut).to(d))
        if self.cfg.bucketed:
            inv = np.argsort(self.order)
            self.inv = _on_each(self.devs, lambda d: torch.as_tensor(inv).to(d))

    def _slots(self, row0: int, valid: int):
        return [(self.devs[d], r0, r1) for d, r0, r1 in
                slot_spans(row0, valid, len(self.devs), self.cfg.lib_block)]

    def _rows_untiled(self, dev, r0: int, r1: int) -> torch.Tensor:
        """Full-width (r1 - r0, N) rho rows of library series [r0, r1) on
        ``dev``, natural column order."""
        rows = self.ts_d[dev][r0:r1]
        if not self.cfg.bucketed:
            return ccm.ccm_block(rows, self.fut_d[dev], self.optE, self.cfg)
        return ccm.ccm_block_bucketed(rows, self.fut_d[dev], self.cfg,
                                      self.plan)[:, self.inv[dev]]

    def run(self, chunk_plan: list[tuple[int, int]],
            writer: Optional[TileWriter] = None,
            rho: Optional[np.ndarray] = None, progress: bool = False,
            on_chunk=None, span_rows: Optional[dict] = None) -> None:
        """Compute the chunks; blocks go to ``writer`` or, without one,
        into the host map ``rho``.  Returns once every block is drained
        (and, with a writer, committed to its manifest).  ``on_chunk(row0)``
        fires before each chunk.  ``span_rows``: {row0: rows} of the
        world's chunk each of this rank's chunks is a share of, recorded
        as the chunk span's ``rows`` (default: the chunk's own rows)."""
        if self.cfg.target_tile:
            self._run_tiled(chunk_plan, writer, rho, progress, on_chunk,
                            span_rows)
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
                with telemetry.span("phase2", "chunk", row0=row0,
                                    rows=valid if span_rows is None
                                    else span_rows[row0], tiled=False,
                                    chunk_rows=self.chunk_rows):
                    if self.ts_d is None:
                        with telemetry.span("phase2", "device_put", row0=row0):
                            self._put()
                    blocks = [self._rows_untiled(dev, r0, r1)
                              for dev, r0, r1 in self._slots(row0, valid)]
                streamer.submit((row0, valid), blocks)

    def _run_tiled(self, chunk_plan, writer, rho, progress, on_chunk, span_rows):
        """(row-chunk x col-tile) phase 2: tables once per chunk and slot,
        targets in column tiles of ``cfg.target_tile`` (uploaded once per
        device and tile), blocks streamed with (row0, col0, valid) tags.
        Bucketed tiles are in the sorted column order (``col_order.npy``
        in the store), all-E tiles in the natural one."""
        cfg, N, order = self.cfg, self.N, self.order
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
                with telemetry.span("phase2", "chunk", row0=row0,
                                    rows=valid if span_rows is None
                                    else span_rows[row0], tiled=True,
                                    tile=T, n_tiles=len(self.tile_plans),
                                    chunk_rows=self.chunk_rows):
                    tables = []
                    for dev, r0, r1 in self._slots(row0, valid):
                        with telemetry.span("phase2", "device_put", row0=r0):
                            rows = self.ts_h[r0:r1].to(dev, non_blocking=True)
                        if order is not None:
                            tables.append((dev, ccm.ccm_row_tables_bucketed(
                                rows, cfg, self.plan)))
                        else:
                            tables.append((dev, ccm.ccm_row_tables(rows, cfg)))
                    for c0, seg_plan in self.tile_plans:
                        futs = _on_each([dev for dev, _ in tables],
                                        lambda d: self.fut_h[c0 : c0 + T].to(
                                            d, non_blocking=True))
                        blocks = []
                        for dev, (idx, w) in tables:
                            if order is not None:
                                blocks.append(ccm.ccm_block_tile_bucketed(
                                    idx, w, futs[dev], cfg, seg_plan, c0, N))
                            else:
                                blocks.append(ccm.ccm_block_tile(
                                    idx, w, futs[dev], self.optE[c0 : c0 + T] - 1,
                                    cfg, c0, N))
                        streamer.submit((row0, c0, valid), blocks)
        if writer is not None:
            writer.commit()  # no deferred entry is left behind


def run_causal_inference(
    ts: np.ndarray,
    cfg: EDMConfig,
    device=None,
    out_dir: Optional[str] = None,
    progress: bool = False,
    timings: Optional[dict] = None,
    group=None,
) -> CausalMap:
    """Full pipeline over the run's device slots (every visible card
    unless ``device`` says otherwise: ``"cpu"``, ``"cuda:1"``, a list).

    With ``out_dir`` the phase-2 blocks stream to a :class:`TileWriter`
    and the returned map is a memmap at <out_dir>/causal_map/data.npy;
    the store is fingerprint-stamped first and checked on every resume.
    A resume may change ``lib_block``, ``target_tile``, the device count
    and the world size: only rows the store does not cover are
    recomputed.  ``timings``, when given, receives phase1_s / phase2_s /
    assemble_s and ``rows``, the phase-2 rows this process computed.

    ``group``: a ``torch.distributed`` process group whose every member
    calls this with the same arguments (rows across ranks,
    ``runtime/ranks.py``): each rank computes its share of every chunk
    (:func:`rank_plan`), optE is gathered to every rank after phase 1,
    and each rank writes its own manifest shard ``blocks.rank<r>.json``;
    rank 0 alone stamps the fingerprint, writes ``col_order.npy``, makes
    the chunk plan from the union of the shards and assembles the map,
    each between barriers.  Every rank returns the whole map (without
    ``out_dir``, the rows gathered from every rank)."""
    devs = check_run(cfg, device)
    ranks = Ranks(group)
    ts = np.asarray(ts, np.float32)
    N = ts.shape[0]
    chunk = ranks.world * len(devs) * cfg.lib_block
    if out_dir is not None:
        fp = integrity.fingerprint_of(ts, cfg)
        if ranks.lead:
            integrity.stamp_fingerprint(out_dir, fp)
        ranks.barrier("the fingerprint")
        if not ranks.lead:  # verifies rank 0's stamp
            integrity.stamp_fingerprint(out_dir, fp)

    t0 = _perf()
    simplex_rhos, optE = run_phase1(ts, cfg, devs, group=ranks.host)
    t1 = _perf()

    ts_fut = ccm.all_futures(torch.as_tensor(ts), cfg).numpy()
    runner = Phase2Runner(ts, ts_fut, optE, cfg, devs, world=ranks.world)
    writer = TileWriter(out_dir, N, writer_id=ranks.writer_id) if out_dir else None
    rho = None if writer is not None else np.zeros((N, N), np.float32)
    if writer is not None:
        plan = None
        if ranks.lead:
            if cfg.target_tile:
                writer.ensure_col_order(runner.order)
            plan = writer.refresh().chunk_plan(chunk)
        plan = ranks.share(plan, "the phase-2 chunk plan")
    else:
        plan = [(r, min(chunk, N - r)) for r in range(0, N, chunk)]
    shares = rank_shares(plan, len(devs), cfg.lib_block, ranks.rank, ranks.world)
    mine = [(r0, n) for r0, n, _ in shares]
    runner.run(mine, writer, rho, progress, on_chunk=chunk_checks(
        ranks, plan, len(devs), cfg.lib_block, "phase 2"),
        span_rows={r0: w for r0, _, w in shares})
    t2 = _perf()
    if writer is not None:
        path = writer.dir / "causal_map" / "data.npy"
        ranks.barrier("the phase-2 shards")
        if ranks.lead:
            with telemetry.span("assemble", "causal_map", N=N):
                rho = writer.refresh().assemble(mmap_path=path)
            # the in-process finish: the run's summary into the history
            # store (a no-op with telemetry off and EDM_HISTORY unset; a
            # later significance finish replaces it, same run identity)
            from repro_torch.runtime import history

            history.record_run(out_dir)
        ranks.barrier("the assembled map")
        if not ranks.lead:
            rho = np.load(path, mmap_mode="r")
    else:
        ranks.gather_rows([rho], _spans(mine), "the causal map's rows")
    if timings is not None:
        timings.update(phase1_s=t1 - t0, phase2_s=t2 - t1,
                       assemble_s=_perf() - t2, rows=sum(n for _, n in mine))
    return CausalMap(rho=rho, optE=optE, simplex_rho=simplex_rhos)


# ------------------------------------ library-sharded kNN (DESIGN SS8, SS14)
def _shard_bounds(Lc: int, W: int) -> tuple[int, np.ndarray]:
    """Contiguous candidate-shard geometry: (shard width, (W, 2) [lo, hi)),
    the JAX package's."""
    shard = -(-Lc // W)
    lo = np.arange(W, dtype=np.int64) * shard
    return shard, np.stack([lo, np.minimum(lo + shard, Lc)], axis=1)


def _shard_table(Vq, Vc, k: int, cfg: EDMConfig, exclude_self: bool,
                 s: int, W: int, dev):
    """Shard s of W: its (S, E_rows, Lq, min(k, shard)) all-E table on
    ``dev``, ids global.  The shard is padded with zero columns to the
    common width; ids at or past its ``hi`` (the padding, or all of a
    shard past Lc) come back as +inf with their own ids."""
    Lc = Vc.shape[-1]
    shard, bounds = _shard_bounds(Lc, W)
    lo, hi = (int(b) for b in bounds[s])
    part = Vc[..., lo:max(lo, hi)]
    part = torch.nn.functional.pad(part, (0, shard - part.shape[-1]))
    eng = engines.get_engine(cfg.engine)
    return eng.knn_tables(Vq.to(dev).contiguous(), part.to(dev).contiguous(),
                          min(k, shard), exclude_self=exclude_self, cfg=cfg,
                          col_offset=lo, col_hi=hi)


def knn_tables_library_sharded(
    Vq, Vc, k: int, cfg: EDMConfig, *, exclude_self: bool, devices=None,
    group=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """All-E kNN tables with the candidate (library) axis in contiguous
    shards, merged to the unsharded table bit for bit (k <= Lc).

    Vq (S, E_rows, Lq), Vc (S, E_rows, Lc) -> idx, dist (S, E_rows, Lq, k).
    Without ``group``: shard s on ``devices[s]`` (:func:`local_devices`;
    default every visible card), every shard dispatched before the
    merge; :func:`knn.merge_topk_tree` folds them, each right table copied
    to its left one's device; the table comes back on Vq's device.  With
    a ``torch.distributed`` ``group`` (no ``devices``): rank r builds shard
    r on Vq's device and :func:`knn.merge_topk_collective` (butterfly or
    all_gather + tree) leaves the global table on every rank."""
    Lc = Vc.shape[-1]
    if k > Lc:
        raise ValueError(f"k={k} exceeds candidate count Lc={Lc}")
    if group is not None:
        if devices is not None:
            raise ValueError("with a group each rank builds its shard on Vq's "
                             "device: pass devices=None")
        import torch.distributed as dist

        idx, d = _shard_table(Vq, Vc, k, cfg, exclude_self,
                              dist.get_rank(group), dist.get_world_size(group),
                              Vq.device)
        return knn.merge_topk_collective(idx, d, k, group)
    devs = local_devices(devices)
    parts = [_shard_table(Vq, Vc, k, cfg, exclude_self, s, len(devs), dev)
             for s, dev in enumerate(devs)]
    idx, d = knn.merge_topk_tree([p[0] for p in parts], [p[1] for p in parts], k)
    return idx.to(Vq.device), d.to(Vq.device)


def knn_tables_library_sharded_sim(
    Vq, Vc, k: int, cfg: EDMConfig, *, exclude_self: bool, shards: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``shards`` shard tables built in turn on Vq's device (the geometry of
    the real sharded build) and folded by :func:`knn.merge_topk_tree`: the
    merge's arithmetic at any shard count on one device, bit-equal to the
    unsharded table and to :func:`knn_tables_library_sharded`."""
    Lc = Vc.shape[-1]
    if k > Lc:
        raise ValueError(f"k={k} exceeds candidate count Lc={Lc}")
    parts = [_shard_table(Vq, Vc, k, cfg, exclude_self, s, shards, Vq.device)
             for s in range(shards)]
    return knn.merge_topk_tree([p[0] for p in parts], [p[1] for p in parts], k)
