"""Significance driver of the port: rho maps -> validated causal graphs,
over the run's device slots.

Runs the two statistical stages over the phase-2 decomposition — row
chunks of ``len(devices) x lib_block`` library series, each slot's
``lib_block`` rows on its device, column tiles of
``cfg.target_tile`` targets (one tile of all N when it is 0) — with
phase 2's ChunkStreamer and TileWriter store:

  * CONVERGENCE — per row chunk, ONE prefix-snapshot table build yields
    bucketed kNN tables for every library size (nested prefixes of the
    seeded subsampling permutation); per tile, the rho-vs-library-size
    curves reduce on the device to the drho and monotonic-trend maps.
  * SURROGATE NULLS — per row chunk the full-library tables are rebuilt
    (phase 2's tables, so the null matches the observed statistic);
    every target of a tile contributes m surrogate futures batched along
    the target axis, and the per-pair p-value (1 + #{null >= obs}) /
    (m + 1) is computed on the device.
  * FDR + ASSEMBLY — p-values take only m+1 distinct values, so the
    Benjamini–Hochberg threshold is computed exactly from streamed
    per-value counts, and the edge list is assembled row by row.

The surrogate futures depend only on the seed and the global series id.
Untiled, they are built ONCE per run, (N * m, Lp) float32 on the device;
tiled, each (chunk, tile) builds its tile's (T * m, Lp) batch, as the
JAX runner does, and the target futures and series are uploaded per
tile: the device holds nothing of size N * m or N * Lp.  Both build in
batches of one size (:meth:`SignificanceChunkRunner.surrogates`), so the
values, and every map, are the same byte for byte.

With ``out_dir`` set, blocks stream through TileWriters into
``rho_conv/`` (drho), ``rho_trend/``, ``pvals/`` and ``edges/``, and a
killed run resumes at the first chunk any artifact is missing.  Entry
points run on every visible card unless the caller passes
``device="cpu"`` (or a device list); the stores are the same byte for
byte for any device count.
"""
from __future__ import annotations

import json
import pathlib
from typing import Optional

import numpy as np
import torch

from repro_torch.core import ccm
from repro_torch.core.pipeline import (check_run, chunk_checks, rank_shares,
                                      slot_spans)
from repro_torch.core.types import EDMConfig
from repro_torch.data import store
from repro_torch.data.store import TileWriter
from repro_torch.inference import convergence, prng, significance, surrogates
from repro_torch.inference.types import SignificanceConfig, SignificanceResult
from repro_torch.runtime import history, integrity, telemetry
from repro_torch.runtime.ranks import Ranks
from repro_torch.runtime.stream import ChunkStreamer, upload_source

# Surrogate values drawn per batch of the build: bounds the int64 words
# and complex spectra the generators hold at once.
SURR_BUILD_VALUES = 1 << 22


class _OnDevice:
    """What one device holds for the significance stage: the column order,
    the subsampling permutation and the surrogate key (each made on the
    device from the seed: the same values on every device) and, untiled,
    the sorted target futures and the surrogate futures."""

    def __init__(self, dev, order: np.ndarray, seed: int, Lp: int):
        self.dev = dev
        self.order = torch.as_tensor(order).to(dev)
        perm_key, self.surr_key = prng.split(prng.prng_key(seed, dev), 2)
        self.col_ids = convergence.subsample_permutation(perm_key, Lp)
        self.fut_sorted = self.fut_surr = None


class SignificanceChunkRunner:
    """Per-chunk significance compute — convergence tables and tile
    reductions, surrogate-null batches — apart from chunk planning and
    finalization, across the device slots (``device``: a device, a name
    or a list; chunks of ``len(devices) x lib_block`` rows, split as
    ``core/pipeline.py::slot_spans``).  Everything the values depend on is
    derived here from shared inputs only: the bucket plan and column
    order from phase-1 optE, the subsampling permutation and surrogate
    keys from sig.seed (per-target fold_in).  ``run`` computes any subset
    of row chunks and drains blocks through the caller's sink.

    Untiled (``cfg.target_tile`` 0, T = N) the sorted target futures
    ``fut_sorted`` (N, Lp) and surrogate futures ``fut_surr`` (N * m, Lp)
    live on every device for the run; tiled both are None and every tile
    uploads or builds its own, once per device.  The attributes
    ``order_d``, ``col_ids``, ``surr_key``, ``fut_sorted`` and
    ``fut_surr`` are the first device's.  ``world``: the ranks of a
    rows-across-ranks run, for the chunk height its spans record."""

    def __init__(self, ts: np.ndarray, optE: np.ndarray, cfg: EDMConfig,
                 sig: SignificanceConfig, device=None, world: int = 1):
        self.devs = check_run(cfg, device)
        self.dev = dev = self.devs[0]
        self.cfg, self.sig = cfg, sig
        ts = np.asarray(ts, np.float32)
        N, L = ts.shape
        self.N = N
        Lp = cfg.n_points(L)
        self.do_conv = bool(sig.lib_sizes)
        self.do_null = sig.n_surrogates > 0
        if self.do_conv and sig.lib_sizes[-1] > Lp:
            raise ValueError(
                f"lib_sizes[-1]={sig.lib_sizes[-1]} exceeds the {Lp} "
                f"embeddable library points of length-{L} series "
                f"(E_max={cfg.E_max}, tau={cfg.tau}, Tp={cfg.Tp})"
            )
        self.m = sig.n_surrogates
        self.chunk = len(self.devs) * cfg.lib_block
        self.chunk_rows = world * self.chunk  # one chunk of the world's plan
        self.T = cfg.target_tile or N
        self.plan, self.order = ccm.make_bucket_plan(np.asarray(optE, np.int32))
        self.tile_plans = ccm.make_tile_plans(self.plan, self.T)
        self.ts_h = upload_source(ts, dev)
        self.ts_sorted_h = upload_source(ts[self.order], dev)
        fut = ccm.all_futures(torch.from_numpy(ts), cfg).numpy()
        self.fut_sorted_h = upload_source(fut[self.order], dev)
        # one batch size for every surrogate build, tiled or not
        self.surr_step = max(1, min(N, SURR_BUILD_VALUES // (max(self.m, 1) * L)))

        self.on = {d: _OnDevice(d, self.order, sig.seed, Lp)
                   for d in dict.fromkeys(self.devs)}
        if not cfg.target_tile:
            for d, st in self.on.items():
                st.fut_sorted = self.fut_sorted_h.to(d)
                if self.do_null:
                    st.fut_surr = self.surrogates(0, N, d)
        home = self.on[dev]
        self.order_d, self.col_ids, self.surr_key = (home.order, home.col_ids,
                                                     home.surr_key)
        self.fut_sorted, self.fut_surr = home.fut_sorted, home.fut_surr

    def rows(self, row0: int, n: int, dev=None) -> torch.Tensor:
        """Library series [row0, row0 + n) on ``dev`` (default the first
        device)."""
        return self.ts_h[row0 : row0 + n].to(dev or self.dev, non_blocking=True)

    def surrogates(self, c0: int, c1: int, dev=None) -> torch.Tensor:
        """((c1 - c0) * m, Lp) surrogate futures of the sorted targets
        [c0, c1) on ``dev`` (default the first device).  Built in batches
        of exactly ``surr_step`` targets (the last one filled up with
        copies of its last target, dropped after), so every FFT call has
        one batch size, tiled or not; each target's draws depend only on
        its global id."""
        st = self.on[dev or self.dev]
        m, step, parts = self.m, self.surr_step, []
        for b0 in range(c0, c1, step):
            b1 = min(b0 + step, c1)
            pos = torch.arange(step, device=st.dev).clamp_max_(b1 - b0 - 1)
            rows = self.ts_sorted_h[b0:b1].to(st.dev, non_blocking=True)[pos]
            fut = surrogates.surrogate_futures(
                st.surr_key, rows, st.order[b0 + pos], n=m,
                kind=self.sig.surrogate, cfg=self.cfg,
            )
            parts.append(fut[: (b1 - b0) * m])
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def run(self, plan_chunks, rho, drain, on_chunk=None,
            span_rows: Optional[dict] = None) -> None:
        """Compute the given (row0, valid) chunks, draining ("conv"|
        "pval", row0, c0, valid)-tagged blocks in submission order; every
        slot's block of a (chunk, tile) is dispatched before any is
        drained, and the parts are joined in row order.

        rho: the observed causal map (memmap fine; read only when the
        null stage is active).  on_chunk(row0) fires before each chunk.
        ``span_rows``: {row0: rows} of the world's chunk each chunk is a
        share of, recorded as the chunk span's ``rows`` (default: the
        chunk's own rows)."""
        N, T, m, cfg = self.N, self.T, self.m, self.cfg
        with ChunkStreamer(drain, depth=cfg.stream_depth,
                           stage="sig") as streamer:
            for row0, valid in plan_chunks:
                if on_chunk is not None:
                    on_chunk(row0)
                with telemetry.span("sig", "chunk", row0=row0,
                                    rows=valid if span_rows is None
                                    else span_rows[row0],
                                    chunk_rows=self.chunk_rows, tile=T,
                                    conv=self.do_conv, null=self.do_null):
                    slots = []
                    for d, r0, r1 in slot_spans(row0, valid, len(self.devs),
                                                cfg.lib_block):
                        st = self.on[self.devs[d]]
                        with telemetry.span("sig", "device_put", row0=r0):
                            rows = self.rows(r0, r1 - r0, st.dev)
                        slot = {"st": st, "r": (r0 - row0, r1 - row0)}
                        if self.do_conv:
                            slot["conv"] = convergence.conv_block_tables(
                                rows, cfg, self.plan, self.sig.lib_sizes,
                                st.col_ids)
                        if self.do_null:
                            slot["null"] = ccm.ccm_row_tables_bucketed(
                                rows, cfg, self.plan)
                        slots.append(slot)
                    if self.do_null:
                        rho_chunk = np.asarray(rho[row0 : row0 + valid], np.float32)
                    for c0, seg_plan in self.tile_plans:
                        c1 = min(c0 + T, N)
                        if self.do_conv:
                            futs = {}
                            blocks = []
                            for slot in slots:
                                st = slot["st"]
                                if st.dev not in futs:
                                    futs[st.dev] = (
                                        st.fut_sorted[c0:c1] if st.fut_sorted is not None
                                        else self.fut_sorted_h[c0:c1].to(
                                            st.dev, non_blocking=True))
                                drho, trend = convergence.conv_block_tile(
                                    *slot["conv"], futs[st.dev], cfg, seg_plan,
                                    col0=c0, width=N)
                                blocks.append(torch.stack([drho, trend]))
                            streamer.submit(("conv", row0, c0, valid), blocks,
                                            axis=1)
                        if self.do_null:
                            surr = {}
                            blocks = []
                            seg_plan_m = tuple((b, cnt * m) for b, cnt in seg_plan)
                            for slot in slots:
                                st = slot["st"]
                                if st.dev not in surr:
                                    surr[st.dev] = (
                                        st.fut_surr[c0 * m : c1 * m]
                                        if st.fut_surr is not None
                                        else self.surrogates(c0, c1, st.dev))
                                a, b = slot["r"]
                                rho_obs = upload_source(
                                    rho_chunk[a:b, self.order[c0:c1]], st.dev
                                ).to(st.dev, non_blocking=True)
                                blocks.append(significance.null_block_pvals(
                                    *slot["null"], surr[st.dev], rho_obs, cfg,
                                    seg_plan_m, m, col0=c0 * m, width=N * m))
                            streamer.submit(("pval", row0, c0, valid), blocks)


# ------------------------------------------------------------------- driver
def _writer(out_dir, name: str, N: int, order,
            writer_id: str | None = None) -> TileWriter:
    w = TileWriter(f"{out_dir}/{name}", N, writer_id=writer_id, stage="sig")
    w.ensure_col_order(order)
    return w


def make_store_drain(N: int, conv_w, trend_w, pv_w):
    """Tile-store sink for :meth:`SignificanceChunkRunner.run` blocks:
    the block routing (conv stacks [drho; trend], pval is flat) and one
    manifest commit per chunk (at its last tile).  The single-process
    driver and the fleet's workers share it, so their stores have one
    layout."""

    def drain(tag, block):
        kind, row0, c0, valid = tag
        last = c0 + block.shape[-1] >= N
        if kind == "conv":
            conv_w.write_tile(row0, c0, block[0][:valid], commit=last)
            trend_w.write_tile(row0, c0, block[1][:valid], commit=last)
        else:
            pv_w.write_tile(row0, c0, block[:valid], commit=last)

    return drain


def _check_resume_config(out_dir, sig: SignificanceConfig) -> None:
    """Pin the null-model parameters of a store to its first run: only
    coverage is inspected on resume, so a rerun with other surrogates,
    seed or lib_sizes would otherwise reuse blocks of the old ones.
    alpha is not pinned: it enters only the BH pass and the edge mask,
    recomputed every run."""
    f = pathlib.Path(out_dir) / "significance.json"
    want = {
        "lib_sizes": list(sig.lib_sizes),
        "n_surrogates": sig.n_surrogates,
        "surrogate": sig.surrogate,
        "seed": sig.seed,
    }
    if f.exists():
        have = json.loads(f.read_text())
        if have != want:
            raise ValueError(
                f"resume config mismatch in {out_dir}: store was written "
                f"with {have} but this run asks for {want}; use a fresh "
                "--out dir (only --fdr may change across resumes)"
            )
        return
    f.parent.mkdir(parents=True, exist_ok=True)
    store.atomic_write_text(f, json.dumps(want))


def run_significance(
    ts: np.ndarray,
    optE: np.ndarray,
    rho: np.ndarray,
    cfg: EDMConfig,
    sig: SignificanceConfig,
    device=None,
    out_dir: Optional[str] = None,
    progress: bool = False,
    group=None,
) -> SignificanceResult:
    """Validate a causal map: convergence statistics, surrogate p-values,
    and the BH-FDR significance-masked edge list, on every visible card
    unless ``device`` says otherwise (``"cpu"``, a device list).

    ts (N, L) series; optE (N,) phase-1 optimal embeddings; rho the
    (N, N) observed causal map (memmap fine — read a chunk of rows at a
    time).  With ``out_dir`` every artifact streams through a TileWriter
    (resumable) and the returned maps are disk-backed memmaps.

    ``group``: rows across ranks, as ``core/pipeline.py::
    run_causal_inference``: each rank computes its share of every chunk
    into its own writer shards, the BH counts are summed over the ranks,
    and rank 0 alone stamps the store, makes the chunk plan and writes
    the assembled maps and ``edges/``, between barriers.  Every rank
    returns the whole result.  The surrogates are keyed by global rows,
    so the bytes equal one process's for any world size."""
    if not (sig.lib_sizes or sig.n_surrogates > 0):
        return SignificanceResult(None, None, None, None)
    ranks = Ranks(group)
    runner = SignificanceChunkRunner(ts, optE, cfg, sig, device,
                                     world=ranks.world)
    N = runner.N
    do_conv, do_null = runner.do_conv, runner.do_null
    m, order = runner.m, runner.order
    chunk = ranks.world * runner.chunk

    if out_dir is not None:
        fp = integrity.fingerprint_of(np.asarray(ts, np.float32), cfg)

        def open_store():
            # Same stamp-or-verify as run_causal_inference; the sig
            # params are pinned separately.
            integrity.stamp_fingerprint(out_dir, fp)
            _check_resume_config(out_dir, sig)
            return [_writer(out_dir, name, N, order, ranks.writer_id) if on
                    else None for name, on in (("rho_conv", do_conv),
                                               ("rho_trend", do_conv),
                                               ("pvals", do_null))]

        if ranks.lead:
            conv_w, trend_w, pv_w = open_store()
        ranks.barrier("the significance store")
        if not ranks.lead:  # verifies what rank 0 wrote
            conv_w, trend_w, pv_w = open_store()
        writers = [w for w in (conv_w, trend_w, pv_w) if w is not None]
        plan_chunks = None
        if ranks.lead:
            cov = writers[0].refresh().covered()
            for w in writers[1:]:
                cov &= w.refresh().covered()
            plan_chunks = writers[0].chunk_plan(chunk, covered=cov)
        plan_chunks = ranks.share(plan_chunks, "the significance chunk plan")
        drho_map = trend_map = pv_map = None
        store_drain = make_store_drain(N, conv_w, trend_w, pv_w)
    else:
        drho_map = np.zeros((N, N), np.float32) if do_conv else None
        trend_map = np.zeros((N, N), np.float32) if do_conv else None
        pv_map = np.ones((N, N), np.float32) if do_null else None
        plan_chunks = [(r, min(chunk, N - r)) for r in range(0, N, chunk)]
        store_drain = None

    # Streaming BH inputs: p-values take the m+1 values j/(m+1), so the
    # per-value counts (diagonal excluded) fix the BH threshold exactly.
    p_counts = np.zeros(m + 1, np.int64)

    def drain(tag, block):
        kind, row0, c0, valid = tag
        cols = order[c0 : c0 + block.shape[-1]]
        last = c0 + block.shape[-1] >= N
        if kind == "pval":
            pv_b = block[:valid]
            offdiag = cols[None, :] != (row0 + np.arange(valid))[:, None]
            p_counts[:] += np.bincount(
                np.rint(pv_b[offdiag] * (m + 1)).astype(np.int64) - 1,
                minlength=m + 1,
            )
        if store_drain is not None:
            store_drain(tag, block)
        elif kind == "conv":
            drho_map[row0 : row0 + valid, cols] = block[0][:valid]
            trend_map[row0 : row0 + valid, cols] = block[1][:valid]
        else:
            pv_map[row0 : row0 + valid, cols] = block[:valid]
        if progress and last and (kind == "pval" or not do_null):
            print(f"significance rows {row0}..{row0 + valid} / {N}")

    resumed_rows = N - sum(v for _, v in plan_chunks)
    shares = rank_shares(plan_chunks, len(runner.devs), cfg.lib_block,
                         ranks.rank, ranks.world)
    mine = [(r0, n) for r0, n, _ in shares]
    runner.run(mine, rho, drain, on_chunk=chunk_checks(
        ranks, plan_chunks, len(runner.devs), cfg.lib_block, "significance"),
        span_rows={r0: w for r0, _, w in shares})
    p_counts = ranks.sum(p_counts, "the p-value counts")

    if out_dir is not None:
        for w in writers:
            w.commit()
        ranks.barrier("the significance shards")
        if ranks.lead:
            # Chunks durable from a prior run never re-drained: their
            # counts come back from the assembled map (p_counts=None ->
            # recount).
            for w in writers:
                w.refresh()
            res = _finalize_store(
                cfg, sig, rho, conv_w=conv_w, trend_w=trend_w, pv_w=pv_w,
                p_counts=None if resumed_rows else p_counts, progress=progress,
            )
            # the run finished: its summary into the history store (a
            # no-op with telemetry off and EDM_HISTORY unset)
            history.record_run(out_dir)
        ranks.barrier("the finalized significance store")
        return res if ranks.lead else _read_store(out_dir, sig)

    ranks.gather_rows([a for a in (drho_map, trend_map, pv_map) if a is not None],
                      [(r0, r0 + n) for r0, n in mine],
                      "the significance maps' rows")
    p_threshold, edges = 0.0, None
    n_tests = int(p_counts.sum())
    if do_null:
        p_threshold, p_cut = _bh_cut(p_counts, m, sig.alpha)
        edges = significance.assemble_edges(pv_map, rho, drho_map, trend_map, p_cut)
        if progress:
            print(f"BH-FDR alpha={sig.alpha}: p* = {p_threshold:.4g} over "
                  f"{n_tests} tests -> {len(edges)} edges")
    return SignificanceResult(
        drho=drho_map, trend=trend_map, pvals=pv_map, edges=edges,
        p_threshold=p_threshold, n_tests=n_tests,
    )


def _read_store(out_dir, sig: SignificanceConfig) -> SignificanceResult:
    """The result a finalized significance store holds (memmaps), for
    the ranks that did not finalize it."""
    out = pathlib.Path(out_dir)

    def load(name):
        return np.load(out / name / "data.npy", mmap_mode="r")

    res = SignificanceResult(None, None, None, None)
    if sig.lib_sizes:
        res.drho, res.trend = load("rho_conv"), load("rho_trend")
    if sig.n_surrogates > 0:
        meta = json.loads((out / "pvals" / "meta.json").read_text())
        res.pvals = load("pvals")
        res.edges = np.load(out / "edges" / "data.npy")
        res.p_threshold, res.n_tests = meta["p_threshold"], meta["n_tests"]
    return res


def _bh_cut(p_counts: np.ndarray, m: int, alpha: float) -> tuple[float, float]:
    """(p_threshold, edge cut).  p-values in the map are float32 of
    j/(m+1); the cut sits at the midpoint between discrete levels so the
    threshold level itself is always included whatever the f32-vs-f64
    rounding of the quotient."""
    p_threshold, _ = significance.bh_threshold_discrete(p_counts, m, alpha)
    p_cut = p_threshold + 0.5 / (m + 1) if p_threshold > 0 else 0.0
    return p_threshold, p_cut


def _finalize_store(
    cfg: EDMConfig,
    sig: SignificanceConfig,
    rho: np.ndarray,
    *,
    conv_w: Optional[TileWriter],
    trend_w: Optional[TileWriter],
    pv_w: Optional[TileWriter],
    p_counts: Optional[np.ndarray] = None,
    progress: bool = False,
) -> SignificanceResult:
    """Assembly + exact discrete BH + edge list over store artifacts.
    Idempotent, and runnable by a process that computed none of the
    chunks (the fleet's ``finalize`` unit): with ``p_counts=None`` the
    per-value histogram is recovered by row-streaming the assembled p
    map (the resume path, and always the fleet's)."""
    with telemetry.span("finalize", "store"):
        m = sig.n_surrogates
        meta_common = {
            "lib_sizes": list(sig.lib_sizes),
            "n_surrogates": m,
            "surrogate": sig.surrogate,
            "seed": sig.seed,
        }
        drho_map = trend_map = pv_map = None
        if conv_w is not None:
            drho_map = conv_w.assemble(mmap_path=conv_w.dir / "data.npy")
            trend_map = trend_w.assemble(mmap_path=trend_w.dir / "data.npy")
            store.save_meta(
                conv_w.dir, drho_map.shape, drho_map.dtype,
                {**meta_common, "stat": "delta_rho", "trend": "../rho_trend"},
            )
            store.save_meta(
                trend_w.dir, trend_map.shape, trend_map.dtype,
                {**meta_common, "stat": "monotonic_trend"},
            )

        p_threshold, edges, n_tests = 0.0, None, 0
        if pv_w is not None:
            pv_map = pv_w.assemble(mmap_path=pv_w.dir / "data.npy")
            if p_counts is None:
                n_tests, p_counts = _recount_pvals(pv_map, m)
            else:
                n_tests = int(p_counts.sum())
            p_threshold, p_cut = _bh_cut(p_counts, m, sig.alpha)
            edges = significance.assemble_edges(pv_map, rho, drho_map, trend_map, p_cut)
            sig_meta = {**meta_common, "alpha": sig.alpha,
                        "p_threshold": p_threshold, "n_tests": n_tests}
            store.save_meta(pv_w.dir, pv_map.shape, pv_map.dtype, sig_meta)
            edir = pv_w.dir.parent / "edges"
            edir.mkdir(parents=True, exist_ok=True)
            store.save_npy_checksummed(edir / "data.npy", edges, fault="edges")
            store.save_meta(
                edir, edges.shape, edges.dtype.str,
                {**sig_meta, "n_edges": int(edges.shape[0]),
                 "fields": list(edges.dtype.names)},
            )
            if progress:
                print(f"BH-FDR alpha={sig.alpha}: p* = {p_threshold:.4g} over "
                      f"{n_tests} tests -> {len(edges)} edges")

        return SignificanceResult(
            drho=drho_map, trend=trend_map, pvals=pv_map, edges=edges,
            p_threshold=p_threshold, n_tests=n_tests,
        )


def finalize_significance(
    out_dir: str,
    rho: np.ndarray,
    cfg: EDMConfig,
    sig: SignificanceConfig,
    progress: bool = False,
) -> SignificanceResult:
    """The fleet's ``finalize`` work unit: assemble the (multi-writer)
    significance store, recount the p-value histogram and write the
    BH-FDR edge list, by whichever worker claims the unit.  Idempotent
    (a finalizer killed midway reruns it); raises if any artifact's
    coverage is incomplete."""
    N = rho.shape[0]
    conv_w = TileWriter(f"{out_dir}/rho_conv", N) if sig.lib_sizes else None
    trend_w = TileWriter(f"{out_dir}/rho_trend", N) if sig.lib_sizes else None
    pv_w = TileWriter(f"{out_dir}/pvals", N) if sig.n_surrogates > 0 else None
    for w in (conv_w, trend_w, pv_w):
        if w is not None and not w.covered().all():
            raise ValueError(
                f"{w.dir} is incomplete ({int((~w.covered()).sum())} rows "
                "uncovered): finalize ran before every sig unit was done"
            )
    result = _finalize_store(cfg, sig, rho, conv_w=conv_w, trend_w=trend_w,
                             pv_w=pv_w, p_counts=None, progress=progress)
    # the finalize claimer is the run's one history writer: one record a
    # finished run, replaced (not duplicated) when a resume or a heal
    # finalizes again
    history.record_run(out_dir)
    return result


def _recount_pvals(pv_map: np.ndarray, m: int) -> tuple[int, np.ndarray]:
    """Row-streamed per-value p counts (diagonal excluded) from a
    (memmapped) p-value map — the resume path of the discrete BH pass."""
    counts = np.zeros(m + 1, np.int64)
    for i in range(pv_map.shape[0]):
        row = np.asarray(pv_map[i])
        idx = np.rint(np.delete(row, i) * (m + 1)).astype(np.int64) - 1
        counts += np.bincount(idx, minlength=m + 1)
    return int(counts.sum()), counts
