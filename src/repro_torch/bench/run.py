"""Benchmark harness of the port: one function per paper table or figure,
the counterpart of the JAX package's ``benchmarks/run.py``.

  PYTHONPATH=src python -m repro_torch.bench.run knn --out build/bench
  PYTHONPATH=src python -m repro_torch.bench.run --tiny --device cpu \\
      --out /tmp/bench          # every bench, at test sizes, on the CPU

Prints ``name,us_per_call,derived`` CSV rows, as the JAX harness does, and
writes one ``BENCH_<name>.json`` per bench to ``--out`` (default
``build/bench/``; never the repository root, which holds the JAX
package's committed baselines).  ``knn``, ``phase2`` and ``significance``
write the top-level keys of the JAX package's JSON of the same name; the
other benches, which print rows only there, write their rows.  Every
JSON carries ``device`` and ``card``: the card's ``nvidia-smi
--query-gpu=name,power.limit`` line, or null on the CPU, where the plain
PyTorch versions run and no time is a card's.

Sizes: the defaults are card sizes (the JAX defaults are a laptop's);
``--tiny`` takes the test sizes.  Times are host clocks around work that
ends in ``torch.cuda.synchronize()``: medians of paired repetitions
where two layouts are compared.

  table2        naive (Alg. 1) vs improved (Alg. 2) causal map
  fig6 / fig7   map time against N / against L, with the fitted exponent
  fig8          one series' kNN tables vs its lookups
  fig9          cumulative-E tables vs a per-E rebuild
  fig9b         the dense tables' variants (``knn_tables_dense(impl=)``):
                the per-E rebuild vs the cumulative loop as a scan,
                unrolled and blocked by 4 and by 2 selections a sort
  knn           the streaming tables vs the dense slab, both engines
                (torch-reference: plain streaming vs the dense oracle;
                cuda: the knn_topk kernel vs the knn_slab kernel)
  phase2        phase 2 all-E synchronous vs bucketed double-buffered vs
                bucketed in column tiles
  significance  one-sweep prefix tables vs the per-size rebuild
  roofline      a summary of the dry runs' JSONs (launch/edm_dryrun.py)
  fig3          the main path's wall over 1, 2 and 4 row slots of one
                device and over every visible card where there are
                several: on one card the slots share it, so the rows
                measure the decomposition's overhead, as the JAX bench's
                spoofed CPU devices do
  scale         BENCH_scale.json: per cell (N x L, E_max 20) one series'
                streaming table build, the library-sharded build + merge
                at 1, 2, 4 and 8 simulated shards (and over every visible
                card where there are several), each bit-equal to the
                unsharded table, and the merge alone on the device vs the
                host oracle

Regression gate (``--check``), the JAX harness's, with the port's engine
names (``torch-reference`` and ``cuda``):

  PYTHONPATH=src python -m repro_torch.bench.run knn phase2 significance \
      --out build/bench                          # writes the baselines
  PYTHONPATH=src python -m repro_torch.bench.run --check knn phase2 \
      significance --out build/bench             # the gate against them

Without ``--check`` a run writes its JSONs, the baselines, to ``--out``.
With it the named benches write to ``<out>/fresh/`` (the gated JSONs
there are removed first, so a stale one never stands in for this run's),
and each gated timing field (:data:`GATES`) is compared against the JSON
of the same name in ``--baselines`` (default ``--out``): one ``gate,`` row
per field, a ``SKIP_no_committed_baseline`` row where the baseline is
missing, a regression past ``SLOWDOWN_LIMIT`` (``BENCH_GATE_LIMIT``,
default 1.5) times the baseline.  ``knn`` adds the knn-gate: the
streaming tables at every Lc on both engines at most the slab's, fresh
(times ``KNN_STREAM_MARGIN``, default 1.15) or baseline (times
``SLOWDOWN_LIMIT``).  The offending benches run once more and each field
keeps its best time; ``<out>/fresh/CHECK_summary.json`` holds every
row, and the run exits nonzero naming the benches still slower.  Each row
also prints the ``card`` of the baseline and of the fresh run: a CPU
baseline read beside a card run shows as such.  Nothing is committed as a
baseline.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import resource
import sys
import tempfile
import time
import tracemalloc

import numpy as np
import torch

from repro_torch import engine as engines
from repro_torch.core import ccm, embedding, knn
from repro_torch.core.baseline import ccm_pair_naive
from repro_torch.core.pipeline import (
    Phase2Runner,
    knn_tables_library_sharded,
    knn_tables_library_sharded_sim,
    run_causal_inference,
    run_phase1,
)
from repro_torch.core.simplex import simplex_batch
from repro_torch.core.types import EDMConfig
from repro_torch.data.store import TileWriter
from repro_torch.data.synthetic import dummy_brain
from repro_torch.inference import prng
from repro_torch.inference.convergence import subsample_permutation
from repro_torch.kernels.knn_slab.ops import knn_slab
from repro_torch.kernels.knn_slab.ref import padded_width
from repro_torch.kernels.knn_topk.ops import knn_topk
from repro_torch.launch import roofline as RL
from repro_torch.runtime.device import BusySampler, card_line, resolve_device
from repro_torch.runtime.platform import local_devices

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
DEFAULT_OUT = REPO_ROOT / "build" / "bench"
DRYRUN_DIR = REPO_ROOT / "build" / "dryrun"

#: bench -> {"card": sizes, "tiny": sizes}
SIZES = {
    "table2": {"card": dict(N=1024, L=1450, E_max=20),
               "tiny": dict(N=6, L=120, E_max=4)},
    "fig6": {"card": dict(Ns=(1024, 2048, 4096), L=1450, E_max=20),
             "tiny": dict(Ns=(4, 6, 8), L=100, E_max=3)},
    "fig7": {"card": dict(N=1024, Ls=(1450, 2900, 5800), E_max=20),
             "tiny": dict(N=6, Ls=(80, 120, 160), E_max=3)},
    "fig8": {"card": dict(N=2048, L=1450, E_max=20),
             "tiny": dict(N=8, L=120, E_max=4)},
    "fig9": {"card": dict(L=4000, E_max=20), "tiny": dict(L=100, E_max=4)},
    "fig9b": {"card": dict(L=2000, E_max=20), "tiny": dict(L=100, E_max=4)},
    "knn": {"card": dict(Lc_sweep=(1000, 2000, 4000, 16000, 64000), Lq=128,
                         E_max=20, k=21, N=128, L_ref=1000),
            "tiny": dict(Lc_sweep=(100, 200), Lq=16, E_max=3, k=4, N=6,
                         L_ref=100)},
    "phase2": {"card": dict(N=2048, L=1450, E_max=20, tile=512),
               "tiny": dict(N=12, L=120, E_max=4, tile=5)},
    "significance": {"card": dict(N=2048, L=1450, E_max=20, rows=8, n_sizes=6),
                     "tiny": dict(N=12, L=120, E_max=4, rows=4, n_sizes=3)},
    "roofline": {"card": {}, "tiny": {}},
    "fig3": {"card": dict(N=4096, L=1450, E_max=20, slots=(1, 2, 4)),
             "tiny": dict(N=12, L=120, E_max=3, slots=(1, 2, 4))},
    "scale": {"card": dict(cells=((512, 1000), (2048, 2048), (16384, 4096)),
                           E_max=20, shard_counts=(1, 2, 4, 8)),
              "tiny": dict(cells=((16, 120), (32, 200)), E_max=4,
                           shard_counts=(1, 2, 4, 8))},
}

#: the JAX scale bench's reference point: its fig6 / fig7 ceiling (N x L)
PRIOR_CEILING_NL = 128 * 1000


class Bench:
    """One run of the harness: the device, where JSONs go, and the rows
    printed so far (per bench)."""

    def __init__(self, dev: torch.device, out: pathlib.Path):
        self.dev = dev
        self.out = out
        self.card = card_line(dev)
        self.rows: list[dict] = []

    def sync(self) -> None:
        """Wait for every visible card (a multi-device run ends on all)."""
        if self.dev.type == "cuda":
            for i in range(torch.cuda.device_count()):
                torch.cuda.synchronize(i)

    def time(self, fn, reps: int = 3) -> float:
        """Median seconds of ``fn()`` after one warm-up call, each ended
        by a synchronise."""
        fn()
        ts = []
        for _ in range(reps):
            self.sync()
            t0 = time.perf_counter()
            fn()
            self.sync()
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    def row(self, name: str, seconds: float, derived: str = "") -> None:
        print(f"{name},{seconds * 1e6:.1f},{derived}", flush=True)
        self.rows.append({"name": name, "us_per_call": seconds * 1e6,
                          "derived": derived})

    def write(self, fname: str, out: dict) -> dict:
        out = {**out, "device": str(self.dev), "card": self.card}
        self.out.mkdir(parents=True, exist_ok=True)
        (self.out / fname).write_text(json.dumps(out, indent=2))
        return out

    def write_rows(self, bench: str) -> dict:
        return self.write(f"BENCH_{bench}.json", {"bench": bench, "rows": self.rows})

    def series(self, N: int, L: int, seed: int = 0) -> torch.Tensor:
        return torch.as_tensor(dummy_brain(N, L, seed=seed)).to(self.dev)


def _optE(b: Bench, ts: torch.Tensor, cfg: EDMConfig) -> np.ndarray:
    """Phase 1 in chunks of ``lib_block`` series, as the pipeline runs it."""
    return run_phase1(ts.cpu().numpy(), cfg, device=b.dev)[1]


# ---------------------------------------------------------------- Table II
def table2_speedup(b: Bench, N, L, E_max):
    """Improved Alg. 2 vs naive Alg. 1 full causal map (the naive cost is
    one pair measured, times N^2)."""
    cfg = EDMConfig(E_max=E_max)
    ts = b.series(N, L)
    optE = _optE(b, ts, cfg)
    ts_fut = ccm.all_futures(ts, cfg)
    t_improved = b.time(lambda: ccm.ccm_matrix(ts, optE, cfg))
    E_med = int(np.median(optE))
    t_pair = b.time(lambda: ccm_pair_naive(ts[0], ts_fut[1], E_med, cfg), reps=5)
    t_naive = t_pair * N * N
    b.row("table2_improved_ccm", t_improved, f"N={N};L={L}")
    b.row("table2_naive_ccm_extrap", t_naive, f"pair={t_pair * 1e6:.0f}us x N^2")
    b.row("table2_speedup", t_improved, f"speedup={t_naive / t_improved:.1f}x")
    for name, (Np, Lp_) in {"fish1": (53053, 1450),
                            "subject11": (101729, 8528)}.items():
        E = 20
        naive = Np * Np * Lp_ * Lp_ * E
        improved = Np * Lp_ * Lp_ * E + Np * Np * Lp_ * E
        b.row(f"table2_model_{name}", 0.0,
              f"algorithmic_speedup={naive / improved:.0f}x")
    return b.write_rows("table2")


# ------------------------------------------------------------------ Fig 6/7
def _map_time(b: Bench, N, L, cfg, seed):
    ts = b.series(N, L, seed=seed)
    optE = _optE(b, ts, cfg)
    return b.time(lambda: ccm.ccm_matrix(ts, optE, cfg))


def fig6_scaling_N(b: Bench, Ns, L, E_max):
    cfg = EDMConfig(E_max=E_max)
    times = {}
    for N in Ns:
        times[N] = _map_time(b, N, L, cfg, seed=N)
        b.row(f"fig6_N{N}", times[N], f"L={L}")
    expo = np.polyfit(np.log(list(times)), np.log(list(times.values())), 1)[0]
    b.row("fig6_scaling_exponent", 0.0, f"O(N^{expo:.2f})_model_<=2")
    return b.write_rows("fig6")


def fig7_scaling_L(b: Bench, N, Ls, E_max):
    cfg = EDMConfig(E_max=E_max)
    times = {}
    for L in Ls:
        times[L] = _map_time(b, N, L, cfg, seed=L)
        b.row(f"fig7_L{L}", times[L], f"N={N}")
    expo = np.polyfit(np.log(list(times)), np.log(list(times.values())), 1)[0]
    b.row("fig7_scaling_exponent", 0.0, f"O(L^{expo:.2f})_model_<=2")
    return b.write_rows("fig7")


# ------------------------------------------------------------------- Fig 8
def fig8_breakdown(b: Bench, N, L, E_max):
    """CCM phase split of one library series: its all-E kNN tables vs the
    lookups of all N targets through them (each at its optE)."""
    cfg = EDMConfig(E_max=E_max)
    eng = engines.get_engine(cfg.engine)
    ts = b.series(N, L)
    optE = _optE(b, ts, cfg)
    Lp = cfg.n_points(L)
    V = embedding.lag_matrix(ts[:1], cfg.E_max, cfg.tau, Lp).contiguous()
    build = lambda: eng.knn_tables(V, V, cfg.k_max, exclude_self=True, cfg=cfg)
    t_knn = b.time(build)
    idx, w = knn.tables_with_weights(*build())
    order = np.argsort(optE - 1, kind="stable")
    tab, cnt = np.unique((optE - 1)[order], return_counts=True)
    segs = tuple((int(r), int(c)) for r, c in zip(tab, cnt))
    fut = ccm.all_futures(ts, cfg)[torch.as_tensor(order).to(b.dev)].contiguous()
    t_lookup = b.time(lambda: eng.ccm_lookup(idx, w, fut, segs))
    total = t_knn + t_lookup
    b.row("fig8_knn_per_series", t_knn, f"{100 * t_knn / total:.0f}%_of_ccm")
    b.row("fig8_lookup_per_series", t_lookup,
          f"{100 * t_lookup / total:.0f}%_of_ccm;N={N}")
    return b.write_rows("fig8")


# ------------------------------------------------------------------- Fig 9
def fig9_multiE_kernel(b: Bench, L, E_max):
    """Cumulative-E tables (one distance sweep for every E) vs a per-E
    rebuild in the matrix-product form."""
    cfg = EDMConfig(E_max=E_max)
    Lp = cfg.n_points(L)
    V = embedding.lag_matrix(b.series(1, L), E_max, cfg.tau, Lp)
    t_cum = b.time(lambda: knn.knn_tables_dense(V, V, E_max + 1, False))
    t_reb = b.time(lambda: [
        knn.knn_table_single_E(V, V, E, E_max + 1, False, matmul_form=True)
        for E in range(1, E_max + 1)])
    b.row("fig9_cumulative_multiE", t_cum, f"L={L};E_max={E_max}")
    b.row("fig9_per_E_rebuild", t_reb, f"speedup={t_reb / t_cum:.1f}x")
    return b.write_rows("fig9")


def fig9b_knn_impl_variants(b: Bench, L, E_max):
    """The dense tables' variants (``knn.knn_tables_dense(impl=)``): the
    paper-faithful per-E rebuild against the cumulative-E loop as a scan,
    unrolled, and blocked by 4 and by 2 selections a sort, on one series
    (the JAX bench's).  Each cumulative variant's tables are first held
    to the scan's, bit for bit."""
    cfg = EDMConfig(E_max=E_max)
    V = embedding.lag_matrix(b.series(1, L), E_max, cfg.tau, cfg.n_points(L))
    scan_i, scan_d = knn.knn_tables_dense(V, V, cfg.k_max, True, impl="scan")
    times = {}
    for impl in ("rebuild", "scan", "unroll", "blocked:4", "blocked:2"):
        if impl != "rebuild":
            i, d = knn.knn_tables_dense(V, V, cfg.k_max, True, impl=impl)
            if not (torch.equal(i, scan_i) and torch.equal(d, scan_d)):
                raise AssertionError(f"fig9b: impl {impl} != scan")
        times[impl] = b.time(lambda impl=impl: knn.knn_tables_dense(
            V, V, cfg.k_max, True, impl=impl))
    base = times["rebuild"]
    for impl, t in times.items():
        b.row(f"fig9b_knn_{impl.replace(':', '')}", t,
              f"vs_paper_faithful_rebuild={base / t:.2f}x")
    return b.write_rows("fig9b")


# ----------------------------------------------------- kNN selection bench
def slab_bytes(engine: str, Lq: int, Lc: int) -> int:
    """Distance working set of the slab layout: the cuda kernel's (Lq,
    Lc_pad) float32 slab (each row in shared memory as far as it fits,
    its tail in a device workspace); the dense oracle's (Lq, Lc) float32
    distances, their sorted copy and its int64 positions."""
    if engine == "cuda":
        return Lq * padded_width(Lc) * 4
    return Lq * Lc * (4 + 4 + 8)


def stream_bytes_cuda(E_max: int, Lq: int, k: int) -> int:
    """On-chip working set of the knn_topk kernel (``csrc/knn_topk.cu``)
    for the all-E tables, independent of Lc.  The fast path (k <= 32,
    E_max <= 32): per block of 8 query rows its shared candidate tile
    ([E][256] float32) and query coordinates, per query row (one warp) the
    register lists (32 lanes x MAXE slots x (float32 + int32)); MAXE is
    E_max rounded up to 8.  The wide route (past either): a launch a
    window of the selection, each with the fast path's 32-lag tile and
    per query row R = ceil(k / 32) slots a lane for the window's lists (at
    most 24, 12, 8 or 6 for R = 1-4); the largest window's set."""
    blocks = -(-Lq // 8)
    if k <= 32 and E_max <= 32:
        maxe = -(-E_max // 8) * 8
        return blocks * (maxe * 256 * 4 + 8 * maxe * 4) + Lq * 32 * maxe * 8
    R = -(-k // 32)
    lists = min(E_max, {1: 24, 2: 12, 3: 8, 4: 6}[R])
    return blocks * (32 * 256 * 4 + 8 * 32 * 4) + Lq * 32 * R * lists * 8


def knn_selection_bench(b: Bench, Lc_sweep, Lq, E_max, k, N, L_ref):
    """BENCH_knn.json: streaming kNN tables vs the dense slab for a fixed
    query block against libraries of growing length Lc, on both engines;
    paired repetitions (the layouts alternate), a slab == stream spot check
    on each engine's cheapest cell, each layout's working set, and the
    kernels' bounds (``launch/roofline.py``).  ``tile_budget_bytes_host``,
    the JAX bench's host tile budget, is null: the port has one budget,
    ``tile_budget_bytes``, for every device."""
    all_E = tuple(range(1, E_max + 1))
    cfg = EDMConfig(E_max=E_max)
    out = {
        "bench": "knn_selection",
        "E_max": E_max,
        "k": k,
        "Lq": Lq,
        "merge": "warp_parallel_selection (cuda); stable sort + merge "
                 "(torch-reference)",
        "tile_budget_bytes": knn.KNN_TILE_BUDGET_BYTES,
        "tile_budget_bytes_host": None,
        "engines": {},
        "phase1": {},
    }
    max_Lc = max(Lc_sweep)
    pair = b.series(2, max_Lc + E_max + 1, seed=3)
    Vq = embedding.lag_matrix(pair[0], E_max, 1, Lq).contiguous()
    for engine in ("torch-reference", "cuda"):
        eng = engines.get_engine(engine)
        rows_d = {}
        checked = False
        for Lc in Lc_sweep:
            Vc = embedding.lag_matrix(pair[1], E_max, 1, Lc).contiguous()
            if engine == "cuda":
                f_stream = lambda: knn_topk(Vq[None], Vc[None], k, False, all_E)
                f_slab = lambda: knn_slab(Vq, Vc, k, False)
                tile = 256  # the kernel's shared-memory candidate tile
                ws_stream = stream_bytes_cuda(E_max, Lq, k)
            else:
                f_stream = lambda: eng.knn_tables(Vq[None], Vc[None], k,
                                                  exclude_self=False, cfg=cfg)
                f_slab = lambda: knn.knn_tables_dense(Vq[None], Vc[None], k, False)
                tile = eng.knn_selection_tile(Lq, Lc, cfg)
                ws_stream = knn.streaming_bytes(Lq, k, min(tile, -(-Lc // 8) * 8),
                                                E_max)
            reps = 5 if Lc <= 4000 else 3
            f_stream()
            f_slab()
            obs = {"stream": [], "slab": []}
            for _ in range(reps):
                for name, f in (("stream", f_stream), ("slab", f_slab)):
                    b.sync()
                    t0 = time.perf_counter()
                    f()
                    b.sync()
                    obs[name].append(time.perf_counter() - t0)
            t_stream = float(np.median(obs["stream"]))
            t_slab = float(np.median(obs["slab"]))
            if not checked:  # the cheapest cell: slab == stream, bit for bit
                si, sd = f_slab()
                ti, td = f_stream()
                si, sd = si.reshape(ti.shape), sd.reshape(td.shape)
                if not (torch.equal(si, ti) and torch.equal(
                        sd.view(torch.int32), td.view(torch.int32))):
                    raise AssertionError(f"knn bench: slab != stream tables "
                                         f"on {engine} at Lc={Lc}")
                checked = True
            rows_d[str(Lc)] = {
                "Lc": Lc,
                "tile_c": tile,
                "stream_s": t_stream,
                "slab_s": t_slab,
                "slab_working_set_bytes": slab_bytes(engine, Lq, Lc),
                "stream_working_set_bytes": ws_stream,
                "stream_bound_s": RL.Roofline(
                    *RL.knn_counts(1, E_max, E_max, Lq, Lc, k)).t_bound,
                "slab_bound_s": RL.Roofline(
                    *RL.slab_counts(E_max, Lq, Lc, k)).t_bound,
                "route": ("kernel" if engine == "cuda" and b.dev.type == "cuda"
                          else "plain"),
            }
            b.row(f"knn_{engine}_Lc{Lc}", t_stream,
                  f"slab_s={t_slab:.6f};tile_c={tile};slab_MiB="
                  f"{rows_d[str(Lc)]['slab_working_set_bytes'] / 2**20:.2f};"
                  f"stream_MiB={ws_stream / 2**20:.2f}")
        out["engines"][engine] = rows_d
        out[f"spot_check_{engine.replace('-', '_')}"] = checked

    # phase 1 at the reference workload: calibrated tile vs a forced narrow
    # one (the plain streaming tables, where the tile width is a choice)
    ts = b.series(N, L_ref, seed=1)
    forced = 512
    times = {}
    for name, c in {"auto": EDMConfig(E_max=E_max, engine="torch-reference"),
                    "forced_tile": EDMConfig(E_max=E_max, engine="torch-reference",
                                             knn_tile_c=forced)}.items():
        times[name] = b.time(lambda c=c: simplex_batch(ts, c))
    Lp = cfg.n_points(L_ref)
    out["phase1"] = {
        "workload": {"N": N, "L": L_ref},
        "auto_s": times["auto"],
        # the tile simplex_batch's plain tables calibrate: rows = N x Lq
        "auto_tile_c": knn.calibrate_knn_tile(N * (Lp - Lp // 2), Lp // 2),
        "forced_tile_s": times["forced_tile"],
        "forced_tile_c": forced,
        "auto_vs_forced": times["auto"] / times["forced_tile"],
    }
    b.row("knn_phase1_ref", times["auto"],
          f"forced_tile_s={times['forced_tile']:.3f};"
          f"auto_vs_forced={times['auto'] / times['forced_tile']:.2f}x")
    return b.write("BENCH_knn.json", out)


# ------------------------------------------------------- phase-2 bench
def _host_peak(fn):
    """(fn's result, its peak traced host allocation in bytes)."""
    tracemalloc.start()
    try:
        res = fn()
        return res, tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()


def phase2_engine_bench(b: Bench, N, L, E_max, tile):
    """BENCH_phase2.json: phase 2 through the pipeline's runner and the
    store: all-E tables drained synchronously (the seed path) vs bucketed
    tables double-buffered vs bucketed in column tiles (the map assembled
    from the store, counted), with host and device memory peaks."""
    base = dict(E_max=E_max, lib_block=8)
    cfgs = {
        "seed_all_e_sync": EDMConfig(**base, bucketed=False, stream_depth=1),
        "bucketed_double_buffered": EDMConfig(**base, bucketed=True,
                                              stream_depth=2),
        "bucketed_tiled": EDMConfig(**base, bucketed=True, stream_depth=2,
                                    target_tile=tile),
    }
    cfg_new = cfgs["bucketed_double_buffered"]
    ts = dummy_brain(N, L, seed=42)
    _, optE = run_phase1(ts, cfg_new, device=b.dev)
    ts_fut = ccm.all_futures(torch.as_tensor(ts), cfg_new).numpy()
    plan, _ = ccm.make_bucket_plan(optE)
    chunk = cfg_new.lib_block
    chunk_plan = [(r, min(chunk, N - r)) for r in range(0, N, chunk)]
    times, rhos, host_peaks, dev_peaks = {}, {}, {}, {}
    for name, cfg in cfgs.items():
        runner = Phase2Runner(ts, ts_fut, optE, cfg, device=b.dev)
        runner.run(chunk_plan[:1], rho=np.zeros((N, N), np.float32))  # warm-up
        with tempfile.TemporaryDirectory() as d:
            writer = TileWriter(d, N)

            def go():
                b.sync()
                t0 = time.perf_counter()
                runner.run(chunk_plan, writer=writer)
                if cfg.target_tile:  # the tiled path has no dense map
                    rho = writer.assemble(mmap_path=pathlib.Path(d) / "map.npy")
                    b.sync()
                    return time.perf_counter() - t0, np.array(rho)
                b.sync()
                return time.perf_counter() - t0, None

            if b.dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(b.dev)
            (times[name], rho), host_peaks[name] = _host_peak(go)
            dev_peaks[name] = (torch.cuda.max_memory_allocated(b.dev)
                               if b.dev.type == "cuda" else None)
            rhos[name] = rho if rho is not None else writer.assemble()
        derived = f"N={N};L={L};E_max={E_max}"
        if cfg.target_tile:
            derived = f"N={N};L={L};tile={tile}"
        b.row(f"phase2_{name}", times[name], derived)
    tile_plans = ccm.make_tile_plans(plan, tile)
    err = float(np.abs(rhos["seed_all_e_sync"]
                       - rhos["bucketed_double_buffered"]).max())
    err_tiled = float(np.abs(rhos["bucketed_double_buffered"]
                             - rhos["bucketed_tiled"]).max())
    speedup = times["seed_all_e_sync"] / times["bucketed_double_buffered"]
    b.row("phase2_speedup", 0.0, f"speedup={speedup:.2f}x;max_drho={err:.1e}")
    b.row("phase2_tiled_host_peak", 0.0,
          f"host_peak_MiB={host_peaks['bucketed_tiled'] / 2**20:.1f};"
          f"dense_MiB={host_peaks['seed_all_e_sync'] / 2**20:.1f};"
          f"tiled_drho={err_tiled:.1e}")

    def path(name, **kw):
        cfg = cfgs[name]
        return {"bucketed": cfg.bucketed, "stream_depth": cfg.stream_depth, **kw,
                "phase2_s": times[name], "host_peak_bytes": host_peaks[name],
                "device_peak_bytes": dev_peaks[name]}

    out = {
        "bench": "phase2_engine",
        "workload": {"N": N, "L": L, "E_max": E_max},
        "engine": cfg_new.engine,
        "n_buckets": len(plan.buckets),
        "buckets": list(plan.buckets),
        "devices": 1,
        "tile": {
            "target_tile": tile,
            "n_col_tiles": len(tile_plans),
            "n_tile_signatures": len({sp for _, sp in tile_plans}),
            "chunk_rows": chunk,
        },
        "seed_path": path("seed_all_e_sync"),
        "new_path": path("bucketed_double_buffered"),
        "tiled_path": path("bucketed_tiled", target_tile=tile),
        "ru_maxrss_kb": int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss),
        "speedup": speedup,
        "max_abs_drho": err,
        "max_abs_drho_tiled": err_tiled,
    }
    return b.write("BENCH_phase2.json", out)


# ------------------------------------------------- significance bench
def significance_bench(b: Bench, N, L, E_max, rows, n_sizes):
    """BENCH_significance.json: one-sweep prefix-snapshot convergence
    tables vs one sweep per library size, for one chunk of ``rows``
    library series with phase 1's real bucket set; equal tables are part
    of the contract.  Extrapolated to N rows (both scale linearly)."""
    cfg = EDMConfig(E_max=E_max)
    eng = engines.get_engine(cfg.engine)
    ts = b.series(N, L, seed=5)
    plan, _ = ccm.make_bucket_plan(_optE(b, ts, cfg))
    Lp = cfg.n_points(L)
    kb = plan.buckets[-1] + 1
    lib_sizes = tuple(int(s) for s in np.linspace(max(kb + 1, Lp // 8), Lp, n_sizes))
    perm = subsample_permutation(prng.prng_key(0, b.dev), Lp)
    V = embedding.lag_matrix(ts[:rows], cfg.E_max, cfg.tau, Lp).contiguous()

    def build(sizes):
        return eng.knn_tables_prefix(V, V, kb, buckets=plan.buckets,
                                     lib_sizes=sizes, exclude_self=cfg.exclude_self,
                                     cfg=cfg, col_ids=perm)

    one_sweep = lambda: build(lib_sizes)

    def rebuild():
        outs = [build((s,)) for s in lib_sizes]
        return torch.cat([o[0] for o in outs], 1), torch.cat([o[1] for o in outs], 1)

    t_one = b.time(one_sweep, reps=1)
    t_reb = b.time(rebuild, reps=1)
    (ai, ad), (ri, rd) = one_sweep(), rebuild()
    if not (torch.equal(ai, ri) and torch.equal(ad.view(torch.int32),
                                                rd.view(torch.int32))):
        raise AssertionError("significance bench: one-sweep != rebuild tables")
    speedup = t_reb / t_one
    b.row("significance_one_sweep_chunk", t_one,
          f"N={N};L={L};rows={rows};S={n_sizes}")
    b.row("significance_rebuild_chunk", t_reb, f"speedup={speedup:.2f}x")
    out = {
        "bench": "significance_convergence_build",
        "workload": {"N": N, "L": L, "E_max": E_max, "Lp": Lp},
        "rows_timed": rows,
        "lib_sizes": list(lib_sizes),
        "n_buckets": len(plan.buckets),
        "k": kb,
        "tile_c": eng.knn_selection_tile(rows * Lp, Lp, cfg),
        "one_sweep_chunk_s": t_one,
        "rebuild_chunk_s": t_reb,
        "one_sweep_full_N_s": t_one * N / rows,
        "rebuild_full_N_s": t_reb * N / rows,
        "speedup": speedup,
        "candidate_cols_ratio": sum(lib_sizes) / lib_sizes[-1],
    }
    return b.write("BENCH_significance.json", out)


# ------------------------------------------------------------------ roofline
def roofline_summary(b: Bench, dryrun_dir=DRYRUN_DIR):
    """One row per dry-run JSON (``launch/edm_dryrun.py``, and the LM dry
    run's ``launch/dryrun.py`` beside it): the compute term, its bottleneck
    and compute fraction, peak memory and, for an EDM chunk, the
    extrapolated whole run; a skipped or failed LM cell a row of 0 that
    says so."""
    d = pathlib.Path(dryrun_dir)
    for p in sorted(d.glob("*.json")) if d.is_dir() else ():
        r = json.loads(p.read_text())
        name = f"roofline_{r['arch']}_{r['cell']}_{str(r.get('mesh')).replace(' ', '')}"
        if "skipped" in r or "failed" in r:
            b.row(name, 0.0, "SKIP" if "skipped" in r else "FAIL")
            continue
        rl = r["roofline"]
        peak = r["memory"]["peak_bytes_per_device"]
        whole = r.get("whole_run_extrapolated_s")
        b.row(name, rl["t_compute_s"],
              f"bottleneck={rl['bottleneck']};frac={rl['roofline_fraction']:.3f};"
              f"mem_GiB={'n/a' if peak is None else f'{peak / 2**30:.1f}'};"
              + (f"whole_run_s={whole['total']:.0f};" if whole else "")
              + f"device={r['device']}")
    return b.write_rows("roofline")


# ------------------------------------------------------------------- Fig 3
def fig3_strong_scaling(b: Bench, N, L, E_max, slots):
    """The main path's wall (phase 1 + phase 2, no store) against the row
    slots: ``w`` slots of this bench's one device, then every visible card
    where there are several.  Slots of one device share it, so their rows
    measure the overhead of the decomposition (chunks of w x lib_block
    rows, one dispatch per slot), as the JAX bench's spoofed CPU devices
    do; only the cards' row can show a speedup.  Every map equals the
    one-slot map byte for byte.  On cards each row carries every card's
    busy share over its timed runs (``nvidia-smi``, sampled)."""
    cfg = EDMConfig(E_max=E_max)
    ts = dummy_brain(N, L)
    base_map = base = None
    runs = [(f"fig3_workers_{w}", [b.dev] * w, f"slots={w}x{b.dev}") for w in slots]
    n_cards = torch.cuda.device_count() if b.dev.type == "cuda" else 0
    if n_cards > 1:
        runs.append((f"fig3_cards_{n_cards}", local_devices("cuda"),
                     f"cards={n_cards}"))
    for name, devs, what in runs:
        rho = run_causal_inference(ts, cfg, device=devs).rho
        if base_map is None:
            base_map = rho
        elif not np.array_equal(rho, base_map):
            raise AssertionError(f"{name}: map differs from the one-slot map")
        busy = BusySampler(n_cards) if n_cards else None
        try:
            t = b.time(lambda devs=devs: run_causal_inference(ts, cfg, device=devs))
        finally:
            busy = busy.stop()["per_card_pct"] if busy else None
        base = base or t
        kind = ("speedup" if name.startswith("fig3_cards")
                else "one_device=decomposition_overhead")
        b.row(name, t, f"spmd_overhead={100 * (t - base) / base:.0f}%;{what};"
              f"N={N};L={L};{kind};x1={base / t:.2f}"
              + ("" if busy is None else
                 ";busy_pct=" + "/".join(f"{v:.1f}" for v in busy if v is not None)))
    return b.write_rows("fig3")


# ------------------------------------------------- paper-shape scaling
def scale_bench(b: Bench, cells, E_max, shard_counts):
    """BENCH_scale.json, the JAX bench's keys: per cell (N series x L
    steps) one representative series' streaming all-E table build (per
    series the cost does not depend on N), the library-sharded build +
    merge at each simulated shard count (``sim{S}``) and over every
    visible card where there are several (``mesh{W}``), each bit-equal to
    the unsharded table, and the merge alone: the device tree
    (``merge_device_s``) against the host lexsort oracle
    (``merge_host_s``); whole-brain extrapolations as the JAX bench
    computes them."""
    cfg = EDMConfig(E_max=E_max)
    k = cfg.k_max
    eng = engines.get_engine(cfg.engine)
    n_cards = torch.cuda.device_count() if b.dev.type == "cuda" else 0
    out: dict = {"prior_ceiling_NL": PRIOR_CEILING_NL,
                 "devices": max(n_cards, 1), "smoke": False, "cells": {}}
    for N, L in cells:
        Lp = cfg.n_points(L)
        V = embedding.lag_matrix(b.series(1, L, seed=N), E_max, cfg.tau,
                                 Lp).contiguous()
        tile_c = knn.resolve_stream_tile(Lp, Lp, cfg)
        reps = 1 if N * L > 10 * PRIOR_CEILING_NL else 3
        build = lambda: eng.knn_tables(V, V, k, exclude_self=True, cfg=cfg)
        t_build = b.time(build, reps=reps)
        ref_i, ref_d = build()

        def same(got):
            return bool(torch.equal(got[0], ref_i) and torch.equal(
                got[1].view(torch.int32), ref_d.view(torch.int32)))

        sharded: dict = {}
        if n_cards > 1:
            devs = local_devices("cuda")
            fn = lambda: knn_tables_library_sharded(V, V, k, cfg, exclude_self=True,
                                                    devices=devs)
            if not same(fn()):
                raise AssertionError(f"scale {N}x{L}: mesh{n_cards} != unsharded")
            sharded[f"mesh{n_cards}"] = {"build_merge_s": b.time(fn, reps=reps),
                                         "identical": True, "collective": True}
        for S in shard_counts:
            fn = lambda S=S: knn_tables_library_sharded_sim(
                V, V, k, cfg, exclude_self=True, shards=S)
            if not same(fn()):
                raise AssertionError(f"scale {N}x{L}: sim{S} != unsharded")
            sharded[f"sim{S}"] = {"build_merge_s": b.time(fn, reps=reps),
                                  "identical": True, "collective": False}
        # the merge alone, device tree vs host oracle, over the shard
        # tables of the largest shard count (built once)
        S = shard_counts[-1]
        shard = -(-Lp // S)
        parts = []
        for s in range(S):
            lo, hi = s * shard, min((s + 1) * shard, Lp)
            part = torch.nn.functional.pad(V[..., lo:max(lo, hi)],
                                           (0, shard - max(0, hi - lo)))
            parts.append(eng.knn_tables(V, part.contiguous(), min(k, shard),
                                        exclude_self=True, cfg=cfg,
                                        col_offset=lo, col_hi=hi))
        idx_p, d_p = [p[0] for p in parts], [p[1] for p in parts]
        t_merge_dev = b.time(lambda: knn.merge_topk_tree(idx_p, d_p, k),
                             reps=max(reps, 3))
        host_i = [i.cpu().numpy() for i in idx_p]
        host_d = [d.cpu().numpy() for d in d_p]
        t0 = time.perf_counter()
        hi_, hd_ = knn.merge_shard_tables(host_i, host_d, k=k)
        t_merge_host = time.perf_counter() - t0
        if not (np.array_equal(hi_, ref_i.cpu().numpy())
                and np.array_equal(hd_.view(np.int32),
                                   ref_d.cpu().numpy().view(np.int32))):
            raise AssertionError(f"scale {N}x{L}: host merge != unsharded")
        cell = {
            "N": N, "L": L, "Lp": Lp, "E_max": E_max, "k": k,
            "NL": N * L, "ceiling_ratio": N * L / PRIOR_CEILING_NL,
            "tile_c": tile_c,
            "streaming_bytes": knn.streaming_bytes(Lp, k, tile_c, E_max),
            "knn_build_s": t_build,
            "sharded": sharded,
            "merge_device_s": t_merge_dev,
            "merge_host_s": t_merge_host,
            "phase1_tables_extrapolated_s": t_build * N,
            "phase1_tables_per_512_workers_s": t_build * N / 512,
        }
        out["cells"][f"{N}x{L}"] = cell
        b.row(f"scale_{N}x{L}_knn_build", t_build,
              f"Lp={Lp};tile={tile_c};NL={N * L}"
              f";ceiling_x={cell['ceiling_ratio']:.0f}")
        for sk, sv in sharded.items():
            b.row(f"scale_{N}x{L}_sharded_{sk}", sv["build_merge_s"],
                  "identical=True")
        b.row(f"scale_{N}x{L}_merge", t_merge_dev,
              f"host={t_merge_host * 1e6:.0f}us;"
              f"device_vs_host={t_merge_host / max(t_merge_dev, 1e-9):.1f}x")
    # per-series build ~ E_max * Lp^2: the constant from the largest cell,
    # projected to the paper's two datasets (the JAX bench's model)
    big = out["cells"][f"{cells[-1][0]}x{cells[-1][1]}"]
    c0 = big["knn_build_s"] / (big["E_max"] * big["Lp"] ** 2)
    for name, (Np, Lraw) in {"fish1_normo": (53053, 1450),
                             "subject11": (101729, 8528)}.items():
        t_series = c0 * 20 * (Lraw - 20) ** 2
        out[f"model_{name}"] = {
            "N": Np, "L": Lraw,
            "phase1_tables_s_1core": t_series * Np,
            "phase1_tables_s_512_workers": t_series * Np / 512,
        }
        b.row(f"scale_model_{name}", t_series * Np / 512,
              "per_512_workers_extrapolated")
    return b.write("BENCH_scale.json", out)


BENCHES = {
    "table2": table2_speedup,
    "fig6": fig6_scaling_N,
    "fig7": fig7_scaling_L,
    "fig8": fig8_breakdown,
    "fig9": fig9_multiE_kernel,
    "fig9b": fig9b_knn_impl_variants,
    "knn": knn_selection_bench,
    "phase2": phase2_engine_bench,
    "significance": significance_bench,
    "roofline": roofline_summary,
    "fig3": fig3_strong_scaling,
    "scale": scale_bench,
}


def run(names, device=None, out=DEFAULT_OUT, tiny: bool = False,
        header: bool = True) -> dict:
    """Run the named benches; {name: the JSON each wrote}."""
    unknown = [n for n in names if n not in BENCHES]
    if unknown:
        raise ValueError(f"unknown bench(es) {unknown}; available: {list(BENCHES)}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    results = {}
    if header:
        print("name,us_per_call,derived", flush=True)
    for name in names:
        b = Bench(dev, pathlib.Path(out))
        results[name] = BENCHES[name](b, **SIZES[name]["tiny" if tiny else "card"])
    return results


# ------------------------------------------------ the regression gate
def gates(tiny: bool = False) -> dict[str, tuple[str, list[tuple[str, ...]]]]:
    """bench -> (its JSON, the gated timing fields as key paths): the JAX
    gate's fields, ``reference`` read as ``torch-reference`` and
    ``pallas-interpret`` as ``cuda``.  The knn fields are at Lc 64,000 and
    16,000 at card sizes, at the sweep's largest Lc under ``--tiny``.
    Wall times only: the derived ratios divide out the machine's speed and
    the working sets are deterministic."""
    sweep = SIZES["knn"]["tiny" if tiny else "card"]["Lc_sweep"]
    lc_ref, lc_cuda = (str(max(sweep)),) * 2 if tiny else ("64000", "16000")
    return {
        "phase2": ("BENCH_phase2.json",
                   [("seed_path", "phase2_s"), ("new_path", "phase2_s"),
                    ("tiled_path", "phase2_s")]),
        "knn": ("BENCH_knn.json",
                [("phase1", "auto_s"),
                 ("engines", "torch-reference", lc_ref, "stream_s"),
                 ("engines", "cuda", lc_cuda, "stream_s")]),
        "significance": ("BENCH_significance.json",
                         [("one_sweep_chunk_s",), ("rebuild_chunk_s",)]),
    }


#: the gated fields at card sizes
GATES = gates()
#: the slowdown past which a gated field regresses
SLOWDOWN_LIMIT = float(os.environ.get("BENCH_GATE_LIMIT", "1.5"))
#: the knn-gate's margin over the slab timed in the same run (timer noise
#: where the two layouts tie)
KNN_STREAM_MARGIN = float(os.environ.get("KNN_STREAM_MARGIN", "1.15"))


def _dig(d: dict, path: tuple[str, ...]) -> float:
    for k in path:
        d = d[k]
    return float(d)


def _cards(base: dict, fresh: dict) -> str:
    """The row's card fields (commas dropped: the rows are CSV)."""
    def one(d):
        return str(d.get("card")).replace(",", "")
    return f"base_card={one(base)};fresh_card={one(fresh)}"


def _knn_stream_gate(base: dict, fresh: dict, floor: dict,
                     summary: list | None = None) -> bool:
    """The knn-gate: the fresh streaming build at every benched Lc on both
    engines at most the slab's -- the slab timed in the same run (times
    KNN_STREAM_MARGIN) or the baseline's slab (times SLOWDOWN_LIMIT).
    ``floor`` keeps the best streaming time per cell across passes."""
    ok = True
    for engine, rows in fresh.get("engines", {}).items():
        for lc, r in sorted(rows.items(), key=lambda kv: int(kv[0])):
            key = f"BENCH_knn.json:knn-gate.{engine}.Lc{lc}"
            f = min(float(r["stream_s"]), floor.get(key, float("inf")))
            floor[key] = f
            slab_fresh = float(r["slab_s"])
            slab_base = float(base.get("engines", {}).get(engine, {}).get(lc, {}).get(
                "slab_s", slab_fresh))
            limit = max(slab_fresh * KNN_STREAM_MARGIN, slab_base * SLOWDOWN_LIMIT)
            verdict = "OK" if f <= limit else "STREAM_SLOWER_THAN_SLAB"
            ok = ok and verdict == "OK"
            if summary is not None:
                summary.append({
                    "gate": key, "bench": "knn", "kind": "knn-stream",
                    "fresh_s": f, "slab_fresh_s": slab_fresh,
                    "slab_base_s": slab_base, "limit_s": limit,
                    "verdict": verdict,
                })
            print(f"gate,{key},stream={f:.3f}s;slab_fresh={slab_fresh:.3f}s;"
                  f"slab_base={slab_base:.3f}s;{verdict};{_cards(base, fresh)}",
                  flush=True)
    return ok


def check_regressions(names, baselines, fresh_dir, gated=None,
                      floor: dict | None = None,
                      summary: list | None = None) -> list[str]:
    """Compare the fresh JSONs in ``fresh_dir`` against the baselines in
    ``baselines``: one row per gated field (``gated``: :func:`gates`'
    mapping, default :data:`GATES`), the benches with a field past
    SLOWDOWN_LIMIT returned.  ``floor`` keeps the best fresh time per field
    across passes (a field regresses only if its best time is slow);
    ``summary`` collects one entry per row for CHECK_summary.json."""
    gated = GATES if gated is None else gated
    bad: list[str] = []
    floor = {} if floor is None else floor
    for name in names:
        if name not in gated:
            continue
        fname, fields = gated[name]
        base_f, fresh_f = pathlib.Path(baselines) / fname, pathlib.Path(fresh_dir) / fname
        if not base_f.exists():
            print(f"gate,{fname},SKIP_no_committed_baseline", flush=True)
            continue
        base = json.loads(base_f.read_text())
        fresh = json.loads(fresh_f.read_text())
        for path in fields:
            key = f"{fname}:{'.'.join(path)}"
            b = _dig(base, path)
            f = min(_dig(fresh, path), floor.get(key, float("inf")))
            floor[key] = f
            ratio = f / b if b > 0 else float("inf")
            verdict = "OK" if ratio <= SLOWDOWN_LIMIT else "REGRESSION"
            if verdict != "OK" and name not in bad:
                bad.append(name)
            if summary is not None:
                summary.append({
                    "gate": key, "bench": name, "kind": "drift",
                    "base_s": b, "fresh_s": f, "ratio": ratio,
                    "verdict": verdict,
                })
            print(f"gate,{key},base={b:.3f}s;fresh={f:.3f}s;ratio={ratio:.2f}x;"
                  f"{verdict};{_cards(base, fresh)}", flush=True)
        if name == "knn" and not _knn_stream_gate(base, fresh, floor, summary):
            if name not in bad:
                bad.append(name)
    return bad


def check(names, device=None, out=DEFAULT_OUT, baselines=None,
          tiny: bool = False) -> dict:
    """The ``--check`` run: the benches into ``<out>/fresh/``, the gate
    against ``baselines`` (default ``out``), one retry of the offending
    benches, CHECK_summary.json.  Returns the summary; exits nonzero on a
    regression that the retry does not clear."""
    gated = gates(tiny)
    if not [n for n in names if n in gated]:
        sys.exit(f"--check needs at least one gated bench: {list(gated)}")
    fresh_dir = pathlib.Path(out) / "fresh"
    baselines = pathlib.Path(out if baselines is None else baselines)
    for name in names:  # a stale fresh JSON must never stand in for this run's
        if name in gated:
            (fresh_dir / gated[name][0]).unlink(missing_ok=True)
    (fresh_dir / "CHECK_summary.json").unlink(missing_ok=True)
    run(names, device, fresh_dir, tiny)
    floor: dict = {}
    summary: list = []
    bad = check_regressions(names, baselines, fresh_dir, gated, floor, summary)
    if bad:
        # one retry of only the offending benches: noise clears (best of
        # two per field), a real regression stays
        print(f"gate,retry,rerunning_{'+'.join(bad)}_once", flush=True)
        run(bad, device, fresh_dir, tiny, header=False)
        summary = [e for e in summary if e["bench"] not in bad]
        bad = check_regressions(bad, baselines, fresh_dir, gated, floor, summary)
    out_summary = {
        "slowdown_limit": SLOWDOWN_LIMIT,
        "knn_stream_margin": KNN_STREAM_MARGIN,
        "benches": list(names),
        "gates": summary,
        "failed": bad,
        "passed": not bad,
    }
    fresh_dir.mkdir(parents=True, exist_ok=True)
    (fresh_dir / "CHECK_summary.json").write_text(json.dumps(out_summary, indent=1))
    if bad:
        sys.exit(f"bench regression gate FAILED: {bad} slower than "
                 f"{SLOWDOWN_LIMIT}x baseline (see the gate rows above; refresh "
                 f"the baselines by rerunning without --check)")
    print(f"gate,all,within_{SLOWDOWN_LIMIT}x_of_baselines", flush=True)
    return out_summary


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*", help=f"benches (default all): {list(BENCHES)}")
    ap.add_argument("--out", default=str(DEFAULT_OUT),
                    help="directory of the BENCH_*.json files (default build/bench)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--tiny", action="store_true", help="test sizes")
    ap.add_argument("--check", action="store_true",
                    help="the regression gate: fresh JSONs to <out>/fresh/, "
                    "compared against --baselines")
    ap.add_argument("--baselines", default=None,
                    help="directory of the gate's baseline JSONs (default --out)")
    args = ap.parse_args(argv)
    unknown = [n for n in args.names if n not in BENCHES]
    if unknown:
        ap.error(f"unknown bench(es) {unknown}; available: {list(BENCHES)}")
    names = args.names or list(BENCHES)
    if args.check:
        return check(names, args.device, args.out, args.baselines, args.tiny)
    if args.baselines is not None:
        ap.error("--baselines takes effect only with --check")
    return run(names, args.device, args.out, args.tiny)


if __name__ == "__main__":
    main()
