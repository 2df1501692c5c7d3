"""EDM causal-inference launcher of the port — the main path on the card.

  PYTHONPATH=src python -m repro_torch.launch.edm_run \\
      --synthetic 2048x1450 --e-max 20 --out /tmp/causal_map
  PYTHONPATH=src python -m repro_torch.launch.edm_run \\
      --synthetic 16384x1450 --e-max 20 --target-tile 4096 --out /tmp/cm
  PYTHONPATH=src python -m repro_torch.launch.edm_run \\
      --synthetic 2048x1450 --lib-sizes 100,200,400,800,1430 \\
      --surrogates 20 --fdr 0.05 --seed 0 --target-tile 512 --out /tmp/cm
  PYTHONPATH=src python -m repro_torch.launch.edm_run \\
      --dataset /path/to/store --out /tmp/causal_map --device cpu
  # the masterless fleet: W worker processes share the card
  PYTHONPATH=src python -m repro_torch.launch.edm_run \\
      --synthetic 16384x1450 --e-max 20 --workers 2 --out /tmp/fleet
  # two row slots on card 0 (several cards: EDM_LOCAL_DEVICE_IDS=0,1)
  EDM_LOCAL_DEVICE_IDS=0,0 PYTHONPATH=src python -m \\
      repro_torch.launch.edm_run --synthetic 2048x1450 --out /tmp/cm2
  # rows across ranks: one process a rank (here rank 1 of 4, a card each)
  EDM_COORDINATOR=localhost:29500 EDM_NUM_PROCESSES=4 EDM_PROCESS_ID=1 \\
      PYTHONPATH=src python -m repro_torch.launch.edm_run \\
      --synthetic 16384x1450 --out /tmp/cm4

Runs phase 1 (simplex) and phase 2 (CCM) — bucketed by optE, or with
tables at every E under ``--no-bucketed``; untiled, or in column tiles
of ``--target-tile`` targets that bound the device memory — streams the
blocks into the zarr-lite store at --out and assembles the causal map
into <out>/causal_map/data.npy.  With ``--lib-sizes`` and/or
``--surrogates`` the significance stage follows, in the same tiles:
convergence statistics (rho_conv/, rho_trend/), surrogate p-values
(pvals/) and the BH-FDR edge list (edges/).  A rerun with the same --out
resumes: only rows missing from the store are recomputed, whatever the
new --lib-block, --target-tile or device count.  Runs on every visible
CUDA card by default (chunks of ``cards x --lib-block`` rows, or of the
slots ``EDM_LOCAL_DEVICE_IDS`` names) and exits with an error where there
is none; ``--device cpu`` (or ``--platform cpu``) runs the plain PyTorch
versions on the CPU.

The EDM_* contract (``runtime/platform.py``) is read first thing: with
EDM_COORDINATOR set the process joins a ``torch.distributed`` group.
A world of W > 1 ranks, one ``edm_run`` process a rank, joins on gloo
(its exchanges are host arrays; ranks may share a card) and splits the
rows (``runtime/ranks.py``): each rank computes its
share of every chunk of ``W x slots x --lib-block`` rows on its card
(``process_id % cards``) or on the slots its ``EDM_LOCAL_DEVICE_IDS``
names, writes its own manifest shard, and prints its own summary and
``rank r/W done in <s>s {json}`` line; rank 0 writes the store's shared
files.  The bytes equal one process's for any W, and a rerun may change
W.  A rank that dies or raises makes every other rank exit non-zero
at their next meeting (``runtime/ranks.py`` states the bound).

``--workers W`` runs the same stages across W worker processes that
claim row-span units from a lease queue in the store
(``launch/edm_fleet.py``), under a supervisor that relaunches a crashed
worker under its id; every artifact is byte-identical to the
single-process run for any W and ``--unit-rows``.

``--engine`` picks the engine (``cuda``: the kernels on a card, their
plain versions on the CPU; ``torch-reference``: the plain versions);
``--use-kernels`` is its deprecated alias for ``cuda``.

Telemetry is on by default: the run's spans and counters go to
``<out>/telemetry/main.jsonl`` (``p<rank>.jsonl`` for each rank of a
larger world), ``EDM_TELEMETRY=off|stdout|jsonl:<path>`` overrides the
sink and ``--no-telemetry`` turns it off; the records never touch the
outputs.  A finished run appends its summary to ``<out>/history.jsonl``
(or ``$EDM_HISTORY``; ``edm_fleet trends`` renders it).  ``--autotune``
applies the shapes of ``<out or --tune-from>/tuned.json`` (or of a fresh
replay of that store's telemetry, ``runtime/autotune.py``) before the
run and writes ``<out>/tuned.json`` from this run's telemetry after it;
every shape gives the same bytes.

  PYTHONPATH=src python -m repro_torch.launch.edm_run \\
      --synthetic 2048x1450 --autotune --out /tmp/a     # records, tunes
  PYTHONPATH=src python -m repro_torch.launch.edm_run \\
      --synthetic 2048x1450 --autotune --tune-from /tmp/a --out /tmp/b
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import time

import numpy as np

from repro_torch.core.pipeline import check_run, run_causal_inference
from repro_torch.core.types import EDMConfig
from repro_torch.data import store
from repro_torch.data.synthetic import dummy_brain
from repro_torch.engine import available_engines
from repro_torch.inference import SignificanceConfig, run_significance
from repro_torch.runtime import autotune, history, platform, telemetry
from repro_torch.runtime.ranks import Ranks


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.edm_run",
        description=__doc__.split("\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--dataset", help="zarr-lite dataset dir")
    ap.add_argument("--synthetic", help="NxL dummy dataset, e.g. 2048x1450")
    ap.add_argument("--out", required=True)
    ap.add_argument("--e-max", type=int, default=20)
    ap.add_argument("--tau", type=int, default=1)
    ap.add_argument("--lib-block", type=int, default=8)
    ap.add_argument(
        "--knn-tile", type=int, default=0,
        help="candidate-tile width of the plain kNN table functions (0 = "
        "calibrated); every width gives the same tables",
    )
    ap.add_argument(
        "--target-tile", type=int, default=0,
        help="phase-2 column tile width (0 = untiled); > 0 streams the "
        "targets in tiles so the device holds O(tile x Lp) of them; the "
        "output is the untiled one byte for byte",
    )
    ap.add_argument(
        "--no-bucketed", action="store_true",
        help="disable optE-bucketed phase 2 (all-E tables; A/B baseline)",
    )
    ap.add_argument(
        "--stream-depth", type=int, default=2,
        help="phase-2 chunks in flight (2 = double buffering, 1 = synchronous)",
    )
    ap.add_argument(
        "--lib-sizes", default="",
        help="comma-separated ascending library sizes for the convergence "
        "diagnostic, e.g. 100,200,400; writes rho_conv/ (delta-rho) and "
        "rho_trend/ (monotonic-trend) store artifacts",
    )
    ap.add_argument(
        "--surrogates", type=int, default=0,
        help="surrogate-null draws per target (0 = skip significance): "
        "writes per-pair p-values (pvals/) and the FDR-masked causal "
        "edge list (edges/)",
    )
    ap.add_argument(
        "--fdr", type=float, default=0.05,
        help="Benjamini-Hochberg FDR level of the edge mask",
    )
    ap.add_argument(
        "--surrogate-kind", default="phase", choices=("phase", "shuffle"),
        help="null model: FFT phase-randomized (spectrum-preserving) or "
        "random shuffle (amplitude-distribution only)",
    )
    ap.add_argument(
        "--seed", type=int, default=0,
        help="root seed of the significance stage: ONE threefry key "
        "derived from it drives the convergence subsampling permutation "
        "and every surrogate draw, as in the JAX package (recorded in "
        "meta.json)",
    )
    ap.add_argument(
        "--device", default=None, choices=("cuda", "cpu"),
        help="cuda (default: every visible card, or EDM_LOCAL_DEVICE_IDS; "
        "exits with an error without a card) or cpu (the plain PyTorch "
        "versions)",
    )
    ap.add_argument(
        "--platform", default=None, choices=platform.available_tiers(),
        help="platform tier (runtime/platform.py): cpu = --device cpu and "
        "the torch-reference engine, gpu = the cards and the cuda engine; "
        "tpu is refused (the port has no TPU tier)",
    )
    ap.add_argument(
        "--engine", default=None, choices=available_engines(),
        help="execution engine (repro_torch.engine registry): cuda (the "
        "hand-written kernels on a card, their plain versions on the CPU) "
        "or torch-reference (the plain PyTorch versions); default: the "
        "--platform tier's, else cuda",
    )
    ap.add_argument(
        "--use-kernels", action="store_true",
        help="DEPRECATED: same as --engine cuda",
    )
    ap.add_argument(
        "--workers", type=int, default=0,
        help="run a local fleet of this many masterless worker processes "
        "over the output store (0 = in this process); any W gives the "
        "same bytes",
    )
    ap.add_argument(
        "--unit-rows", type=int, default=0,
        help="fleet work-unit height in rows (claim granularity); 0 = one "
        "chunk (--lib-block)",
    )
    ap.add_argument(
        "--unit-retries", type=int, default=3,
        help="failed compute attempts (fleet-wide) before a work unit is "
        "poisoned and the fleet exits nonzero with its id",
    )
    ap.add_argument(
        "--max-worker-restarts", type=int, default=2,
        help="times the fleet supervisor relaunches a crashed worker under "
        "the same id before leaving its units to the others",
    )
    ap.add_argument(
        "--no-telemetry", action="store_true",
        help="disable the default per-run telemetry JSONL sink "
        "(<out>/telemetry/main.jsonl, p<rank>.jsonl in a world of several "
        "ranks); records are byte-invisible to outputs, so this only saves "
        "the write traffic.  EDM_TELEMETRY=off|stdout|jsonl:<path> "
        "overrides the default sink instead",
    )
    ap.add_argument(
        "--autotune", action="store_true",
        help="apply tuned geometry (<out or --tune-from>/tuned.json, or "
        "a fresh replay of recorded telemetry) before the run, and write "
        "<out>/tuned.json from this run's telemetry after it; shapes are "
        "byte-invisible to outputs (runtime/autotune.py)",
    )
    ap.add_argument(
        "--tune-from",
        help="store whose recorded telemetry / tuned.json seeds "
        "--autotune (default: --out itself, i.e. a rerun tunes from the "
        "previous run)",
    )
    return ap


def main(argv=None) -> dict:
    """Parse ``argv`` (default: sys.argv), run, and return a summary:
    {"result": CausalMap, "N", "L", "wall_s", "phase1_s", "phase2_s",
    "assemble_s", "rows", "cross_maps_per_s", "n_buckets", "device",
    "devices", "significance": SignificanceResult | None,
    "significance_s", "edges", "rank", "world"} (significance,
    significance_s and edges None without significance flags; ``rows``:
    the phase-2 rows this rank computed), "lib_block", "target_tile" (the
    shapes it ran, tuned or not) and "autotune": {"applied": the tuned
    shapes applied or None, "wrote": the tuned.json written or None,
    "lib_block_cap": the cap of a tuned run on a card or None};
    with ``--workers`` the fleet's summary (:func:`_run_fleet`) and
    "autotune"."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if bool(args.synthetic) == bool(args.dataset):
        ap.error("give exactly one of --synthetic NxL and --dataset DIR")
    engine_flag = f"--engine {args.engine}"
    if args.use_kernels:
        if args.engine not in (None, "cuda"):
            ap.error(f"--use-kernels conflicts with --engine {args.engine}; "
                     "drop the deprecated flag")
        print("note: --use-kernels is deprecated; use --engine cuda")
        args.engine, engine_flag = "cuda", "--use-kernels"
    engine = args.engine or "cuda"
    device = args.device or "cuda"
    if args.platform:
        try:
            tier = platform.apply_platform(args.platform)
        except ValueError as e:
            ap.error(str(e))
        if args.device not in (None, tier["device"]):
            ap.error(f"--device {args.device} conflicts with --platform "
                     f"{args.platform} (device {tier['device']})")
        if args.engine not in (None, tier["engine"]):
            ap.error(f"{engine_flag} conflicts with --platform {args.platform} "
                     f"(engine {tier['engine']})")
        device, engine = tier["device"], tier["engine"]
        print(f"platform: tier {tier['tier']} (device {device}, engine {engine})")
    # the EDM_* contract, before any work
    spec = platform.distributed_spec_from_env()
    # rows across ranks exchange host arrays only: gloo, which also lets
    # ranks share a card (NCCL would refuse it)
    rows_across_ranks = (spec is not None and spec["num_processes"] > 1
                         and args.workers == 0)
    dist = platform.init_distributed(
        spec, device=device, backend="gloo" if rows_across_ranks else None)
    if dist is not None:
        print(f"distributed: process {dist['process_id']}/"
              f"{dist['num_processes']} via {dist['coordinator']} "
              f"({dist['backend']}, {dist['device']})")
    if args.synthetic:
        N, L = map(int, args.synthetic.split("x"))
        ts = dummy_brain(N, L)
    else:
        ts = np.array(store.load_dataset(args.dataset), np.float32)
    cfg = EDMConfig(
        E_max=args.e_max, tau=args.tau, lib_block=args.lib_block,
        stream_depth=args.stream_depth, knn_tile_c=args.knn_tile,
        target_tile=args.target_tile, bucketed=not args.no_bucketed,
        engine=engine,
    )
    lib_sizes = tuple(int(s) for s in args.lib_sizes.split(",") if s)
    sig = None
    if lib_sizes or args.surrogates:
        sig = SignificanceConfig(
            lib_sizes=lib_sizes, n_surrogates=args.surrogates,
            alpha=args.fdr, surrogate=args.surrogate_kind, seed=args.seed,
        )
    # each process of the run its own JSONL: "main", or p<rank> in a world
    # of several ranks (as its fleet workers are p<rank>w<i>)
    sink = "main" if spec is None or spec["num_processes"] == 1 \
        else f"p{spec['process_id']}"
    if args.no_telemetry:
        telemetry.configure(worker=sink)
    else:
        telemetry.configure_from_env(
            default_path=telemetry.worker_jsonl(args.out, sink), worker=sink)
    try:
        if args.workers > 0:
            return _fleet_main(args, ts, cfg, sig, device, spec)
        return _in_process(args, ts, cfg, sig, device, spec, rows_across_ranks)
    finally:
        telemetry.shutdown()


def _slot_free_bytes(devs, ranks: Ranks | None, processes: int) -> int | None:
    """The device memory one slot of this run may use (None off the card):
    over the cards the run's slots are on, the least of each card's free
    memory shared among the slots on it -- of every rank of the world
    (one host), and of each of ``processes`` fleet workers.  This
    process's allocator first returns its unused cache to the card: a
    cached block is fragmented memory a chunk's large buffers may not
    fit in.  The same on every rank."""
    import torch

    cards = sorted({d.index or 0 for d in devs if d.type == "cuda"})
    if not cards:
        return None
    slots = np.zeros(torch.cuda.device_count(), np.int64)
    for d in devs:
        slots[d.index or 0] += processes
    if ranks is not None:
        slots = ranks.sum(slots, "the slots on each card")
    torch.cuda.empty_cache()
    free = [torch.cuda.mem_get_info(c)[0] // int(slots[c]) for c in cards]
    if ranks is None:
        return min(free)
    mine = np.zeros(ranks.world, np.int64)
    mine[ranks.rank] = min(free)
    return int(ranks.sum(mine, "the free memory").min())


def _tuned_cfg(args, cfg: EDMConfig, devs, shape, ranks: Ranks | None = None):
    """``--autotune``: ``cfg`` with the tuned shapes of ``--tune-from``
    (default ``--out``) stamped in — its ``tuned.json``, else a replay of
    its telemetry — and the tuned lease ttl kept in ``args.tuned_ttl``
    for the fleet's workers; the worker count is printed as a
    recommendation, never applied.  On a card ``lib_block`` is capped so
    that a chunk fits the memory free for each slot (printed on a line of
    its own; ``autotune.fit_lib_block``).  Under ranks, rank 0 loads or
    recommends and every rank applies what it shares.  Returns (cfg, the
    applied recommendation or None, the cap or None)."""
    if not args.autotune:
        return cfg, None, None
    src = args.tune_from or args.out
    tuned = None
    if ranks is None or ranks.lead:
        tuned = autotune.load_tuned(src) or autotune.recommend(src)
    if ranks is not None:
        tuned = ranks.share(tuned, "the tuned shapes")
    if tuned is None:
        if args.tune_from:
            raise SystemExit(f"--tune-from {src}: no tuned.json and no chunk "
                             "telemetry to replay")
        return cfg, None, None
    world = 1 if ranks is None else ranks.world
    free = _slot_free_bytes(devs, ranks, max(1, args.workers))
    N, L = shape
    cfg = autotune.apply_to_cfg(cfg, tuned, world * len(devs), free, N, L)
    rec = tuned["recommend"]
    cap = None
    if free is not None:
        cap = autotune.fit_lib_block(cfg, N, L, free)
        print(f"autotune: lib_block cap {cap} ({autotune.chunk_row_bytes(cfg, N, L)} "
              f"device bytes a library row, {free} free a slot): chunk_rows "
              f"{rec.get('chunk_rows')} -> lib_block {cfg.lib_block}")
    if rec.get("ttl"):
        args.tuned_ttl = float(rec["ttl"])
    if rec.get("workers") and args.workers > 0 and rec["workers"] != args.workers:
        print(f"autotune: recommend --workers {rec['workers']} (this run uses "
              f"{args.workers}; straggler-tail model, see tuned.json evidence)")
    print(f"autotune: applied {rec} from {src}")
    return cfg, rec, cap


def _run_config(args, cfg: EDMConfig) -> None:
    """The run-start clock anchor (a trace aligns timelines on it), then
    the run's config snapshot (the stream_depth and workers rules read it)."""
    telemetry.emit_clock_anchor(driver=True, workers=args.workers)
    telemetry.counter(
        "fleet", "run_config", engine=cfg.engine, lib_block=cfg.lib_block,
        target_tile=cfg.target_tile, knn_tile_c=cfg.knn_tile_c,
        stream_depth=cfg.stream_depth, workers=args.workers,
        autotune=bool(args.autotune),
    )


def _autotune_epilogue(args) -> dict | None:
    """``--autotune``: replay the telemetry this run just recorded and
    write the recommendation to ``<out>/tuned.json`` for the next run;
    returns it (None where nothing was recorded)."""
    if not args.autotune:
        return None
    tuned = autotune.recommend(args.out)
    if tuned is None:
        print("autotune: no chunk telemetry recorded this run (nothing "
              "computed, or telemetry disabled); tuned.json not updated")
        return None
    p = autotune.write_tuned(args.out, tuned)
    print(f"autotune: wrote {p}: {tuned['recommend']}")
    return tuned


def _fleet_main(args, ts, cfg, sig, device: str, spec: dict | None) -> dict:
    """``--workers``: tune, run the fleet, then (rank 0 of an EDM_* world
    only) the history record and the autotune epilogue."""
    cfg, applied, cap = _tuned_cfg(args, cfg, check_run(cfg, device), ts.shape)
    _run_config(args, cfg)
    summary = _run_fleet(args, ts, cfg, sig, device, spec)
    summary["autotune"] = {"applied": applied, "wrote": None, "lib_block_cap": cap}
    if spec is None or spec["process_id"] == 0:
        # the finalize claimer wrote the run's record; this one also
        # covers the supervisor's own records (same run: replaces it)
        history.record_run(args.out)  # flushes this process's records first
        summary["autotune"]["wrote"] = _autotune_epilogue(args)
    return summary


def _in_process(args, ts, cfg, sig, device: str, spec: dict | None,
                rows_across_ranks: bool) -> dict:
    """One process, or one rank of rows across ranks: tune, run the map
    and the significance stage, then (rank 0) the history record and the
    autotune epilogue; returns :func:`main`'s summary."""
    group = None
    if rows_across_ranks:
        import torch.distributed

        group = torch.distributed.group.WORLD
        devs = check_run(cfg, platform.rank_devices(spec, device))
    else:
        devs = check_run(cfg, device)
    ranks = Ranks(group)
    cfg, applied, cap = _tuned_cfg(args, cfg, devs, ts.shape, ranks)
    _run_config(args, cfg)
    if ranks.world > 1 and any(d.type == "cuda" for d in devs):
        from repro_torch import kernels

        if ranks.lead:  # once, before any rank loads a kernel
            kernels.build_all()
        ranks.barrier("the kernel build")
    print(f"devices: {len(devs)} slot(s) {[str(d) for d in devs]}")
    timings: dict = {}
    t0 = time.perf_counter()
    result = run_causal_inference(ts, cfg, device=devs, out_dir=args.out,
                                  progress=True, timings=timings,
                                  group=ranks.host)
    dt = time.perf_counter() - t0
    N = ts.shape[0]
    n_buckets = len(np.unique(result.optE))
    print(f"causal map {N}x{N} in {dt:.1f}s ({N * N / dt:.0f} cross-maps/s); "
          f"optE mean {result.optE.mean():.2f}; engine {cfg.engine} on "
          f"{len(devs)} x {devs[0].type}; buckets {n_buckets}/{cfg.E_max}"
          f"{'' if cfg.bucketed else ' (all-E tables)'}; tile "
          f"{cfg.target_tile or 'none'}; phase 1 "
          f"{timings['phase1_s']:.2f}s, phase 2 {timings['phase2_s']:.2f}s"
          + (f"; {ranks} ({timings['rows']} rows)" if ranks.world > 1 else ""))
    meta = {
        "optE": result.optE.tolist(),
        "engine": cfg.engine,
        "framework": "torch",
        "device": devs[0].type,
        "devices": [str(d) for d in devs],
        "bucketed": cfg.bucketed,
        "n_buckets": int(n_buckets),
        "stream_depth": cfg.stream_depth,
        "target_tile": cfg.target_tile,
        "knn_tile_c": cfg.knn_tile_c,
        "seed": args.seed,
        "ranks": ranks.world,
    }
    # The pipeline assembled the map into <out>/causal_map/data.npy; only
    # the zarr-lite meta is missing.
    if ranks.lead:
        store.save_meta(args.out + "/causal_map", result.rho.shape,
                        result.rho.dtype, meta)
    out = sig_s = None
    if sig is not None:
        t1 = time.perf_counter()
        out = run_significance(ts, result.optE, result.rho, cfg, sig,
                               device=devs, out_dir=args.out, progress=True,
                               group=ranks.host)
        sig_s = time.perf_counter() - t1
        stages = [s for s, on in (("convergence", sig.lib_sizes),
                                  ("surrogates", sig.n_surrogates)) if on]
        print(f"significance [{'+'.join(stages)}] in {sig_s:.1f}s"
              + (f"; {len(out.edges)} edges at FDR {args.fdr} "
                 f"(p* = {out.p_threshold:.4g}, {out.n_tests} tests)"
                 if out.edges is not None else ""))
    telemetry.flush()  # every rank's records durable before rank 0 reads them
    ranks.barrier("the end of the run")  # rank 0's meta and edges are written
    wrote = None
    if ranks.lead:
        history.record_run(args.out)  # the run's summary (history.jsonl)
        wrote = _autotune_epilogue(args)
    summary = {
        "result": result, "N": N, "L": int(ts.shape[1]), "wall_s": dt,
        **timings, "cross_maps_per_s": N * N / dt,
        "n_buckets": int(n_buckets), "device": devs[0].type,
        "devices": [str(d) for d in devs], "significance": out, "significance_s": sig_s,
        "edges": None if out is None or out.edges is None else len(out.edges),
        "rank": ranks.rank, "world": ranks.world,
        "lib_block": cfg.lib_block, "target_tile": cfg.target_tile,
        "autotune": {"applied": applied, "wrote": wrote, "lib_block_cap": cap},
    }
    if ranks.world > 1:
        _print_rank_record(summary, devs, time.perf_counter() - t0)
    return summary


def _print_rank_record(summary: dict, devs, wall: float) -> None:
    """A rank's last line, ``rank r/W done in <s>s {json}``: its launches
    of each kernel (per process: a reader sums them over the ranks), its
    rows, stage seconds and peak device bytes."""
    import torch

    from repro_torch.launch.edm_fleet import launch_counts

    cards = [d for d in dict.fromkeys(devs) if d.type == "cuda"]
    rec = {k: summary[k] for k in ("rank", "world", "devices", "rows", "wall_s",
                                    "phase1_s", "phase2_s", "assemble_s",
                                    "significance_s", "edges")}
    rec.update(launches=launch_counts(), peak_device_bytes=sum(
        torch.cuda.max_memory_allocated(d) for d in cards))
    print(f"rank {summary['rank']}/{summary['world']} done in {wall:.1f}s "
          f"{json.dumps(rec)}", flush=True)


def _run_fleet(args, ts, cfg, sig, device: str, spec: dict | None) -> dict:
    """``--workers W``: a local masterless fleet over ``--out``.

    The supervisor prepares the store (dataset + fleet.json, the
    engine's limits checked on the device, the kernels built once on the
    card) and spawns, watches and relaunches workers; it schedules
    nothing.  A worker that exits non-zero is relaunched under the same
    id (it reclaims its own leases at once) up to --max-worker-restarts
    times; a relaunched worker runs without EDM_FAULTS, so one armed
    fault kills one process generation.  A poisoned unit ends the fleet
    with its id.  Under an EDM_* world of several ranks, each rank's
    supervisor names its workers ``p<rank>w<i>``, so two supervisors over
    one store never share a worker id (a lease owner and a manifest
    shard).  Success is the queue's completion witnesses and every
    requested artifact.  Returns {"fleet", "N", "L", "workers",
    "wall_s", "cross_maps_per_s", "n_buckets", "device", "restarts",
    "failed", "edges"}."""
    from repro_torch.launch import edm_fleet

    out = pathlib.Path(args.out)
    dataset = args.dataset
    if args.synthetic:
        dataset = out / "dataset"
        meta_f = dataset / "meta.json"
        if meta_f.exists():
            have = json.loads(meta_f.read_text()).get("synthetic")
            if have != args.synthetic:
                raise SystemExit(
                    f"--out {out} holds a --synthetic {have} dataset but "
                    f"this run asks for {args.synthetic}; use a fresh --out dir"
                )
        else:
            store.save_dataset(dataset, ts, {"synthetic": args.synthetic})
    edm_fleet.init_fleet(out, dataset, cfg, sig, unit_rows=args.unit_rows,
                         seed=args.seed, device=device, platform=args.platform,
                         distributed=spec is not None)
    if device == "cuda":
        from repro_torch import kernels

        kernels.build_all()
    t0 = time.perf_counter()

    def spawn(wid, relaunch=False):
        env = dict(os.environ)
        if relaunch:
            env.pop("EDM_FAULTS", None)
        # ttl: the schedule knob of --autotune (None: the worker default)
        return edm_fleet.spawn_worker(out, wid, env=env,
                                      ttl=getattr(args, "tuned_ttl", None),
                                      unit_retries=args.unit_retries)

    prefix = f"p{spec['process_id']}" if spec and spec["num_processes"] > 1 else ""
    procs = {w: spawn(w) for w in (f"{prefix}w{i}" for i in range(args.workers))}
    restarts = dict.fromkeys(procs, 0)
    failed = {}
    try:
        while procs:
            poison = sorted((out / "queue").glob("*.poison"))
            if poison:
                info = json.loads(poison[0].read_text())
                raise SystemExit(
                    f"fleet failed: work unit {info.get('uid')} failed "
                    f"permanently after {info.get('attempts')} attempt(s): "
                    f"{info.get('error')}"
                )
            for wid in list(procs):
                rc = procs[wid].poll()
                if rc is None:
                    continue
                del procs[wid]
                if rc == 0:
                    continue
                if restarts[wid] < args.max_worker_restarts:
                    restarts[wid] += 1
                    print(f"worker {wid} exited {rc}; relaunching "
                          f"({restarts[wid]}/{args.max_worker_restarts})",
                          flush=True)
                    procs[wid] = spawn(wid, relaunch=True)
                else:
                    failed[wid] = rc
                    print(f"warning: worker {wid} exited {rc} with restarts "
                          "exhausted (the other workers cover its units)",
                          flush=True)
            if procs:
                time.sleep(0.25)
    finally:
        for p in procs.values():
            p.terminate()
        for p in procs.values():
            p.wait()
    # done markers land strictly after the store commit they certify; a
    # bare data.npy may be a torn memmap of a fleet that died assembling
    required = [out / "queue" / "assemble.done",
                out / "causal_map" / "data.npy",
                out / "causal_map" / "meta.json"]
    if sig is not None:
        required.append(out / "queue" / "finalize.done")
        if sig.lib_sizes:
            required += [out / "rho_conv" / "data.npy",
                         out / "rho_trend" / "data.npy"]
        if sig.n_surrogates:
            required += [out / "pvals" / "data.npy", out / "edges" / "data.npy"]
    missing = [str(p) for p in required if not p.exists()]
    if missing:
        raise SystemExit(
            f"fleet failed: missing completion witness(es) {missing} "
            f"(worker failures: {failed or 'none reported'})"
        )
    meta = json.loads((out / "causal_map" / "meta.json").read_text())
    N = meta["shape"][0]
    dt = time.perf_counter() - t0
    summary = {
        "fleet": True, "N": N, "L": int(ts.shape[1]), "workers": args.workers,
        "wall_s": dt, "cross_maps_per_s": N * N / dt,
        "n_buckets": meta["n_buckets"], "device": device,
        "restarts": restarts, "failed": failed, "edges": None,
    }
    print(f"fleet[{args.workers}] causal map {N}x{N} in {dt:.1f}s "
          f"({N * N / dt:.0f} cross-maps/s); engine {cfg.engine} on "
          f"{device}; buckets {meta['n_buckets']}/{cfg.E_max}; tile "
          f"{cfg.target_tile or 'none'}; restarts {json.dumps(restarts)}; "
          f"failed {json.dumps(failed)}", flush=True)
    emeta_f = out / "edges" / "meta.json"
    if sig is not None and emeta_f.exists():
        emeta = json.loads(emeta_f.read_text())
        summary["edges"] = emeta["n_edges"]
        print(f"significance: {emeta['n_edges']} edges at FDR {emeta['alpha']} "
              f"(p* = {emeta['p_threshold']:.4g}, {emeta['n_tests']} tests)",
              flush=True)
    return summary


if __name__ == "__main__":
    main()
