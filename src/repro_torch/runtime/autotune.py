"""Recorded-timing autotuner of the port: replay a store's telemetry,
tune the knobs — the counterpart of ``repro.runtime.autotune``, with its
constants and decision rules unchanged.

The fleet has three hand-set geometry knobs — ``chunk_rows`` (row-chunk
height = devices x lib_block), ``target_tile`` (phase-2 column tile
width), ``knn_tile_c`` (streaming kNN candidate-tile width) — and every
one of them is BIT-INVISIBLE to outputs (any geometry produces
byte-identical causal_map/rho_conv/pvals).  That invariant is what
makes automated tuning safe: a recommendation can
never change results, only wall time.  This module closes the loop the
paper closed by hand (SSIV-B profiling -> per-node work shapes):

  recommend(store)  — replay the per-worker telemetry JSONL a run
                      recorded (runtime/telemetry.py) and derive tuned
                      knob values from MEASURED timings;
  write_tuned()     — persist them as ``tuned.json`` beside
                      ``fleet.json`` (same atomic-write discipline);
  load_tuned()      — read them back (fleet restart / --autotune);
  apply_to_cfg()    — stamp them into an EDMConfig for the next run;
                      on a card, ``lib_block`` capped so that a chunk
                      fits the memory free for it (``fit_lib_block``,
                      a rule of the port alone).

Decision rules (the JAX package's DESIGN.md SS11):

  chunk_rows   — rows/sec measured from phase2+sig "chunk" spans,
                 scaled to TARGET_CHUNK_S seconds of compute per chunk
                 (long enough to amortize dispatch, short enough that a
                 lease TTL covers several chunks), rounded to the
                 recorded chunk's row multiple and clamped to [min(8),
                 the run's N].
  target_tile  — the store-overhead ratio (mean write_tile span /
                 mean per-tile compute) steers a pow2 resize of the
                 recorded tile: > WRITE_RATIO_HI means tiles are too
                 narrow (per-tile overhead dominates) -> double;
                 < WRITE_RATIO_LO with more than one tile per row
                 chunk -> halve (narrower tiles shrink the live
                 working set for free).  Clamped to [TILE_MIN, N].
  knn_tile_c   — pin the width the engine actually calibrated at the
                 largest recorded library length (the "engine"/
                 "knn_tile" counter), so the next run skips calibration
                 and keeps the same kernel shapes across restarts.

Schedule knobs (evidence comes from the lease queue's held-time
counters and the streamer's drain spans):

  ttl          — lease expiry sized from the MEASURED hold-time tail:
                 TTL_SAFETY x held p95, clamped to [TTL_MIN, TTL_MAX].
                 A TTL far above real hold times parks crashed units
                 for minutes; far below it triggers spurious steals of
                 slow-but-alive workers.
  workers      — straggler-tail share model: with W workers a stage's
                 tail is ~ one unit hold (the barrier waits on the last
                 unit), so tail share ≈ p95 / (busy/W + p95).  Pick the
                 largest W keeping that share under TAIL_TARGET:
                 W = busy_total x TAIL_TARGET / (p95 x (1-TAIL_TARGET)).
  stream_depth — drain overlap: gather_share = (time the drain spent
                 blocked on device gathers) / (chunk compute time).
                 Above GATHER_HI the device is finishing ahead of the
                 host pipeline -> one more chunk in flight; below
                 GATHER_LO at depth > 2 the extra buffer is dead weight
                 -> shrink.  Clamped to [1, DEPTH_MAX].

Geometry knobs land in the EDMConfig (apply_to_cfg); schedule knobs are
applied by ``edm_run`` (it spawns workers with the tuned ttl and
prints the worker recommendation — worker count is the user's budget
call, never silently changed).

Every recommendation carries its evidence (the aggregates it was
derived from) in tuned.json, so a recommendation is auditable and a
rerun under different hardware visibly re-derives different shapes.

On a card a ``chunk`` span closes once the chunk's kernels are queued:
its seconds are the host's dispatch time, so the chunk_rows rule scales
a dispatch rate and lands far above what the device itself would ask
for.  ``recommend`` keeps the JAX rule all the same; ``apply_to_cfg``
given the memory a slot may use caps ``lib_block`` to what fits it
(``edm_run`` passes the card's free memory and prints the cap).

  PYTHONPATH=src python -m repro_torch.runtime.autotune STORE [--write]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib

from repro_torch.runtime import telemetry

TUNED_NAME = "tuned.json"
TUNED_VERSION = 1

#: target seconds of compute per row chunk (see module docstring).
TARGET_CHUNK_S = 20.0
#: store-overhead band steering the target_tile resize.
WRITE_RATIO_HI = 0.10
WRITE_RATIO_LO = 0.025
TILE_MIN = 16
CHUNK_ROWS_MIN = 8

#: schedule-knob bands (module docstring).
TTL_SAFETY = 4.0
TTL_MIN = 60.0
TTL_MAX = 3600.0
TAIL_TARGET = 0.2
WORKERS_MAX = 64
GATHER_HI = 0.15
GATHER_LO = 0.02
DEPTH_MAX = 4


def _pow2_at_most(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def replay(out_dir: str | pathlib.Path) -> dict:
    """Aggregate a store's recorded telemetry into the sufficient
    statistics of the decision rules: per-stage chunk span sums, store
    write span sums, and the engine calibration counters."""
    agg = {
        "chunk_s": 0.0, "chunk_rows_done": 0, "chunks": 0,
        "tiles_per_chunk": 0, "rec_chunk_rows": 0, "rec_tile": 0,
        "write_s": 0.0, "writes": 0, "write_bytes": 0,
        "knn_tile": {},  # Lc -> calibrated width
        "records": 0, "N": 0,
        # schedule-knob evidence
        "held": [],          # unit hold durations (done + stolen + released)
        "gather_s": 0.0,     # drain time blocked on device gathers
        "busy_by_worker": {},  # worker file -> chunk-span seconds
        "rec_depth": 0,      # stream depth the run actually ran
        "rec_workers": 0,    # worker count the run actually ran
    }
    for stem, rec in telemetry.iter_store_records(out_dir):
        agg["records"] += 1
        stage, name = rec.get("stage"), rec.get("name")
        attrs = rec.get("attrs") or {}
        if name == "held" and rec.get("kind") == "counter":
            agg["held"].append(float(rec.get("value", 0.0)))
        elif name == "drain" and "dur_s" in rec:
            agg["gather_s"] += float(attrs.get("gather_s", 0.0))
            if attrs.get("depth"):
                agg["rec_depth"] = max(agg["rec_depth"], int(attrs["depth"]))
        elif name == "run_config":
            if attrs.get("stream_depth"):
                agg["rec_depth"] = max(agg["rec_depth"],
                                       int(attrs["stream_depth"]))
            if attrs.get("workers"):
                agg["rec_workers"] = max(agg["rec_workers"],
                                         int(attrs["workers"]))
        if name == "chunk" and stage in ("phase2", "sig"):
            agg["busy_by_worker"][stem] = (
                agg["busy_by_worker"].get(stem, 0.0) + rec.get("dur_s", 0.0)
            )
            agg["chunk_s"] += rec.get("dur_s", 0.0)
            agg["chunk_rows_done"] += int(attrs.get("rows", 0))
            agg["chunks"] += 1
            agg["rec_chunk_rows"] = max(
                agg["rec_chunk_rows"], int(attrs.get("chunk_rows", 0))
            )
            if attrs.get("tile"):
                agg["rec_tile"] = max(agg["rec_tile"], int(attrs["tile"]))
            if attrs.get("n_tiles"):
                agg["tiles_per_chunk"] = max(
                    agg["tiles_per_chunk"], int(attrs["n_tiles"])
                )
        elif name in ("write_tile", "write_block") and "dur_s" in rec:
            agg["write_s"] += rec["dur_s"]
            agg["writes"] += 1
            agg["write_bytes"] += int(attrs.get("bytes", 0))
        elif name == "knn_tile" and stage == "engine":
            agg["knn_tile"][int(attrs.get("Lc", 0))] = int(rec.get("value", 0))
        elif name == "causal_map" and stage == "assemble":
            agg["N"] = max(agg["N"], int(attrs.get("N", 0)))
    return agg


def recommend(out_dir: str | pathlib.Path) -> dict | None:
    """Tuned knob values for the next run over this workload, derived
    from the store's recorded telemetry; None when the store holds no
    usable chunk records (telemetry was off or the run never computed).
    """
    agg = replay(out_dir)
    if agg["chunks"] == 0 or agg["chunk_s"] <= 0:
        return None
    rec: dict = {}

    rows_per_s = agg["chunk_rows_done"] / agg["chunk_s"]
    base = agg["rec_chunk_rows"] or CHUNK_ROWS_MIN
    want = max(CHUNK_ROWS_MIN, rows_per_s * TARGET_CHUNK_S)
    # Round to the recorded chunk's row multiple so the recommendation
    # maps cleanly onto devices x lib_block at apply time.
    chunk_rows = max(base, int(round(want / base)) * base)
    if agg["N"]:
        chunk_rows = min(chunk_rows, agg["N"])
    rec["chunk_rows"] = chunk_rows

    if agg["rec_tile"]:
        tile = agg["rec_tile"]
        if agg["writes"] and agg["chunks"] and agg["tiles_per_chunk"]:
            per_tile_compute = agg["chunk_s"] / (
                agg["chunks"] * agg["tiles_per_chunk"]
            )
            per_write = agg["write_s"] / agg["writes"]
            ratio = per_write / per_tile_compute if per_tile_compute else 0.0
            if ratio > WRITE_RATIO_HI:
                tile *= 2
            elif ratio < WRITE_RATIO_LO and agg["tiles_per_chunk"] > 1:
                tile = max(TILE_MIN, tile // 2)
            rec["write_ratio"] = round(ratio, 4)
        tile = max(TILE_MIN, _pow2_at_most(tile) if tile & (tile - 1) else tile)
        if agg["N"]:
            tile = min(tile, agg["N"])
        rec["target_tile"] = tile

    if agg["knn_tile"]:
        lc = max(agg["knn_tile"])
        rec["knn_tile_c"] = agg["knn_tile"][lc]

    # ---- schedule knobs (module docstring) ------------------------------
    held = sorted(agg["held"])
    held_p95 = held[min(len(held) - 1, int(0.95 * (len(held) - 1)))] \
        if held else None
    if held_p95 is not None and held_p95 > 0:
        rec["ttl"] = round(
            min(TTL_MAX, max(TTL_MIN, TTL_SAFETY * held_p95)), 1)
        busy_total = sum(agg["busy_by_worker"].values())
        if busy_total > 0:
            w = busy_total * TAIL_TARGET / (held_p95 * (1.0 - TAIL_TARGET))
            rec["workers"] = int(min(WORKERS_MAX, max(1, w)))
        rec["held_p95_s"] = round(held_p95, 4)
    depth = agg["rec_depth"]
    if depth and agg["chunk_s"] > 0:
        gather_share = agg["gather_s"] / agg["chunk_s"]
        if gather_share > GATHER_HI:
            depth += 1
        elif gather_share < GATHER_LO and depth > 2:
            depth -= 1
        rec["stream_depth"] = int(min(DEPTH_MAX, max(1, depth)))
        rec["gather_share"] = round(gather_share, 4)

    evidence = {k: v for k, v in agg.items()
                if k not in ("knn_tile", "held")}
    evidence["knn_tile"] = {str(k): v for k, v in agg["knn_tile"].items()}
    evidence["held_n"] = len(held)
    evidence["held_p95_s"] = held_p95
    for k in ("held_p95_s", "gather_share"):
        if k in rec:
            evidence[k] = rec.pop(k)
    return {
        "v": TUNED_VERSION,
        "from": str(pathlib.Path(out_dir)),
        "recommend": {
            k: rec[k]
            for k in ("chunk_rows", "target_tile", "knn_tile_c",
                      "stream_depth", "ttl", "workers")
            if k in rec
        },
        "evidence": evidence,
    }


# ------------------------------------------------------------ persistence
def tuned_path(out_dir: str | pathlib.Path) -> pathlib.Path:
    return pathlib.Path(out_dir) / TUNED_NAME


def write_tuned(out_dir: str | pathlib.Path, tuned: dict) -> pathlib.Path:
    from repro_torch.data.store import atomic_write_text

    p = tuned_path(out_dir)
    p.parent.mkdir(parents=True, exist_ok=True)
    atomic_write_text(p, json.dumps(tuned, indent=1))
    return p


def load_tuned(out_dir: str | pathlib.Path) -> dict | None:
    p = tuned_path(out_dir)
    if not p.exists():
        return None
    try:
        t = json.loads(p.read_text())
    except ValueError:
        return None
    return t if t.get("v") == TUNED_VERSION and "recommend" in t else None


#: the share of the memory a card has free for a run that a tuned chunk
#: may fill (the rest: the allocator's rounding and fragmentation -- phase
#: 1's and the tables' blocks split among the lookups' large buffers --
#: and the kernels' workspaces)
FIT_SHARE = 0.8


def chunk_row_bytes(cfg, N: int, L: int, n_tables: int | None = None) -> int:
    """Device bytes one library row adds to a phase-2 chunk at the run's
    shapes, as the chunk allocates them (``core/ccm.py``): its lag rows
    (E_max, Lp) float32; its kNN tables, ``n_tables`` (default E_max, the
    most a bucketed run has: its bucket count is known only after phase
    1) of (Lp, k) entries, each an int32 index, a float32 weight and a
    distance in the accumulator's dtype; one target block's predictions
    (T, Lp) float32 and the Pearson's centred copy of them, T =
    min(target_block, target_tile or N, N); and its rho row, N float32 in
    each of the stream's depth + 1 chunks."""
    Lp = cfg.n_points(L)
    n_tables = cfg.E_max if n_tables is None else n_tables
    dist = 2 if cfg.dist_dtype == "bfloat16" else 4
    T = min(cfg.target_block, cfg.target_tile or N, N)
    return (4 * cfg.E_max * Lp + n_tables * Lp * cfg.k_max * (8 + dist)
            + 2 * 4 * T * Lp + 4 * N * (cfg.stream_depth + 1))


def run_fixed_bytes(cfg, N: int, L: int) -> int:
    """Device bytes a slot holds whatever ``lib_block``: untiled, the series
    (N, L) and the targets' futures (N, Lp) float32 and (bucketed) the
    inverse column order (N int64); tiled, one tile's futures."""
    Lp = cfg.n_points(L)
    if cfg.target_tile:
        return 4 * cfg.target_tile * Lp
    return 4 * N * (L + Lp) + 8 * N


def fit_lib_block(cfg, N: int, L: int, free_bytes: int) -> int:
    """The largest ``lib_block`` whose phase-2 chunk fits ``free_bytes``
    (the device memory one slot may use) at FIT_SHARE, by
    :func:`chunk_row_bytes` and :func:`run_fixed_bytes`; at least 1."""
    room = FIT_SHARE * free_bytes - run_fixed_bytes(cfg, N, L)
    return max(1, int(room // chunk_row_bytes(cfg, N, L)))


def apply_to_cfg(cfg, tuned: dict, n_devices: int, free_bytes: int | None = None,
                 N: int | None = None, L: int | None = None):
    """EDMConfig with the tuned shapes stamped in (byte-identity makes
    any of them safe to apply): chunk_rows -> lib_block (per-device row
    share; ``n_devices`` the run's device slots over every rank, as
    the JAX package's global device count), target_tile / knn_tile_c /
    stream_depth verbatim.  The
    remaining schedule knobs (ttl, workers) are process-level, not
    config-level — ``edm_run`` applies / prints them.

    ``free_bytes`` (the device memory one slot may use; ``N`` and ``L``
    the run's series count and length with it): ``lib_block`` is capped
    at :func:`fit_lib_block` of the tuned config, a decision of the port
    (the JAX rule scales ``chunk_rows`` to time alone, and at 16,384
    series asks for several times a card's memory).  Without it, the
    JAX package's apply."""
    rec = tuned["recommend"]
    fields = {}
    if rec.get("chunk_rows"):
        fields["lib_block"] = max(1, int(rec["chunk_rows"]) // max(1, n_devices))
    if rec.get("target_tile"):
        fields["target_tile"] = int(rec["target_tile"])
    if rec.get("knn_tile_c"):
        fields["knn_tile_c"] = int(rec["knn_tile_c"])
    if rec.get("stream_depth"):
        fields["stream_depth"] = int(rec["stream_depth"])
    cfg = dataclasses.replace(cfg, **fields) if fields else cfg
    if free_bytes is not None:
        cap = fit_lib_block(cfg, N, L, free_bytes)
        if cfg.lib_block > cap:
            cfg = dataclasses.replace(cfg, lib_block=cap)
    return cfg


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Replay a run store's telemetry and print (or write) "
        "tuned geometry knobs for the next run (see edm_run --autotune)."
    )
    ap.add_argument("store", help="run store holding telemetry/*.jsonl")
    ap.add_argument("--write", action="store_true",
                    help="persist the recommendation as <store>/tuned.json")
    args = ap.parse_args(argv)
    tuned = recommend(args.store)
    if tuned is None:
        raise SystemExit(
            f"{args.store}: no chunk telemetry to tune from (was the run "
            "recorded with the JSONL sink enabled?)"
        )
    print(json.dumps(tuned, indent=1))
    if args.write:
        print(f"wrote {write_tuned(args.store, tuned)}")


if __name__ == "__main__":
    main()
