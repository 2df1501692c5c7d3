"""Run-history store of the port: the fleet's memory across runs, the
counterpart of ``repro.runtime.history`` (the JAX package's DESIGN.md
SS13), with its record format, so either package's ``edm_fleet trends``
reads the other's history.

A single run's trace (``runtime/trace.py``) answers "where did THIS
run's wall time go"; this module answers the cross-run questions — did
the last knob change help, is tonight's run slower than last week's on
the same workload.  One summary record is appended per FINISHED run, at
finalize time, to an append-only JSONL:

  * default path ``<out>/history.jsonl`` (outside every artifact dir,
    so fsck and byte-identity checks never see it); the ``EDM_HISTORY``
    env var points it at a shared file instead, accumulating history
    across stores — the knob-vs-throughput table grows one row per run.
  * crash-safe by the store's one durability primitive (write-temp +
    fsync + os.replace): a reader always sees whole records, a SIGKILL
    mid-append leaves the previous generation.
  * re-finalizing the SAME run (elastic resume, fsck --heal recompute)
    REPLACES its record rather than duplicating it — run identity is
    (out, fingerprint), so history rows stay one-per-run.

The run's identity comes from the store's own files (``fleet.json`` or
``causal_map/meta.json``, and ``fingerprint.json``); the keys the port
adds there (``framework``, ``device``) are not read, as the JAX module
reads none of the keys it does not list, and the port's fingerprint
(which covers ``framework``) is taken as it stands.

Records are written only when there is evidence to summarize (a
telemetry sink is active or ``EDM_HISTORY`` is set) — a telemetry-off
run leaves the store exactly as before.

``edm_fleet trends`` renders a history file as a cross-run table with
regression flags (total wall vs the previous run of the same
fingerprint) and a knob-vs-throughput rollup grouped by geometry.
"""
from __future__ import annotations

import json
import os
import pathlib
import time
from typing import Any, Optional

from repro_torch.runtime import telemetry

HISTORY_NAME = "history.jsonl"
HISTORY_VERSION = 1
#: wall-time growth vs the previous same-fingerprint run that flags a
#: regression in `edm_fleet trends` (20% — above run-to-run jitter).
REGRESSION_PCT = 20.0


def history_path(out_dir: str | pathlib.Path) -> pathlib.Path:
    """EDM_HISTORY env override, else ``<out>/history.jsonl``."""
    env = os.environ.get("EDM_HISTORY", "")
    if env:
        return pathlib.Path(env)
    return pathlib.Path(out_dir) / HISTORY_NAME


# ------------------------------------------------------------ record build
def _run_identity(out: pathlib.Path) -> dict:
    """(N, L, engine, geometry, fingerprint) from the store's own files —
    fleet.json when the run was a fleet, causal_map/meta.json otherwise."""
    ident: dict[str, Any] = {
        "fingerprint": None, "N": None, "L": None, "engine": None,
        "geometry": {},
    }
    fp_f = out / "fingerprint.json"
    if fp_f.exists():
        try:
            ident["fingerprint"] = json.loads(
                fp_f.read_text()).get("fingerprint")
        except ValueError:
            pass
    spec_f = out / "fleet.json"
    if spec_f.exists():
        try:
            spec = json.loads(spec_f.read_text())
        except ValueError:
            spec = {}
        cfg = spec.get("cfg") or {}
        ident.update(
            N=spec.get("N"), L=spec.get("L"),
            engine=cfg.get("engine"),
            fingerprint=spec.get("fingerprint", ident["fingerprint"]),
        )
        ident["geometry"] = {
            "unit_rows": spec.get("unit_rows"),
            "lib_block": cfg.get("lib_block"),
            "target_tile": cfg.get("target_tile"),
            "knn_tile_c": cfg.get("knn_tile_c"),
            "stream_depth": cfg.get("stream_depth"),
        }
        return ident
    meta_f = out / "causal_map" / "meta.json"
    if meta_f.exists():
        try:
            meta = json.loads(meta_f.read_text())
        except ValueError:
            meta = {}
        shape = meta.get("shape") or [None, None]
        ident.update(N=shape[0], engine=meta.get("engine"))
        ident["geometry"] = {
            "target_tile": meta.get("target_tile"),
            "knn_tile_c": meta.get("knn_tile_c"),
            "stream_depth": meta.get("stream_depth"),
        }
    return ident


def build_record(out_dir: str | pathlib.Path) -> dict:
    """One run-summary record from a store's recorded telemetry + specs:
    fingerprint, geometry, engine, per-stage span durations, bytes
    written, chunk p50/p95/p99, steal/retry/poison counts, worker count,
    and derived rows/s throughput (phase2+sig chunk rows over their span
    time).  Telemetry-off stores yield a record with zeroed timings —
    identity fields still make it a useful trend row."""
    out = pathlib.Path(out_dir)
    rec: dict[str, Any] = {
        "v": HISTORY_VERSION,
        "t": time.time(),
        "out": str(out.resolve()),
        **_run_identity(out),
        "workers": 0,
        "stages": {},
        "total_span_s": 0.0,
        "bytes_written": 0,
        "chunks": 0,
        "chunk_p50_s": None, "chunk_p95_s": None, "chunk_p99_s": None,
        "rows_per_s": None,
        "steals": 0, "retries": 0, "poisoned": 0,
        "held_p95_s": None,
    }
    stems: set[str] = set()
    chunk_durs: list[float] = []
    held: list[float] = []
    chunk_rows = 0
    chunk_s = 0.0
    done_uids: set[str] = set()
    for stem, r in telemetry.iter_store_records(out):
        if telemetry.validate(r):
            continue
        stems.add(stem)
        stage, name, attrs = r["stage"], r["name"], r["attrs"] or {}
        if r["kind"] == "span":
            st = rec["stages"].setdefault(stage, {"span_s": 0.0})
            st["span_s"] += r["dur_s"]
            rec["total_span_s"] += r["dur_s"]
            if name == "chunk":
                chunk_durs.append(r["dur_s"])
                if stage in ("phase2", "sig"):
                    chunk_rows += int(attrs.get("rows", 0))
                    chunk_s += r["dur_s"]
            elif name in ("write_tile", "write_block"):
                rec["bytes_written"] += int(attrs.get("bytes", 0))
            continue
        if name == "steal":
            rec["steals"] += 1
        elif name == "unit_failed":
            rec["retries"] += 1
        elif name == "unit_poisoned":
            rec["poisoned"] += 1
        elif name == "held":
            held.append(float(r.get("value", 0.0)))
        elif name == "done":
            # dedupe: a crash between record-flush and marker can leave
            # two done records for one uid (see workqueue.mark_done)
            done_uids.add(str(attrs.get("uid", "")))
    rec["workers"] = len(stems)
    rec["chunks"] = len(chunk_durs)
    rec["units_done"] = len(done_uids)
    chunk_durs.sort()
    held.sort()

    def pct(vals: list[float], p: float) -> Optional[float]:
        if not vals:
            return None
        return round(vals[min(len(vals) - 1, int(p * (len(vals) - 1)))], 6)

    rec["chunk_p50_s"] = pct(chunk_durs, 0.50)
    rec["chunk_p95_s"] = pct(chunk_durs, 0.95)
    rec["chunk_p99_s"] = pct(chunk_durs, 0.99)
    rec["held_p95_s"] = pct(held, 0.95)
    if chunk_s > 0 and chunk_rows > 0:
        rec["rows_per_s"] = round(chunk_rows / chunk_s, 4)
    for st in rec["stages"].values():
        st["span_s"] = round(st["span_s"], 6)
    rec["total_span_s"] = round(rec["total_span_s"], 6)
    return rec


# ------------------------------------------------------------- persistence
def load_history(path: str | pathlib.Path) -> list[dict]:
    """Valid history records in file order (append order == time order)."""
    return [r for r in telemetry.read_jsonl(path)
            if isinstance(r, dict) and r.get("v") == HISTORY_VERSION]


def append_record(path: str | pathlib.Path, rec: dict) -> pathlib.Path:
    """Append ``rec``, replacing any previous record of the SAME run
    (identity = (out, fingerprint)) — re-finalizing after an elastic
    resume or a heal updates the run's row instead of duplicating it.
    Atomic whole-file rewrite (temp + fsync + rename): a reader never
    sees a torn line, a SIGKILL leaves the previous generation."""
    from repro_torch.data.store import atomic_write_text

    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    key = (rec.get("out"), rec.get("fingerprint"))
    kept = [r for r in load_history(p)
            if (r.get("out"), r.get("fingerprint")) != key]
    kept.append(rec)
    atomic_write_text(p, "".join(json.dumps(r) + "\n" for r in kept))
    return p


def record_run(out_dir: str | pathlib.Path) -> Optional[pathlib.Path]:
    """Summarize a finished run into the history store; the finalize
    paths of both pipelines call this once per completed run.

    No-op (returns None) when there is nothing to remember the run BY —
    no telemetry sink active and no ``EDM_HISTORY`` override — so a
    telemetry-off run leaves its store byte-for-byte as before.  Flushes
    the active sink first: the summary must see this process's own tail
    records (the just-closed stage spans)."""
    if not telemetry.enabled() and not os.environ.get("EDM_HISTORY"):
        return None
    telemetry.flush()
    try:
        return append_record(history_path(out_dir), build_record(out_dir))
    except OSError:
        return None  # history is observability, never a run failure


# ----------------------------------------------------------------- trends
def analyze_trends(records: list[dict]) -> dict:
    """Cross-run analysis of a history: per-run rows (with a regression
    flag vs the previous run of the same fingerprint) and a
    knob-vs-throughput rollup grouped by geometry."""
    runs: list[dict] = []
    last_by_fp: dict[str, dict] = {}
    for r in records:
        row = {
            "t": r.get("t"), "out": r.get("out"),
            "fingerprint": r.get("fingerprint"),
            "N": r.get("N"), "engine": r.get("engine"),
            "workers": r.get("workers"),
            "geometry": r.get("geometry") or {},
            "total_span_s": r.get("total_span_s"),
            "rows_per_s": r.get("rows_per_s"),
            "chunk_p95_s": r.get("chunk_p95_s"),
            "steals": r.get("steals"), "retries": r.get("retries"),
            "poisoned": r.get("poisoned"),
            "regression_pct": None,
        }
        fp = r.get("fingerprint")
        prev = last_by_fp.get(fp) if fp else None
        if (prev is not None and prev.get("total_span_s")
                and row["total_span_s"]):
            delta = 100.0 * (row["total_span_s"] / prev["total_span_s"] - 1)
            row["regression_pct"] = round(delta, 1)
        if fp:
            last_by_fp[fp] = row
        runs.append(row)

    knobs: dict[str, dict] = {}
    for row in runs:
        g = row["geometry"]
        key = json.dumps({
            "engine": row["engine"], "workers": row["workers"],
            "tile": g.get("target_tile"), "depth": g.get("stream_depth"),
            "unit_rows": g.get("unit_rows") or g.get("lib_block"),
        }, sort_keys=True)
        k = knobs.setdefault(key, {"runs": 0, "rows_per_s": []})
        k["runs"] += 1
        if row["rows_per_s"]:
            k["rows_per_s"].append(row["rows_per_s"])
    knob_rows = []
    for key, k in knobs.items():
        vals = k["rows_per_s"]
        knob_rows.append({
            **json.loads(key), "runs": k["runs"],
            "rows_per_s_mean": round(sum(vals) / len(vals), 4)
            if vals else None,
        })
    knob_rows.sort(key=lambda r: -(r["rows_per_s_mean"] or 0.0))
    regressed = [r for r in runs
                 if (r["regression_pct"] or 0.0) > REGRESSION_PCT]
    return {"runs": runs, "knobs": knob_rows, "regressions": regressed}


def render_trends(records: list[dict]) -> str:
    """Human form of :func:`analyze_trends` over a loaded history."""
    if not records:
        return ("history: no runs recorded yet (runs append a summary at "
                "finalize when telemetry or EDM_HISTORY is active)")
    a = analyze_trends(records)
    lines = [f"history: {len(a['runs'])} run(s)"]
    lines.append(
        f"{'when':<20} {'N':>6} {'engine':<16} {'W':>3} {'tile':>5} "
        f"{'depth':>5} {'span_s':>9} {'rows/s':>8}  flags")
    for r in a["runs"]:
        when = time.strftime("%Y-%m-%d %H:%M:%S",
                             time.localtime(r["t"] or 0))
        g = r["geometry"]
        flags = []
        if r["regression_pct"] is not None:
            sign = "+" if r["regression_pct"] >= 0 else ""
            tag = (f"REGRESSION {sign}{r['regression_pct']}%"
                   if r["regression_pct"] > REGRESSION_PCT
                   else f"{sign}{r['regression_pct']}%")
            flags.append(tag)
        if r["steals"]:
            flags.append(f"{r['steals']} steal(s)")
        if r["poisoned"]:
            flags.append(f"{r['poisoned']} poisoned")
        lines.append(
            f"{when:<20} {r['N'] or '?':>6} {(r['engine'] or '?'):<16} "
            f"{r['workers'] or 0:>3} {g.get('target_tile') or 0:>5} "
            f"{g.get('stream_depth') or 0:>5} "
            f"{(r['total_span_s'] or 0.0):>9.3f} "
            f"{(r['rows_per_s'] or 0.0):>8.2f}  "
            + (", ".join(flags) or "-"))
    if len(a["knobs"]) > 1:
        lines.append("knob vs throughput (mean rows/s per geometry):")
        for k in a["knobs"]:
            lines.append(
                f"  engine={k['engine']} W={k['workers']} tile={k['tile']} "
                f"depth={k['depth']} unit_rows={k['unit_rows']}: "
                f"{k['rows_per_s_mean'] or 0.0:.2f} rows/s "
                f"over {k['runs']} run(s)")
    if a["regressions"]:
        lines.append(f"{len(a['regressions'])} regression(s) above "
                     f"{REGRESSION_PCT:.0f}% — see flags above")
    return "\n".join(lines)
