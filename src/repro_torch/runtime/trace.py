"""Fleet trace assembly of the port: the analysis layer above the
telemetry spine, the counterpart of ``repro.runtime.trace`` (the JAX
package's DESIGN.md SS13) over the same record schema.

The spine (``runtime/telemetry.py``) records WHERE each worker's wall
time went; this module stitches the per-worker JSONL files into ONE
fleet trace that answers "why did this run take as long as it did":

  * :func:`align_clocks` — per-worker clock alignment.  Every record
    carries both an epoch (``t``) and a monotonic (``mono``) timestamp;
    a worker's internal timeline is rebuilt on its monotonic clock
    (immune to NTP steps mid-run) shifted by the median epoch-mono
    offset, and CROSS-worker epoch skew is corrected against the
    queue's causal order: a unit's done counter cannot precede any of
    its claims, and no event of stage k+1 can precede the last done of
    stage k (run_stage is a barrier).  Violations shift the late
    worker's whole timeline — clock-skew tolerant without any RPC.
  * :func:`assemble_trace` — join spans/counters to work units via
    their ``(stage, uid/row0, col0)`` attrs and reconstruct each unit's
    lifecycle (queued -> claimed -> computed -> fsynced -> done,
    including steals, retries, and poison verdicts), then compute the
    critical path through the phase1 -> phase2 -> assemble -> sig ->
    finalize DAG (within a stage units are parallel; the unit that
    finishes LAST is what the barrier waited on) and attribute each
    stage's wall time to compute / device gather / store-fsync /
    queue-wait / straggler-tail buckets.
  * :func:`chrome_trace` — export as Chrome trace-event JSON (Perfetto
    / chrome://tracing loadable): one process row per worker, lanes for
    barrier / compute / io spans, instant events for queue counters.
  * :func:`reconcile` — per-stage span totals cross-checked against
    ``edm_fleet status`` (same aggregation over the same records; held
    within 1%).

On a card the buckets read as follows (docs/PORT.md): a ``chunk`` span
closes once the chunk's kernels are queued, so ``compute`` is the
host's dispatch time, not device time; the wait for the device shows up
in the drains' ``gather_s`` (``gather``), where the host copies a
result back; ``store`` is the writes and their fsyncs; the queue's own
spans (``queue_claim``, ``queue_renew``, ``queue_done``,
``queue_wait``) are not busy time, so they land in ``queue_wait``.

Everything here is READ-ONLY over the recorded JSONL — assembling a
trace can never perturb a run, and a store with no telemetry yields an
empty (but well-formed) trace.
"""
from __future__ import annotations

import ast
import json
import pathlib
from typing import Any, Optional

from repro_torch.runtime import telemetry

#: stage DAG order (a run may only walk a prefix / skip sig+finalize).
STAGE_ORDER = ("phase1", "phase2", "assemble", "sig", "finalize")
#: wall-time attribution buckets.
BUCKETS = ("compute", "gather", "store", "queue_wait", "straggler_tail",
           "other")
_SKEW_EPS = 1e-3  # seconds of causality violation tolerated as jitter
_SKEW_ITERS = 64


# ------------------------------------------------------------ record load
def load_worker_records(
    out_dir: str | pathlib.Path,
) -> dict[str, list[dict]]:
    """Schema-valid records per worker file, in recorded (seq) order."""
    by_worker: dict[str, list[dict]] = {}
    for stem, rec in telemetry.iter_store_records(out_dir):
        if telemetry.validate(rec):
            continue
        by_worker.setdefault(stem, []).append(rec)
    for recs in by_worker.values():
        recs.sort(key=lambda r: (r.get("pid", 0), r.get("seq", 0)))
    return by_worker


# ---------------------------------------------------------- clock algebra
def _epoch_mono_offset(recs: list[dict]) -> Optional[float]:
    """Median (epoch - mono) over a worker's records — its epoch clock
    expressed as an offset of its monotonic clock; the median survives
    an NTP step that shifts a minority of records."""
    ds = sorted(r["t"] - r["mono"] for r in recs if "mono" in r)
    if not ds:
        return None
    return ds[len(ds) // 2]


def _raw_time(rec: dict, offset: Optional[float]) -> float:
    """Record end time on the worker's reconstructed timeline (pre
    cross-worker correction): monotonic + median offset when the record
    carries a mono clock, the raw epoch stamp otherwise (legacy/foreign
    records)."""
    if offset is not None and "mono" in rec:
        return rec["mono"] + offset
    return rec["t"]


def align_clocks(by_worker: dict[str, list[dict]]) -> dict[str, float]:
    """Per-worker additive corrections mapping every worker's records
    onto one shared fleet timeline.

    Phase 1 (intra-worker): each worker's timeline is rebuilt as
    ``mono + median(t - mono)`` — its own epoch clock, made robust to
    mid-run NTP steps.  Phase 2 (cross-worker): queue causality
    violations (a done observed before its claim, a stage event before
    the previous stage's barrier drained) shift the EARLY-reading
    worker's whole timeline forward by the violation, iterated to a
    fixed point.  On a single skew-free host every correction is ~0.

    Returns worker -> total offset to ADD to :func:`_raw_time`.
    """
    base: dict[str, Optional[float]] = {
        w: _epoch_mono_offset(recs) for w, recs in by_worker.items()
    }
    shift = {w: 0.0 for w in by_worker}

    # queue protocol events: (stage, name, uid, worker_file, raw_time)
    events: list[tuple[str, str, str, str, float]] = []
    for w, recs in by_worker.items():
        for r in recs:
            if r["kind"] != "counter":
                continue
            if r["name"] in ("claim", "steal", "done"):
                events.append((
                    r["stage"], r["name"], str(r["attrs"].get("uid", "")),
                    w, _raw_time(r, base[w]),
                ))

    # constraints: (early_worker, t_early, late_worker, t_late).  The
    # per-uid bound uses the LAST done record: a crash between the done
    # flush and the durable marker legitimately leaves an earlier done
    # record followed by a steal + recompute, and only the final
    # completion is causally after every claim/steal.
    cons: list[tuple[str, float, str, float]] = []
    done_at: dict[str, tuple[str, float]] = {}
    for stage, name, uid, w, t in events:
        if name == "done":
            cur = done_at.get(uid)
            if cur is None or t > cur[1]:
                done_at[uid] = (w, t)
    for stage, name, uid, w, t in events:
        if name in ("claim", "steal") and uid in done_at:
            dw, dt = done_at[uid]
            if dw != w:
                cons.append((w, t, dw, dt))
    # stage barrier: last done of stage k precedes first event of k+1
    per_stage: dict[str, list[tuple[str, str, float]]] = {}
    for stage, name, uid, w, t in events:
        per_stage.setdefault(stage, []).append((name, w, t))
    order = [s for s in STAGE_ORDER if s in per_stage]
    for prev, nxt in zip(order, order[1:]):
        dones = [(w, t) for name, w, t in per_stage[prev] if name == "done"]
        firsts = [(w, t) for name, w, t in per_stage[nxt]]
        if not dones or not firsts:
            continue
        for dw, dt in dones:
            for fw, ft in firsts:
                if dw != fw:
                    cons.append((dw, dt, fw, ft))

    # iterative relaxation: push the worker that READS EARLY forward.
    # Shifts only ever grow, bounded by the true total skew -> converges.
    for _ in range(_SKEW_ITERS):
        moved = False
        for we, te, wl, tl in cons:
            early = te + shift[we]
            late = tl + shift[wl]
            if late + _SKEW_EPS < early:
                shift[wl] += early - late
                moved = True
        if not moved:
            break
    return shift


class _Timeline:
    """Aligned time accessor for one fleet's records."""

    def __init__(self, by_worker: dict[str, list[dict]]):
        self.by_worker = by_worker
        self._base = {w: _epoch_mono_offset(r) for w, r in by_worker.items()}
        self.shift = align_clocks(by_worker)

    def end(self, worker: str, rec: dict) -> float:
        return _raw_time(rec, self._base[worker]) + self.shift[worker]

    def start(self, worker: str, rec: dict) -> float:
        return self.end(worker, rec) - float(rec.get("dur_s", 0.0))


# ------------------------------------------------------------- tag parsing
def _tag_row0(attrs: dict) -> Optional[int]:
    """row0 of a stream-drain span: tags are ``repr`` of the pipeline's
    (row0, valid) / (kind, row0, col0, valid) tuples."""
    if "row0" in attrs:
        return int(attrs["row0"])
    tag = attrs.get("tag")
    if not isinstance(tag, str):
        return None
    try:
        val = ast.literal_eval(tag)
    except (ValueError, SyntaxError):
        return None
    if isinstance(val, tuple):
        for x in val:
            if isinstance(x, int):
                return int(x)
    return None


# ---------------------------------------------------------- unit lifecycle
def _unit_key(stage: str, attrs: dict) -> Optional[str]:
    uid = attrs.get("uid")
    return str(uid) if uid else None


def assemble_trace(out_dir: str | pathlib.Path) -> dict:
    """The fleet-wide causal trace of one run store (JSON-safe dict).

    Keys:
      workers        sorted worker-file stems
      clock_shift_s  per-worker cross-clock correction applied
      units          uid -> lifecycle {stage,row0,nrows,claims,steals,
                     retries,poisoned,claimed_t,done_t,held_s,
                     compute_s,gather_s,store_s,chunks,worker}
      stages         stage -> {start,end,wall_s,units,done_units,
                     buckets{...},per_worker{busy_s,span_s},chunk_p50/
                     p95/p99}
      critical_path  one entry per stage walked: the unit the barrier
                     waited on, with queue_wait/compute/gather/store/
                     straggler_tail seconds
      span_totals    stage -> sum of ALL span dur_s (the exact
                     aggregation `edm_fleet status` reports — the
                     reconciliation surface)
      total_wall_s   aligned end - start over every record
    """
    by_worker = load_worker_records(out_dir)
    trace: dict[str, Any] = {
        "out": str(out_dir),
        "workers": sorted(by_worker),
        "clock_shift_s": {},
        "units": {},
        "stages": {},
        "critical_path": [],
        "span_totals": {},
        "total_wall_s": 0.0,
    }
    if not by_worker:
        return trace
    tl = _Timeline(by_worker)
    trace["clock_shift_s"] = {w: round(s, 6) for w, s in tl.shift.items()}

    units: dict[str, dict] = {}
    span_totals: dict[str, float] = {}
    # per (worker, stage): busy interval list + stage-span time + chunks
    busy: dict[tuple[str, str], list[tuple[float, float]]] = {}
    stage_span: dict[tuple[str, str], tuple[float, float]] = {}
    chunk_durs: dict[str, list[float]] = {}
    chunk_spans: dict[str, list[tuple[str, float, float, dict]]] = {}
    sub_spans: dict[str, list[tuple[str, float, float, str, dict]]] = {}
    t_min, t_max = float("inf"), float("-inf")

    def unit_for(stage: str, uid: str, attrs: dict) -> dict:
        u = units.get(uid)
        if u is None:
            u = units[uid] = {
                "stage": stage, "row0": int(attrs.get("row0", 0)),
                "nrows": int(attrs.get("nrows", 0)),
                "claims": [], "steals": 0, "retries": 0, "poisoned": False,
                "claimed_t": None, "done_t": None, "held_s": None,
                "worker": None, "compute_s": 0.0, "gather_s": 0.0,
                "store_s": 0.0, "chunks": 0,
            }
        return u

    for w, recs in by_worker.items():
        for r in recs:
            end = tl.end(w, r)
            start = tl.start(w, r)
            t_min, t_max = min(t_min, start), max(t_max, end)
            stage, name, attrs = r["stage"], r["name"], r["attrs"]
            if r["kind"] == "span":
                span_totals[stage] = span_totals.get(stage, 0.0) + r["dur_s"]
                if name == "stage":
                    stage_span[(w, stage)] = (start, end)
                elif name == "chunk":
                    chunk_durs.setdefault(stage, []).append(r["dur_s"])
                    chunk_spans.setdefault(stage, []).append(
                        (w, start, end, attrs))
                    busy.setdefault((w, stage), []).append((start, end))
                elif name in ("drain", "device_put", "write_tile",
                              "write_block", "manifest_commit",
                              "causal_map", "store"):
                    sub_spans.setdefault(stage, []).append(
                        (w, start, end, name, attrs))
                    busy.setdefault((w, stage), []).append((start, end))
                continue
            # counters: unit lifecycle joins
            uid = _unit_key(stage, attrs)
            if uid is None:
                continue
            if name in ("claim", "steal"):
                u = unit_for(stage, uid, attrs)
                u["claims"].append({"worker": w, "t": round(end, 6),
                                    "stolen": name == "steal"})
                u["steals"] += name == "steal"
                if u["claimed_t"] is None or end < u["claimed_t"]:
                    u["claimed_t"] = end
            elif name == "done":
                u = unit_for(stage, uid, attrs)
                # duplicate done records are possible (a SIGKILL between
                # the flushed record and the marker recomputes the
                # unit) — the FIRST completion is the causal one
                if u["done_t"] is None or end < u["done_t"]:
                    u["done_t"] = end
                    u["held_s"] = float(attrs.get("held_s", 0.0))
                    u["worker"] = w
            elif name == "unit_failed":
                unit_for(stage, uid, attrs)["retries"] += 1
            elif name == "unit_poisoned":
                unit_for(stage, uid, attrs)["poisoned"] = True

    # ---- join compute/gather/store spans to units ----------------------
    def covering_unit(stage: str, row0: Optional[int]) -> Optional[dict]:
        if row0 is None:
            return None
        for u in units.values():
            if u["stage"] == stage and (
                u["nrows"] == 0 or u["row0"] <= row0 < u["row0"] + u["nrows"]
            ):
                return u
        return None

    for stage, spans in chunk_spans.items():
        for w, start, end, attrs in spans:
            u = covering_unit(stage, attrs.get("row0", 0))
            if u is not None:
                u["chunks"] += 1
                u["compute_s"] += end - start
                u["gather_s"] += float(attrs.get("gather_s", 0.0))
    for stage, spans in sub_spans.items():
        pstage = stage if stage in STAGE_ORDER else None
        for w, start, end, name, attrs in spans:
            row0 = _tag_row0(attrs)
            target = pstage
            if target is None:
                # "store"-stage writes: find the pipeline stage whose
                # chunk/stage span of the SAME worker contains this span
                for ps, cspans in chunk_spans.items():
                    if any(cw == w and cs - _SKEW_EPS <= start
                           and end <= ce + _SKEW_EPS
                           for cw, cs, ce, _ in cspans):
                        target = ps
                        break
                target = target or "phase2"
            u = covering_unit(target, row0)
            if u is None:
                continue
            dur = end - start
            if name in ("write_tile", "write_block", "manifest_commit"):
                u["store_s"] += dur
            elif name == "drain":
                u["gather_s"] += float(attrs.get("gather_s", 0.0))
                # drain minus gather is dominated by the nested store
                # write, credited above via its own span
            elif name == "device_put":
                # device upload rides the compute bucket's chunk span;
                # subtract it from compute, credit gather (H2D+D2H both
                # count as device transfer time)
                u["compute_s"] -= dur
                u["gather_s"] += dur

    # ---- per-stage rollup + buckets ------------------------------------
    def merge_intervals(iv: list[tuple[float, float]]) -> float:
        total, cur_s, cur_e = 0.0, None, None
        for s, e in sorted(iv):
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total

    stages_present = [
        s for s in STAGE_ORDER
        if s in chunk_spans or s in span_totals
        or any(u["stage"] == s for u in units.values())
    ]
    for stage in stages_present:
        ss = [v for (w, st), v in stage_span.items() if st == stage]
        evs = [u[k] for u in units.values() if u["stage"] == stage
               for k in ("claimed_t", "done_t") if u[k] is not None]
        cts = [(s, e) for _, s, e, _ in chunk_spans.get(stage, [])]
        cts += [(s, e) for _, s, e, _, _ in sub_spans.get(stage, [])
                if stage in STAGE_ORDER]
        lo = min([s for s, _ in ss] + [s for s, _ in cts] + evs,
                 default=None)
        hi = max([e for _, e in ss] + [e for _, e in cts] + evs,
                 default=None)
        if lo is None:
            continue
        wall = max(hi - lo, 0.0)
        sunits = [u for u in units.values() if u["stage"] == stage]
        per_worker: dict[str, dict] = {}
        workers_in = {w for (w, st) in busy if st == stage} | {
            w for (w, st) in stage_span if st == stage}
        for w in sorted(workers_in):
            b = merge_intervals(busy.get((w, stage), []))
            sp = stage_span.get((w, stage))
            per_worker[w] = {
                "busy_s": round(b, 6),
                "span_s": round(sp[1] - sp[0], 6) if sp else None,
            }
        compute = sum(u["compute_s"] for u in sunits)
        gather = sum(u["gather_s"] for u in sunits)
        store_t = sum(u["store_s"] for u in sunits)
        if not sunits:  # in-process run: bucket from raw spans
            compute = sum(e - s for _, s, e, _ in chunk_spans.get(stage, []))
            for w, s, e, name, attrs in sub_spans.get(stage, []):
                if name in ("write_tile", "write_block", "manifest_commit",
                            "causal_map", "store"):
                    store_t += e - s
                elif name == "drain":
                    gather += float(attrs.get("gather_s", 0.0))
                elif name == "device_put":
                    compute -= e - s
                    gather += e - s
            for _, s, e, attrs in chunk_spans.get(stage, []):
                gather += float(attrs.get("gather_s", 0.0))
        # queue wait: time a worker spent inside the stage but not busy
        queue_wait = 0.0
        for w in workers_in:
            sp = stage_span.get((w, stage))
            if sp is not None:
                queue_wait += max(
                    0.0, (sp[1] - sp[0])
                    - merge_intervals(busy.get((w, stage), [])))
        # straggler tail: per worker, idle span between its last busy
        # moment and the fleet-wide stage end (the barrier wait on the
        # last unit) — a subset of queue_wait, surfaced separately
        # because it is what the worker-count knob tunes
        tail = 0.0
        for w in workers_in:
            iv = busy.get((w, stage), [])
            last = max((e for _, e in iv), default=None)
            if last is not None and len(workers_in) > 1:
                tail += max(0.0, hi - last)
        other = max(0.0, wall - compute - gather - store_t)
        durs = sorted(chunk_durs.get(stage, []))

        def pct(p: float) -> Optional[float]:
            if not durs:
                return None
            return round(durs[min(len(durs) - 1,
                                  int(p * (len(durs) - 1)))], 6)

        trace["stages"][stage] = {
            "start": round(lo, 6), "end": round(hi, 6),
            "wall_s": round(wall, 6),
            "units": len(sunits),
            "done_units": sum(u["done_t"] is not None for u in sunits),
            "chunks": len(durs),
            "chunk_p50_s": pct(0.50), "chunk_p95_s": pct(0.95),
            "chunk_p99_s": pct(0.99),
            "buckets": {
                "compute": round(max(compute, 0.0), 6),
                "gather": round(gather, 6),
                "store": round(store_t, 6),
                "queue_wait": round(queue_wait, 6),
                "straggler_tail": round(tail, 6),
                "other": round(other, 6),
            },
            "per_worker": per_worker,
        }

    # ---- critical path -------------------------------------------------
    for stage in stages_present:
        st = trace["stages"].get(stage)
        if st is None:
            continue
        sunits = [(uid, u) for uid, u in units.items()
                  if u["stage"] == stage and u["done_t"] is not None]
        if sunits:
            uid, u = max(sunits, key=lambda kv: kv[1]["done_t"])
            entry = {
                "stage": stage, "uid": uid, "worker": u["worker"],
                "queue_wait_s": round(
                    max(0.0, (u["claimed_t"] or st["start"]) - st["start"]),
                    6),
                "compute_s": round(max(u["compute_s"], 0.0), 6),
                "gather_s": round(u["gather_s"], 6),
                "store_s": round(u["store_s"], 6),
                "held_s": u["held_s"],
                "steals": u["steals"], "retries": u["retries"],
                "poisoned": u["poisoned"],
                "done_t": round(u["done_t"], 6),
                "straggler_tail_s": round(
                    max(0.0, st["end"] - u["done_t"]), 6),
            }
        else:  # in-process run: the stage itself is the path node
            b = st["buckets"]
            entry = {
                "stage": stage, "uid": stage, "worker": None,
                "queue_wait_s": 0.0,
                "compute_s": b["compute"], "gather_s": b["gather"],
                "store_s": b["store"], "held_s": None,
                "steals": 0, "retries": 0, "poisoned": False,
                "done_t": st["end"], "straggler_tail_s": 0.0,
            }
        trace["critical_path"].append(entry)

    trace["units"] = {
        uid: {**u,
              "claimed_t": None if u["claimed_t"] is None
              else round(u["claimed_t"], 6),
              "done_t": None if u["done_t"] is None
              else round(u["done_t"], 6),
              "compute_s": round(max(u["compute_s"], 0.0), 6),
              "gather_s": round(u["gather_s"], 6),
              "store_s": round(u["store_s"], 6)}
        for uid, u in sorted(units.items())
    }
    trace["span_totals"] = {k: round(v, 6) for k, v in span_totals.items()}
    trace["total_wall_s"] = round(max(0.0, t_max - t_min), 6)
    return trace


# -------------------------------------------------------- chrome trace JSON
_LANES = {"stage": 0, "chunk": 1, "device_put": 1, "drain": 2,
          "write_tile": 3, "write_block": 3, "manifest_commit": 3,
          "causal_map": 1, "store": 1}
_LANE_NAMES = {0: "barrier", 1: "compute", 2: "drain", 3: "store",
               9: "events"}


def chrome_trace(out_dir: str | pathlib.Path) -> dict:
    """Chrome trace-event JSON for a run store — load the written file
    in Perfetto (ui.perfetto.dev) or chrome://tracing.

    One process row per worker (named), thread lanes per span family
    (barrier / compute / drain / store), ``X`` complete events for
    spans, ``i`` instant events for queue counters; all timestamps on
    the skew-corrected fleet timeline, microseconds from run start.
    """
    by_worker = load_worker_records(out_dir)
    events: list[dict] = []
    if not by_worker:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    tl = _Timeline(by_worker)
    t0 = min(
        tl.start(w, r) for w, recs in by_worker.items() for r in recs
    )

    def us(t: float) -> int:
        return int(round((t - t0) * 1e6))

    for pid, w in enumerate(sorted(by_worker)):
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": w}})
        for tid, lane in sorted(_LANE_NAMES.items()):
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": lane}})
        for r in by_worker[w]:
            stage, name, attrs = r["stage"], r["name"], r["attrs"]
            if r["kind"] == "span":
                events.append({
                    "ph": "X", "pid": pid,
                    "tid": _LANES.get(name, 1),
                    "name": f"{stage}.{name}",
                    "ts": us(tl.start(w, r)),
                    "dur": max(1, int(round(r["dur_s"] * 1e6))),
                    "args": attrs,
                })
            else:
                events.append({
                    "ph": "i", "s": "t", "pid": pid, "tid": 9,
                    "name": f"{stage}.{name}",
                    "ts": us(tl.end(w, r)),
                    "args": {**attrs, "value": r.get("value")},
                })
    events.sort(key=lambda e: (e["ph"] != "M", e.get("ts", 0)))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(
    out_dir: str | pathlib.Path, path: str | pathlib.Path
) -> pathlib.Path:
    from repro_torch.data.store import atomic_write_text

    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    atomic_write_text(p, json.dumps(chrome_trace(out_dir)))
    return p


# ------------------------------------------------------------ reconciliation
def reconcile(trace: dict, status: dict) -> dict:
    """Per-stage span totals: trace vs `edm_fleet status` (both sum the
    dur_s of every valid span record per stage — any drift means the
    two readers disagree about the same files).  ``ok`` when every
    common stage matches within 1%."""
    out: dict[str, Any] = {"stages": {}, "ok": True}
    st_tel = status.get("telemetry", {}).get("stages", {})
    for stage in set(trace.get("span_totals", {})) | set(st_tel):
        a = float(trace.get("span_totals", {}).get(stage, 0.0))
        b = float(st_tel.get(stage, {}).get("span_s", 0.0))
        denom = max(abs(a), abs(b), 1e-9)
        delta = abs(a - b) / denom
        out["stages"][stage] = {
            "trace_s": round(a, 6), "status_s": round(b, 6),
            "delta_pct": round(100.0 * delta, 4),
        }
        if delta > 0.01:
            out["ok"] = False
    return out


# ----------------------------------------------------------------- render
def render_trace(trace: dict) -> str:
    """Human one-pager: per-stage wall + buckets, then the critical path."""
    lines = [f"trace {trace['out']}: {len(trace['workers'])} worker(s), "
             f"total wall {trace['total_wall_s']:.3f}s"]
    shifts = {w: s for w, s in trace.get("clock_shift_s", {}).items()
              if abs(s) > 0.01}
    if shifts:
        lines.append("clock skew corrected: " + ", ".join(
            f"{w}+{s:.3f}s" for w, s in sorted(shifts.items())))
    if trace["stages"]:
        lines.append(
            f"{'stage':<10} {'wall':>9} {'compute':>9} {'gather':>9} "
            f"{'store':>9} {'wait':>9} {'tail':>9}")
        for stage in STAGE_ORDER:
            st = trace["stages"].get(stage)
            if st is None:
                continue
            b = st["buckets"]
            lines.append(
                f"{stage:<10} {st['wall_s']:>8.3f}s {b['compute']:>8.3f}s "
                f"{b['gather']:>8.3f}s {b['store']:>8.3f}s "
                f"{b['queue_wait']:>8.3f}s {b['straggler_tail']:>8.3f}s")
    if trace["critical_path"]:
        lines.append("critical path (the unit each stage barrier waited on):")
        for e in trace["critical_path"]:
            who = f"@{e['worker']}" if e["worker"] else ""
            extras = []
            if e["steals"]:
                extras.append(f"{e['steals']} steal(s)")
            if e["retries"]:
                extras.append(f"{e['retries']} retry(ies)")
            if e["poisoned"]:
                extras.append("POISONED")
            lines.append(
                f"  {e['stage']:<9} {e['uid']}{who}: wait "
                f"{e['queue_wait_s']:.3f}s, compute {e['compute_s']:.3f}s, "
                f"gather {e['gather_s']:.3f}s, store {e['store_s']:.3f}s, "
                f"tail {e['straggler_tail_s']:.3f}s"
                + (f" [{', '.join(extras)}]" if extras else ""))
    if not trace["stages"]:
        lines.append("no telemetry records (sink disabled or run not started)")
    return "\n".join(lines)


# ------------------------------------------------------ hold-time helpers
def held_percentiles(out_dir: str | pathlib.Path) -> dict:
    """p50/p95/p99 over every recorded unit hold (done + stolen +
    released) — the straggler threshold of `status --watch` and the TTL
    rule's evidence."""
    holds: list[float] = []
    for _, rec in telemetry.iter_store_records(out_dir):
        if rec.get("kind") == "counter" and rec.get("name") == "held":
            holds.append(float(rec.get("value", 0.0)))
        elif (rec.get("kind") == "counter" and rec.get("name") == "done"
              and "held_s" in (rec.get("attrs") or {})):
            holds.append(float(rec["attrs"]["held_s"]))
    holds.sort()

    def pct(p: float) -> Optional[float]:
        if not holds:
            return None
        return round(holds[min(len(holds) - 1,
                               int(p * (len(holds) - 1)))], 6)

    return {"n": len(holds), "p50": pct(0.50), "p95": pct(0.95),
            "p99": pct(0.99)}
