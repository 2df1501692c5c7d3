"""Shared fixtures of the telemetry-trio parity tests (test_torch_trace.py,
test_torch_history.py, test_torch_autotune.py): the JAX package's
hand-written telemetry stores (tests/test_trace.py), stores and histories
drawn from a numpy seed, and a port fleet store written by a W=2 CPU run.
Every store is plain JSONL in the shared record schema, so the same
files feed ``repro.runtime.*`` and ``repro_torch.runtime.*``."""
import importlib
import json
import os
import pathlib
import subprocess
import sys
import types

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]
PKGS = ("repro", "repro_torch")
U0, U1 = "phase2_00000000_00008", "phase2_00000008_00008"
STAGES = ("phase1", "phase2", "assemble", "sig", "finalize")


def modules(pkg: str) -> types.SimpleNamespace:
    """The package's telemetry, trace, history and autotune modules."""
    return types.SimpleNamespace(**{
        name: importlib.import_module(f"{pkg}.runtime.{name}")
        for name in ("telemetry", "trace", "history", "autotune")})


# ------------------------------------------------ the JAX tests' fixtures
def write_worker(out, worker, records, pid=1, mono_offset=900.0):
    """One worker's JSONL (schema boilerplate filled in, ``mono`` derived
    from ``t`` minus the worker's epoch-mono offset)."""
    p = pathlib.Path(out) / "telemetry" / f"{worker}.jsonl"
    p.parent.mkdir(parents=True, exist_ok=True)
    lines = []
    for i, r in enumerate(records):
        rec = {"v": 1, "worker": worker, "pid": pid, "seq": i + 1,
               "attrs": {}, **r}
        rec.setdefault("mono", rec["t"] - mono_offset)
        lines.append(json.dumps(rec) + "\n")
    with open(p, "a") as f:
        f.writelines(lines)
    return p


def span(stage, name, end, dur, **attrs):
    return {"kind": "span", "stage": stage, "name": name, "t": end,
            "dur_s": dur, "attrs": attrs}


def ctr(stage, name, t, value=1.0, **attrs):
    return {"kind": "counter", "stage": stage, "name": name, "t": t,
            "value": value, "attrs": attrs}


def two_worker_store(out, w1_skew=0.0, w1_mono_offset=None):
    """tests/test_trace.py's 2-worker fixture: two phase-2 units (w1's
    the straggler) and an assemble unit claimed by w1 after the barrier;
    ``w1_skew`` shifts every w1 epoch stamp."""
    write_worker(out, "w0", [
        ctr("phase2", "claim", 1000.0, uid=U0, row0=0, nrows=8,
            lease_age_s=0.0),
        span("phase2", "chunk", 1010.0, 10.0, row0=0, rows=8, chunk_rows=8,
             gather_s=1.0),
        span("store", "write_tile", 1010.5, 0.5, row0=0, col0=0, bytes=100),
        ctr("phase2", "done", 1011.0, uid=U0, row0=0, nrows=8, held_s=11.0),
        ctr("phase2", "held", 1011.0, value=11.0, uid=U0, outcome="done"),
        span("phase2", "stage", 1012.0, 12.5),
    ], pid=10)
    s = w1_skew
    off = 900.0 if w1_mono_offset is None else w1_mono_offset
    write_worker(out, "w1", [
        ctr("phase2", "claim", 1000.5 + s, uid=U1, row0=8, nrows=8,
            lease_age_s=0.0),
        span("phase2", "chunk", 1015.0 + s, 14.0, row0=8, rows=8,
             chunk_rows=8, gather_s=2.0),
        ctr("phase2", "done", 1015.5 + s, uid=U1, row0=8, nrows=8,
            held_s=15.0),
        ctr("phase2", "held", 1015.5 + s, value=15.0, uid=U1, outcome="done"),
        span("phase2", "stage", 1016.0 + s, 16.2),
        ctr("assemble", "claim", 1016.5 + s, uid="assemble", row0=0,
            nrows=16, lease_age_s=0.0),
        ctr("assemble", "done", 1017.0 + s, uid="assemble", row0=0,
            nrows=16, held_s=0.5),
    ], pid=11, mono_offset=off)
    return pathlib.Path(out)


def duplicate_done_store(out):
    """tests/test_trace.py's crash-before-marker fixture: w1's done record
    survives, w2 steals after the TTL and finishes the unit again."""
    write_worker(out, "w0", [
        ctr("phase2", "claim", 1000.0, uid=U0, row0=0, nrows=8),
        ctr("phase2", "done", 1011.0, uid=U0, row0=0, nrows=8, held_s=11.0),
    ], pid=10)
    write_worker(out, "w1", [
        ctr("phase2", "claim", 1000.5, uid=U1, row0=8, nrows=8),
        ctr("phase2", "done", 1015.5, uid=U1, row0=8, nrows=8, held_s=15.0),
    ], pid=11)
    write_worker(out, "w2", [
        ctr("phase2", "steal", 1020.0, uid=U1, row0=8, nrows=8,
            lease_age_s=600.0),
        ctr("phase2", "done", 1030.0, uid=U1, row0=8, nrows=8, held_s=10.0),
        ctr("assemble", "claim", 1031.0, uid="assemble", row0=0, nrows=16),
        ctr("assemble", "done", 1031.5, uid="assemble", row0=0, nrows=16,
            held_s=0.5),
    ], pid=12)
    return pathlib.Path(out)


def ntp_step_store(out):
    """An NTP step yanks one record's epoch stamp by +500 s; mono stays."""
    write_worker(out, "w0", [
        ctr("phase2", "claim", 1000.0, uid=U0, row0=0, nrows=8),
        {**ctr("phase2", "done", 1505.0, uid=U0, row0=0, nrows=8,
               held_s=5.0), "mono": 105.0},
        span("phase2", "stage", 1006.0, 6.0),
    ])
    return pathlib.Path(out)


# ----------------------------------------------- stores from a numpy seed
def random_store(out, seed: int, workers: int = 3, units: int = 5):
    """A fleet's telemetry drawn from ``seed``: every stage of the DAG with
    its claims (some stolen), chunk / device_put / drain / write / commit
    spans, done (some twice: a crash before the marker) and held
    counters, stage spans, edm_run's run_config, the engine's knn_tile
    and the in-process assemble span; every worker's epoch clock skewed
    and its monotonic clock on its own zero."""
    rng = np.random.default_rng(seed)
    names = [f"w{i}" for i in range(workers)]
    skew = {w: (0.0 if i == 0 else float(rng.uniform(-3.0, 3.0)))
            for i, w in enumerate(names)}
    zero = {w: float(rng.uniform(100.0, 5000.0)) for w in names}
    recs = {w: [] for w in names}

    def emit(w, rec):
        true_t = rec["t"]
        recs[w].append({**rec, "t": true_t + skew[w], "mono": true_t - zero[w]})

    t = 1000.0
    emit(names[0], ctr("fleet", "run_config", t, engine="cuda", lib_block=4,
                       target_tile=int(rng.choice([0, 16])), knn_tile_c=0,
                       stream_depth=int(rng.integers(1, 4)), workers=workers,
                       autotune=False))
    for w in names:
        emit(w, ctr("fleet", "clock_anchor", t, epoch=t, mono=t - zero[w],
                    worker_id=w))
    emit(names[0], ctr("engine", "knn_tile", t, value=float(
        rng.choice([128, 256, 512])), Lc=int(rng.integers(200, 2000)),
        profile="plain", working_set_bytes=1000))
    N = 8 * units
    for stage in STAGES:
        n_units = units if stage in ("phase2", "sig") else 1
        start = t
        free = {w: t + float(rng.uniform(0.0, 0.2)) for w in names}
        for u in range(n_units):
            row0, nrows = (u * 8, 8) if n_units > 1 else (0, N)
            uid = (f"{stage}_{row0:08d}_{nrows:05d}" if n_units > 1 else stage)
            w = names[int(rng.integers(workers))]
            t0 = free[w] + float(rng.uniform(0.01, 0.3))
            emit(w, ctr(stage, "claim", t0, uid=uid, row0=row0, nrows=nrows,
                        lease_age_s=0.0))
            tt = t0
            for c in range(int(rng.integers(1, 4))):
                dur = float(rng.uniform(0.05, 1.5))
                put = float(rng.uniform(0.001, 0.01))
                tt += dur
                emit(w, span(stage, "device_put", tt - dur + put, put,
                             row0=row0 + c))
                emit(w, span(stage, "chunk", tt, dur, row0=row0 + c, rows=4,
                             chunk_rows=4, tile=16, n_tiles=2))
                g = float(rng.uniform(0.0, 0.2))
                emit(w, span(stage, "drain", tt + g + 0.02, g + 0.02,
                             tag=repr((row0 + c, 0, 4)), in_flight=1, depth=2,
                             gather_s=g, bytes=256))
                emit(w, span("store", "write_tile", tt + g + 0.015, 0.01,
                             row0=row0 + c, col0=0, bytes=256, fsync_s=0.002))
                tt += g + 0.03
            emit(w, span("store", "manifest_commit", tt, 0.005, entries=2))
            held = tt - t0
            emit(w, ctr(stage, "done", tt + 0.01, uid=uid, row0=row0,
                        nrows=nrows, held_s=held))
            emit(w, ctr(stage, "held", tt + 0.01, value=held, uid=uid,
                        outcome="done"))
            free[w] = tt + 0.01
            if rng.uniform() < 0.3 and workers > 1:  # a steal and a redo
                w2 = names[(names.index(w) + 1) % workers]
                ts = max(free[w2], tt) + float(rng.uniform(0.05, 0.5))
                emit(w2, ctr(stage, "steal", ts, uid=uid, row0=row0,
                             nrows=nrows, lease_age_s=600.0))
                emit(w2, ctr(stage, "held", ts, value=600.0, uid=uid,
                             outcome="stolen"))
                emit(w2, ctr(stage, "done", ts + 0.5, uid=uid, row0=row0,
                             nrows=nrows, held_s=0.5))
                free[w2] = ts + 0.5
        end = max(free.values()) + 0.05
        if stage == "assemble":
            w = names[int(rng.integers(workers))]
            emit(w, span("assemble", "causal_map", end - 0.01, 0.02, N=N))
        for w in names:
            emit(w, span(stage, "stage", end + float(rng.uniform(0.0, 0.01)),
                         end - start))
        t = end + 0.1
    for i, w in enumerate(names):
        write_worker(out, w, recs[w], pid=100 + i)
    return pathlib.Path(out)


def random_history(seed: int, n: int = 12) -> list[dict]:
    """History records drawn from ``seed``: a few fingerprints and outs,
    geometries and workers, slowdowns above and below the flag."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        fp = f"fp{int(rng.integers(3))}"
        recs.append({
            "v": 1, "t": 1.7e9 + 3600.0 * i, "out": f"/runs/{fp}",
            "fingerprint": fp, "N": int(rng.choice([16, 2048, 16384])),
            "L": 1450, "engine": str(rng.choice(["cuda", "torch-reference"])),
            "workers": int(rng.integers(0, 4)),
            "geometry": {"target_tile": int(rng.choice([0, 512, 4096])),
                         "stream_depth": int(rng.integers(1, 4)),
                         "unit_rows": int(rng.choice([0, 8, 16])),
                         "lib_block": 8},
            "total_span_s": float(rng.uniform(5.0, 60.0)),
            "rows_per_s": (None if rng.uniform() < 0.2
                           else float(rng.uniform(10.0, 500.0))),
            "chunk_p95_s": float(rng.uniform(0.01, 1.0)),
            "steals": int(rng.integers(0, 3)), "retries": int(rng.integers(0, 2)),
            "poisoned": int(rng.integers(0, 2)),
        })
    return recs


# --------------------------------------------------- a port CPU fleet store
def port_fleet_store(out, *extra) -> pathlib.Path:
    """``repro_torch.launch.edm_run --workers 2 --device cpu`` over a
    16 x 300 series with significance: the supervisor's and both workers'
    JSONL, history.jsonl, fleet.json, fingerprint.json."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "OMP_NUM_THREADS": "1"}
    for k in ("EDM_FAULTS", "EDM_TELEMETRY", "EDM_HISTORY", "EDM_COORDINATOR",
              "EDM_NUM_PROCESSES", "EDM_PROCESS_ID", "EDM_LOCAL_DEVICE_IDS"):
        env.pop(k, None)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.edm_run", "--synthetic",
         "16x300", "--e-max", "4", "--lib-sizes", "40,80", "--surrogates", "6",
         "--workers", "2", "--device", "cpu", "--out", str(out), *extra],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return pathlib.Path(out)
