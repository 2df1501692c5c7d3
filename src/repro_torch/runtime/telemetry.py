"""Structured runtime telemetry of the port — the fleet's observability
spine, with the record schema of ``repro.runtime.telemetry`` (DESIGN.md
SS11), so ``repro``'s ``edm_fleet status`` and the port's read the same
per-worker JSONL.

This module records where the wall time goes, as structured records
every layer can emit without knowing who is listening:

  * :func:`span` — a timed context manager (``dur_s`` stamped on exit);
  * :func:`counter` — a point event with a value (claims, steals, bytes,
    cache entries, calibration results).

Records flow to pluggable SINKS (the ``HomebrewNLP-Jax`` wandblog idiom:
one emit call, N backends):

  * :class:`JsonlSink` — one JSON record per line under the run store
    (``<out>/telemetry/<worker>.jsonl``); the fleet default.  Flushes
    append and fsync; a SIGKILL mid-flush leaves at most a torn last
    line, which readers skip.
  * :class:`MemorySink` — in-process record list for tests.
  * :class:`StdoutSink` — one line per record for CI logs.

The JAX package's probe of XLA's compilation cache has no counterpart:
the port's kernels are built once, before any worker starts.

Telemetry is byte-invisible to outputs: nothing here touches compute,
and every sink writes only under ``telemetry/`` (never inside an
artifact dir), so W=1 == W=4 byte-identity holds with sinks enabled.
When no sink is configured, :func:`emit` is a cheap no-op — hot paths
may call it unconditionally.

Record schema (version 1; :func:`validate` is the shared checker used
by tests and ``edm_fleet status``):

  v        int     schema version (== 1)
  kind     str     "span" | "counter"
  stage    str     pipeline stage ("phase1", "phase2", "assemble",
                   "sig", "finalize") or runtime layer ("queue",
                   "store", "stream", "engine", "fleet")
  name     str     record name within the stage (e.g. "chunk",
                   "claim", "write_tile", "knn_tile")
  t        float   epoch seconds at emit (span: at exit)
  mono     float   CLOCK_MONOTONIC seconds at emit — the skew/NTP-step
                   immune sibling of ``t`` (extra field; schema-v1
                   validators ignore it)
  dur_s    float   span wall time (spans only)
  value    float   counter value (counters only)
  worker   str     emitting identity (worker id or "main")
  pid      int     emitting process
  seq      int     per-process monotonic sequence number
  attrs    dict    free-form JSON-safe details (row0, bytes, lease age…)

Loss window: the JSONL sink batches ``flush_every`` records per
append, so a SIGKILL can lose at most the records since the last
flush.  The queue flushes at every UNIT boundary (done/failure — see
runtime/workqueue.py) and the fleet at every STAGE boundary, bounding
the loss to the current unit's in-progress tail; an exit hook
(:mod:`atexit`, registered at configure time) flushes on every
non-SIGKILL death so only a hard kill can lose even that.
"""
from __future__ import annotations

import atexit
import contextlib
import json
import os
import pathlib
import sys
import threading
import time
from typing import Iterator

#: pipeline stages every full run walks (the "five stages" of the fleet);
#: validate() additionally accepts the runtime layers below.
PIPELINE_STAGES = ("phase1", "phase2", "assemble", "sig", "finalize")
RUNTIME_STAGES = ("queue", "store", "stream", "engine", "fleet")
SCHEMA_VERSION = 1

_lock = threading.Lock()
_sinks: list["Sink"] = []
_worker = "main"
_seq = 0
_atexit_registered = False


# ------------------------------------------------------------------- sinks
class Sink:
    """Sink protocol: ``write(record)`` per record, ``flush`` to make
    buffered records durable, ``close`` once at shutdown.  Subclasses
    need not be thread-safe — the module lock serializes calls."""

    def write(self, rec: dict) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self.flush()


class MemorySink(Sink):
    """In-memory record list (tests)."""

    def __init__(self):
        self.records: list[dict] = []

    def write(self, rec: dict) -> None:
        self.records.append(rec)


class StdoutSink(Sink):
    """One ``telemetry,<stage>,<name>,...`` line per record — greppable
    CI-log form, same field order as the JSONL schema."""

    def __init__(self, file=None):
        self._file = file

    def write(self, rec: dict) -> None:
        f = self._file or sys.stdout
        head = rec["dur_s"] if rec["kind"] == "span" else rec["value"]
        print(
            f"telemetry,{rec['stage']},{rec['name']},{head:.6f},"
            f"{json.dumps(rec.get('attrs') or {}, sort_keys=True)}",
            file=f, flush=True,
        )


class JsonlSink(Sink):
    """Crash-safe JSONL file sink.

    Records accumulate in memory and every flush APPENDS them to the file
    and fsyncs it, so a flush costs what it adds: a fleet worker flushes
    at every unit boundary, and the JAX package's whole-file rewrite
    would make a run of U units cost O(U^2) (thousands of units at
    N = 16,384).  A process killed mid-append leaves at most a torn last
    line, which :func:`read_jsonl` skips; a relaunched worker appends to
    the same file, starting on a fresh line after a torn one.
    """

    def __init__(self, path: str | pathlib.Path, flush_every: int = 32):
        self.path = pathlib.Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.flush_every = max(1, int(flush_every))
        self._pending: list[dict] = []
        self._new_line = False
        if self.path.exists() and self.path.stat().st_size:
            with open(self.path, "rb") as f:
                f.seek(-1, os.SEEK_END)
                self._new_line = f.read(1) != b"\n"  # torn by a kill

    def write(self, rec: dict) -> None:
        self._pending.append(rec)
        if len(self._pending) >= self.flush_every:
            self.flush()

    def flush(self) -> None:
        if not self._pending:
            return
        text = "".join(json.dumps(r) + "\n" for r in self._pending)
        if self._new_line:
            text = "\n" + text
        created = not self.path.exists()
        with open(self.path, "a") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        if created:
            from repro_torch.data.store import _fsync_dir  # lazy: no cycle

            _fsync_dir(self.path.parent)
        self._pending.clear()
        self._new_line = False


def read_jsonl(path: str | pathlib.Path) -> list[dict]:
    """Read a telemetry JSONL, tolerating a missing file and torn lines
    (a writer killed mid-append)."""
    p = pathlib.Path(path)
    if not p.exists():
        return []
    out: list[dict] = []
    for line in p.read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            out.append(json.loads(line))
        except ValueError:
            continue  # torn by a writer killed mid-append
    return out


# ------------------------------------------------------------ configuration
def configure(*sinks: Sink, worker: str | None = None) -> None:
    """Install the process's sink list (replacing any previous ones) and
    optionally its emitting identity.  ``configure()`` with no sinks
    disables telemetry."""
    global _sinks, _atexit_registered
    with _lock:
        for s in _sinks:
            try:
                s.close()
            except OSError:
                pass
        _sinks = list(sinks)
        if worker is not None:
            set_identity(worker)
        if _sinks and not _atexit_registered:
            # Last-chance flush on any non-SIGKILL exit (normal return,
            # sys.exit, unhandled exception): the batched JSONL tail is
            # lost only to a hard kill, and even that loss is bounded by
            # the unit-boundary flushes (see module docstring).
            atexit.register(flush)
            _atexit_registered = True


def configure_from_env(
    default_path: str | pathlib.Path | None = None,
    worker: str | None = None,
) -> None:
    """Honor ``EDM_TELEMETRY``: ``off`` (no sinks), ``stdout``,
    ``jsonl:<path>``, or unset — in which case ``default_path`` (when
    given) enables the JSONL sink there, the fleet/driver default."""
    spec = os.environ.get("EDM_TELEMETRY", "")
    if spec == "off":
        configure(worker=worker)
    elif spec == "stdout":
        configure(StdoutSink(), worker=worker)
    elif spec.startswith("jsonl:"):
        configure(JsonlSink(spec[len("jsonl:"):]), worker=worker)
    elif default_path is not None:
        configure(JsonlSink(default_path), worker=worker)
    else:
        configure(worker=worker)


def set_identity(worker: str) -> None:
    global _worker
    _worker = worker


def enabled() -> bool:
    return bool(_sinks)


def flush() -> None:
    with _lock:
        for s in _sinks:
            s.flush()


def shutdown() -> None:
    configure()


# ------------------------------------------------------------------- emit
def _emit(kind: str, stage: str, name: str, *, dur_s=None, value=None,
          attrs=None) -> None:
    global _seq
    if not _sinks:
        return
    with _lock:
        _seq += 1
        rec = {
            "v": SCHEMA_VERSION,
            "kind": kind,
            "stage": stage,
            "name": name,
            "t": time.time(),
            "mono": time.monotonic(),
            "worker": _worker,
            "pid": os.getpid(),
            "seq": _seq,
            "attrs": dict(attrs or {}),
        }
        if kind == "span":
            rec["dur_s"] = float(dur_s)
        else:
            rec["value"] = float(value)
        for s in _sinks:
            s.write(rec)


def counter(stage: str, name: str, value: float = 1.0, **attrs) -> None:
    """Point event: queue claims/steals/dones, bytes written, cache
    entries, calibration results…"""
    _emit("counter", stage, name, value=value, attrs=attrs)


def emit_clock_anchor(**attrs) -> None:
    """One explicit (epoch, monotonic) clock sample at the start of a
    worker or of ``edm_run``: it marks the run start on both clocks, so
    ``runtime/trace.py`` can align workers on their monotonic clocks.
    Emitted by the fleet worker and by ``edm_run``, never
    implicitly by :func:`configure` (tests install sinks freely and
    count records)."""
    counter("fleet", "clock_anchor",
            epoch=time.time(), mono=time.monotonic(), **attrs)


@contextlib.contextmanager
def span(stage: str, name: str, **attrs):
    """Timed region; ``dur_s`` is wall time between enter and exit.  The
    yielded dict lets the body add attrs discovered mid-span (e.g. fsync
    time, tile count).  Emits nothing when no sink is configured."""
    if not _sinks:
        yield {}
        return
    extra: dict = {}
    t0 = time.perf_counter()
    try:
        yield extra
    finally:
        _emit("span", stage, name, dur_s=time.perf_counter() - t0,
              attrs={**attrs, **extra})


# ------------------------------------------------------------- validation
_REQUIRED = {"v": int, "kind": str, "stage": str, "name": str, "t": float,
             "worker": str, "pid": int, "seq": int, "attrs": dict}


def validate(rec: dict) -> list[str]:
    """Schema check; returns a list of violations (empty == valid)."""
    errs: list[str] = []
    for field, typ in _REQUIRED.items():
        if field not in rec:
            errs.append(f"missing field {field!r}")
        elif typ is float:
            if not isinstance(rec[field], (int, float)):
                errs.append(f"{field}={rec[field]!r} not a number")
        elif not isinstance(rec[field], typ):
            errs.append(f"{field}={rec[field]!r} not {typ.__name__}")
    if errs:
        return errs
    if rec["v"] != SCHEMA_VERSION:
        errs.append(f"schema version {rec['v']} != {SCHEMA_VERSION}")
    if rec["kind"] == "span":
        if not isinstance(rec.get("dur_s"), (int, float)) or rec["dur_s"] < 0:
            errs.append(f"span dur_s={rec.get('dur_s')!r} invalid")
    elif rec["kind"] == "counter":
        if not isinstance(rec.get("value"), (int, float)):
            errs.append(f"counter value={rec.get('value')!r} invalid")
    else:
        errs.append(f"kind={rec['kind']!r} not span|counter")
    if rec["stage"] not in PIPELINE_STAGES + RUNTIME_STAGES:
        errs.append(f"stage={rec['stage']!r} unknown")
    try:
        json.dumps(rec["attrs"])
    except (TypeError, ValueError):
        errs.append("attrs not JSON-serializable")
    return errs


# -------------------------------------------------------------- store I/O
def store_telemetry_dir(out_dir: str | pathlib.Path) -> pathlib.Path:
    return pathlib.Path(out_dir) / "telemetry"


def worker_jsonl(out_dir: str | pathlib.Path, worker: str) -> pathlib.Path:
    return store_telemetry_dir(out_dir) / f"{worker}.jsonl"


def iter_store_records(
    out_dir: str | pathlib.Path,
) -> Iterator[tuple[str, dict]]:
    """Yield (worker_file_stem, record) over every per-worker JSONL a
    run store holds — the input of ``edm_fleet status`` and of the
    trace, history and autotune readers."""
    d = store_telemetry_dir(out_dir)
    if not d.exists():
        return
    for p in sorted(d.glob("*.jsonl")):
        for rec in read_jsonl(p):
            yield p.stem, rec
