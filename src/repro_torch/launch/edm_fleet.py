"""Masterless multi-process EDM fleet of the port — the paper's 512-node
master-worker over the tile store, without the master (the JAX package's
DESIGN.md SS10), on the card.

  # spawned for you (a supervisor that restarts crashed workers):
  PYTHONPATH=src python -m repro_torch.launch.edm_run --synthetic 2048x1450 \\
      --surrogates 20 --lib-sizes 100,200,400 --workers 2 --out /tmp/fleet
  # or by hand, each worker over an initialised store:
  PYTHONPATH=src python -m repro_torch.launch.edm_fleet --out /tmp/fleet \\
      --worker-id w2
  PYTHONPATH=src python -m repro_torch.launch.edm_fleet status --out /tmp/fleet
  PYTHONPATH=src python -m repro_torch.launch.edm_fleet status --watch \\
      --interval 2 --out /tmp/fleet
  PYTHONPATH=src python -m repro_torch.launch.edm_fleet fsck --out /tmp/fleet
  PYTHONPATH=src python -m repro_torch.launch.edm_fleet trace --reconcile \\
      --out /tmp/fleet            # writes /tmp/fleet/trace.json (Perfetto)
  PYTHONPATH=src python -m repro_torch.launch.edm_fleet trends \\
      --history /tmp/fleet/history.jsonl

Every worker runs the same stage sequence and coordinates only through
files in the shared ``--out`` store:

  phase1   — one unit; the claimer runs simplex projection for all rows
             and persists optE + simplex rhos.
  phase2   — (row-span) units claimed from a lease queue; each worker
             computes its units in chunks of ``lib_block`` rows and
             streams blocks through a writer_id-sharded TileWriter.
  assemble — one unit: merge manifests, memmap-assemble causal_map/.
  sig      — (row-span) units of the significance stage, through the
             same sharded writers.
  finalize — one unit: assemble rho_conv/rho_trend/pvals, recount the p
             histogram, BH-FDR edge list.

Each worker computes its units in chunks of ``len(devices) x
lib_block`` rows over its own device slots (every visible card, or
those its ``EDM_LOCAL_DEVICE_IDS`` names; ``runtime/platform.py``); W
workers may share cards, each with its own CUDA context (the card's
compute mode must be Default).  ``fleet.json`` names the device type,
the platform tier and whether workers join a ``torch.distributed``
group from their own EDM_* rank environment; a worker that cannot use
its device exits non-zero — it never goes on on the CPU.
SIGKILL any worker at any point: its claimed unit's lease expires (or is
reclaimed at once by a relaunch under the same id) and is recomputed.
Every unit's values are independent of which worker computes it and of
the unit's height (``core/ccm.py::pearson_layout``), and every store
write is an atomic replace, so the assembled causal_map, rho_conv,
rho_trend, pvals and edges are byte-identical for any worker count,
kill schedule or unit size.

The store is the JAX package's format: its ``edm_fleet status`` and
``fsck`` read a port store.  The fingerprint carries ``"framework":
"torch"`` and ``fleet.json`` a ``"device"`` key, so a port worker refuses
a store the JAX package initialised, and the other way round.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.core import ccm
from repro_torch.core.pipeline import Phase2Runner, check_run, run_phase1
from repro_torch.core.types import EDMConfig, config_from_jax
from repro_torch.data import store
from repro_torch.data.store import TileWriter
from repro_torch.inference.types import SignificanceConfig, sig_config_from_jax
from repro_torch.runtime import faultpoints, history, integrity, telemetry, trace
from repro_torch.runtime import platform as rt_platform
from repro_torch.runtime.workqueue import LeaseQueue, WorkUnit, plan_units

SPEC_NAME = "fleet.json"
STAGE_ORDER = ("phase1", "phase2", "assemble", "sig", "finalize")


# ------------------------------------------------------------------- spec
def init_fleet(
    out_dir: str | pathlib.Path,
    dataset: str | pathlib.Path,
    cfg: EDMConfig,
    sig: SignificanceConfig | None = None,
    unit_rows: int = 0,
    seed: int | None = None,
    device: str = "cuda",
    platform: str | None = None,
    distributed: bool = False,
) -> dict:
    """Write the shared fleet spec every worker derives its queue from,
    after the engine's limits are checked on ``device`` (raises where it
    is ``cuda`` and there is no card).  ``unit_rows=0`` resolves to one
    chunk of this process's device slots, ``len(local_devices()) x
    lib_block`` rows.  The keys are the JAX package's plus ``device``:
    ``platform`` (a tier the workers apply) and ``distributed`` (workers
    join a ``torch.distributed`` group from their own EDM_* environment);
    a rerun into the same store must ask for the same spec."""
    devs = check_run(cfg, device)
    if platform is not None:
        rt_platform.apply_platform(platform)  # tpu raises here
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    meta = json.loads((pathlib.Path(dataset) / "meta.json").read_text())
    N, L = (int(s) for s in meta["shape"][:2])
    if unit_rows <= 0:
        unit_rows = len(devs) * cfg.lib_block
    if seed is None:
        seed = 0 if sig is None else sig.seed
    ts = np.asarray(store.load_dataset(dataset), np.float32)
    fp = integrity.fingerprint_of(ts, cfg)
    spec = {
        "dataset": str(pathlib.Path(dataset).resolve()),
        "N": N,
        "L": L,
        "unit_rows": int(unit_rows),
        "seed": int(seed),
        "cfg": dataclasses.asdict(cfg),
        "sig": None if sig is None else dataclasses.asdict(sig),
        "dataset_crc32": fp["dataset_crc32"],
        "fingerprint": fp["fingerprint"],
        "platform": platform,
        "distributed": bool(distributed),
        "device": devs[0].type,
    }
    spec = json.loads(json.dumps(spec))  # tuples as they read back
    existing = out / SPEC_NAME
    if existing.exists():
        have = json.loads(existing.read_text())
        if have != spec:
            raise ValueError(
                f"fleet spec mismatch in {out}: store was initialised with "
                f"{have} but this run asks for {spec}; use a fresh --out dir"
            )
        return have
    store.atomic_write_text(existing, json.dumps(spec, indent=1))
    integrity.stamp_fingerprint(out, fp)
    return spec


def load_fleet(out_dir: str | pathlib.Path) -> dict:
    """The store's spec with ``cfg`` / ``sig`` as the port's configs.
    Refuses a spec the JAX package wrote (no ``device`` key)."""
    path = pathlib.Path(out_dir) / SPEC_NAME
    spec = json.loads(path.read_text())
    if "device" not in spec:
        raise integrity.IntegrityError(
            f"{path} was initialised by the JAX package (it names no "
            "device); the port runs only stores it initialised — use a "
            "fresh --out dir or python -m repro.launch.edm_fleet"
        )
    spec["cfg"] = config_from_jax(spec["cfg"])
    if spec["sig"] is not None:
        spec["sig"] = sig_config_from_jax(spec["sig"])
    return spec


def spawn_worker(
    out_dir: str | pathlib.Path,
    worker_id: str,
    ttl: float | None = None,
    env: dict | None = None,
    unit_retries: int | None = None,
) -> subprocess.Popen:
    """Spawn one fleet worker as a subprocess (``env``: its whole
    environment, default this process's).  On the card, build the
    kernels first (``kernels.build_all``): W workers then load the built
    libraries instead of each running nvcc.  A worker spawned here never
    inherits this process's rank (EDM_COORDINATOR / EDM_NUM_PROCESSES /
    EDM_PROCESS_ID are dropped: W children joining under one rank would
    hang the group); it keeps EDM_LOCAL_DEVICE_IDS, its device slots."""
    e = dict(os.environ if env is None else env)
    for var in rt_platform.RANK_ENV:
        e.pop(var, None)
    src = pathlib.Path(__file__).resolve().parents[2]
    e["PYTHONPATH"] = f"{src}:{e['PYTHONPATH']}" if e.get("PYTHONPATH") else str(src)
    cmd = [sys.executable, "-m", "repro_torch.launch.edm_fleet",
           "--out", str(out_dir), "--worker-id", worker_id]
    if ttl is not None:
        cmd += ["--ttl", str(ttl)]
    if unit_retries is not None:
        cmd += ["--unit-retries", str(unit_retries)]
    return subprocess.Popen(cmd, env=e)


# ----------------------------------------------------------------- worker
def _sub_chunks(unit: WorkUnit, chunk: int) -> list[tuple[int, int]]:
    """Split a claimed unit into (row0, valid) chunks of at most
    ``chunk`` rows, this worker's ``len(devices) x lib_block`` (a unit of a
    spec written under another device count may span several: elastic
    across device counts)."""
    hi = unit.row0 + unit.nrows
    return [(r, min(chunk, hi - r)) for r in range(unit.row0, hi, chunk)]


def _covered_and(writers: list[TileWriter]) -> np.ndarray:
    cov = writers[0].refresh().covered()
    for w in writers[1:]:
        cov &= w.refresh().covered()
    return cov


def launch_counts() -> dict[str, int]:
    """This process's launches of each kernel of the port (0 on the CPU,
    where the wrappers run their plain versions; ``flash_attn`` is not
    on the fleet's path and is counted so that a reader of the done line
    sees every kernel)."""
    from repro_torch.kernels.ccm_lookup.ops import ccm_lookup
    from repro_torch.kernels.flash_attn.ops import flash_attn
    from repro_torch.kernels.knn_topk.ops import knn_topk, knn_topk_prefix

    return {"knn_topk": knn_topk.LAUNCHES,
            "knn_topk_prefix": knn_topk_prefix.LAUNCHES,
            "ccm_lookup": ccm_lookup.LAUNCHES,
            "flash_attn": sum(flash_attn.ROUTE_LAUNCHES.values())}


class FleetWorker:
    """One worker's walk through the stage sequence.  Usable in-process
    (tests drive workers' stages by hand) or via :func:`main`."""

    def __init__(self, out_dir: str | pathlib.Path, worker_id: str,
                 ttl: float = 600.0, poll: float = 0.25,
                 timeout: float | None = 3600.0, progress: bool = True,
                 unit_retries: int = 3):
        self.out = pathlib.Path(out_dir)
        spec = load_fleet(self.out)
        apply_spec_platform(self.out)
        self.cfg: EDMConfig = spec["cfg"]
        self.sig: SignificanceConfig | None = spec["sig"]
        self.unit_rows: int = spec["unit_rows"]
        self.seed: int = spec["seed"]
        self.devs = check_run(self.cfg, spec["device"])
        self.dev = self.devs[0]
        for d in dict.fromkeys(self.devs):
            if d.type == "cuda":
                # the worker's CUDA context, made now: where the card will
                # not give one (compute mode not Default) it fails here
                torch.zeros(1, device=d)
                torch.cuda.reset_peak_memory_stats(d)
        self.ts = np.array(store.load_dataset(spec["dataset"]), np.float32)
        self.N = self.ts.shape[0]
        want = (spec["N"], spec["L"])
        if self.ts.shape != want:
            raise ValueError(f"dataset shape {self.ts.shape} != fleet spec {want}")
        have = integrity.fingerprint_of(self.ts, self.cfg)
        if have["fingerprint"] != spec["fingerprint"]:
            raise integrity.IntegrityError(
                f"worker {worker_id}: run fingerprint {have['fingerprint']} "
                f"(dataset crc {have['dataset_crc32']}) != fleet spec "
                f"{spec['fingerprint']} — the dataset at {spec['dataset']} "
                "changed since init_fleet; use a fresh --out dir"
            )
        self.worker_id = worker_id
        self.queue = LeaseQueue(self.out / "queue", worker_id, ttl=ttl,
                                poll=poll, fail_limit=unit_retries)
        self.timeout = timeout
        self.progress = progress
        self.chunk = len(self.devs) * self.cfg.lib_block
        self.stage_s: dict[str, float] = {}

    def _log(self, msg: str) -> None:
        # one write a line: W workers share the supervisor's stdout, and
        # print's separate write of the newline (unbuffered stdout) lets
        # another process's line land inside this one
        if self.progress:
            sys.stdout.write(f"[{self.worker_id}] {msg}\n")
            sys.stdout.flush()

    def _renew_chunk(self, unit: WorkUnit) -> None:
        """Per-chunk keepalive: the ``chunk_pre`` fault point, then the
        lease renewal that keeps a slow but live unit from being stolen."""
        faultpoints.fire("chunk_pre")
        self.queue.renew(unit)

    def _stage(self, kind: str, units, compute, already_done=None) -> None:
        """One stage barrier under a telemetry span, flushed after."""
        t0 = time.perf_counter()
        with telemetry.span(kind, "stage"):
            self.queue.run_stage(units, compute, already_done=already_done,
                                 timeout=self.timeout)
        telemetry.flush()
        self.stage_s[kind] = time.perf_counter() - t0

    # -------------------------------------------------------- stage fns
    def _phase1(self) -> np.ndarray:
        p1 = self.out / "phase1"

        def compute(unit):
            self._log("phase1: simplex projection")
            rhos, optE = run_phase1(self.ts, self.cfg, self.devs,
                                    on_chunk=lambda row0: self.queue.renew(unit))
            p1.mkdir(parents=True, exist_ok=True)
            # optE.npy is the stage's completion witness: it lands last
            store.save_npy_checksummed(p1 / "simplex_rho.npy", rhos)
            store.save_meta(p1, optE.shape, optE.dtype, {"stat": "optE"})
            store.save_npy_checksummed(p1 / "optE.npy", optE)

        self._stage("phase1", plan_units("phase1", self.N, self.unit_rows),
                    compute, already_done=lambda u: (p1 / "optE.npy").exists())
        return integrity.load_npy_verified(p1 / "optE.npy")

    def _phase2(self, optE: np.ndarray) -> None:
        ts_fut = ccm.all_futures(torch.from_numpy(self.ts), self.cfg).numpy()
        runner = Phase2Runner(self.ts, ts_fut, optE, self.cfg, self.devs)
        writer = TileWriter(self.out, self.N, writer_id=self.worker_id,
                            stage="phase2")

        def compute(unit):
            self._log(f"phase2 rows {unit.row0}..{unit.row0 + unit.nrows}")
            runner.run(_sub_chunks(unit, self.chunk), writer,
                       on_chunk=lambda row0: self._renew_chunk(unit))

        # coverage snapshot once per stage entry; units finished later are
        # the queue's business
        cov = writer.refresh().covered()
        self._stage("phase2", plan_units("phase2", self.N, self.unit_rows),
                    compute,
                    already_done=lambda u: bool(cov[u.row0 : u.row0 + u.nrows].all()))

    def _assemble(self, optE: np.ndarray) -> np.ndarray:
        map_npy = self.out / "causal_map" / "data.npy"

        def compute(unit):
            self._log("assemble: causal_map")
            writer = TileWriter(self.out, self.N)
            cov = writer.covered()
            if not cov.all():
                # done markers say phase 2 is done but the store is not
                # covered: fail loudly rather than assemble zero rows
                raise RuntimeError(
                    f"phase-2 store {self.out} incomplete at assemble: "
                    f"{int((~cov).sum())} rows uncovered"
                )
            rho = writer.assemble(mmap_path=map_npy)
            store.save_meta(self.out / "causal_map", rho.shape, rho.dtype, {
                "optE": optE.tolist(),
                "engine": self.cfg.engine,
                "framework": integrity.FRAMEWORK,
                "device": self.dev.type,
                "bucketed": self.cfg.bucketed,
                "n_buckets": int(len(np.unique(optE))),
                "stream_depth": self.cfg.stream_depth,
                "target_tile": self.cfg.target_tile,
                "knn_tile_c": self.cfg.knn_tile_c,
                "seed": self.seed,
                "fleet": True,
            })
            # the run's summary into the history store: without
            # significance assemble is the run's end, and a later finalize
            # replaces this record (same run identity); only the assemble
            # claimer writes it, one history writer a run
            history.record_run(self.out)

        self._stage("assemble", plan_units("assemble", self.N, self.unit_rows),
                    compute)
        return np.load(map_npy, mmap_mode="r")

    def _significance(self, optE: np.ndarray, rho: np.ndarray) -> None:
        from repro_torch.inference.pipeline import (
            SignificanceChunkRunner,
            _check_resume_config,
            _writer,
            finalize_significance,
            make_store_drain,
        )

        sig = self.sig
        _check_resume_config(self.out, sig)
        runner = SignificanceChunkRunner(self.ts, optE, self.cfg, sig, self.devs)
        conv_w = trend_w = pv_w = None
        if runner.do_conv:
            conv_w = _writer(self.out, "rho_conv", self.N, runner.order,
                             writer_id=self.worker_id)
            trend_w = _writer(self.out, "rho_trend", self.N, runner.order,
                              writer_id=self.worker_id)
        if runner.do_null:
            pv_w = _writer(self.out, "pvals", self.N, runner.order,
                           writer_id=self.worker_id)
        writers = [w for w in (conv_w, trend_w, pv_w) if w is not None]
        drain = make_store_drain(self.N, conv_w, trend_w, pv_w)

        def compute(unit):
            self._log(f"sig rows {unit.row0}..{unit.row0 + unit.nrows}")
            runner.run(_sub_chunks(unit, self.chunk), rho, drain,
                       on_chunk=lambda row0: self._renew_chunk(unit))
            for w in writers:
                w.commit()

        # a chunk counts only when every artifact has it
        cov = _covered_and(writers)
        self._stage("sig", plan_units("sig", self.N, self.unit_rows), compute,
                    already_done=lambda u: bool(cov[u.row0 : u.row0 + u.nrows].all()))

        def do_finalize(unit):
            self._log("finalize: assembly + recount + BH-FDR edges")
            finalize_significance(str(self.out), rho, self.cfg, sig,
                                  progress=self.progress)

        self._stage("finalize", plan_units("finalize", self.N, self.unit_rows),
                    do_finalize)

    # --------------------------------------------------------- full run
    def run(self) -> dict:
        """Walk the stage sequence (every stage under a telemetry span,
        flushed at its end, so each worker's JSONL covers all five stages
        even where it computed none of a stage's units).  The last log
        line, ``[wid] done in <s>s {json}``, carries this process's
        kernel launches, peak device bytes (the most of any of its cards)
        and stage seconds; the same dict is returned."""
        t0 = time.time()
        telemetry.emit_clock_anchor(worker_id=self.worker_id)
        optE = self._phase1()
        self._phase2(optE)
        rho = self._assemble(optE)
        if self.sig is not None and (self.sig.lib_sizes or self.sig.n_surrogates > 0):
            self._significance(optE, rho)
        done = {
            "worker": self.worker_id,
            "launches": launch_counts(),
            "devices": [str(d) for d in self.devs],
            "peak_device_bytes": max(
                (torch.cuda.max_memory_allocated(d) for d in self.devs
                 if d.type == "cuda"), default=None),
            "stages_s": self.stage_s,
        }
        self._log(f"done in {time.time() - t0:.1f}s {json.dumps(done)}")
        telemetry.flush()
        return done


def apply_spec_platform(out_dir: str | pathlib.Path) -> None:
    """A worker's platform opt-in from ``fleet.json``: apply its
    ``platform`` tier (``tpu`` raises) and, where the spec says
    ``distributed``, join the group from this process's own EDM_* rank
    environment (:func:`platform.init_distributed`: a no-op without
    EDM_COORDINATOR, as in a worker :func:`spawn_worker` started; partial
    settings raise)."""
    raw = json.loads((pathlib.Path(out_dir) / SPEC_NAME).read_text())
    if raw.get("platform"):
        rt_platform.apply_platform(raw["platform"])
    if raw.get("distributed"):
        rt_platform.init_distributed(device=raw.get("device"))


# ----------------------------------------------------------------- status
def fleet_status(out_dir: str | pathlib.Path) -> dict:
    """Fleet state from files alone (no worker RPC): per stage the
    total / done / poisoned units and live leases; per artifact the
    covered-row fraction; per worker file the telemetry record counts
    and per stage the span time and claim / steal / done counts.
    JSON-safe; :func:`render_status` is the human form."""
    out = pathlib.Path(out_dir)
    spec = json.loads((out / SPEC_NAME).read_text())
    N, unit_rows = spec["N"], spec["unit_rows"]
    qdir = out / "queue"
    now = time.time()

    stages = {}
    for kind in STAGE_ORDER:
        if kind in ("sig", "finalize") and spec.get("sig") is None:
            continue
        units = plan_units(kind, N, unit_rows)
        done = sum((qdir / f"{u.uid}.done").exists() for u in units)
        poisoned, leases = [], []
        for u in units:
            pp = qdir / f"{u.uid}.poison"
            if pp.exists():
                try:
                    poisoned.append(json.loads(pp.read_text()))
                except ValueError:
                    poisoned.append({"uid": u.uid})
            lp = qdir / f"{u.uid}.lease"
            if lp.exists() and not (qdir / f"{u.uid}.done").exists():
                try:
                    held = json.loads(lp.read_text())
                except (OSError, ValueError):
                    continue
                age = now - held.get("t", now)
                leases.append({
                    "uid": u.uid, "worker": held.get("worker"),
                    "age_s": round(age, 1),
                    "expired": age > held.get("ttl", 0),
                })
        stages[kind] = {"total": len(units), "done": done,
                        "leases": leases, "poisoned": poisoned}

    coverage = {}
    artifacts = [("causal_map", out)]
    if spec.get("sig") is not None:
        s = spec["sig"]
        if s.get("lib_sizes"):
            artifacts += [("rho_conv", out / "rho_conv"),
                          ("rho_trend", out / "rho_trend")]
        if s.get("n_surrogates", 0) > 0:
            artifacts += [("pvals", out / "pvals")]
    for name, d in artifacts:
        if not pathlib.Path(d).exists():
            coverage[name] = {"covered": 0, "total": N, "pct": 0.0}
            continue
        cov = TileWriter(d, N).covered()
        coverage[name] = {
            "covered": int(cov.sum()), "total": N,
            "pct": round(100.0 * float(cov.mean()), 1),
        }

    workers: dict[str, dict] = {}
    per_stage: dict[str, dict] = {}
    violations = 0
    for stem, rec in telemetry.iter_store_records(out):
        w = workers.setdefault(stem, {"records": 0, "invalid": 0})
        w["records"] += 1
        if telemetry.validate(rec):
            w["invalid"] += 1
            violations += 1
            continue
        st = per_stage.setdefault(
            rec["stage"], {"span_s": 0.0, "claim": 0, "steal": 0, "done": 0})
        if rec["kind"] == "span":
            st["span_s"] += rec["dur_s"]
        elif rec["name"] in ("claim", "steal", "done"):
            st[rec["name"]] += 1
    for st in per_stage.values():
        st["span_s"] = round(st["span_s"], 3)

    all_done = all(s["done"] == s["total"] for s in stages.values())
    full_cov = all(c["pct"] >= 100.0 for c in coverage.values())
    return {
        "out": str(out), "N": N, "L": spec.get("L"),
        "unit_rows": unit_rows, "device": spec.get("device"),
        "stages": stages, "coverage": coverage,
        "telemetry": {"workers": workers, "stages": per_stage,
                      "violations": violations},
        "complete": bool(all_done and full_cov and coverage),
    }


def render_status(st: dict) -> str:
    lines = [
        f"fleet {st['out']}: N={st['N']} L={st['L']} "
        f"unit_rows={st['unit_rows']} device={st['device']}"
        f"{'  [COMPLETE]' if st['complete'] else ''}",
        f"{'stage':<10} {'done':>9}  leases",
    ]
    for kind, s in st["stages"].items():
        parts = []
        for lease in s["leases"]:
            flag = " EXPIRED" if lease["expired"] else ""
            parts.append(f"{lease['uid']}@{lease['worker']} {lease['age_s']}s{flag}")
        for p in s["poisoned"]:
            parts.append(f"{p.get('uid')} POISONED ({p.get('error', '?')})")
        lines.append(f"{kind:<10} {s['done']:>4}/{s['total']:<4}  "
                     + ("; ".join(parts) or "-"))
    lines.append("coverage: " + ", ".join(
        f"{name} {c['pct']}% ({c['covered']}/{c['total']})"
        for name, c in st["coverage"].items()
    ))
    tel = st["telemetry"]
    if tel["workers"]:
        nrec = sum(w["records"] for w in tel["workers"].values())
        lines.append(
            f"telemetry: {len(tel['workers'])} worker file(s), {nrec} "
            f"records, {tel['violations']} schema violation(s)"
        )
        for stage, s in sorted(tel["stages"].items()):
            lines.append(
                f"  {stage:<10} span {s['span_s']:>8.3f}s  "
                f"claims {s['claim']}  steals {s['steal']}  done {s['done']}"
            )
    else:
        lines.append("telemetry: no records (sink disabled or not started)")
    return "\n".join(lines)


def watch_status(
    out_dir: str | pathlib.Path,
    interval: float = 2.0,
    iterations: int | None = None,
    file=None,
) -> dict:
    """``status --watch``: re-render fleet state every ``interval``
    seconds until the run completes, adding what a single snapshot
    cannot show —

      * per-stage throughput (units done/s) and row-coverage rate with
        an ETA, both from deltas between refreshes;
      * STRAGGLER flags on live leases whose age exceeds the fleet's
        p95 unit hold time (the recorded ``held`` counters — a unit
        held longer than 95% of completed holds is statistically late,
        long before its TTL expires).

    ``iterations`` bounds the loop (tests); returns the last status
    dict.  Pure reader — the same files-only observability as
    :func:`fleet_status`, no worker RPC."""
    f = file or sys.stdout
    prev_t: float | None = None
    prev_cov: dict[str, int] = {}
    prev_done: dict[str, int] = {}
    n = 0
    while True:
        st = fleet_status(out_dir)
        now = time.time()
        lines = [render_status(st)]
        if prev_t is not None:
            dt = max(now - prev_t, 1e-6)
            for kind, s in st["stages"].items():
                d = s["done"] - prev_done.get(kind, s["done"])
                if d > 0 and s["done"] < s["total"]:
                    rate = d / dt
                    eta = (s["total"] - s["done"]) / rate
                    lines.append(f"watch: {kind} {rate:.2f} units/s, "
                                 f"ETA {eta:.0f}s")
            for name, c in st["coverage"].items():
                d = c["covered"] - prev_cov.get(name, c["covered"])
                if d > 0 and c["covered"] < c["total"]:
                    rate = d / dt
                    eta = (c["total"] - c["covered"]) / rate
                    lines.append(f"watch: {name} {rate:.1f} rows/s, "
                                 f"ETA {eta:.0f}s")
        held = trace.held_percentiles(out_dir)
        p95 = held.get("p95")
        if p95:
            for kind, s in st["stages"].items():
                for lease in s["leases"]:
                    if lease["age_s"] > p95:
                        lines.append(
                            f"watch: STRAGGLER {lease['uid']}@{lease['worker']} "
                            f"held {lease['age_s']}s > fleet p95 {p95:.1f}s"
                            + (" (lease EXPIRED)" if lease["expired"] else ""))
        print("\n".join(lines), file=f, flush=True)
        prev_t = now
        prev_cov = {k: c["covered"] for k, c in st["coverage"].items()}
        prev_done = {k: s["done"] for k, s in st["stages"].items()}
        n += 1
        if st["complete"] or (iterations is not None and n >= iterations):
            return st
        time.sleep(interval)


_FLAGS_EPILOG = """\
commands:
  work (default)      claim and compute units until the run completes
  status              render live lease/coverage/telemetry state and exit
  fsck                verify every store artifact against its recorded
                      checksum (masterless, from files alone) and exit
  trace               assemble the fleet-wide causal trace from recorded
                      telemetry: unit lifecycles, clock-skew-aligned
                      timelines, critical path through the stage DAG,
                      wall-time buckets (compute / gather / store /
                      queue-wait / straggler-tail); writes Chrome
                      trace-event JSON loadable in Perfetto
  trends              render the cross-run history (one summary record
                      appended per finished run): regression flags vs
                      the previous same-fingerprint run and a
                      knob-vs-throughput table

flags (work):
  --out DIR           shared fleet store holding fleet.json   [required]
  --worker-id ID      stable queue identity                   [required]
  --ttl SEC           lease expiry                            [600]
  --poll SEC          barrier poll interval                   [0.25]
  --timeout SEC       max wait on one stage barrier           [3600]
  --unit-retries N    attempts before a unit is poisoned      [3]

flags (status):
  --out DIR           fleet store to inspect                  [required]
  --json              machine-readable status dict
  --expect-complete   exit 1 unless all stages done AND every
                      artifact at 100% row coverage
  --watch             re-render every --interval seconds until complete,
                      with per-stage throughput, ETA, and STRAGGLER
                      flags on leases older than the fleet p95 hold time
  --interval SEC      --watch refresh period                  [2]

flags (fsck):
  --out DIR           store to verify                         [required]
  --json              machine-readable fsck report
  --heal              revoke damaged tiles' manifest entries + queue done
                      markers so one normal fleet pass recomputes exactly
                      the damaged units (refused on a stale fingerprint:
                      wrong INPUTS cannot be healed, only recomputed)
  --expect-clean      exit 1 unless the store verifies clean

flags (trace):
  --out DIR           fleet store whose telemetry to assemble [required]
  --trace-out FILE    Chrome trace JSON path     [<out>/trace.json]
  --json              machine-readable trace analysis (units, stages,
                      buckets, critical path) instead of the one-pager
  --reconcile         exit 1 unless per-stage span totals match
                      `status` within 1% (CI gate)

flags (trends):
  --history FILE      history JSONL to render [<out>/history.jsonl or
                      $EDM_HISTORY; --out optional when given]
  --json              machine-readable trends analysis

environment:
  EDM_TELEMETRY       off | stdout | jsonl:<path>; unset -> per-worker
                      JSONL at <out>/telemetry/<worker-id>.jsonl
  EDM_HISTORY         shared run-history JSONL (default:
                      <out>/history.jsonl; one summary record appended
                      per finished run, same-run reruns replace theirs)
  EDM_FAULTS          fault-injection spec (runtime/faultpoints.py), e.g.
                      tile_pre_rename:crash@3 — testing only
  EDM_LOCAL_DEVICE_IDS  this worker's device slots, e.g. 0,1 (default every
                      visible card; "0,0": two slots on card 0)
  EDM_COORDINATOR     torch.distributed group (runtime/platform.py;
  EDM_NUM_PROCESSES   joined only when fleet.json says `distributed`):
  EDM_PROCESS_ID      host:port of rank 0, world size, this rank
"""


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch.launch.edm_fleet",
        description=__doc__.split("\n")[0],
        epilog=_FLAGS_EPILOG,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("cmd", nargs="?", default="work",
                    choices=["work", "status", "fsck", "trace", "trends"],
                    help="work: run a fleet worker (default); status: "
                    "render live fleet state for --out and exit; fsck: "
                    "verify store integrity (optionally --heal) and exit; "
                    "trace: assemble the fleet causal trace + Chrome "
                    "trace JSON; trends: render the cross-run history")
    ap.add_argument("--out",
                    help="shared fleet store (holds fleet.json; see edm_run "
                    "--workers or init_fleet); required for every command "
                    "except `trends --history FILE`")
    ap.add_argument("--worker-id",
                    help="stable queue identity; relaunching a killed "
                    "worker under the same id reclaims its leases at once")
    ap.add_argument("--ttl", type=float, default=600.0,
                    help="lease expiry seconds")
    ap.add_argument("--poll", type=float, default=0.25,
                    help="barrier poll interval seconds")
    ap.add_argument("--timeout", type=float, default=3600.0,
                    help="max seconds to wait on any one stage barrier")
    ap.add_argument("--unit-retries", type=int, default=3,
                    help="failed compute attempts (fleet-wide) before a "
                    "unit is poisoned and the whole fleet exits nonzero")
    ap.add_argument("--json", action="store_true",
                    help="status / fsck / trace / trends: print the "
                    "machine-readable dict")
    ap.add_argument("--expect-complete", action="store_true",
                    help="status: exit 1 unless every stage is done and "
                    "every artifact reports 100%% row coverage")
    ap.add_argument("--heal", action="store_true",
                    help="fsck: revoke damaged coverage + done markers so "
                    "a fleet pass recomputes exactly what was lost")
    ap.add_argument("--expect-clean", action="store_true",
                    help="fsck: exit 1 unless the store verifies clean")
    ap.add_argument("--watch", action="store_true",
                    help="status: re-render every --interval seconds until "
                    "the run completes, with throughput, ETA, and "
                    "straggler flags (lease age > fleet p95 hold time)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="status --watch refresh period in seconds")
    ap.add_argument("--trace-out",
                    help="trace: Chrome trace-event JSON destination "
                    "(default <out>/trace.json; load in Perfetto)")
    ap.add_argument("--reconcile", action="store_true",
                    help="trace: exit 1 unless per-stage span totals "
                    "reconcile with `status` within 1%%")
    ap.add_argument("--history",
                    help="trends: history JSONL to render (default "
                    "$EDM_HISTORY or <out>/history.jsonl)")
    return ap


def main(argv=None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.out is None and not (args.cmd == "trends" and args.history):
        ap.error(f"{args.cmd} requires --out")

    if args.cmd == "status":
        if args.watch:
            watch_status(args.out, interval=args.interval)
            return
        st = fleet_status(args.out)
        print(json.dumps(st, indent=1) if args.json else render_status(st))
        if args.expect_complete and not st["complete"]:
            sys.exit(1)
        return

    if args.cmd == "trace":
        tr = trace.assemble_trace(args.out)
        dest = pathlib.Path(args.trace_out) if args.trace_out \
            else pathlib.Path(args.out) / "trace.json"
        trace.write_chrome_trace(args.out, dest)
        rep = trace.reconcile(tr, fleet_status(args.out)) \
            if args.reconcile else None
        if args.json:
            print(json.dumps({**tr, "reconcile": rep} if rep else tr, indent=1))
        else:
            print(trace.render_trace(tr))
            print(f"chrome trace: {dest} (load in Perfetto / chrome://tracing)")
            if rep is not None:
                for stage, s in sorted(rep["stages"].items()):
                    print(f"reconcile {stage}: trace {s['trace_s']}s vs "
                          f"status {s['status_s']}s (delta {s['delta_pct']}%)")
        if rep is not None and not rep["ok"]:
            sys.exit(1)
        return

    if args.cmd == "trends":
        hp = pathlib.Path(args.history) if args.history \
            else history.history_path(args.out)
        recs = history.load_history(hp)
        if args.json:
            print(json.dumps({"path": str(hp), **history.analyze_trends(recs)},
                             indent=1))
        else:
            print(f"history: {hp}")
            print(history.render_trends(recs))
        return

    if args.cmd == "fsck":
        report = integrity.fsck_store(args.out, heal=args.heal)
        print(json.dumps(report, indent=1) if args.json
              else integrity.render_fsck(report))
        if args.expect_clean and not report["clean"]:
            sys.exit(1)
        return

    if not args.worker_id:
        ap.error("work requires --worker-id")
    telemetry.configure_from_env(
        default_path=telemetry.worker_jsonl(args.out, args.worker_id),
        worker=args.worker_id,
    )
    try:
        FleetWorker(args.out, args.worker_id, ttl=args.ttl, poll=args.poll,
                    timeout=args.timeout, unit_retries=args.unit_retries).run()
    finally:
        telemetry.shutdown()


if __name__ == "__main__":
    main()
