"""Elastic file-lock lease work queue of the port — the paper's
master-worker, masterless (DESIGN.md SS10), with the on-disk protocol of
``repro.runtime.workqueue``.

The paper schedules EDM work units from an MPI master onto 512 workers
(SSIII-C).  Our substrate is better than a master: the TileWriter store
already makes every (row-chunk x col-tile) block idempotent and
resumable, so scheduling reduces to *mutual exclusion with expiry* over
a deterministic unit list that every worker can compute on its own.
This module provides exactly that:

  * :class:`WorkUnit` — a (kind, row0, nrows) row span of one pipeline
    stage ("phase1", "phase2", "assemble", "sig", "finalize").  Unit
    lists derive deterministically from (N, unit_rows), so W workers
    pointed at the same store agree on the queue without any exchange.
  * :class:`LeaseQueue` — claim/renew/steal/done over lease files in a
    shared directory.  A claim is an O_CREAT|O_EXCL lease create (atomic
    on POSIX local *and* network filesystems); a crash leaves the lease
    to EXPIRE (wall-clock TTL), after which any worker may steal it by
    token-stamped atomic replace.  Completion is a separate durable done
    marker, written only after the store commit it certifies.

Safety model: leases make duplicate work *rare*, not impossible (two
stealers can race the replace; the loser's readback detects it, but a
worker may also outlive its own TTL mid-compute).  Correctness never
depends on exclusion: every unit's outputs are bit-identical regardless
of which worker computes them (geometry-independent values, DESIGN.md
SS7/SS9/SS10) and every store write is an atomic replace, so duplicated
units overwrite each other with identical bytes.  The queue is pure
coordination; the store is the ground truth.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import time

# The ONE durability primitive (write-temp + fsync + os.replace) is
# owned by the store — queue files and store files share the same
# "SIGKILL can never tear shared state" contract, so they must share
# the same implementation.
from repro_torch.data.store import FATAL_WRITE_ERRNOS, _unique_tmp, atomic_write_text
from repro_torch.runtime import faultpoints, telemetry


def _fatal_oserror(e: BaseException) -> bool:
    """True for environment failures where retrying the unit elsewhere is
    pointless and poisons faster than burning the budget: the shared
    store's disk is full / quota'd / read-only (every worker writes the
    SAME filesystem, so the next attempt fails identically)."""
    while e is not None:
        if isinstance(e, OSError) and e.errno in FATAL_WRITE_ERRNOS:
            return True
        e = e.__cause__ or e.__context__
    return False

_STAGELESS = ("phase1", "assemble", "finalize")  # one unit per run


class UnitFailedError(RuntimeError):
    """A work unit exhausted its bounded retry budget (the unit is
    poisoned: every worker that observes the marker raises too, so the
    fleet drains instead of spinning on TTL steals forever)."""

    def __init__(self, uid: str, attempts: int, error: str):
        super().__init__(
            f"work unit {uid} failed permanently after {attempts} "
            f"attempt(s): {error}"
        )
        self.uid = uid
        self.attempts = attempts
        self.error = error


@dataclasses.dataclass(frozen=True, order=True)
class WorkUnit:
    """One claimable span of pipeline work.

    kind: stage name; "phase2" and "sig" units carry a [row0, row0+nrows)
    row span of the causal map, the singleton kinds ("phase1",
    "assemble", "finalize") span the whole run and exist once.
    """

    kind: str
    row0: int = 0
    nrows: int = 0

    @property
    def uid(self) -> str:
        if self.kind in _STAGELESS:
            return self.kind
        return f"{self.kind}_{self.row0:08d}_{self.nrows:05d}"


def plan_units(kind: str, N: int, unit_rows: int) -> list["WorkUnit"]:
    """Deterministic unit grid for a row-span stage: every worker calls
    this with the same (N, unit_rows) from the fleet spec and gets the
    same queue — no master required."""
    if kind in _STAGELESS:
        return [WorkUnit(kind, 0, N)]
    if unit_rows < 1:
        raise ValueError(f"unit_rows={unit_rows} must be >= 1")
    return [
        WorkUnit(kind, r, min(unit_rows, N - r)) for r in range(0, N, unit_rows)
    ]


class LeaseQueue:
    """File-lock lease queue over a shared directory.

    Per unit uid there are two files: ``<uid>.lease`` (current claim:
    worker, pid, token, t, ttl) and ``<uid>.done`` (durable completion
    marker).  The protocol:

      claim    — O_CREAT|O_EXCL create of the lease.  If it exists and is
                 expired (t + ttl < now), or belongs to THIS worker id (a
                 relaunch after SIGKILL reclaims its own units without
                 waiting out the TTL), steal: atomically replace with a
                 fresh token and read back — owning the readback token is
                 owning the lease.
      renew    — re-stamp t on an owned lease mid-compute (long units).
      mark_done— create the done marker (after the store commit), then
                 drop the lease.
      run_stage— the masterless barrier: loop {claim, compute, done}
                 until every unit of the stage is done, sleeping between
                 polls while other workers hold the remainder.
    """

    def __init__(
        self,
        root: str | pathlib.Path,
        worker: str,
        ttl: float = 600.0,
        poll: float = 0.25,
        fail_limit: int = 3,
    ):
        if ttl <= 0:
            raise ValueError("ttl must be > 0")
        if fail_limit < 1:
            raise ValueError("fail_limit must be >= 1")
        self.dir = pathlib.Path(root)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.worker = worker
        self.ttl = float(ttl)
        self.poll = float(poll)
        self.fail_limit = int(fail_limit)
        self._n = 0  # per-claim token counter
        self._claim_t: dict[str, float] = {}  # uid -> claim time (held span)
        self._seen_done: set[str] = set()

    # ------------------------------------------------------------ paths
    def _lease(self, unit: WorkUnit) -> pathlib.Path:
        return self.dir / f"{unit.uid}.lease"

    def _done(self, unit: WorkUnit) -> pathlib.Path:
        return self.dir / f"{unit.uid}.done"

    def _fail(self, unit: WorkUnit) -> pathlib.Path:
        return self.dir / f"{unit.uid}.fail"

    def _poison(self, unit: WorkUnit) -> pathlib.Path:
        return self.dir / f"{unit.uid}.poison"

    def _payload(self) -> dict:
        self._n += 1
        return {
            "worker": self.worker,
            "pid": os.getpid(),
            "token": f"{self.worker}-{os.getpid()}-{self._n}-{os.urandom(4).hex()}",
            "t": time.time(),
            "ttl": self.ttl,
        }

    @staticmethod
    def _read(path: pathlib.Path) -> dict | None:
        try:
            return json.loads(path.read_text())
        except (OSError, ValueError):
            return None  # missing, or torn by a non-atomic foreign writer

    # ----------------------------------------------------------- claims
    def is_done(self, unit: WorkUnit) -> bool:
        # A done marker, once seen, is remembered: only fsck --heal
        # revokes one, between runs.  Without this a claim scan would
        # stat every finished unit again, O(units^2) per stage.
        if unit.uid in self._seen_done:
            return True
        if self._done(unit).exists():
            self._seen_done.add(unit.uid)
            return True
        return False

    def pending(self, units: list[WorkUnit]) -> list[WorkUnit]:
        return [u for u in units if not self.is_done(u)]

    def try_claim(self, unit: WorkUnit) -> bool:
        """True when this worker now holds the unit's lease."""
        if self.is_done(unit):
            return False
        path = self._lease(unit)
        payload = self._payload()
        # Atomic create-with-content: hard-link a fully-written temp onto
        # the lease name.  O_CREAT|O_EXCL alone is NOT enough — it makes
        # the (empty) file visible before the payload lands, and a
        # concurrent reader would mistake the moment for a torn lease.
        tmp = _unique_tmp(path)
        with open(tmp, "w") as f:
            f.write(json.dumps(payload))
            f.flush()
            os.fsync(f.fileno())
        try:
            os.link(tmp, path)
            # mark_done writes the done marker BEFORE unlinking the lease,
            # so if our link landed on a name a finisher just freed, the
            # marker is already visible — recheck and back off.
            return self._acquired(unit, stolen=False, lease_age=0.0)
        except FileExistsError:
            pass
        finally:
            os.unlink(tmp)
        held = self._read(path)
        now = time.time()
        if held is None:
            # Unreadable: torn by a foreign non-atomic writer, or unlinked
            # between our exists-check and read.  Grace it by file mtime —
            # never steal something that might be mid-protocol and fresh.
            try:
                expired = os.path.getmtime(path) + self.ttl < now
            except OSError:
                expired = True  # vanished: the holder finished or released
            own_ghost = False
        else:
            expired = held.get("t", 0) + held.get("ttl", 0) < now
            # A lease this worker id wrote in a PREVIOUS life (it was
            # killed and relaunched) is immediately reclaimable — the id
            # names the queue slot, and a live worker never claims the
            # same unit twice.
            own_ghost = held.get("worker") == self.worker
        if not (expired or own_ghost):
            return False
        if self.is_done(unit):  # the holder finished while we deliberated
            return False
        lease_age = now - held.get("t", now) if held is not None else self.ttl
        if expired and not own_ghost:
            telemetry.counter(
                unit.kind, "lease_expired", lease_age_s=lease_age,
                uid=unit.uid,
                prev_worker=None if held is None else held.get("worker"),
            )
            # The stolen-from holder can never report its own hold time
            # (it is dead or wedged) — the stealer records the observed
            # terminal hold on its behalf, so hold-time histograms (TTL
            # tuning, straggler attribution; DESIGN.md SS13) see steals
            # too, not just clean completions.
            telemetry.counter(
                unit.kind, "held", lease_age, uid=unit.uid,
                outcome="stolen",
                prev_worker=None if held is None else held.get("worker"),
            )
        # Steal by token-stamped replace; the readback arbitrates racing
        # stealers (at most one sees its own token as the survivor).
        faultpoints.fire("lease_pre_steal")
        atomic_write_text(path, json.dumps(payload))
        back = self._read(path)
        if back is None or back.get("token") != payload["token"]:
            return False
        return self._acquired(unit, stolen=True, lease_age=lease_age)

    def _acquired(self, unit: WorkUnit, stolen: bool,
                  lease_age: float) -> bool:
        """Post-acquisition done recheck: a finisher may have completed
        the unit in the window between our pre-checks and the lease
        landing.  Dropping the just-taken lease keeps done units
        lease-free (claim order: done marker always wins)."""
        if not self.is_done(unit):
            self._claim_t[unit.uid] = time.time()
            telemetry.counter(
                unit.kind, "steal" if stolen else "claim",
                uid=unit.uid, row0=unit.row0, nrows=unit.nrows,
                lease_age_s=lease_age,
            )
            return True
        try:
            self._lease(unit).unlink()
        except OSError:
            pass
        return False

    def claim_next(self, units: list[WorkUnit]) -> WorkUnit | None:
        for u in units:
            if self.try_claim(u):
                return u
        return None

    def renew(self, unit: WorkUnit) -> bool:
        """Re-stamp an owned lease's clock; False if no longer the owner
        (the unit was stolen after this worker outlived its TTL — finish
        anyway: duplicate completion is safe, see module docstring)."""
        with telemetry.span(unit.kind, "queue_renew"):
            held = self._read(self._lease(unit))
            if held is None or held.get("worker") != self.worker:
                return False
            held["t"] = time.time()
            atomic_write_text(self._lease(unit), json.dumps(held))
            return True

    def release(self, unit: WorkUnit) -> None:
        """Give a claimed-but-uncomputed unit back (graceful shutdown)."""
        held = self._read(self._lease(unit))
        if held is not None and held.get("worker") == self.worker:
            if unit.uid in self._claim_t:
                telemetry.counter(
                    unit.kind, "held",
                    time.time() - self._claim_t.pop(unit.uid),
                    uid=unit.uid, outcome="release",
                )
            try:
                self._lease(unit).unlink()
            except OSError:
                pass

    def mark_done(self, unit: WorkUnit) -> None:
        """Durable completion marker.  Call ONLY after the store writes
        the unit certifies are committed (the marker is what lets other
        workers skip the unit forever).

        Telemetry ORDER matters here: the done + held records are
        emitted and FLUSHED before the marker lands, so a durable done
        marker always implies its writer's records for the unit are
        durable too — the loss-window bound (a SIGKILL between flush and
        marker merely recomputes the unit, and duplicate done records
        are deduped at trace time)."""
        held_s = time.time() - self._claim_t.pop(unit.uid, time.time())
        telemetry.counter(
            unit.kind, "done", uid=unit.uid, row0=unit.row0,
            nrows=unit.nrows, held_s=held_s,
        )
        telemetry.counter(unit.kind, "held", held_s, uid=unit.uid,
                          outcome="done")
        telemetry.flush()  # unit boundary: make the unit's tail durable
        faultpoints.fire("done_pre_mark")
        atomic_write_text(
            self._done(unit),
            json.dumps({"worker": self.worker, "t": time.time()}),
            fault="done",
        )
        try:
            self._lease(unit).unlink()
        except OSError:
            pass

    def _drop_done_leases(self, units: list[WorkUnit]) -> None:
        """Unlink every lease left over a unit of ``units``, all done.

        A holder SIGKILLed between its done marker and its lease unlink
        (the last two steps of :meth:`mark_done`) leaves a lease that no
        claim ever touches again: claims skip done units, and a relaunch
        under the same id never revisits one.  The done marker wins, so
        such a lease guards nothing; every worker leaving the barrier
        removes what is left (one directory listing a stage)."""
        names = set(os.listdir(self.dir))
        for u in units:
            if f"{u.uid}.lease" in names:
                try:
                    self._lease(u).unlink()
                except OSError:
                    pass  # another worker leaving the barrier got there first

    # ---------------------------------------------------- bounded retries
    def record_failure(self, unit: WorkUnit, error: str,
                       fatal: bool = False) -> int:
        """Durably count one failed compute attempt of ``unit``; returns
        the total attempt count.  At ``fail_limit`` attempts the unit is
        POISONED (a durable ``.poison`` marker): every worker's
        run_stage raises :class:`UnitFailedError` on observing it, so a
        unit that crashes every claimer drains the fleet with a clear
        verdict instead of cycling through TTL steals forever.

        ``fatal=True`` (non-retryable environment failure, e.g. the
        shared store's disk is full — see :func:`_fatal_oserror`) poisons
        immediately: the error is one every retry would repeat.

        The count is a read-modify-write over an atomic file: racing
        workers may undercount one attempt, which only ever grants a
        poison unit one extra try — the bound stays bounded.
        """
        have = self._read(self._fail(unit)) or {"attempts": 0, "errors": []}
        attempts = int(have.get("attempts", 0)) + 1
        errors = (list(have.get("errors", [])) + [
            {"worker": self.worker, "t": time.time(), "error": error[:500]}
        ])[-self.fail_limit:]
        atomic_write_text(
            self._fail(unit),
            json.dumps({"attempts": attempts, "errors": errors}),
        )
        telemetry.counter(
            unit.kind, "unit_failed", uid=unit.uid, attempts=attempts,
            error=error[:200], fatal=fatal,
        )
        if fatal or attempts >= self.fail_limit:
            atomic_write_text(
                self._poison(unit),
                json.dumps({"uid": unit.uid, "attempts": attempts,
                            "worker": self.worker, "error": error[:500],
                            "fatal": fatal}),
            )
            telemetry.counter(unit.kind, "unit_poisoned", uid=unit.uid,
                              attempts=attempts, fatal=fatal)
        self.release(unit)
        telemetry.flush()  # unit boundary (failure): bound the loss window
        return attempts

    def poisoned(self, units: list[WorkUnit]) -> dict | None:
        """The first poison marker among ``units`` (or None)."""
        for u in units:
            p = self._read(self._poison(u))
            if p is not None:
                return {"uid": u.uid, **p}
        return None

    # ---------------------------------------------------------- barrier
    def run_stage(
        self,
        units: list[WorkUnit],
        compute,
        already_done=None,
        timeout: float | None = None,
    ) -> int:
        """Masterless stage barrier: claim and compute units until EVERY
        unit is done (by this worker or any other), then return how many
        this worker computed.

        already_done(unit) -> bool lets the caller skip units whose
        output is durable in the store from a prior run (elastic resume:
        queue markers and store coverage may disagree after a crash —
        the store wins).  While other workers hold the remaining units
        this worker sleeps ``poll`` between scans; a holder that dies
        mid-unit surfaces back as claimable once its lease expires, so
        the barrier cannot deadlock on a crash.  ``timeout`` (seconds)
        bounds the total wait and raises TimeoutError — a fleet-wide
        wedge is a bug, not a state to park in forever.

        A compute(unit) exception is a FAILED ATTEMPT, not instant
        death: it is durably counted (:meth:`record_failure`), the lease
        released, and the unit retried — by this worker or any other —
        up to ``fail_limit`` total attempts across the fleet, after
        which the unit is poisoned and every worker's barrier raises
        :class:`UnitFailedError` (bounded retries; the driver surfaces
        the failing unit id and exits nonzero).

        The queue's own time is recorded as spans of the stage:
        ``queue_claim`` (poison scan and claim), ``queue_done``
        (:meth:`mark_done`), ``queue_wait`` (the barrier's scan and
        sleep) and, per chunk, ``queue_renew``.
        """
        if not units:
            return 0
        kind = units[0].kind
        t0 = time.monotonic()
        computed = 0
        if already_done is not None:
            for u in units:
                if not self.is_done(u) and already_done(u):
                    self.mark_done(u)
        next_poison_check = t0
        while True:
            with telemetry.span(kind, "queue_claim"):
                # the poison scan opens one file a unit: at most once a
                # poll period, not once a claim (O(units^2) opens a stage)
                if time.monotonic() >= next_poison_check:
                    poison = self.poisoned(units)
                    if poison is not None:
                        raise UnitFailedError(
                            poison["uid"],
                            int(poison.get("attempts", self.fail_limit)),
                            str(poison.get("error", "unknown")),
                        )
                    next_poison_check = time.monotonic() + self.poll
                unit = self.claim_next(units)
            if unit is not None:
                try:
                    faultpoints.fire("unit_pre_compute")
                    compute(unit)
                    # The window the done-marker ordering protects: store
                    # bytes durable, completion not yet certified.
                    faultpoints.fire("unit_post_compute")
                except (KeyboardInterrupt, SystemExit):
                    self.release(unit)
                    raise
                except Exception as e:  # noqa: BLE001 - counted + rethrown at limit
                    fatal = _fatal_oserror(e)
                    attempts = self.record_failure(unit, repr(e), fatal=fatal)
                    if fatal or attempts >= self.fail_limit:
                        raise UnitFailedError(unit.uid, attempts,
                                              repr(e)) from e
                    continue
                with telemetry.span(kind, "queue_done"):
                    self.mark_done(unit)
                computed += 1
                continue
            with telemetry.span(kind, "queue_wait"):
                if not self.pending(units):
                    self._drop_done_leases(units)
                    return computed
                if timeout is not None and time.monotonic() - t0 > timeout:
                    raise TimeoutError(
                        f"stage {kind}: {len(self.pending(units))} "
                        f"unit(s) still pending after {timeout:.0f}s"
                    )
                time.sleep(self.poll)
