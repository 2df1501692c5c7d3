"""The port's work queue and multi-writer store (``repro_torch.runtime.
workqueue``, ``repro_torch.data.store``), the cases of
tests/test_workqueue.py: lease claim / expiry / steal semantics,
duplicate-claim exclusion under contention, bounded retries and poison,
writer_id-sharded TileWriter manifests, crash-mid-tile recovery, and the
fleet-style significance path (sharded writers + finalize recount) being
byte-identical to the port's single-process driver, on the CPU."""
import concurrent.futures
import errno
import json
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.data.store import TileWriter  # noqa: E402
from repro_torch.runtime.workqueue import (  # noqa: E402
    LeaseQueue,
    UnitFailedError,
    WorkUnit,
    plan_units,
)


# ------------------------------------------------------------ unit grids
def test_plan_units_deterministic_grid():
    units = plan_units("phase2", 20, 8)
    assert units == [
        WorkUnit("phase2", 0, 8),
        WorkUnit("phase2", 8, 8),
        WorkUnit("phase2", 16, 4),
    ]
    # every worker derives the same queue from the same spec
    assert plan_units("phase2", 20, 8) == units
    assert [u.uid for u in units] == [
        "phase2_00000000_00008",
        "phase2_00000008_00008",
        "phase2_00000016_00004",
    ]
    # singleton stages have one whole-run unit
    assert plan_units("phase1", 20, 8) == [WorkUnit("phase1", 0, 20)]
    assert plan_units("finalize", 20, 8)[0].uid == "finalize"
    with pytest.raises(ValueError, match="unit_rows"):
        plan_units("sig", 20, 0)


# ------------------------------------------------------- claim semantics
def test_claim_is_exclusive(tmp_path):
    u = WorkUnit("phase2", 0, 8)
    qa = LeaseQueue(tmp_path, "a", ttl=60)
    qb = LeaseQueue(tmp_path, "b", ttl=60)
    assert qa.try_claim(u)
    assert not qb.try_claim(u)  # live foreign lease
    assert not qa.is_done(u)
    qa.mark_done(u)
    assert qb.is_done(u)
    assert not qb.try_claim(u)  # done units are never claimable again
    assert qb.pending([u]) == []


def test_expired_lease_is_stolen(tmp_path):
    u = WorkUnit("sig", 0, 4)
    qa = LeaseQueue(tmp_path, "a", ttl=0.5)
    qb = LeaseQueue(tmp_path, "b", ttl=60)
    assert qa.try_claim(u)
    assert not qb.try_claim(u)
    time.sleep(0.6)  # a's lease expires (simulated crash)
    assert qb.try_claim(u)
    # a is no longer the owner: renew refuses, and finishing is harmless
    assert not qa.renew(u)
    assert qb.renew(u)


def test_relaunched_worker_reclaims_own_lease_instantly(tmp_path):
    """SIGKILL + relaunch under the same worker id must not wait out the
    TTL: the id names the queue slot."""
    u = WorkUnit("phase2", 0, 8)
    q1 = LeaseQueue(tmp_path, "w0", ttl=3600)
    assert q1.try_claim(u)
    # the relaunched process is a NEW LeaseQueue with the same id
    q2 = LeaseQueue(tmp_path, "w0", ttl=3600)
    assert q2.try_claim(u)
    # a foreign worker still cannot
    assert not LeaseQueue(tmp_path, "w1", ttl=3600).try_claim(u)


def test_release_returns_unit(tmp_path):
    u = WorkUnit("phase2", 0, 8)
    qa = LeaseQueue(tmp_path, "a", ttl=60)
    qb = LeaseQueue(tmp_path, "b", ttl=60)
    assert qa.try_claim(u)
    qa.release(u)
    assert qb.try_claim(u)
    qb.release(u)  # release of a foreign-owned unit is refused
    assert not qa.renew(u) or True  # a does not own it
    assert LeaseQueue(tmp_path, "c", ttl=60).try_claim(u)


def test_torn_lease_gets_mtime_grace_then_expires(tmp_path):
    """An unreadable lease (foreign non-atomic writer) is NOT stolen
    while fresh — it might be mid-protocol — but is reclaimed once its
    file age exceeds the TTL."""
    u = WorkUnit("phase2", 0, 8)
    lease = tmp_path / f"{u.uid}.lease"
    lease.write_text("{not json")
    assert not LeaseQueue(tmp_path, "a", ttl=60).try_claim(u)
    q = LeaseQueue(tmp_path, "a", ttl=0.2)
    time.sleep(0.3)
    assert q.try_claim(u)


def test_duplicate_claim_exclusion_under_contention(tmp_path):
    """8 workers racing claim_next over 24 units: every unit is claimed
    exactly once, none is lost."""
    units = plan_units("phase2", 24 * 4, 4)
    claims: dict[str, list[WorkUnit]] = {}

    def worker(wid: str):
        q = LeaseQueue(tmp_path, wid, ttl=600)
        mine = []
        while True:
            u = q.claim_next(units)
            if u is None:
                return mine
            mine.append(u)
            q.mark_done(u)

    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        futs = {f"w{i}": ex.submit(worker, f"w{i}") for i in range(8)}
        claims = {w: f.result() for w, f in futs.items()}
    seen = [u for mine in claims.values() for u in mine]
    assert len(seen) == len(units)  # no duplicates ...
    assert set(seen) == set(units)  # ... and no losses
    q = LeaseQueue(tmp_path, "check", ttl=600)
    assert q.pending(units) == []


def test_run_stage_barrier_completes_and_skips_already_done(tmp_path):
    units = plan_units("sig", 12, 4)
    done_log = []
    q = LeaseQueue(tmp_path, "a", ttl=60, poll=0.01)
    n = q.run_stage(
        units, lambda u: done_log.append(u),
        already_done=lambda u: u.row0 == 4,  # durable in the store already
    )
    assert n == 2 and {u.row0 for u in done_log} == {0, 8}
    assert q.pending(units) == []
    # second pass over a completed stage computes nothing
    assert q.run_stage(units, lambda u: done_log.append(u)) == 0


def test_run_stage_waits_for_foreign_holder_then_finishes(tmp_path):
    """The masterless barrier: B sleeps while A holds the last unit, and
    returns once A's done marker lands."""
    units = plan_units("phase2", 8, 4)
    qa = LeaseQueue(tmp_path, "a", ttl=60, poll=0.01)
    qb = LeaseQueue(tmp_path, "b", ttl=60, poll=0.01)
    assert qa.try_claim(units[0])

    def finish_a():
        time.sleep(0.15)
        qa.mark_done(units[0])

    t = threading.Thread(target=finish_a)
    t.start()
    n = qb.run_stage(units, lambda u: None, timeout=10)
    t.join()
    assert n == 1  # b computed only the unit a never held
    assert qb.pending(units) == []


def test_run_stage_timeout_raises(tmp_path):
    units = plan_units("phase2", 4, 4)
    assert LeaseQueue(tmp_path, "dead", ttl=3600).try_claim(units[0])
    q = LeaseQueue(tmp_path, "b", ttl=3600, poll=0.01)
    with pytest.raises(TimeoutError, match="phase2"):
        q.run_stage(units, lambda u: None, timeout=0.1)


def test_run_stage_reclaims_crashed_holder_after_expiry(tmp_path):
    """A holder that dies mid-unit surfaces back as claimable once its
    lease expires — the barrier cannot deadlock on a crash."""
    units = plan_units("phase2", 4, 4)
    assert LeaseQueue(tmp_path, "dead", ttl=0.05).try_claim(units[0])
    q = LeaseQueue(tmp_path, "b", ttl=60, poll=0.01)
    assert q.run_stage(units, lambda u: None, timeout=10) == 1


@pytest.mark.parametrize("survivor", ["w0", "w1"])
def test_barrier_drops_the_lease_of_a_holder_killed_after_its_done_marker(
        tmp_path, survivor):
    """w0 dies between mark_done's marker and its lease unlink: the unit
    is done, its lease is left.  Whoever leaves the stage's barrier, w0
    relaunched under its id or another worker, removes it."""
    units = plan_units("phase2", 12, 4)
    assert LeaseQueue(tmp_path, "w0", ttl=3600).try_claim(units[1])
    (tmp_path / f"{units[1].uid}.done").write_text(
        json.dumps({"worker": "w0", "t": time.time()}))
    q = LeaseQueue(tmp_path, survivor, ttl=3600, poll=0.01)
    assert q.run_stage(units, lambda u: None, timeout=10) == 2
    assert not list(tmp_path.glob("*.lease"))
    assert len(list(tmp_path.glob("*.done"))) == 3


def test_slow_but_alive_worker_keeps_lease_via_renew(tmp_path):
    """The fleet's per-chunk keepalive (FleetWorker._renew_chunk): a
    compute whose total time outlives the TTL, but which renews between
    chunks, is never stolen — while a dead holder (no renews) still is."""
    u = plan_units("phase2", 4, 4)[0]
    qa = LeaseQueue(tmp_path, "a", ttl=0.3)
    qb = LeaseQueue(tmp_path, "b", ttl=0.3)
    assert qa.try_claim(u)
    for _ in range(4):  # 0.6s of "compute" >> ttl, renewed per chunk
        time.sleep(0.15)
        assert qa.renew(u)
        assert not qb.try_claim(u)
    qa.mark_done(u)
    # contrast: a holder that stops renewing (crashed) is stolen
    u2 = plan_units("sig", 4, 4)[0]
    assert qa.try_claim(u2)
    time.sleep(0.4)
    assert qb.try_claim(u2)


def _enospc(path):
    raise OSError(errno.ENOSPC, f"out of space at {path}/tile")


def _edquot_chained(path):
    try:
        raise OSError(errno.EDQUOT, "quota")
    except OSError as e:
        raise RuntimeError("tile write failed") from e


@pytest.mark.parametrize("fail", [_enospc, _edquot_chained])
def test_disk_full_poisons_immediately_not_retried(tmp_path, fail):
    """ENOSPC-class failures are environment verdicts, not flaky units:
    one attempt, immediate poison, no retry-budget burn (every retry
    would hit the same full disk) — also when the store wraps the errno
    in another error."""
    units = plan_units("phase2", 4, 4)
    q = LeaseQueue(tmp_path, "a", ttl=60, poll=0.01, fail_limit=3)

    with pytest.raises(UnitFailedError) as ei:
        q.run_stage(units, lambda u: fail(tmp_path), timeout=10)
    assert ei.value.attempts == 1  # poisoned on the FIRST attempt
    info = json.loads((tmp_path / f"{units[0].uid}.poison").read_text())
    assert info["fatal"]
    if fail is _enospc:
        assert "out of space" in info["error"]


# --------------------------------------------------------- bounded retries
def test_flaky_unit_retried_then_succeeds(tmp_path):
    """A transiently-failing compute is a counted attempt, not instant
    death: the unit is released, retried, and completes."""
    units = plan_units("sig", 4, 4)
    q = LeaseQueue(tmp_path, "a", ttl=60, poll=0.01, fail_limit=3)
    calls = []

    def compute(u):
        calls.append(u.uid)
        if len(calls) < 2:
            raise RuntimeError("transient")

    assert q.run_stage(units, compute, timeout=10) == 1
    assert len(calls) == 2
    assert q.pending(units) == []
    # the attempt was durably counted, but the unit was never poisoned
    assert (tmp_path / f"{units[0].uid}.fail").exists()
    assert not (tmp_path / f"{units[0].uid}.poison").exists()


def test_unit_poisoned_at_fail_limit(tmp_path):
    units = plan_units("phase2", 4, 4)
    q = LeaseQueue(tmp_path, "a", ttl=60, poll=0.01, fail_limit=2)

    def compute(u):
        raise ValueError("deterministically broken")

    with pytest.raises(UnitFailedError) as ei:
        q.run_stage(units, compute, timeout=10)
    assert ei.value.uid == units[0].uid
    assert ei.value.attempts == 2
    assert "broken" in ei.value.error
    assert (tmp_path / f"{units[0].uid}.poison").exists()
    info = json.loads((tmp_path / f"{units[0].uid}.fail").read_text())
    assert info["attempts"] == 2 and len(info["errors"]) == 2


def test_poison_drains_every_worker_not_just_the_failer(tmp_path):
    """The fleet-exit property: once a unit is poisoned, EVERY worker's
    barrier raises with the failing uid instead of spinning on TTL
    steals forever."""
    units = plan_units("sig", 8, 4)
    qa = LeaseQueue(tmp_path, "a", ttl=60, poll=0.01, fail_limit=1)
    with pytest.raises(UnitFailedError):
        qa.run_stage(
            units,
            lambda u: (_ for _ in ()).throw(RuntimeError("boom")),
            timeout=10,
        )
    qb = LeaseQueue(tmp_path, "b", ttl=60, poll=0.01)
    with pytest.raises(UnitFailedError, match=units[0].uid):
        qb.run_stage(units, lambda u: None, timeout=10)
    assert qb.poisoned(units)["uid"] == units[0].uid


def test_retry_budget_is_fleet_wide(tmp_path):
    """Attempts accumulate across workers — a unit that crashes every
    claimer exhausts ONE shared budget, not one per worker."""
    u = plan_units("sig", 4, 4)[0]
    qa = LeaseQueue(tmp_path, "a", ttl=60, fail_limit=3)
    qb = LeaseQueue(tmp_path, "b", ttl=60, fail_limit=3)
    assert qa.try_claim(u)
    assert qa.record_failure(u, "e1") == 1
    assert qb.try_claim(u)  # record_failure released a's lease
    assert qb.record_failure(u, "e2") == 2
    assert qa.try_claim(u)
    assert qa.record_failure(u, "e3") == 3
    assert (tmp_path / f"{u.uid}.poison").exists()


def test_interrupt_releases_without_counting_an_attempt(tmp_path):
    """Ctrl-C / SystemExit is a shutdown, not a unit failure: the lease
    is returned and the retry budget untouched."""
    units = plan_units("phase2", 4, 4)
    q = LeaseQueue(tmp_path, "a", ttl=3600, poll=0.01)

    def compute(u):
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        q.run_stage(units, compute, timeout=10)
    assert not (tmp_path / f"{units[0].uid}.fail").exists()
    assert LeaseQueue(tmp_path, "b", ttl=3600).try_claim(units[0])


# ----------------------------------------- multi-writer TileWriter store
def test_tile_writer_sharded_manifests_merge(tmp_path):
    N = 8
    rho = np.arange(N * N, dtype=np.float32).reshape(N, N)
    wa = TileWriter(tmp_path / "w", N, writer_id="wa")
    wb = TileWriter(tmp_path / "w", N, writer_id="wb")
    wa.write_block(0, rho[:4])
    wb.write_block(4, rho[4:])
    # each worker committed only its own shard — no lock, no lost update
    assert set(json.loads(
        (tmp_path / "w" / "blocks.wa.json").read_text())) == {"__crc__", "0"}
    assert set(json.loads(
        (tmp_path / "w" / "blocks.wb.json").read_text())) == {"__crc__", "4"}
    # a's in-memory view predates b's commit; refresh merges it in
    assert not wa.covered().all()
    assert wa.refresh().covered().all()
    # fresh readers (writer_id=None) see the union at load
    r = TileWriter(tmp_path / "w", N)
    assert r.covered().all()
    np.testing.assert_array_equal(r.assemble(), rho)
    assert r.chunk_plan(4) == []


def test_next_uncovered_sees_every_writers_shard(tmp_path):
    """The case of tests/test_optim_data.py::test_row_block_writer_coverage,
    with the blocks split across two writer shards: the first uncovered
    row is that of the merged coverage, from ``start`` on."""
    N = 10
    wa = TileWriter(tmp_path / "w", N, writer_id="wa")
    wb = TileWriter(tmp_path / "w", N, writer_id="wb")
    wa.write_block(0, np.ones((4, N), np.float32))
    wb.write_block(7, np.ones((3, N), np.float32))
    assert wa.next_uncovered() == 4  # its own shard only
    assert wa.refresh().next_uncovered() == 4
    assert wa.next_uncovered(start=7) is None
    wa.write_block(4, np.ones((3, N), np.float32))
    assert wb.refresh().next_uncovered() is None
    assert TileWriter(tmp_path / "w", N).assemble().sum() == N * N


def test_tile_writer_crash_mid_write_leaves_no_torn_state(tmp_path):
    """A worker killed mid-write leaves only ignorable .tmp residue —
    never a torn manifest or tile."""
    N = 6
    w = TileWriter(tmp_path / "w", N, writer_id="wa")
    w.write_tile(0, 0, np.ones((3, N), np.float32))
    # simulated kill artifacts: torn foreign shard + orphan tmp files
    (tmp_path / "w" / "blocks.crashed.json").write_text('{"3,0": [3,')
    (tmp_path / "w" / "tile_00000003_00000000.npy.tmp-999").write_bytes(b"\x93NUM")
    (tmp_path / "w" / "blocks.wb.json.tmp-999").write_text("{}")
    r = TileWriter(tmp_path / "w", N)
    np.testing.assert_array_equal(r.covered(), [True] * 3 + [False] * 3)
    assert r.chunk_plan(3) == [(3, 3)]
    # and the crashed worker's rows are recomputable by anyone
    wb = TileWriter(tmp_path / "w", N, writer_id="wb")
    wb.write_tile(3, 0, np.full((3, N), 2, np.float32))
    assert TileWriter(tmp_path / "w", N).covered().all()


def test_tile_writer_duplicate_tiles_identical_content_benign(tmp_path):
    """Lease-steal races can compute a unit twice; both workers then
    write the same tile key with identical bytes — last replace wins."""
    N = 4
    block = np.arange(2 * N, dtype=np.float32).reshape(2, N)
    wa = TileWriter(tmp_path / "w", N, writer_id="wa")
    wb = TileWriter(tmp_path / "w", N, writer_id="wb")
    wa.write_tile(0, 0, block)
    wb.write_tile(0, 0, block.copy())
    wa.write_tile(2, 0, block)
    r = TileWriter(tmp_path / "w", N)
    assert r.covered().all()
    np.testing.assert_array_equal(r.assemble(), np.vstack([block, block]))


def test_legacy_single_writer_layout_unchanged(tmp_path):
    """writer_id=None keeps the single-writer on-disk layout: one blocks.json,
    same keys — old stores resume under the new code.  Entries now carry
    a content crc and the shard a __crc__ self-checksum (DESIGN.md SS12)."""
    N = 4
    w = TileWriter(tmp_path / "w", N)
    w.write_block(0, np.zeros((4, N), np.float32))
    files = {p.name for p in (tmp_path / "w").iterdir()}
    assert "blocks.json" in files
    assert not any(
        f.startswith("blocks.") and f != "blocks.json"
        for f in files if not f.endswith(".crc32")
    )
    man = json.loads((tmp_path / "w" / "blocks.json").read_text())
    assert set(man) == {"__crc__", "0"}
    nrows, crc = man["0"]
    assert nrows == 4 and len(crc) == 8


def test_legacy_manifest_without_checksums_still_resumes(tmp_path):
    """A pre-integrity store (bare-int block entries, [nr, nc] tiles, no
    __crc__) must keep loading: coverage, chunk_plan, and assemble all
    work, with verification simply skipped for legacy entries."""
    N = 4
    d = tmp_path / "w"
    d.mkdir()
    w = TileWriter(d, N)
    w.write_block(0, np.arange(2 * N, dtype=np.float32).reshape(2, N))
    w.write_tile(2, 0, np.zeros((2, 2), np.float32), commit=False)
    w.write_tile(2, 2, np.zeros((2, 2), np.float32))
    # rewrite the manifest as a pre-integrity store has it: no crcs, no __crc__
    (d / "blocks.json").write_text(
        json.dumps({"0": 2, "2,0": [2, 2], "2,2": [2, 2]})
    )
    r = TileWriter(d, N)
    assert r.covered().all()
    out = r.assemble()
    assert out.shape == (N, N)
    np.testing.assert_array_equal(out[:2], np.arange(2 * N).reshape(2, N))


# ------------------------------- fleet-style significance, crash + recount
@pytest.mark.parametrize("crash_mid_tile", [False, True])
def test_sharded_sig_writers_finalize_matches_driver(tmp_path, crash_mid_tile):
    """Two fleet-style workers split the significance chunks through
    writer_id-sharded writers; finalize (assemble + RECOUNT of the
    p histogram + BH + edges) must be byte-identical to the one-process
    run_significance driver.  With crash_mid_tile a worker dies after
    writing a partial, uncommitted tile of its unit; the reclaiming
    worker recomputes the whole unit."""
    from repro_torch.core.pipeline import run_causal_inference
    from repro_torch.core.types import EDMConfig
    from repro_torch.data.synthetic import dummy_brain
    from repro_torch.inference import SignificanceConfig, run_significance
    from repro_torch.inference.pipeline import (
        SignificanceChunkRunner,
        _writer,
        finalize_significance,
        make_store_drain,
    )

    ts = dummy_brain(12, 220, seed=11)
    cfg = EDMConfig(E_max=4, lib_block=4, target_tile=5)
    sig = SignificanceConfig(lib_sizes=(30, 60, 120), n_surrogates=6, seed=1)
    base = run_causal_inference(ts, cfg, device="cpu")
    optE, rho = np.asarray(base.optE), np.asarray(base.rho)

    ref_dir = tmp_path / "ref"
    ref = run_significance(ts, optE, rho, cfg, sig, device="cpu",
                           out_dir=str(ref_dir))

    out = tmp_path / "fleet"
    out.mkdir()
    N = ts.shape[0]
    units = plan_units("sig", N, 4)

    def worker(wid):
        runner = SignificanceChunkRunner(ts, optE, cfg, sig, device="cpu")
        ws = {
            "conv": _writer(out, "rho_conv", N, runner.order, writer_id=wid),
            "trend": _writer(out, "rho_trend", N, runner.order, writer_id=wid),
            "pv": _writer(out, "pvals", N, runner.order, writer_id=wid),
        }

        drain = make_store_drain(N, ws["conv"], ws["trend"], ws["pv"])
        return runner, ws, drain

    runner_a, ws_a, drain_a = worker("wa")
    runner_b, ws_b, drain_b = worker("wb")
    qa = LeaseQueue(out / "queue", "wa", ttl=0.05)
    qb = LeaseQueue(out / "queue", "wb", ttl=60, poll=0.01)

    # worker A claims the first unit ...
    assert qa.try_claim(units[0])
    if crash_mid_tile:
        # ... and dies mid-unit: one partial pvals tile on disk, nothing
        # committed, lease left to expire
        ws_a["pv"].write_tile(0, 0, np.zeros((4, 5), np.float32), commit=False)
        time.sleep(0.1)
    else:
        runner_a.run([(0, 4)], rho, drain_a)
        for w in ws_a.values():
            w.commit()
        qa.mark_done(units[0])

    # worker B drains the rest of the stage (reclaiming A's unit when it
    # crashed), then wins the finalize unit
    def compute(unit):
        runner_b.run([(unit.row0, unit.nrows)], rho, drain_b)
        for w in ws_b.values():
            w.commit()

    def already_done(unit):
        cov = ws_b["conv"].refresh().covered()
        cov &= ws_b["trend"].refresh().covered()
        cov &= ws_b["pv"].refresh().covered()
        return bool(cov[unit.row0 : unit.row0 + unit.nrows].all())

    qb.run_stage(units, compute, already_done=already_done, timeout=60)
    got = finalize_significance(str(out), rho, cfg, sig)

    for art in ("rho_conv", "rho_trend", "pvals", "edges"):
        a = np.load(out / art / "data.npy")
        b = np.load(ref_dir / art / "data.npy")
        assert a.tobytes() == b.tobytes(), art
    assert got.p_threshold == ref.p_threshold
    assert got.n_tests == ref.n_tests


def test_finalize_refuses_incomplete_store(tmp_path):
    from repro_torch.core.types import EDMConfig
    from repro_torch.inference import SignificanceConfig, finalize_significance

    N = 6
    w = TileWriter(tmp_path / "pvals", N, writer_id="wa")
    w.write_tile(0, 0, np.ones((3, N), np.float32))
    with pytest.raises(ValueError, match="incomplete"):
        finalize_significance(
            str(tmp_path), np.ones((N, N), np.float32), EDMConfig(E_max=4),
            SignificanceConfig(lib_sizes=(), n_surrogates=4),
        )


# ---------------------------------------------------- hold-time counters
def test_mark_done_emits_done_and_held_counters(tmp_path):
    """mark_done records the unit's terminal hold time twice — on the
    done counter (joined to the unit by uid) and as a ``held`` sample
    (the TTL-autotune / straggler-watch histogram) — and flushes both
    BEFORE the durable marker lands (the loss-window bound)."""
    from repro_torch.runtime import telemetry

    mem = telemetry.MemorySink()
    telemetry.configure(mem, worker="wa")
    try:
        u = WorkUnit("phase2", 0, 8)
        q = LeaseQueue(tmp_path, "wa", ttl=60)
        assert q.try_claim(u)
        time.sleep(0.02)
        q.mark_done(u)
        held = [r for r in mem.records if r["name"] == "held"]
        assert len(held) == 1
        assert held[0]["stage"] == "phase2"
        assert held[0]["attrs"] == {"uid": u.uid, "outcome": "done"}
        assert held[0]["value"] >= 0.015
        done = [r for r in mem.records if r["name"] == "done"]
        assert done[0]["attrs"]["held_s"] == held[0]["value"]
    finally:
        telemetry.shutdown()


def test_run_stage_records_the_queues_time_as_spans(tmp_path):
    """run_stage times its claims, done markers and barrier waits, and
    renew its lease rewrite, as spans of the units' stage: the queue's
    share of a stage is measured, not a residual."""
    from repro_torch.runtime import telemetry

    mem = telemetry.MemorySink()
    telemetry.configure(mem, worker="wa")
    try:
        units = plan_units("phase2", 12, 4)
        qa = LeaseQueue(tmp_path, "wa", ttl=60, poll=0.01)
        qb = LeaseQueue(tmp_path, "wb", ttl=60, poll=0.01)
        assert qb.try_claim(units[2])  # held elsewhere: qa's barrier waits

        def spans_named(name):
            return [r for r in list(mem.records)
                    if r["kind"] == "span" and r["name"] == name]

        def finish_b():
            # Handshake, not a blind head start: qa's barrier starts only
            # after its second unit is done, and under load its two
            # fsynced claims and done markers can eat any fixed head
            # start.  From there units[2] is held a fixed 0.3 s, of which
            # the barrier's recorded waits must make up 0.05 s: each of its
            # polls sleeps in a queue_wait span and scans in a queue_claim
            # span.  The deadline only keeps a broken span from hanging
            # the test.
            deadline = time.monotonic() + 30.0
            while (len(spans_named("queue_done")) < 2
                   and time.monotonic() < deadline):
                time.sleep(0.005)
            time.sleep(0.3)
            qb.mark_done(units[2])

        t = threading.Thread(target=finish_b)
        t.start()
        assert qa.run_stage(units, lambda u: qa.renew(u)) == 2
        t.join()
    finally:
        telemetry.shutdown()
    spans = [r for r in mem.records if r["kind"] == "span"]
    names = {r["name"] for r in spans}
    assert {"queue_claim", "queue_done", "queue_wait", "queue_renew"} <= names
    assert all(r["stage"] == "phase2" and telemetry.validate(r) == []
               for r in spans)
    count = {n: sum(r["name"] == n for r in spans) for n in names}
    assert count["queue_done"] == 2 and count["queue_renew"] == 2
    wait = sum(r["dur_s"] for r in spans if r["name"] == "queue_wait")
    assert wait >= 0.05


def test_release_and_steal_emit_held_outcomes(tmp_path):
    """A graceful release samples the hold with outcome=release; a TTL
    steal makes the STEALER record the victim's terminal hold
    (outcome=stolen) — the victim is dead and cannot."""
    from repro_torch.runtime import telemetry

    mem = telemetry.MemorySink()
    telemetry.configure(mem, worker="a")
    try:
        u = WorkUnit("phase2", 0, 8)
        qa = LeaseQueue(tmp_path, "a", ttl=0.05)
        qb = LeaseQueue(tmp_path, "b", ttl=0.05)
        assert qa.try_claim(u)
        qa.release(u)
        rel = [r for r in mem.records if r["name"] == "held"]
        assert len(rel) == 1 and rel[0]["attrs"]["outcome"] == "release"

        assert qa.try_claim(u)
        time.sleep(0.12)  # let the lease expire; "a" is now the victim
        assert qb.try_claim(u)
        stolen = [r for r in mem.records
                  if r["name"] == "held"
                  and r["attrs"].get("outcome") == "stolen"]
        assert len(stolen) == 1
        assert stolen[0]["attrs"]["uid"] == u.uid
        assert stolen[0]["attrs"]["prev_worker"] == "a"
        assert stolen[0]["value"] >= 0.05  # at least the TTL elapsed
    finally:
        telemetry.shutdown()


def test_jsonl_sink_appends_and_skips_a_torn_line(tmp_path):
    """The port's JSONL sink appends at each flush; a writer killed
    mid-append leaves a torn last line, which readers skip, and the next
    process's records start on a line of their own."""
    from repro_torch.runtime import telemetry

    path = tmp_path / "telemetry" / "w0.jsonl"
    sink = telemetry.JsonlSink(path, flush_every=2)
    telemetry.configure(sink, worker="w0")
    try:
        for i in range(3):
            telemetry.counter("phase2", "claim", row0=i)
        telemetry.flush()
        assert [r["attrs"]["row0"] for r in telemetry.read_jsonl(path)] == [0, 1, 2]
        with open(path, "a") as f:
            f.write('{"v": 1, "kind": "coun')  # a kill mid-append
        telemetry.configure(telemetry.JsonlSink(path), worker="w0")
        telemetry.counter("phase2", "done", row0=3)
        telemetry.flush()
    finally:
        telemetry.shutdown()
    recs = telemetry.read_jsonl(path)
    assert [r["name"] for r in recs] == ["claim"] * 3 + ["done"]
    assert all(telemetry.validate(r) == [] for r in recs)
