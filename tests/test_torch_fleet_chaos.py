"""The chaos battery of tests/test_chaos.py on the port's fleet, on the
CPU: seeded schedules of worker kills, injected crash / error / delay
faults (``repro_torch.runtime.faultpoints``, the same grammar and point
names) and post-hoc store corruption.  Every schedule must converge to
the port's single-process bytes of causal_map / rho_conv / rho_trend /
pvals / edges with a clean ``fsck``, and every corruption must be
detected, healed, and recomputed to the same bytes by one more fleet
pass.  Three seeds; the schedules are pure functions of their seed.
"""
import json
import os
import random
import signal
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.core.types import EDMConfig  # noqa: E402
from repro_torch.data import store  # noqa: E402
from repro_torch.inference.types import SignificanceConfig  # noqa: E402
from repro_torch.launch import edm_fleet  # noqa: E402
from repro_torch.runtime import integrity  # noqa: E402

ARTIFACTS = ("causal_map", "rho_conv", "rho_trend", "pvals", "edges")
CFG = EDMConfig(E_max=4, lib_block=4, target_tile=6)
SIG = SignificanceConfig(lib_sizes=(40, 80), n_surrogates=6, seed=0)
N_SCHEDULES = 3
SCHEDULE_TIMEOUT = 600.0
MAX_RESTARTS = 6

#: one armed process generation each — crash arms die once and the
#: relaunched (unarmed) worker finishes; error/delay arms are absorbed
#: in-process by the bounded-retry / TTL machinery.
FAULT_ARMS = (
    "tile_pre_rename:crash@{k}",
    "tile_pre_fsync:crash@{k}",
    "manifest_pre_rename:crash@{k}",
    "done_pre_mark:crash@1",
    "done_pre_rename:crash@1",
    "unit_post_compute:crash@1",
    "lease_pre_steal:crash@1",
    "unit_pre_compute:error@1",
    "chunk_pre:error@{k}",
    "chunk_pre:delay=0.2",
)
CORRUPTIONS = ("none", "bitflip", "truncate", "delete")


def make_schedule(seed: int) -> dict:
    rng = random.Random(seed)
    n_workers = rng.randint(1, 3)
    workers = []
    for i in range(n_workers):
        arm = None
        if rng.random() < 0.7:
            arm = rng.choice(FAULT_ARMS).format(k=rng.randint(1, 4))
        workers.append({"id": f"c{i}", "fault": arm})
    return {
        "seed": seed,
        "workers": workers,
        # one external SIGKILL of a random live worker, paper-style
        "kill_after_s": rng.uniform(2.0, 8.0) if rng.random() < 0.5 else None,
        "kill_idx": rng.randrange(n_workers),
        "corruption": rng.choice(CORRUPTIONS),
    }


@pytest.fixture(scope="module")
def baseline(tmp_path_factory):
    """The single-process ground truth every schedule must reproduce."""
    from repro_torch.core.pipeline import run_causal_inference
    from repro_torch.inference import run_significance

    root = tmp_path_factory.mktemp("baseline")
    ts = np.random.default_rng(42).standard_normal((16, 250)).astype(np.float32)
    store.save_dataset(root / "dataset", ts, {"synthetic": "16x250"})
    out = root / "out"
    res = run_causal_inference(ts, CFG, device="cpu", out_dir=str(out))
    run_significance(ts, res.optE, np.asarray(res.rho), CFG, SIG,
                     device="cpu", out_dir=str(out))
    return {
        "dataset": root / "dataset",
        "bytes": {n: (out / n / "data.npy").read_bytes() for n in ARTIFACTS},
    }


def _spawn(out, wid, fault=None):
    env = dict(os.environ, OMP_NUM_THREADS="1")  # one thread a worker
    env.pop("EDM_FAULTS", None)
    env.pop("EDM_TELEMETRY", None)  # default-on JSONL: the loss-window
    # bound below is asserted against the recorded telemetry
    if fault is not None:
        env["EDM_FAULTS"] = fault
    return edm_fleet.spawn_worker(out, wid, env=env)


def _drive_fleet(out, schedule):
    """Run one schedule's fleet to convergence: spawn armed workers,
    apply the external kill, relaunch every dead worker (unarmed — the
    armed generation crashed exactly once) until the store completes."""
    procs, restarts = {}, {}
    for w in schedule["workers"]:
        procs[w["id"]] = _spawn(out, w["id"], fault=w["fault"])
        restarts[w["id"]] = 0
    kill_at = (None if schedule["kill_after_s"] is None
               else time.time() + schedule["kill_after_s"])
    kill_wid = schedule["workers"][schedule["kill_idx"]]["id"]
    deadline = time.time() + SCHEDULE_TIMEOUT
    try:
        while True:
            if time.time() > deadline:
                raise TimeoutError(
                    f"schedule {schedule['seed']} did not converge: "
                    f"{json.dumps(edm_fleet.fleet_status(out)['stages'])}"
                )
            if kill_at is not None and time.time() >= kill_at:
                kill_at = None
                if procs[kill_wid].poll() is None:
                    procs[kill_wid].send_signal(signal.SIGKILL)
            poison = list((out / "queue").glob("*.poison"))
            if poison:
                raise AssertionError(
                    f"unit poisoned under schedule {schedule['seed']}: "
                    + poison[0].read_text()
                )
            # Relaunch crashed workers FIRST, then re-poll for the
            # all-dead checks below: a stale snapshot here once spawned a
            # second same-id worker next to the relaunched one, and two
            # live processes sharing a worker id (which the fleet's
            # one-process-per-id contract forbids) last-writer-win
            # clobbered each other's manifest shard.
            for wid, p in procs.items():
                rc = p.poll()
                if rc is None or rc == 0:
                    continue
                if restarts[wid] >= MAX_RESTARTS:
                    raise AssertionError(
                        f"worker {wid} burned {MAX_RESTARTS} restarts "
                        f"(schedule {schedule['seed']}, last rc {rc})"
                    )
                restarts[wid] += 1
                procs[wid] = _spawn(out, wid)  # unarmed relaunch
            if all(p.poll() is not None for p in procs.values()):
                if edm_fleet.fleet_status(out)["complete"]:
                    return
                # every proc exited 0 yet the store is incomplete (a
                # worker raced a stage it could not finish): respawn one
                wid = schedule["workers"][0]["id"]
                if restarts[wid] >= MAX_RESTARTS:
                    raise AssertionError(
                        f"store incomplete after {MAX_RESTARTS} respawns "
                        f"of {wid} (schedule {schedule['seed']})"
                    )
                restarts[wid] += 1
                procs[wid] = _spawn(out, wid)
            time.sleep(0.5)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
        for p in procs.values():
            p.wait(timeout=30)


def _corrupt(out, kind, rng):
    """Post-hoc damage in a random tiled artifact dir; returns the path."""
    d = rng.choice([out, out / "pvals", out / "rho_conv"])
    tiles = sorted(d.glob("tile_*.npy"))
    f = tiles[rng.randrange(len(tiles))]
    if kind == "bitflip":
        raw = bytearray(f.read_bytes())
        raw[rng.randrange(len(raw))] ^= 1 << rng.randrange(8)
        f.write_bytes(bytes(raw))
    elif kind == "truncate":
        f.write_bytes(f.read_bytes()[: rng.randrange(8, 64)])
    else:  # delete
        f.unlink()
    return f


def _assert_matches(out, baseline):
    for name in ARTIFACTS:
        got = (out / name / "data.npy").read_bytes()
        assert got == baseline["bytes"][name], (
            f"{name} differs from the W=1 baseline"
        )


def _assert_done_markers_covered(out):
    """Every durable ``queue/*.done`` marker names its writer; that
    worker's telemetry JSONL must contain the matching done counter
    (mark_done's flush-before-marker ordering makes this an invariant,
    not a best effort)."""
    from repro_torch.runtime import telemetry

    for marker in sorted((out / "queue").glob("*.done")):
        uid = marker.name[: -len(".done")]
        writer = json.loads(marker.read_text())["worker"]
        recs = telemetry.read_jsonl(telemetry.worker_jsonl(out, writer))
        assert any(
            r.get("kind") == "counter" and r.get("name") == "done"
            and r.get("attrs", {}).get("uid") == uid
            for r in recs
        ), f"done marker {uid} has no durable done record from {writer}"


@pytest.mark.parametrize("seed", range(N_SCHEDULES))
def test_chaos_schedule_converges_byte_identical(baseline, tmp_path, seed):
    schedule = make_schedule(seed)
    out = tmp_path / "fleet"
    edm_fleet.init_fleet(out, baseline["dataset"], CFG, SIG, device="cpu")
    _drive_fleet(out, schedule)

    # 1. converged bytes == the single-process ground truth
    _assert_matches(out, baseline)
    # 2. the surviving store verifies clean, crash residue and all
    rep = integrity.fsck_store(out)
    assert rep["clean"], json.dumps(rep, indent=1)
    # 2b. telemetry loss-window bound: mark_done flushes the unit's done
    # record BEFORE the durable marker lands, so — even across injected
    # SIGKILLs — every surviving done marker implies its writer's
    # telemetry for that unit survived too (DESIGN.md SS13)
    _assert_done_markers_covered(out)

    # 3. post-hoc corruption: detect -> heal -> one pass -> identical
    if schedule["corruption"] != "none":
        rng = random.Random(schedule["seed"] ^ 0xC0FFEE)
        f = _corrupt(out, schedule["corruption"], rng)
        rep = integrity.fsck_store(out, heal=True)
        assert not rep["clean"], f"fsck missed {schedule['corruption']} of {f}"
        assert "refused" not in rep["healed"]
        assert integrity.fsck_store(out)["clean"]
        edm_fleet.FleetWorker(out, "wheal", progress=False).run()
        _assert_matches(out, baseline)
        assert integrity.fsck_store(out)["clean"]


def test_faultpoint_spec_parsing():
    from repro_torch.runtime import faultpoints

    arms = faultpoints.parse_spec("tile_pre_rename:crash@3, chunk_pre:delay=0.5")
    assert arms["tile_pre_rename"] == ("crash", 0.0, 3)
    assert arms["chunk_pre"] == ("delay", 0.5, 0)
    with pytest.raises(faultpoints.FaultSpecError):
        faultpoints.parse_spec("p:explode")
    with pytest.raises(faultpoints.FaultSpecError):
        faultpoints.parse_spec("p:crash@0")
    with pytest.raises(faultpoints.FaultSpecError):
        faultpoints.parse_spec("p:delay")


def test_faultpoint_error_and_nth_hit_semantics():
    from repro_torch.runtime import faultpoints

    faultpoints.configure("p:error@3")
    try:
        faultpoints.fire("p")
        faultpoints.fire("p")
        faultpoints.fire("other")  # unarmed points never fire
        with pytest.raises(faultpoints.InjectedFault, match="hit 3"):
            faultpoints.fire("p")
        faultpoints.fire("p")  # @n is one-shot: hit 4 passes
    finally:
        faultpoints.configure(None)
