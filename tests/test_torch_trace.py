"""The port's fleet trace (``repro_torch.runtime.trace``) against the JAX
package's (``repro.runtime.trace``) on the CPU.

The JAX tests' hand-written stores (tests/test_trace.py: the 2-worker
fixture, clock skew, the NTP step, duplicate done records, the empty
store, the golden Chrome trace, reconciliation, hold percentiles, the
straggler watch) run through both packages with the same pinned
numbers; stores drawn from a numpy seed and a store that the port's
``edm_run --workers 2 --device cpu`` wrote go through both packages'
``assemble_trace``, ``chrome_trace``, ``render_trace``, ``reconcile`` and
``held_percentiles``, which must agree exactly."""
import io
import json
import threading
import time

import pytest

pytest.importorskip("torch")

from torch_telemetry_fixtures import (  # noqa: E402
    PKGS,
    U0,
    U1,
    ctr,
    duplicate_done_store,
    modules,
    ntp_step_store,
    port_fleet_store,
    random_store,
    two_worker_store,
    write_worker,
)

J, P = modules("repro"), modules("repro_torch")


@pytest.fixture(autouse=True)
def _clean_telemetry():
    for m in (J, P):
        m.telemetry.shutdown()
        m.telemetry.set_identity("main")
    yield
    for m in (J, P):
        m.telemetry.shutdown()
        m.telemetry.set_identity("main")


@pytest.fixture(params=PKGS)
def pkg(request):
    return modules(request.param)


@pytest.fixture(scope="module")
def fleet_store(tmp_path_factory):
    return port_fleet_store(tmp_path_factory.mktemp("fleet") / "out")


def _status_stages(m, out):
    """``edm_fleet status``'s per-stage span aggregation over ``out``."""
    per_stage = {}
    for _, rec in m.telemetry.iter_store_records(out):
        if m.telemetry.validate(rec) or rec["kind"] != "span":
            continue
        st = per_stage.setdefault(rec["stage"], {"span_s": 0.0})
        st["span_s"] += rec["dur_s"]
    return per_stage


# ------------------------------------- the JAX tests' bodies, both packages
def test_unit_lifecycles_and_buckets(pkg, tmp_path):
    tr = pkg.trace.assemble_trace(two_worker_store(tmp_path))
    assert tr["workers"] == ["w0", "w1"]
    assert set(tr["units"]) == {U0, U1, "assemble"}
    u1, u0 = tr["units"][U1], tr["units"][U0]
    assert u1["worker"] == "w1" and u1["steals"] == 0
    assert u1["held_s"] == 15.0 and u1["chunks"] == 1
    assert u1["compute_s"] == pytest.approx(14.0)
    assert u1["gather_s"] == pytest.approx(2.0)
    assert u0["store_s"] == pytest.approx(0.5)
    p2 = tr["stages"]["phase2"]
    assert p2["units"] == 2 and p2["done_units"] == 2 and p2["chunks"] == 2
    assert p2["start"] == pytest.approx(1012.0 - 12.5)
    assert p2["end"] == pytest.approx(1016.0)
    b = p2["buckets"]
    assert set(b) == set(pkg.trace.BUCKETS)
    assert b["compute"] == pytest.approx(24.0)
    assert b["gather"] == pytest.approx(3.0)
    assert b["store"] == pytest.approx(0.5)
    assert b["straggler_tail"] >= 1015.0 - 1010.5 - 0.1
    assert p2["chunk_p50_s"] == 10.0 and p2["chunk_p95_s"] == 10.0
    assert tr["span_totals"]["phase2"] == pytest.approx(10 + 14 + 12.5 + 16.2)
    assert tr["span_totals"]["store"] == pytest.approx(0.5)
    path = {e["stage"]: e for e in tr["critical_path"]}
    assert list(path) == ["phase2", "assemble"]
    assert path["phase2"]["uid"] == U1 and path["phase2"]["worker"] == "w1"
    assert path["phase2"]["queue_wait_s"] == pytest.approx(1.0)
    assert path["phase2"]["straggler_tail_s"] == pytest.approx(0.5)
    text = pkg.trace.render_trace(tr)
    assert U1 in text and "critical path" in text


def test_duplicate_done_records_dedupe(pkg, tmp_path):
    tr = pkg.trace.assemble_trace(duplicate_done_store(tmp_path))
    assert all(abs(s) < 1e-6 for s in tr["clock_shift_s"].values())
    u = tr["units"][U1]
    assert u["done_t"] == pytest.approx(1015.5)
    assert u["worker"] == "w1" and u["held_s"] == 15.0
    assert u["steals"] == 1 and len(u["claims"]) == 2


def test_clock_skew_alignment(pkg, tmp_path):
    tr = pkg.trace.assemble_trace(two_worker_store(
        tmp_path, w1_skew=-50.0, w1_mono_offset=850.0))
    shift = tr["clock_shift_s"]
    assert shift["w0"] == pytest.approx(0.0, abs=1e-6)
    assert 44.0 <= shift["w1"] <= 50.0
    last_done = max(u["done_t"] for u in tr["units"].values()
                    if u["stage"] == "phase2")
    assert tr["units"]["assemble"]["claimed_t"] >= last_done - 1e-3
    tr0 = pkg.trace.assemble_trace(two_worker_store(tmp_path / "clean"))
    assert all(abs(s) < 1e-6 for s in tr0["clock_shift_s"].values())


def test_ntp_step_immunity_via_mono(pkg, tmp_path):
    tr = pkg.trace.assemble_trace(ntp_step_store(tmp_path))
    assert tr["units"][U0]["done_t"] == pytest.approx(1005.0)
    assert tr["total_wall_s"] < 10.0


def test_empty_store_yields_wellformed_trace(pkg, tmp_path):
    tr = pkg.trace.assemble_trace(tmp_path)
    assert tr["units"] == {} and tr["stages"] == {}
    assert tr["critical_path"] == [] and tr["total_wall_s"] == 0.0
    assert "no telemetry records" in pkg.trace.render_trace(tr)
    assert pkg.trace.chrome_trace(tmp_path)["traceEvents"] == []


def test_chrome_trace_golden(pkg, tmp_path):
    out = two_worker_store(tmp_path)
    ct = pkg.trace.chrome_trace(out)
    evs = ct["traceEvents"]
    assert ct["displayTimeUnit"] == "ms"
    meta = [e for e in evs if e["ph"] == "M"]
    assert {e["args"]["name"] for e in meta
            if e["name"] == "process_name"} == {"w0", "w1"}
    xs = [e for e in evs if e["ph"] == "X"]
    inst = [e for e in evs if e["ph"] == "i"]
    assert len(xs) == 5 and len(inst) == 8
    ts = [e["ts"] for e in evs[len(meta):]]
    assert ts == sorted(ts) and all(isinstance(t, int) for t in ts)
    chunk = next(e for e in xs if e["name"] == "phase2.chunk"
                 and e["args"]["row0"] == 0)
    assert chunk["ts"] == 500000 and chunk["dur"] == 10_000_000
    assert chunk["pid"] == 0
    done = next(e for e in inst if e["name"] == "phase2.done"
                and e["args"]["uid"] == U0)
    assert done["ts"] == 11_500_000
    p = pkg.trace.write_chrome_trace(out, tmp_path / "trace.json")
    assert json.loads(p.read_text()) == ct


def test_reconcile_matches_fleet_status_aggregation(pkg, tmp_path):
    out = two_worker_store(tmp_path)
    tr = pkg.trace.assemble_trace(out)
    per_stage = _status_stages(pkg, out)
    rep = pkg.trace.reconcile(tr, {"telemetry": {"stages": per_stage}})
    assert rep["ok"], rep
    per_stage["phase2"]["span_s"] *= 1.5
    rep = pkg.trace.reconcile(tr, {"telemetry": {"stages": per_stage}})
    assert not rep["ok"] and rep["stages"]["phase2"]["delta_pct"] > 1.0


def test_held_percentiles_reader(pkg, tmp_path):
    write_worker(tmp_path / "s", "w0", [
        ctr("phase2", "held", 1000.0 + i, value=float(i + 1), uid=f"u{i}")
        for i in range(100)])
    pc = pkg.trace.held_percentiles(tmp_path / "s")
    assert pc == {"n": 100, "p50": 50.0, "p95": 95.0, "p99": 99.0}
    assert pkg.trace.held_percentiles(tmp_path / "none") == {
        "n": 0, "p50": None, "p95": None, "p99": None}


@pytest.mark.parametrize("fleet_pkg", PKGS)
def test_watch_status_flags_stragglers_and_rates(fleet_pkg, tmp_path):
    """Each package's ``status --watch`` (bounded to two refreshes) over a
    hand-made store: a lease far older than the fleet's p95 hold is a
    STRAGGLER; a done marker landing between refreshes gives a rate and
    an ETA.  The port's store names its device."""
    import importlib

    edm_fleet = importlib.import_module(f"{fleet_pkg}.launch.edm_fleet")
    out = tmp_path / "fleet"
    out.mkdir()
    (out / "fleet.json").write_text(json.dumps(
        {"N": 16, "L": 100, "unit_rows": 8, "seed": 0, "sig": None, "cfg": {},
         "device": "cpu"}))
    qdir = out / "queue"
    qdir.mkdir()
    (qdir / "phase1.done").write_text(json.dumps({"worker": "w0"}))
    (qdir / f"{U0}.lease").write_text(json.dumps(
        {"worker": "w9", "t": time.time() - 30.0, "ttl": 600.0}))
    write_worker(out, "w0", [
        ctr("phase2", "held", 1000.0 + i, value=2.0, uid=f"u{i}",
            outcome="done") for i in range(20)])

    def land_done():
        time.sleep(0.3)
        (qdir / f"{U1}.done").write_text(json.dumps({"worker": "w0"}))

    t = threading.Thread(target=land_done)
    t.start()
    buf = io.StringIO()
    st = edm_fleet.watch_status(out, interval=0.6, iterations=2, file=buf)
    t.join()
    text = buf.getvalue()
    assert f"STRAGGLER {U0}@w9" in text and "fleet p95 2.0s" in text
    assert "watch: phase2" in text and "units/s" in text and "ETA" in text
    assert not st["complete"]


# ---------------------------------------------- the two packages, exactly
def _same_outputs(out):
    """Every reader of the trace module, both packages, one store."""
    tj, tp = J.trace.assemble_trace(out), P.trace.assemble_trace(out)
    assert tj == tp
    assert J.trace.render_trace(tj) == P.trace.render_trace(tp)
    assert J.trace.chrome_trace(out) == P.trace.chrome_trace(out)
    assert J.trace.held_percentiles(out) == P.trace.held_percentiles(out)
    status = {"telemetry": {"stages": _status_stages(P, out)}}
    assert J.trace.reconcile(tj, status) == P.trace.reconcile(tp, status)
    return tp


@pytest.mark.parametrize("store", ["two_worker", "skewed", "duplicate_done",
                                   "ntp_step", "empty"])
def test_fixture_stores_give_the_jax_trace(store, tmp_path):
    make = {"two_worker": two_worker_store,
            "skewed": lambda d: two_worker_store(d, w1_skew=-50.0,
                                                 w1_mono_offset=850.0),
            "duplicate_done": duplicate_done_store,
            "ntp_step": ntp_step_store, "empty": lambda d: d}[store]
    _same_outputs(make(tmp_path))


@pytest.mark.parametrize("seed", range(6))
def test_seeded_stores_give_the_jax_trace(seed, tmp_path):
    """Three skewed workers, every stage, steals and redone units."""
    tr = _same_outputs(random_store(tmp_path, seed))
    assert list(tr["stages"]) == ["phase1", "phase2", "assemble", "sig",
                                  "finalize"]
    assert len(tr["critical_path"]) == 5


def test_port_fleet_store_gives_the_jax_trace_and_reconciles(fleet_store, tmp_path):
    """The store of ``edm_run --workers 2 --device cpu``: both packages'
    traces, Chrome traces and reconciliations agree; the JAX package's
    ``fleet_status`` and the port's aggregate the same spans; every
    stage of the DAG has its buckets and its critical-path unit."""
    from repro.launch import edm_fleet as jfleet
    from repro_torch.launch import edm_fleet

    tr = _same_outputs(fleet_store)
    rj = J.trace.reconcile(tr, jfleet.fleet_status(fleet_store))
    rp = P.trace.reconcile(tr, edm_fleet.fleet_status(fleet_store))
    assert rj == rp
    assert set(tr["workers"]) == {"main", "w0", "w1"}
    assert [e["stage"] for e in tr["critical_path"]] == list(tr["stages"]) == [
        "phase1", "phase2", "assemble", "sig", "finalize"]
    for st in tr["stages"].values():
        assert set(st["buckets"]) == set(P.trace.BUCKETS)
    assert all(u["done_t"] is not None for u in tr["units"].values())


def test_trace_cli_on_the_port_fleet_store(fleet_store, tmp_path, capsys):
    """``edm_fleet trace --json --reconcile``: the analysis the module
    gives, its reconciliation against ``fleet_status``, the Chrome trace
    at ``--trace-out`` the one ``chrome_trace`` makes; the exit code is 1
    exactly where a stage misses the 1% gate."""
    from repro_torch.launch import edm_fleet

    dest = tmp_path / "t.json"
    argv = ["trace", "--out", str(fleet_store), "--trace-out", str(dest),
            "--json", "--reconcile"]
    want = P.trace.reconcile(P.trace.assemble_trace(fleet_store),
                             edm_fleet.fleet_status(fleet_store))
    if want["ok"]:
        edm_fleet.main(argv)
    else:  # status rounds span sums to 1 ms: a stage of a few ms misses
        with pytest.raises(SystemExit) as e:
            edm_fleet.main(argv)
        assert e.value.code == 1
    got = json.loads(capsys.readouterr().out)
    assert got.pop("reconcile") == want
    assert got == P.trace.assemble_trace(fleet_store)
    assert json.loads(dest.read_text()) == P.trace.chrome_trace(fleet_store)
