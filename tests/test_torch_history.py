"""The port's run history (``repro_torch.runtime.history``) against the
JAX package's (``repro.runtime.history``) on the CPU.

The JAX tests' bodies (tests/test_trace.py: build / append / replace,
the record_run gate and ``EDM_HISTORY``, trends with regression flags)
run through both packages; summaries of hand-written stores, of stores
drawn from a numpy seed and of the store the port's ``edm_run --workers
2 --device cpu`` wrote, and trends of histories drawn from a seed, must
be the same from both packages (``time.time`` pinned where a record
stamps it).  Then the port's own runs: one record a finished run, a
rerun of the same run replaces it, ``--no-telemetry`` leaves none, and
``edm_fleet trends`` renders a shared history."""
import json
import time

import pytest

pytest.importorskip("torch")

from torch_telemetry_fixtures import (  # noqa: E402
    PKGS,
    duplicate_done_store,
    modules,
    port_fleet_store,
    random_history,
    random_store,
    two_worker_store,
)

J, P = modules("repro"), modules("repro_torch")
T_PINNED = 1.7e9
SMALL = ["--synthetic", "12x120", "--e-max", "3", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _clean_telemetry(monkeypatch):
    monkeypatch.delenv("EDM_HISTORY", raising=False)
    monkeypatch.delenv("EDM_TELEMETRY", raising=False)
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


# ------------------------------------- the JAX tests' bodies, both packages
def test_history_build_append_replace_roundtrip(pkg, tmp_path):
    out = two_worker_store(tmp_path / "run")
    (out / "fingerprint.json").write_text(json.dumps({"fingerprint": "fpA"}))
    rec = pkg.history.build_record(out)
    assert rec["v"] == pkg.history.HISTORY_VERSION
    assert rec["fingerprint"] == "fpA" and rec["workers"] == 2
    assert rec["chunks"] == 2 and rec["units_done"] == 3
    assert rec["chunk_p95_s"] == 10.0 and rec["held_p95_s"] == 11.0
    assert rec["bytes_written"] == 100
    assert rec["rows_per_s"] == pytest.approx(16 / 24.0, rel=1e-3)
    assert rec["stages"]["phase2"]["span_s"] == pytest.approx(52.7)
    hp = tmp_path / "history.jsonl"
    pkg.history.append_record(hp, rec)
    pkg.history.append_record(hp, {**rec, "total_span_s": 99.0})
    got = pkg.history.load_history(hp)
    assert len(got) == 1 and got[0]["total_span_s"] == 99.0
    pkg.history.append_record(hp, {**rec, "out": "/elsewhere", "t": rec["t"] + 1})
    assert len(pkg.history.load_history(hp)) == 2
    with open(hp, "a") as f:
        f.write('{"v": 1, "tor')
    assert len(pkg.history.load_history(hp)) == 2


def test_record_run_gating_and_env_override(pkg, tmp_path, monkeypatch):
    out = two_worker_store(tmp_path / "run")
    assert pkg.history.record_run(out) is None
    assert not (out / "history.jsonl").exists()
    shared = tmp_path / "shared_history.jsonl"
    monkeypatch.setenv("EDM_HISTORY", str(shared))
    assert pkg.history.record_run(out) == shared
    pkg.history.record_run(out)
    assert len(pkg.history.load_history(shared)) == 1
    monkeypatch.delenv("EDM_HISTORY")
    pkg.telemetry.configure(pkg.telemetry.MemorySink())
    assert pkg.history.record_run(out) == out / "history.jsonl"


def test_trends_rendering_and_regression_flags(pkg):
    base = {"v": 1, "out": "/runs/a", "fingerprint": "fp1", "N": 64,
            "engine": "cuda", "workers": 2,
            "geometry": {"target_tile": 32, "stream_depth": 2, "unit_rows": 8},
            "steals": 0, "retries": 0, "poisoned": 0, "chunk_p95_s": 1.0}
    recs = [
        {**base, "t": 1000.0, "total_span_s": 10.0, "rows_per_s": 50.0},
        {**base, "t": 2000.0, "total_span_s": 11.0, "rows_per_s": 48.0},
        {**base, "t": 3000.0, "total_span_s": 22.0, "rows_per_s": 24.0,
         "geometry": {"target_tile": 64, "stream_depth": 2, "unit_rows": 8},
         "steals": 3},
    ]
    a = pkg.history.analyze_trends(recs)
    assert a["runs"][0]["regression_pct"] is None
    assert a["runs"][1]["regression_pct"] == pytest.approx(10.0)
    assert a["runs"][2]["regression_pct"] == pytest.approx(100.0)
    assert len(a["regressions"]) == 1 and len(a["knobs"]) == 2
    assert a["knobs"][0]["tile"] == 32
    text = pkg.history.render_trends(recs)
    assert "REGRESSION +100.0%" in text and "3 steal(s)" in text
    assert "knob vs throughput" in text
    assert "no runs recorded" in pkg.history.render_trends([])


# ---------------------------------------------- the two packages, exactly
def _same_record(out, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: T_PINNED)
    rj, rp = J.history.build_record(out), P.history.build_record(out)
    assert rj == rp and rp["t"] == T_PINNED
    return rp


@pytest.mark.parametrize("store", ["two_worker", "duplicate_done",
                                   "seeded_0", "seeded_1", "seeded_2"])
def test_build_record_equals_the_jax_one(store, tmp_path, monkeypatch):
    out = tmp_path / "run"
    if store == "two_worker":
        two_worker_store(out)
        (out / "fingerprint.json").write_text(json.dumps({"fingerprint": "f"}))
    elif store == "duplicate_done":
        duplicate_done_store(out)
    else:
        random_store(out, int(store[-1]))
    _same_record(out, monkeypatch)


def test_build_record_of_the_port_fleet_store(fleet_store, monkeypatch):
    """The JAX module reads the port's fleet.json and fingerprint; the
    keys the port adds (``device``, the fingerprint's ``framework``) do
    not enter the identity, as no key outside the JAX module's list does."""
    rec = _same_record(fleet_store, monkeypatch)
    spec = json.loads((fleet_store / "fleet.json").read_text())
    assert rec["fingerprint"] == spec["fingerprint"]
    assert (rec["N"], rec["L"], rec["engine"]) == (16, 300, "cuda")
    assert set(rec["geometry"]) == {"unit_rows", "lib_block", "target_tile",
                                    "knn_tile_c", "stream_depth"}
    assert rec["workers"] == 3 and rec["units_done"] > 0 and rec["rows_per_s"]
    # the finished run left one record (finalize replaced assemble's,
    # the supervisor replaced finalize's)
    hist = P.history.load_history(fleet_store / "history.jsonl")
    assert len(hist) == 1 and J.history.load_history(
        fleet_store / "history.jsonl") == hist


@pytest.mark.parametrize("seed", range(4))
def test_trends_equal_the_jax_trends(seed, tmp_path):
    recs = random_history(seed)
    assert J.history.analyze_trends(recs) == P.history.analyze_trends(recs)
    assert J.history.render_trends(recs) == P.history.render_trends(recs)
    hp = tmp_path / "h.jsonl"
    for r in recs:  # written by the port, read by both
        P.history.append_record(hp, r)
    assert J.history.load_history(hp) == P.history.load_history(hp)


# -------------------------------------------------------- the port's runs
def test_edm_run_keeps_one_record_a_run(tmp_path, monkeypatch, capsys):
    """Default sink: each finished run leaves its record in
    <out>/history.jsonl; a rerun into the same store (a resume that
    computes nothing) replaces it; significance replaces the map's; a
    shared EDM_HISTORY collects one record a store; --no-telemetry
    without EDM_HISTORY writes none."""
    from repro_torch.launch import edm_fleet, edm_run

    a = tmp_path / "a"
    edm_run.main([*SMALL, "--out", str(a)])
    edm_run.main([*SMALL, "--out", str(a)])
    (rec,) = P.history.load_history(a / "history.jsonl")
    assert rec["out"] == str(a.resolve()) and rec["N"] == 12
    assert rec["engine"] == "cuda" and rec["workers"] == 1
    b = tmp_path / "b"
    edm_run.main([*SMALL, "--lib-sizes", "40,80", "--surrogates", "3",
                  "--out", str(b)])
    (rec_b,) = P.history.load_history(b / "history.jsonl")
    assert {"sig", "finalize"} <= set(rec_b["stages"])
    c = tmp_path / "c"
    edm_run.main([*SMALL, "--no-telemetry", "--out", str(c)])
    assert not (c / "history.jsonl").exists() and not (c / "telemetry").exists()

    shared = tmp_path / "shared.jsonl"
    monkeypatch.setenv("EDM_HISTORY", str(shared))
    for out in (a, c, tmp_path / "d", a):
        edm_run.main([*SMALL, "--out", str(out)])
    recs = P.history.load_history(shared)
    assert sorted(r["out"] for r in recs) == sorted(
        str(p.resolve()) for p in (a, c, tmp_path / "d"))
    capsys.readouterr()
    edm_fleet.main(["trends", "--history", str(shared), "--json"])
    got = json.loads(capsys.readouterr().out)
    assert got == {"path": str(shared), **P.history.analyze_trends(recs)}
    edm_fleet.main(["trends", "--out", str(tmp_path / "elsewhere")])
    text = capsys.readouterr().out
    assert f"history: {shared}" in text and "history: 3 run(s)" in text
