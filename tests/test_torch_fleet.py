"""The port's masterless fleet (``repro_torch.launch.edm_fleet``, ``edm_run
--workers``) on the CPU, with its workers as real subprocesses at
``device="cpu"`` (one thread each, so a test under ``pytest -n`` does not
oversubscribe the machine): every artifact byte-identical to the port's
single-process run for any worker count, unit height and tile width; the
map within 1e-5 of the JAX package's; the store readable by the JAX
package's ``fleet_status`` and ``fsck_store``; and the refusals."""
import dataclasses
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.types import EDMConfig  # noqa: E402
from repro_torch.data import store  # noqa: E402
from repro_torch.data.synthetic import dummy_brain  # noqa: E402
from repro_torch.inference.types import SignificanceConfig  # noqa: E402
from repro_torch.launch import edm_fleet  # noqa: E402
from repro_torch.runtime import integrity, telemetry  # noqa: E402

ARTIFACTS = ("causal_map", "rho_conv", "rho_trend", "pvals", "edges")
CFG = EDMConfig(E_max=4, lib_block=4, target_tile=6)
SIG = SignificanceConfig(lib_sizes=(40, 80), n_surrogates=6, seed=0)
WAIT_S = 300  # every wait on a worker has its own limit
NEAR_TIE = 1e-5  # |null - obs| within which the frameworks may round apart


def worker_env() -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("EDM_FAULTS", None)
    env.pop("EDM_TELEMETRY", None)
    return env


def _series():
    return dummy_brain(16, 250, seed=0)


def _baseline(out, ts, cfg, sig):
    from repro_torch.core.pipeline import run_causal_inference
    from repro_torch.inference import run_significance

    res = run_causal_inference(ts, cfg, device="cpu", out_dir=str(out))
    run_significance(ts, res.optE, np.asarray(res.rho), cfg, sig, device="cpu",
                     out_dir=str(out))
    return {a: (out / a / "data.npy").read_bytes() for a in ARTIFACTS}


@pytest.fixture(scope="module")
def baseline(tmp_path_factory):
    """The port's single-process stores, untiled and at tile 6: one bytes
    set (the tiles do not show), and the dataset the fleets read."""
    root = tmp_path_factory.mktemp("baseline")
    ts = _series()
    store.save_dataset(root / "dataset", ts, {"synthetic": "16x250"})
    untiled = _baseline(root / "untiled", ts,
                        dataclasses.replace(CFG, target_tile=0), SIG)
    tiled = _baseline(root / "tiled", ts, CFG, SIG)
    assert untiled == tiled
    return {"dataset": root / "dataset", "bytes": untiled, "ts": ts}


def run_fleet(out, dataset, cfg=CFG, sig=SIG, workers=2, unit_rows=0):
    edm_fleet.init_fleet(out, dataset, cfg, sig, unit_rows=unit_rows,
                         device="cpu")
    procs = {f"w{i}": edm_fleet.spawn_worker(out, f"w{i}", env=worker_env())
             for i in range(workers)}
    t0 = time.time()
    for wid, p in procs.items():
        rc = p.wait(timeout=max(1.0, WAIT_S - (time.time() - t0)))
        assert rc == 0, f"worker {wid} exited {rc}"
    return out


def assert_bytes(out, want):
    for a in ARTIFACTS:
        assert (out / a / "data.npy").read_bytes() == want[a], \
            f"{a} differs from the single-process run"


@pytest.fixture(scope="module")
def fleet2(baseline, tmp_path_factory):
    """A W=2 fleet at tile 6 over the baseline dataset."""
    return run_fleet(tmp_path_factory.mktemp("fleet2") / "out",
                     baseline["dataset"])


# ------------------------------------------------------------------ bytes
@pytest.mark.parametrize("tile", [0, 6])
def test_two_workers_equal_the_single_process_run(baseline, fleet2, tmp_path,
                                                  tile):
    out = fleet2 if tile == 6 else run_fleet(
        tmp_path / "out", baseline["dataset"],
        dataclasses.replace(CFG, target_tile=0))
    assert_bytes(out, baseline["bytes"])
    meta = json.loads((out / "causal_map" / "meta.json").read_text())
    assert meta["fleet"] is True and meta["framework"] == "torch"
    assert not list((out / "queue").glob("*.lease"))


@pytest.mark.parametrize("workers,unit_rows", [(1, 0), (2, 3), (2, 5), (3, 4)])
def test_any_worker_count_and_unit_height_give_the_same_bytes(
        baseline, tmp_path, workers, unit_rows):
    """Units of 3 or 5 rows cut chunks of lib_block 4 elsewhere: chunks
    of 3, 1, 2, ... library rows; the bytes do not move."""
    out = run_fleet(tmp_path / "out", baseline["dataset"], workers=workers,
                    unit_rows=unit_rows)
    assert_bytes(out, baseline["bytes"])
    spec = json.loads((out / "fleet.json").read_text())
    assert spec["unit_rows"] == (unit_rows or CFG.lib_block)


# ----------------------------------------------------------- against JAX
def _port_curves_and_null(ts, cfg, optE, sig):
    """The port's rho curves (S, N, N) and null rho (N, N, m), natural
    column order, to find the near-ties of a run."""
    from repro_torch.core import ccm as tccm
    from repro_torch.inference import convergence
    from repro_torch.inference.pipeline import SignificanceChunkRunner

    r = SignificanceChunkRunner(ts, optE, cfg, sig, device="cpu")
    inv = np.argsort(r.order)
    cidx, cw = convergence.conv_block_tables(r.rows(0, r.N), cfg, r.plan,
                                             sig.lib_sizes, r.col_ids)
    seg = tuple(enumerate(r.plan.counts))
    curves = torch.stack([
        tccm.ccm_row_lookup_bucketed(cidx[:, s], cw[:, s], r.fut_sorted, cfg, seg)
        for s in range(len(sig.lib_sizes))
    ]).numpy()[..., inv]
    fidx, fw = tccm.ccm_row_tables_bucketed(r.rows(0, r.N), cfg, r.plan)
    m = sig.n_surrogates
    null = tccm.ccm_row_lookup_bucketed(
        fidx, fw, r.fut_surr, cfg, tuple((b, c * m) for b, c in seg)
    ).numpy().reshape(r.N, r.N, m)[:, inv]
    return curves, null


def test_fleet_matches_the_jax_single_process_run(baseline, fleet2,
                                                  record_property):
    """The fleet's map within 1e-5 of JAX's (untiled: the JAX tiled map
    is no bit reference, ROADMAP queue 3), optE equal, drho within 1e-5;
    trend and p-values equal outside near-ties."""
    from repro.core.pipeline import run_causal_inference as jrun_map
    from repro.core.types import EDMConfig as JCfg
    from repro.inference import SignificanceConfig as JSig
    from repro.inference import run_significance as jrun_sig

    ts = baseline["ts"]
    jcfg = JCfg(E_max=4, lib_block=4)
    jsig = JSig(**dataclasses.asdict(SIG))
    want = jrun_map(ts, jcfg)
    wsig = jrun_sig(ts, np.asarray(want.optE), np.asarray(want.rho), jcfg, jsig)
    rho = np.load(fleet2 / "causal_map" / "data.npy")
    optE = np.load(fleet2 / "phase1" / "optE.npy")
    np.testing.assert_array_equal(optE, np.asarray(want.optE))
    map_err = float(np.abs(rho - np.asarray(want.rho)).max())
    assert map_err <= 1e-5
    drho = np.load(fleet2 / "rho_conv" / "data.npy")
    assert np.abs(drho - wsig.drho).max() <= 1e-5

    curves, null = _port_curves_and_null(ts, dataclasses.replace(CFG, target_tile=0),
                                         optE, SIG)
    S = curves.shape[0]
    gaps = np.abs(curves[:, None] - curves[None, :])
    trend_tie = (gaps[np.triu_indices(S, 1)] <= NEAR_TIE).any(0)
    p_tie = (np.abs(null - rho[..., None]) <= NEAR_TIE + map_err).any(-1)
    record_property("near_ties_skipped", int(trend_tie.sum() + p_tie.sum()))
    trend = np.load(fleet2 / "rho_trend" / "data.npy")
    pvals = np.load(fleet2 / "pvals" / "data.npy")
    np.testing.assert_array_equal(trend[~trend_tie], wsig.trend[~trend_tie])
    np.testing.assert_array_equal(pvals[~p_tie], wsig.pvals[~p_tie])
    assert p_tie.sum() <= p_tie.size // 4


# ------------------------------------------------- telemetry, status, fsck
def test_every_worker_records_all_five_stages(fleet2):
    span_stages: dict[str, set] = {}
    for stem, rec in telemetry.iter_store_records(fleet2):
        assert telemetry.validate(rec) == [], (stem, rec)
        if rec["kind"] == "span":
            span_stages.setdefault(stem, set()).add(rec["stage"])
    assert set(span_stages) == {"w0", "w1"}
    for wid, stages in span_stages.items():
        assert set(telemetry.PIPELINE_STAGES) <= stages, (wid, stages)
    st = edm_fleet.fleet_status(fleet2)
    assert st["complete"] and st["telemetry"]["violations"] == 0
    for kind, s in st["stages"].items():
        assert s["done"] == s["total"] and not s["leases"] and not s["poisoned"]
    assert "[COMPLETE]" in edm_fleet.render_status(st)


def test_jax_status_and_fsck_read_the_port_fleet_store(fleet2, capsys):
    """repro's fleet_status reads a port fleet store as complete, its
    fsck_store as clean; the port's fsck agrees, and its CLI exits 0 with
    --expect-complete / --expect-clean."""
    from repro.launch import edm_fleet as jfleet
    from repro.runtime import integrity as jintegrity

    st = jfleet.fleet_status(fleet2)
    assert st["complete"], st
    assert st["telemetry"]["violations"] == 0
    rep = jintegrity.fsck_store(fleet2)
    assert rep["clean"] and rep["fingerprint"]["status"] == "ok", rep
    assert integrity.fsck_store(fleet2)["clean"]
    edm_fleet.main(["status", "--out", str(fleet2), "--expect-complete"])
    edm_fleet.main(["fsck", "--out", str(fleet2), "--expect-clean"])
    out = capsys.readouterr().out
    assert "[COMPLETE]" in out and "CLEAN" in out


# --------------------------------------------------------------- refusals
def _refusal_store(tmp_path, baseline, case):
    out = tmp_path / "out"
    if case == "jax_store":
        from repro.core.types import EDMConfig as JCfg
        from repro.launch import edm_fleet as jfleet

        jfleet.init_fleet(out, baseline["dataset"], JCfg(E_max=4, lib_block=4))
        return out, integrity.IntegrityError, "initialised by the JAX package"
    ds = tmp_path / "dataset"
    store.save_dataset(ds, baseline["ts"], {"synthetic": "16x250"})
    edm_fleet.init_fleet(out, ds, CFG, SIG, device="cpu")
    spec_f = out / "fleet.json"
    if case == "changed_dataset":
        store.save_dataset(ds, baseline["ts"] + 1.0)
        return out, integrity.IntegrityError, "changed since init_fleet"
    spec = json.loads(spec_f.read_text())
    # a tier the port does not have; a group joined from a partial EDM_*
    # environment (the test sets EDM_COORDINATOR alone)
    key, value, match = {"platform": ("platform", "tpu", "no TPU tier"),
                         "distributed": ("distributed", True, "missing")}[case]
    spec[key] = value
    spec_f.write_text(json.dumps(spec))
    return out, ValueError, match


@pytest.mark.parametrize("case", ["jax_store", "changed_dataset", "platform",
                                  "distributed"])
def test_worker_refuses(tmp_path, baseline, case, monkeypatch):
    out, err, match = _refusal_store(tmp_path, baseline, case)
    monkeypatch.setenv("EDM_COORDINATOR", "localhost:1")
    monkeypatch.delenv("EDM_NUM_PROCESSES", raising=False)
    monkeypatch.delenv("EDM_PROCESS_ID", raising=False)
    with pytest.raises(err, match=match):
        edm_fleet.FleetWorker(out, "w0", progress=False)


def test_init_fleet_refuses_a_changed_spec_and_a_missing_card(tmp_path, baseline):
    out = tmp_path / "out"
    edm_fleet.init_fleet(out, baseline["dataset"], CFG, SIG, device="cpu")
    assert edm_fleet.init_fleet(out, baseline["dataset"], CFG, SIG,
                                device="cpu")["unit_rows"] == 4
    with pytest.raises(ValueError, match="fleet spec mismatch"):
        edm_fleet.init_fleet(out, baseline["dataset"], CFG, SIG, unit_rows=3,
                             device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            edm_fleet.init_fleet(tmp_path / "card", baseline["dataset"], CFG, SIG)


def test_worker_without_the_card_exits_nonzero(tmp_path, baseline):
    """A spec that names the card, read by a worker that has none: the
    worker exits non-zero and computes nothing (no CPU fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = tmp_path / "out"
    edm_fleet.init_fleet(out, baseline["dataset"], CFG, SIG, device="cpu")
    spec = json.loads((out / "fleet.json").read_text())
    spec["device"] = "cuda"
    (out / "fleet.json").write_text(json.dumps(spec))
    p = edm_fleet.spawn_worker(out, "w0", env=worker_env())
    assert p.wait(timeout=WAIT_S) != 0
    assert not (out / "phase1").exists()


@pytest.mark.parametrize("cmd", ["trace", "trends", "status --watch"])
def test_fleet_cli_trace_trends_and_watch_read_a_fleet_store(fleet2, tmp_path,
                                                             capsys, cmd):
    """``trace`` writes a Chrome trace and renders every stage with its
    critical-path unit; ``trends`` renders the one record the finished
    run left (the finalize claimer replaced the assemble claimer's);
    ``status --watch`` returns at once on a complete store."""
    dest = tmp_path / "trace.json"
    extra = {"trace": ["--trace-out", str(dest)],
             "status --watch": ["--interval", "0.1"]}.get(cmd, [])
    edm_fleet.main([*cmd.split(), "--out", str(fleet2), *extra])
    out = capsys.readouterr().out
    if cmd == "trace":
        assert json.loads(dest.read_text())["traceEvents"]
        assert "critical path" in out and f"chrome trace: {dest}" in out
        for stage in telemetry.PIPELINE_STAGES:
            assert f"\n{stage:<10}" in out and f"  {stage:<9} " in out
    elif cmd == "trends":
        assert "history: 1 run(s)" in out and "REGRESSION" not in out
    else:
        assert out.count("[COMPLETE]") == 1


# -------------------------------------------------------------- edm_run CLI
def _cli(out, *extra):
    from repro_torch.launch import edm_run

    return edm_run.main(["--synthetic", "16x250", "--e-max", "4",
                         "--lib-block", "4", "--target-tile", "6",
                         "--lib-sizes", "40,80", "--surrogates", "6",
                         "--device", "cpu", "--out", str(out), *extra])


#: what the JAX package's ``edm_run --workers`` leaves in its store
FLEET_STORE = (
    "fleet.json", "fingerprint.json", "significance.json",
    "dataset/data.npy", "dataset/meta.json",
    "phase1/optE.npy", "phase1/simplex_rho.npy", "phase1/meta.json",
    "col_order.npy",
    "queue/phase1.done", "queue/assemble.done", "queue/finalize.done",
    "causal_map/data.npy", "causal_map/meta.json",
    "rho_conv/data.npy", "rho_conv/meta.json", "rho_conv/col_order.npy",
    "rho_trend/data.npy", "rho_trend/meta.json",
    "pvals/data.npy", "pvals/meta.json",
    "edges/data.npy", "edges/meta.json",
    "telemetry/w0.jsonl", "telemetry/w1.jsonl",
)


def test_edm_run_workers_writes_the_fleet_store(tmp_path, baseline, monkeypatch,
                                                capfd):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.delenv("EDM_FAULTS", raising=False)
    out = tmp_path / "out"
    summary = _cli(out, "--workers", "2")
    assert summary["fleet"] and summary["restarts"] == {"w0": 0, "w1": 0}
    assert not summary["failed"] and summary["edges"] is not None
    missing = [f for f in FLEET_STORE if not (out / f).exists()]
    assert not missing, missing
    assert list(out.glob("blocks.w*.json")) and not (out / "blocks.json").exists()
    assert json.loads((out / "causal_map" / "meta.json").read_text())["fleet"] is True
    assert_bytes(out, baseline["bytes"])
    text = capfd.readouterr().out
    done = [ln for ln in text.splitlines() if "] done in " in ln]
    assert len(done) == 2
    for ln in done:
        rec = json.loads(ln[ln.index("{"):])
        assert set(rec["launches"]) == {"knn_topk", "knn_topk_prefix",
                                          "ccm_lookup", "flash_attn"}
        assert set(rec["stages_s"]) == set(telemetry.PIPELINE_STAGES)


def test_edm_run_supervisor_relaunches_a_crashed_worker(tmp_path, baseline,
                                                        monkeypatch):
    """Every first-generation worker dies at its second tile rename; the
    supervisor relaunches each once without EDM_FAULTS, and the store
    converges to the same bytes with no stale lease."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("EDM_FAULTS", "tile_pre_rename:crash@2")
    out = tmp_path / "out"
    summary = _cli(out, "--workers", "2", "--unit-rows", "5")
    assert summary["restarts"] == {"w0": 1, "w1": 1} and not summary["failed"]
    assert_bytes(out, baseline["bytes"])
    assert not list((out / "queue").glob("*.lease"))
    assert integrity.fsck_store(out)["clean"]


def test_edm_run_poisoned_unit_fails_the_fleet_naming_it(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("EDM_FAULTS", "unit_pre_compute:error")
    with pytest.raises(SystemExit, match="phase1 failed permanently"):
        _cli(tmp_path / "out", "--workers", "2", "--unit-retries", "1",
             "--max-worker-restarts", "0")
