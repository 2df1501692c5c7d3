"""The ``--check`` regression gate of the port's bench harness
(``repro_torch.bench.run``) on hand-made JSONs, held to the JAX harness's
gate (``benchmarks/run.py``) on the same numbers: a missing baseline is a
SKIP row, a field past 1.5x its baseline a regression, the retry keeps
each field's best time, the knn-gate holds the streaming tables to the
slab fresh and in the baseline, and CHECK_summary.json carries the JAX
summary's keys.  One in-process ``--check`` at ``--tiny`` on the CPU."""
import importlib.util
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.bench import run as brun  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
SIG = "BENCH_significance.json"
PHASE2 = "BENCH_phase2.json"


def _write(d: pathlib.Path, name: str, data: dict) -> None:
    d.mkdir(parents=True, exist_ok=True)
    (d / name).write_text(json.dumps(data))


def _sig(one: float, reb: float, card=None) -> dict:
    return {"one_sweep_chunk_s": one, "rebuild_chunk_s": reb, "card": card}


def _phase2(t: float) -> dict:
    return {p: {"phase2_s": t} for p in ("seed_path", "new_path", "tiled_path")}


def _knn(engines: dict, lc_times: dict, auto: float = 1.0) -> dict:
    """engines: the JSON's engine names; lc_times {Lc: (stream_s, slab_s)}."""
    return {"phase1": {"auto_s": auto},
            "engines": {e: {lc: {"stream_s": s, "slab_s": sl}
                            for lc, (s, sl) in lc_times.items()} for e in engines}}


def test_gates_are_the_jax_fields_with_the_port_engine_names():
    card, tiny = brun.gates(False), brun.gates(True)
    assert brun.GATES == card and set(card) == {"phase2", "knn", "significance"}
    assert card["knn"][1][1:] == [("engines", "torch-reference", "64000", "stream_s"),
                                  ("engines", "cuda", "16000", "stream_s")]
    lc = str(max(brun.SIZES["knn"]["tiny"]["Lc_sweep"]))
    assert tiny["knn"][1][1:] == [("engines", "torch-reference", lc, "stream_s"),
                                  ("engines", "cuda", lc, "stream_s")]
    assert card["significance"] == tiny["significance"] == (
        SIG, [("one_sweep_chunk_s",), ("rebuild_chunk_s",)])
    assert brun.SLOWDOWN_LIMIT == 1.5 and brun.KNN_STREAM_MARGIN == 1.15


def test_missing_baseline_is_a_skip_row(tmp_path, capsys):
    _write(tmp_path / "fresh", SIG, _sig(1.0, 2.0))
    summary = []
    assert brun.check_regressions(["significance"], tmp_path / "base",
                                  tmp_path / "fresh", summary=summary) == []
    assert capsys.readouterr().out.strip() == f"gate,{SIG},SKIP_no_committed_baseline"
    assert summary == []


@pytest.mark.parametrize("fresh,verdicts", [((1.4, 2.0), ["OK", "OK"]),
                                            ((1.6, 2.0), ["REGRESSION", "OK"])])
def test_drift_rows_pass_and_regress(tmp_path, capsys, fresh, verdicts):
    _write(tmp_path / "base", SIG, _sig(1.0, 2.0, "NVIDIA H100 80GB HBM3, 700.00 W"))
    _write(tmp_path / "fresh", SIG, _sig(*fresh))
    summary = []
    bad = brun.check_regressions(["significance"], tmp_path / "base",
                                 tmp_path / "fresh", summary=summary)
    assert bad == ([] if verdicts == ["OK", "OK"] else ["significance"])
    assert [e["verdict"] for e in summary] == verdicts
    assert summary[0] == {"gate": f"{SIG}:one_sweep_chunk_s", "bench": "significance",
                          "kind": "drift", "base_s": 1.0, "fresh_s": fresh[0],
                          "ratio": fresh[0], "verdict": verdicts[0]}
    rows = [r for r in capsys.readouterr().out.splitlines() if r.startswith("gate,")]
    assert len(rows) == 2 and len(rows[0].split(",")) == 3
    assert rows[0].endswith(f"{verdicts[0]};base_card=NVIDIA H100 80GB HBM3 700.00 W;"
                            "fresh_card=None")


@pytest.mark.parametrize("stream,slab_fresh,slab_base,ok", [
    (1.10, 1.0, 0.5, True),    # within the fresh slab's 1.15
    (1.20, 1.0, 0.5, False),   # past both limits
    (1.40, 1.0, 1.0, True),    # within the baseline slab's 1.5
    (1.60, 1.0, 1.0, False),
])
def test_knn_gate_fresh_and_baseline_slab_limits(tmp_path, stream, slab_fresh,
                                                  slab_base, ok):
    engines = ("torch-reference", "cuda")
    lcs = ("64000", "16000")
    _write(tmp_path / "base", "BENCH_knn.json",
           _knn(engines, {lc: (1.0, slab_base) for lc in lcs}))
    fresh = _knn(engines, {lc: (1.0, slab_fresh) for lc in lcs})
    fresh["engines"]["cuda"]["16000"] = {"stream_s": stream, "slab_s": slab_fresh}
    _write(tmp_path / "fresh", "BENCH_knn.json", fresh)
    summary, floor = [], {}
    bad = brun.check_regressions(["knn"], tmp_path / "base", tmp_path / "fresh",
                                 floor=floor, summary=summary)
    gate = {e["gate"]: e for e in summary if e["kind"] == "knn-stream"}
    cell = gate["BENCH_knn.json:knn-gate.cuda.Lc16000"]
    assert cell["limit_s"] == pytest.approx(max(slab_fresh * 1.15, slab_base * 1.5))
    assert (cell["verdict"] == "OK") == ok and (bad == []) == ok
    assert len(gate) == 4 and floor["BENCH_knn.json:knn-gate.cuda.Lc16000"] == stream


def test_retry_keeps_the_best_of_two_and_writes_the_summary(tmp_path, monkeypatch,
                                                            capsys):
    """A field slow in the first pass and fast in the retry passes; one
    slow in both fails, naming its bench, with a nonzero exit."""
    out = tmp_path / "out"
    _write(out, SIG, _sig(1.0, 2.0))
    _write(out, PHASE2, _phase2(1.0))
    passes = {"significance": [(3.0, 2.0), (1.2, 9.0)], "phase2": [5.0, 4.0]}
    calls = []

    def fake_run(names, device=None, out_dir=None, tiny=False, header=True):
        calls.append(list(names))
        for n in names:
            t = passes[n].pop(0)
            if n == "significance":
                _write(pathlib.Path(out_dir), SIG, _sig(*t))
            else:
                _write(pathlib.Path(out_dir), PHASE2, _phase2(t))
        return {}

    monkeypatch.setattr(brun, "run", fake_run)
    with pytest.raises(SystemExit) as e:
        brun.main(["significance", "phase2", "--check", "--device", "cpu",
                   "--out", str(out)])
    assert "phase2" in str(e.value.code) and "significance" not in str(e.value.code)
    assert calls == [["significance", "phase2"], ["significance", "phase2"]]
    text = capsys.readouterr().out
    assert "gate,retry,rerunning_significance+phase2_once" in text
    s = json.loads((out / "fresh" / "CHECK_summary.json").read_text())
    assert s["failed"] == ["phase2"] and s["passed"] is False
    one = [g for g in s["gates"] if g["gate"] == f"{SIG}:one_sweep_chunk_s"]
    assert len(one) == 1 and one[0]["fresh_s"] == 1.2 and one[0]["verdict"] == "OK"
    reb = [g for g in s["gates"] if g["gate"] == f"{SIG}:rebuild_chunk_s"][0]
    assert reb["fresh_s"] == 2.0  # the best of the two passes
    assert len(s["gates"]) == 5


def _jax_bench_module():
    spec = importlib.util.spec_from_file_location("jax_bench_run",
                                                  REPO / "benchmarks" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_check_summary_has_the_jax_keys(tmp_path, monkeypatch):
    """The JAX gate and the port's on the same hand-made baselines and
    fresh times (the JAX gate's directories pointed into tmp_path): the
    same rows, the same verdicts, the same keys."""
    jb = _jax_bench_module()
    jroot, pout = tmp_path / "jax", tmp_path / "port"
    for d in (jroot, pout):
        _write(d, SIG, _sig(1.0, 2.0))
        _write(d, PHASE2, _phase2(1.0))
    fresh = {SIG: _sig(1.4, 4.0), PHASE2: _phase2(1.1)}

    def writer(fname, out_dir):
        return lambda *a, **k: _write(pathlib.Path(out_dir()), fname, fresh[fname])

    monkeypatch.setattr(jb, "REPO", jroot)
    monkeypatch.setattr(jb, "RESULTS", jroot / "results")
    monkeypatch.setattr(jb, "BENCHES", {
        "significance": writer(SIG, lambda: jb.BENCH_DIR),
        "phase2": writer(PHASE2, lambda: jb.BENCH_DIR)})
    monkeypatch.setattr("sys.argv", ["run.py", "--check", "significance", "phase2"])
    with pytest.raises(SystemExit):
        jb.main()
    want = json.loads((jroot / "results" / "fresh" / "CHECK_summary.json").read_text())

    def fake_run(names, device=None, out_dir=None, tiny=False, header=True):
        for n in names:
            fname = brun.GATES[n][0]
            _write(pathlib.Path(out_dir), fname, fresh[fname])

    monkeypatch.setattr(brun, "run", fake_run)
    with pytest.raises(SystemExit):
        brun.main(["--check", "significance", "phase2", "--out", str(pout)])
    got = json.loads((pout / "fresh" / "CHECK_summary.json").read_text())
    assert list(got) == list(want)
    assert [sorted(g) for g in got["gates"]] == [sorted(g) for g in want["gates"]]
    assert got == want


def test_check_in_process_at_tiny_on_the_cpu(tmp_path, capsys):
    """``--check`` with one bench and no baselines: SKIP rows, exit 0, the
    fresh JSON under <out>/fresh/ and a passing summary."""
    out = tmp_path / "bench"
    stale = out / "fresh" / SIG
    _write(out / "fresh", SIG, {"stale": True})
    summary = brun.main(["significance", "--check", "--tiny", "--device", "cpu",
                         "--out", str(out)])
    assert summary["passed"] is True and summary["gates"] == []
    assert f"gate,{SIG},SKIP_no_committed_baseline" in capsys.readouterr().out
    assert "stale" not in json.loads(stale.read_text())
    assert json.loads((out / "fresh" / "CHECK_summary.json").read_text()) == summary
    assert not (out / SIG).exists()


@pytest.mark.parametrize("argv", [["knn", "--chek"], ["fig6", "--check"],
                                  ["knn", "--baselines", "x"]])
def test_bad_flags_exit_nonzero(tmp_path, argv, capsys):
    with pytest.raises(SystemExit) as e:
        brun.main([*argv, "--tiny", "--device", "cpu", "--out", str(tmp_path)])
    assert e.value.code not in (0, None)
    assert not any(tmp_path.iterdir())
