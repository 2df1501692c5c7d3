"""The port's benchmark harness (``python -m repro_torch.bench.run``) at
its test sizes on the CPU: every ported bench runs, writes its JSON under
``--out`` only (the JAX package's committed ``BENCH_*.json`` at the
repository root keep their bytes), with the JAX bench's top-level keys
where the JAX bench writes a JSON and its row names where it prints rows;
the kNN bench's slab == stream spot check holds on both engines; an
unknown bench name exits non-zero."""
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parents[1]
PORTED = ("table2", "fig6", "fig7", "fig8", "fig9", "knn", "phase2",
          "significance", "roofline")
JAX_JSONS = {"knn": "BENCH_knn.json", "phase2": "BENCH_phase2.json",
             "significance": "BENCH_significance.json"}


def _root_bench_bytes():
    return {p.name: p.read_bytes() for p in sorted(REPO.glob("BENCH_*.json"))}


@pytest.fixture(scope="module")
def bench_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("bench")
    before = _root_bench_bytes()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.run", *PORTED, "--tiny",
         "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, cwd=str(out), timeout=600,
        env={**os.environ, "PYTHONPATH": str(REPO / "src"),
             "OMP_NUM_THREADS": "1"},
    )
    assert r.returncode == 0, r.stderr[-3000:]
    return out, r.stdout, before


def test_every_bench_writes_its_json_under_out_only(bench_run):
    out, stdout, before = bench_run
    assert sorted(p.name for p in out.iterdir()) == sorted(
        f"BENCH_{n}.json" for n in PORTED)
    assert _root_bench_bytes() == before
    assert stdout.splitlines()[0] == "name,us_per_call,derived"
    for line in stdout.splitlines()[1:]:
        name, us, _ = line.split(",", 2)
        float(us)
    for n in PORTED:
        d = json.loads((out / f"BENCH_{n}.json").read_text())
        assert d["device"] == "cpu" and d["card"] is None


@pytest.mark.parametrize("name", sorted(JAX_JSONS))
def test_json_has_the_jax_benchs_top_level_keys(bench_run, name):
    out, _, _ = bench_run
    want = set(json.loads((REPO / JAX_JSONS[name]).read_text()))
    got = json.loads((out / JAX_JSONS[name]).read_text())
    assert want <= set(got), sorted(want - set(got))


ROWS = {
    "table2": ["table2_improved_ccm", "table2_naive_ccm_extrap", "table2_speedup",
               "table2_model_fish1", "table2_model_subject11"],
    "fig6": ["fig6_N4", "fig6_N6", "fig6_N8", "fig6_scaling_exponent"],
    "fig7": ["fig7_L80", "fig7_L120", "fig7_L160", "fig7_scaling_exponent"],
    "fig8": ["fig8_knn_per_series", "fig8_lookup_per_series"],
    "fig9": ["fig9_cumulative_multiE", "fig9_per_E_rebuild"],
}


@pytest.mark.parametrize("name", sorted(ROWS))
def test_row_benches_print_the_jax_benchs_rows(bench_run, name):
    out, _, _ = bench_run
    d = json.loads((out / f"BENCH_{name}.json").read_text())
    assert [r["name"] for r in d["rows"]] == ROWS[name]


def test_knn_bench_checks_slab_against_stream_on_both_engines(bench_run):
    out, _, _ = bench_run
    d = json.loads((out / "BENCH_knn.json").read_text())
    assert d["spot_check_torch_reference"] and d["spot_check_cuda"]
    assert set(d["engines"]) == {"torch-reference", "cuda"}
    for engine, rows in d["engines"].items():
        assert list(rows) == ["100", "200"]
        for r in rows.values():
            assert r["stream_s"] > 0 and r["slab_s"] > 0
            assert r["route"] == "plain"  # the CPU runs no kernel
            assert r["slab_bound_s"] > 0 and r["stream_bound_s"] > 0
        # the slab grows with Lc, the streaming working set does not
        assert rows["200"]["slab_working_set_bytes"] >= rows["100"]["slab_working_set_bytes"]
        assert rows["200"]["stream_working_set_bytes"] <= 2 * rows["100"][
            "stream_working_set_bytes"]
    assert set(d["phase1"]) >= {"auto_s", "forced_tile_s", "auto_tile_c"}


def test_phase2_and_significance_benches_hold_their_contracts(bench_run):
    out, _, _ = bench_run
    p2 = json.loads((out / "BENCH_phase2.json").read_text())
    assert p2["max_abs_drho"] <= 1e-5 and p2["max_abs_drho_tiled"] == 0.0
    assert p2["tiled_path"]["target_tile"] == 5
    sig = json.loads((out / "BENCH_significance.json").read_text())
    assert sig["lib_sizes"] == sorted(sig["lib_sizes"]) and sig["rows_timed"] == 4


def test_roofline_bench_summarises_the_dry_runs(tmp_path, capsys):
    from repro_torch.bench import run as brun
    from repro_torch.configs.edm_datasets import EDMDatasetConfig
    from repro_torch.core.types import EDMConfig
    from repro_torch.launch.edm_dryrun import dryrun

    (tmp_path / "dry").mkdir()
    rep = dryrun(EDMDatasetConfig("Tiny", 120, 24, EDMConfig(E_max=4, lib_block=4)),
                 "cpu")
    (tmp_path / "dry" / "tiny.json").write_text(json.dumps(rep))
    b = brun.Bench(torch.device("cpu"), tmp_path / "out")
    d = brun.roofline_summary(b, tmp_path / "dry")
    assert [r["name"] for r in d["rows"]] == ["roofline_edm-tiny_ccm_N24_L120_1card"]
    assert re.search(r"bottleneck=(compute|memory);frac=", d["rows"][0]["derived"])
    assert "mem_GiB=n/a" in d["rows"][0]["derived"]


def test_unknown_bench_exits_nonzero(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.run", "knn", "fig3",
         "--tiny", "--device", "cpu", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")},
    )
    assert r.returncode != 0 and "fig3" in r.stderr
    assert not any(tmp_path.iterdir())
