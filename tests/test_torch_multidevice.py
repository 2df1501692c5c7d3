"""The port's paths over several device slots, on the CPU through
``spoof_cpu_devices(n)`` (the counterpart of XLA's host-device spoof) or
``EDM_LOCAL_DEVICE_IDS=0,0`` with ``--device cpu``: chunks of ``n x
lib_block`` rows, slot d taking rows ``[row0 + d * lib_block, ...)``.
The main path at 1, 2 and 3 slots (bucketed and all-E, untiled and
tiled) gives maps equal byte for byte to one slot's and within 1e-5 of
the JAX package's run; a resume that changes the slot count keeps the
bytes; the significance stores at 2 slots equal those at 1; a two-worker
fleet with ``unit_rows=0`` over two slots equals the single process; the
bench's ``fig3`` and ``scale`` run at test sizes with the JAX harness's
row names and keys."""
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.pipeline import run_causal_inference as jax_run  # noqa: E402
from repro.core.types import EDMConfig as JaxConfig  # noqa: E402
from repro.runtime import integrity as jintegrity  # noqa: E402
from repro_torch.core.pipeline import run_causal_inference, slot_spans  # noqa: E402
from repro_torch.core.types import EDMConfig  # noqa: E402
from repro_torch.data.synthetic import dummy_brain  # noqa: E402
from repro_torch.runtime import integrity  # noqa: E402
from repro_torch.runtime.platform import spoof_cpu_devices  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
N, L, E_MAX = 14, 220, 4
WAIT_S = 100


@pytest.fixture(scope="module")
def ts():
    return dummy_brain(N, L, seed=3)


@pytest.fixture(scope="module")
def jax_map(ts):
    return np.asarray(jax_run(ts, JaxConfig(E_max=E_MAX)).rho)


def test_slot_spans_split_a_chunk_as_the_jax_mesh():
    assert slot_spans(0, 9, 3, 3) == [(0, 0, 3), (1, 3, 6), (2, 6, 9)]
    assert slot_spans(12, 2, 3, 3) == [(0, 12, 14)]  # a short last chunk
    assert slot_spans(6, 7, 3, 3) == [(0, 6, 9), (1, 9, 12), (2, 12, 13)]
    assert slot_spans(0, 12, 2, 3) == [(0, 0, 6), (1, 6, 12)]  # a larger chunk


@pytest.mark.parametrize("bucketed", [True, False])
@pytest.mark.parametrize("tile", [0, 5])
def test_main_path_over_slots_equals_one_slot_and_jax(ts, jax_map, bucketed, tile):
    cfg = EDMConfig(E_max=E_MAX, lib_block=3, bucketed=bucketed, target_tile=tile)
    base = run_causal_inference(ts, cfg, device=spoof_cpu_devices(1))
    assert np.abs(base.rho - jax_map).max() <= 1e-5
    for n in (2, 3):
        got = run_causal_inference(ts, cfg, device=spoof_cpu_devices(n))
        assert got.rho.tobytes() == base.rho.tobytes(), n
        assert np.array_equal(got.optE, base.optE)
        assert got.simplex_rho.tobytes() == base.simplex_rho.tobytes()


def _drop_block(out: pathlib.Path, row0: int) -> None:
    (out / f"rows_{row0:08d}.npy").unlink()
    entries = jintegrity.read_manifest_shard(out / "blocks.json")
    del entries[str(row0)]
    (out / "blocks.json").write_text(jintegrity.manifest_with_crc(entries))
    (out / "causal_map" / "data.npy").unlink()


def test_resume_with_another_slot_count_keeps_the_bytes(tmp_path, capsys,
                                                        monkeypatch):
    """A store of chunks of 3 x 2 rows (EDM_LOCAL_DEVICE_IDS=0,0,0): a lost
    block recomputed by one slot, then by two, gives the same bytes, and
    the store of blocks of several heights is fsck-clean."""
    from repro_torch.launch import edm_run

    out = tmp_path / "s"
    argv = ["--synthetic", f"{N}x{L}", "--e-max", str(E_MAX), "--lib-block",
            "2", "--device", "cpu", "--out", str(out)]
    monkeypatch.setenv("EDM_LOCAL_DEVICE_IDS", "0,0,0")
    first = edm_run.main(argv)
    assert first["devices"] == ["cpu"] * 3
    log = capsys.readouterr().out
    assert "ccm rows 0..6 / 14" in log and "ccm rows 12..14 / 14" in log
    before = (out / "causal_map" / "data.npy").read_bytes()
    for ids in ("0", "0,0"):
        _drop_block(out, 6)
        monkeypatch.setenv("EDM_LOCAL_DEVICE_IDS", ids)
        edm_run.main(argv)
        log = capsys.readouterr().out
        assert "ccm rows 6..12 / 14" in log or "ccm rows 6..8 / 14" in log
        assert "ccm rows 0.." not in log
        assert (out / "causal_map" / "data.npy").read_bytes() == before
        assert integrity.fsck_store(out)["clean"]
        assert jintegrity.fsck_store(out)["clean"]


def test_significance_at_two_slots_equals_one(tmp_path):
    from repro_torch.inference import SignificanceConfig, run_significance

    sig = SignificanceConfig(lib_sizes=(40, 80, 150), n_surrogates=5, seed=2)
    ts = dummy_brain(N, L, seed=5)
    stores = {}
    for n, tile in ((1, 0), (2, 0), (2, 4)):
        cfg = EDMConfig(E_max=E_MAX, lib_block=3, target_tile=tile)
        out = tmp_path / f"n{n}_t{tile}"
        res = run_causal_inference(ts, cfg, device=spoof_cpu_devices(n),
                                   out_dir=str(out))
        run_significance(ts, res.optE, np.asarray(res.rho), cfg, sig,
                         device=spoof_cpu_devices(n), out_dir=str(out))
        stores[n, tile] = {a: (out / a / "data.npy").read_bytes() for a in
                           ("causal_map", "rho_conv", "rho_trend", "pvals",
                            "edges")}
    for key in stores:
        assert stores[key] == stores[1, 0], key


def test_two_worker_fleet_over_two_slots_equals_the_single_process(tmp_path,
                                                                   monkeypatch):
    """``unit_rows=0`` is one chunk of the init process's slots (2 x 3
    rows); each worker runs its units over its own two slots."""
    from repro_torch.data import store
    from repro_torch.inference import SignificanceConfig, run_significance
    from repro_torch.launch import edm_fleet

    ts = dummy_brain(16, 250, seed=0)
    cfg = EDMConfig(E_max=E_MAX, lib_block=3, target_tile=6)
    sig = SignificanceConfig(lib_sizes=(40, 80), n_surrogates=6, seed=0)
    ref = tmp_path / "ref"
    res = run_causal_inference(ts, cfg, device="cpu", out_dir=str(ref))
    run_significance(ts, res.optE, np.asarray(res.rho), cfg, sig, device="cpu",
                     out_dir=str(ref))
    store.save_dataset(tmp_path / "ds", ts, {"synthetic": "16x250"})
    monkeypatch.setenv("EDM_LOCAL_DEVICE_IDS", "0,0")
    out = tmp_path / "fleet"
    spec = edm_fleet.init_fleet(out, tmp_path / "ds", cfg, sig, unit_rows=0,
                                device="cpu")
    assert spec["unit_rows"] == 6
    env = dict(os.environ, OMP_NUM_THREADS="1", EDM_LOCAL_DEVICE_IDS="0,0")
    env.pop("EDM_FAULTS", None)
    env.pop("EDM_TELEMETRY", None)
    procs = [edm_fleet.spawn_worker(out, f"w{i}", env=env) for i in range(2)]
    t0 = time.time()
    try:
        for p in procs:
            assert p.wait(timeout=max(1.0, WAIT_S - (time.time() - t0))) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for a in ("causal_map", "rho_conv", "rho_trend", "pvals", "edges"):
        assert (out / a / "data.npy").read_bytes() == \
            (ref / a / "data.npy").read_bytes(), a
    assert integrity.fsck_store(out)["clean"]


@pytest.fixture(scope="module")
def bench_rows(tmp_path_factory):
    out = tmp_path_factory.mktemp("bench")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.bench.run", "fig3", "scale", "--tiny",
         "--device", "cpu", "--out", str(out)],
        capture_output=True, text=True, cwd=str(out), timeout=100,
        env={**os.environ, "PYTHONPATH": str(REPO / "src"), "OMP_NUM_THREADS": "1"},
    )
    assert r.returncode == 0, r.stderr[-3000:]
    return out, [ln.split(",", 2) for ln in r.stdout.splitlines()[1:]]


def test_fig3_rows_are_the_jax_benchs(bench_rows):
    out, rows = bench_rows
    names = [r[0] for r in rows if r[0].startswith("fig3")]
    assert names == ["fig3_workers_1", "fig3_workers_2", "fig3_workers_4"]
    for r in rows:
        if r[0].startswith("fig3"):
            assert "spmd_overhead=" in r[2] and "decomposition_overhead" in r[2]
    d = json.loads((out / "BENCH_fig3.json").read_text())
    assert d["device"] == "cpu" and d["card"] is None


def test_scale_json_has_the_jax_benchs_keys(bench_rows):
    out, rows = bench_rows
    want = json.loads((REPO / "BENCH_scale.json").read_text())
    got = json.loads((out / "BENCH_scale.json").read_text())
    assert set(want) <= set(got), sorted(set(want) - set(got))
    want_cell = next(iter(want["cells"].values()))
    for name, cell in got["cells"].items():
        assert set(want_cell) <= set(cell), name
        assert sorted(cell["sharded"]) == ["sim1", "sim2", "sim4", "sim8"]
        assert all(v["identical"] for v in cell["sharded"].values())
    names = {r[0] for r in rows}
    for N_, L_ in ((16, 120), (32, 200)):
        assert {f"scale_{N_}x{L_}_knn_build", f"scale_{N_}x{L_}_merge",
                f"scale_{N_}x{L_}_sharded_sim8"} <= names
    assert {"scale_model_fish1_normo", "scale_model_subject11"} <= names
