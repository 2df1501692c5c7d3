"""The port's CLI end to end on the CPU against the JAX run: the map
within 1e-5 with the same optE, a store the JAX package's fsck calls
clean, a resume that reproduces the bytes, and a fingerprint of its own.
A port store's bytes are never compared with a JAX store's."""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
import numpy as np  # noqa: E402

from repro.core.pipeline import run_causal_inference as jax_run  # noqa: E402
from repro.core.types import EDMConfig as JaxConfig  # noqa: E402
from repro.data.synthetic import dummy_brain  # noqa: E402
from repro.runtime import integrity as jintegrity  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
N, L, E_MAX = 16, 300, 4


def _port_cli(out, *extra, data=("--synthetic", f"{N}x{L}"), ok=True):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.edm_run", *data,
         "--e-max", str(E_MAX), "--device", "cpu", "--out", str(out), *extra],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert (proc.returncode == 0) == ok, proc.stderr
    return proc.stdout if ok else proc.stderr


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("port_vs_jax")
    port, jax_out = base / "port", base / "jax"
    log = _port_cli(port, "--lib-block", "3")
    jres = jax_run(dummy_brain(N, L), JaxConfig(E_max=E_MAX), out_dir=str(jax_out))
    return {"port": port, "jax": jax_out, "log": log, "jres": jres}


def test_cli_map_matches_jax_run(runs):
    got = np.load(runs["port"] / "causal_map" / "data.npy")
    want = np.asarray(runs["jres"].rho)
    assert got.shape == (N, N) and np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-5
    meta = json.loads((runs["port"] / "causal_map" / "meta.json").read_text())
    assert meta["optE"] == np.asarray(runs["jres"].optE).tolist()
    assert meta["framework"] == "torch" and meta["device"] == "cpu"
    assert f"ccm rows 15..16 / {N}" in runs["log"]


def test_jax_fsck_reads_the_port_store_clean(runs):
    rep = jintegrity.fsck_store(runs["port"])
    assert rep["clean"], jintegrity.render_fsck(rep)
    assert rep["artifacts"]["phase2"]["ok"] == -(-N // 3)
    assert rep["artifacts"]["causal_map"]["status"] == "ok"


def test_port_fingerprint_differs_from_the_jax_run(runs):
    fp = json.loads((runs["port"] / "fingerprint.json").read_text())
    jfp = json.loads((runs["jax"] / "fingerprint.json").read_text())
    assert fp["dataset_crc32"] == jfp["dataset_crc32"]
    assert fp["framework"] == "torch"
    assert fp["fingerprint"] != jfp["fingerprint"]


def test_resume_recomputes_a_lost_block_to_the_same_bytes(runs, tmp_path):
    out = tmp_path / "store"
    shutil.copytree(runs["port"], out)
    before = (out / "causal_map" / "data.npy").read_bytes()
    (out / "rows_00000006.npy").unlink()
    entries = jintegrity.read_manifest_shard(out / "blocks.json")
    del entries["6"]
    (out / "blocks.json").write_text(jintegrity.manifest_with_crc(entries))
    (out / "causal_map" / "data.npy").unlink()
    log = _port_cli(out, "--lib-block", "5")
    assert "ccm rows 6..9 / 16" in log and "ccm rows 0.." not in log
    assert (out / "causal_map" / "data.npy").read_bytes() == before
    assert jintegrity.fsck_store(out)["clean"]


def test_resume_into_a_jax_store_is_refused(runs, tmp_path):
    out = tmp_path / "jax_store"
    shutil.copytree(runs["jax"], out)
    assert "fingerprint mismatch" in _port_cli(out, ok=False)


def test_dataset_flag_reads_a_jax_package_dataset(runs, tmp_path):
    from repro.data import store as jstore

    jstore.save_dataset(tmp_path / "ds", dummy_brain(N, L))
    _port_cli(tmp_path / "out", data=("--dataset", str(tmp_path / "ds")))
    np.testing.assert_array_equal(
        np.load(tmp_path / "out" / "causal_map" / "data.npy"),
        np.load(runs["port"] / "causal_map" / "data.npy"))


def test_in_process_run_without_a_store_equals_the_store(runs):
    from repro_torch.core.pipeline import run_causal_inference
    from repro_torch.core.types import EDMConfig

    timings = {}
    res = run_causal_inference(dummy_brain(N, L), EDMConfig(E_max=E_MAX),
                               device="cpu", timings=timings)
    stored = np.load(runs["port"] / "causal_map" / "data.npy")
    np.testing.assert_array_equal(res.rho, stored)
    assert set(timings) == {"phase1_s", "phase2_s", "assemble_s", "rows"}
    assert timings["rows"] == N
    assert res.simplex_rho.shape == (N, E_MAX)
