"""The records the port's ``edm_run`` emits against the JAX package's:
the two CLIs over the same 16 x 300 series at E_max 4 (each package's
reference engine, on the CPU, each in its own process), untiled, in
column tiles and with the significance stage, write the same set of
(kind, stage, name) records, each with the same attribute keys.  The one
record left out is the JAX package's ``compile_cache`` counter (its probe
of XLA's compilation cache, which the port has no counterpart of)."""
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from torch_telemetry_fixtures import REPO  # noqa: E402

RUN = ["--synthetic", "16x300", "--e-max", "4"]
JAX_ONLY = {"compile_cache"}


def _records(out) -> dict:
    """{(kind, stage, name): attribute keys} over every JSONL of ``out``."""
    got: dict = {}
    for p in sorted((out / "telemetry").glob("*.jsonl")):
        for line in p.read_text().splitlines():
            rec = json.loads(line)
            if rec["name"] in JAX_ONLY:
                continue
            got.setdefault((rec["kind"], rec["stage"], rec["name"]),
                           set()).update(rec["attrs"])
    return got


def _run(module, out, *argv):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "OMP_NUM_THREADS": "1",
           "JAX_PLATFORMS": "cpu"}
    for k in ("EDM_TELEMETRY", "EDM_HISTORY", "EDM_COORDINATOR",
              "EDM_NUM_PROCESSES", "EDM_PROCESS_ID", "EDM_LOCAL_DEVICE_IDS"):
        env.pop(k, None)
    proc = subprocess.run([sys.executable, "-m", module, *RUN, *argv, "--out",
                           str(out)], env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]


@pytest.mark.parametrize("extra", [[], ["--target-tile", "5"],
                                   ["--lib-sizes", "40,80", "--surrogates", "6"]])
def test_edm_run_emits_the_jax_record_set(tmp_path, extra):
    _run("repro.launch.edm_run", tmp_path / "jax", *extra)
    _run("repro_torch.launch.edm_run", tmp_path / "port", *extra,
         "--device", "cpu", "--engine", "torch-reference")
    want, got = _records(tmp_path / "jax"), _records(tmp_path / "port")
    assert got == want
    names = {name for _, _, name in got}
    assert {"clock_anchor", "run_config", "knn_tile", "chunk", "device_put",
            "drain", "causal_map"} <= names
