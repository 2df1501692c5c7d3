"""The port stands alone: it imports neither jax nor the JAX package, and
its entry points run on the card by default — without one they raise
instead of silently running on the CPU."""
import os
import pathlib
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402,F401  (the tests run both packages; jax stays on the CPU)
import numpy as np  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def _port_modules():
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(REPO / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    mods = list(_port_modules())
    assert len(mods) > 20
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print(repr(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")},
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


_BAD_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:\.|\s|$)", re.M)


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py")) + ["chip_smoke.py"],
)
def test_source_has_no_jax_or_repro_import(path):
    text = (REPO / path).read_text()
    assert not _BAD_IMPORT.findall(text), f"{path} imports jax or repro"


def test_run_causal_inference_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from repro_torch.core.pipeline import run_causal_inference, run_phase1
    from repro_torch.core.types import EDMConfig

    ts = np.random.default_rng(0).standard_normal((4, 120)).astype(np.float32)
    cfg = EDMConfig(E_max=3)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_causal_inference(ts, cfg, **kw)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_phase1(ts, cfg, **kw)


def test_run_significance_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from repro_torch.core.types import EDMConfig
    from repro_torch.inference import SignificanceConfig, run_significance

    ts = np.random.default_rng(0).standard_normal((4, 120)).astype(np.float32)
    sig = SignificanceConfig(lib_sizes=(20, 40), n_surrogates=3)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_significance(ts, np.full(4, 2, np.int32), np.zeros((4, 4)),
                             EDMConfig(E_max=3), sig, **kw)


def test_edm_run_cli_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from repro_torch.launch import edm_run

    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            edm_run.main(["--synthetic", "4x120", "--e-max", "3",
                          "--out", str(tmp_path / "o"), *extra])
    assert not (tmp_path / "o" / "causal_map").exists()


def test_edm_run_fleet_defaults_to_the_card(tmp_path):
    """``--workers`` without ``--device``: the supervisor refuses before it
    spawns a worker (the engine's limits are checked on the card)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from repro_torch.launch import edm_run

    with pytest.raises(RuntimeError, match="no CUDA device"):
        edm_run.main(["--synthetic", "4x120", "--e-max", "3", "--workers", "2",
                      "--out", str(tmp_path / "o")])
    assert not (tmp_path / "o" / "fleet.json").exists()
    assert not (tmp_path / "o" / "queue").exists()


@pytest.mark.parametrize("flag", ["--no-telemetry", "--autotune", "--tune-from"])
def test_edm_run_telemetry_and_autotune_flags_run(flag, tmp_path, capsys):
    """Each flag of the telemetry trio runs on the CPU: ``--no-telemetry``
    leaves no telemetry and no history; ``--autotune`` records, keeps the
    run's history and writes ``tuned.json``; ``--tune-from`` applies
    another store's recommendation (``--target-tile`` and
    ``--no-bucketed``: tests/test_torch_tiling.py; the fleet's flags:
    tests/test_torch_fleet.py; ``--engine`` and ``--use-kernels``:
    tests/test_torch_engine_check.py; the byte equality of every shape:
    tests/test_torch_autotune.py)."""
    from repro_torch.launch import edm_run

    base = ["--synthetic", "12x120", "--e-max", "3", "--device", "cpu"]
    src = tmp_path / "src"
    if flag == "--tune-from":
        edm_run.main([*base, "--out", str(src)])
    out = tmp_path / "out"
    extra = {"--no-telemetry": [flag], "--autotune": [flag],
             "--tune-from": ["--autotune", flag, str(src)]}[flag]
    summary = edm_run.main([*base, "--out", str(out), *extra])
    text = capsys.readouterr().out
    if flag == "--no-telemetry":
        assert not (out / "telemetry").exists()
        assert not (out / "history.jsonl").exists()
    elif flag == "--autotune":
        assert (out / "telemetry" / "main.jsonl").exists()
        assert (out / "history.jsonl").exists() and (out / "tuned.json").exists()
        assert summary["autotune"]["wrote"]["recommend"]["chunk_rows"] >= 8
    else:
        applied = summary["autotune"]["applied"]
        assert f"autotune: applied {applied} from {src}" in text
        assert summary["lib_block"] == applied["chunk_rows"]


@pytest.mark.parametrize("module", [
    "repro_torch.models.moe", "repro_torch.models.ssm", "repro_torch.optim.schedule",
    "repro_torch.optim.adamw", "repro_torch.optim.adafactor",
    "repro_torch.optim.grad_compress", "repro_torch.checkpoint.manager",
    "repro_torch.runtime.fault", "repro_torch.launch.train", "repro_torch.launch.steps",
])
def test_lm_family_modules_load_no_jax_and_no_repro(module):
    """The MoE and Mamba2 layers and the training path (optimizers,
    schedules, checkpoints, the resilient loop, the train CLI and steps)
    are among the modules above and import neither package on their own."""
    assert module in list(_port_modules())
    code = (
        "import importlib, sys\n"
        f"importlib.import_module({module!r})\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")}, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_platform_module_loads_no_jax_and_no_repro():
    """The platform layer (tiers, device slots, the EDM_* group contract)
    is among the modules above and imports neither package on its own."""
    assert "repro_torch.runtime.platform" in list(_port_modules())
    code = (
        "import sys\n"
        "import repro_torch.runtime.platform as p\n"
        "assert p.available_tiers() == ('cpu', 'gpu', 'tpu')\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(REPO / "src")}, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
