"""``repro_torch.runtime.platform`` against the JAX package's
``runtime/platform.py`` (tests/test_platform.py's cases): the tier
registry, the EDM_* contract parsed to the same specs and refused with
the same errors, a one-process world through ``init_distributed``
(idempotent; a conflicting re-init refuses), the run's device list and
``EDM_LOCAL_DEVICE_IDS``, the fleet spec's ``platform`` /
``distributed`` opt-in, and ``edm_run --platform`` with its refusals."""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.runtime import platform as jplatform  # noqa: E402
from repro_torch import engine  # noqa: E402
from repro_torch.runtime import platform  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]


def _run_sub(code: str, extra_env=None):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "OMP_NUM_THREADS": "1"}
    for v in (*platform.RANK_ENV, platform.ENV_LOCAL_DEVICE_IDS):
        env.pop(v, None)
    env.update(extra_env or {})
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          capture_output=True, text=True, env=env, timeout=120,
                          cwd=str(REPO))


def test_tier_registry():
    assert platform.available_tiers() == jplatform.available_tiers() == (
        "cpu", "gpu", "tpu")
    assert platform.default_engine("cpu") == "torch-reference"
    assert platform.default_engine("gpu") == "cuda"
    for name in ("cpu", "gpu"):
        engine.get_engine(platform.default_engine(name))  # must resolve
    rec = platform.apply_platform("cpu")
    assert rec == {"tier": "cpu", "device": "cpu", "engine": "torch-reference"}
    assert platform.current() == rec
    with pytest.raises(ValueError, match="no TPU tier"):
        platform.apply_platform("tpu")
    with pytest.raises(ValueError, match="no TPU tier"):
        platform.default_engine("tpu")
    with pytest.raises(KeyError, match="unknown platform tier"):
        platform.apply_platform("cuda")


ENVS = [
    {},
    {"EDM_COORDINATOR": "head:1234", "EDM_NUM_PROCESSES": "8",
     "EDM_PROCESS_ID": "3", "EDM_LOCAL_DEVICE_IDS": "0,1"},
    {"EDM_COORDINATOR": "head:1234", "EDM_NUM_PROCESSES": "2",
     "EDM_PROCESS_ID": "0"},
    {"EDM_COORDINATOR": "head:1"},
    {"EDM_COORDINATOR": "head:1", "EDM_NUM_PROCESSES": "2"},
    {"EDM_COORDINATOR": "head:1", "EDM_NUM_PROCESSES": "2", "EDM_PROCESS_ID": "2"},
    {"EDM_COORDINATOR": "head:1", "EDM_NUM_PROCESSES": "2", "EDM_PROCESS_ID": "-1"},
    {"EDM_NUM_PROCESSES": "2", "EDM_PROCESS_ID": "1"},
]


@pytest.mark.parametrize("env", ENVS, ids=range(len(ENVS)))
def test_distributed_spec_from_env_matches_jax(env):
    """The same spec, or the same error type and message, as the JAX
    package's function on the same env dict."""
    try:
        want = jplatform.distributed_spec_from_env(env)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            platform.distributed_spec_from_env(env)
        assert str(got.value) == str(e)
    else:
        assert platform.distributed_spec_from_env(env) == want
    if env.get("EDM_LOCAL_DEVICE_IDS"):
        assert want["local_device_ids"] == (0, 1)


def test_init_distributed_one_process_world():
    """A one-rank gloo world through the EDM_* env: the group forms, a
    second init with the same spec returns the first record, a
    conflicting one refuses; describe() reports the membership."""
    r = _run_sub("""
        import socket
        s = socket.socket(); s.bind(("localhost", 0))
        port = s.getsockname()[1]; s.close()
        import os
        os.environ.update(EDM_COORDINATOR=f"localhost:{port}",
                          EDM_NUM_PROCESSES="1", EDM_PROCESS_ID="0")
        import torch.distributed as dist
        from repro_torch.runtime import platform
        info = platform.init_distributed(device="cpu")
        assert info["num_processes"] == 1 and info["process_id"] == 0
        assert info["backend"] == "gloo" and info["device"] == "cpu"
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert platform.init_distributed(device="cpu") == info
        try:
            platform.init_distributed({"coordinator": "x:1",
                                       "num_processes": 2, "process_id": 1},
                                      device="cpu")
        except RuntimeError as e:
            assert "already initialized" in str(e)
        else:
            raise AssertionError("conflicting re-init must refuse")
        assert platform.describe()["distributed"] == info
        assert platform.distributed_info() == info
        dist.destroy_process_group()
        print("distributed OK")
    """)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "distributed OK" in r.stdout


def test_no_coordinator_is_the_one_process_no_op(monkeypatch):
    for v in platform.RANK_ENV:
        monkeypatch.delenv(v, raising=False)
    assert platform.init_distributed() is None
    assert platform.distributed_info() is None


def test_local_devices_and_the_device_id_list():
    cpu = torch.device("cpu")
    assert platform.local_devices("cpu", env={}) == [cpu]
    assert platform.local_devices("cpu", env={"EDM_LOCAL_DEVICE_IDS": "0,0,0"}) \
        == [cpu] * 3
    assert platform.spoof_cpu_devices(3) == [cpu] * 3
    assert platform.local_devices(platform.spoof_cpu_devices(2)) == [cpu] * 2
    assert platform.local_devices(("cpu",)) == [cpu]
    with pytest.raises(ValueError, match="at least one device"):
        platform.spoof_cpu_devices(0)
    with pytest.raises(ValueError, match="empty device list"):
        platform.local_devices([])
    with pytest.raises(ValueError, match="every id is 0"):
        platform.local_devices("cpu", env={"EDM_LOCAL_DEVICE_IDS": "0,1"})
    with pytest.raises(ValueError, match="comma-separated"):
        platform.local_devices("cpu", env={"EDM_LOCAL_DEVICE_IDS": "a,b"})
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        assert platform.local_devices(env={}) == [
            torch.device("cuda", i) for i in range(n)]
        assert platform.local_devices(env={"EDM_LOCAL_DEVICE_IDS": "0,0"}) == [
            torch.device("cuda", 0)] * 2
        with pytest.raises(ValueError, match="outside the"):
            platform.local_devices(env={"EDM_LOCAL_DEVICE_IDS": str(n)})
    else:  # nothing falls back to the CPU
        for dev in (None, "cuda", ["cuda:0"]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                platform.local_devices(dev, env={})


def _dataset(tmp_path):
    from repro_torch.data import store
    from repro_torch.data.synthetic import dummy_brain

    store.save_dataset(tmp_path / "ds", dummy_brain(8, 150, seed=1), {})
    return tmp_path / "ds"


def test_fleet_spec_records_platform_and_distributed(tmp_path, monkeypatch):
    """``init_fleet`` records the tier and the group opt-in; ``unit_rows=0``
    is one chunk of this process's device slots; a worker applies the
    tier and, without EDM_COORDINATOR (as spawned workers run), joins no
    group; a tpu spec is refused at init."""
    from repro_torch.core.types import EDMConfig
    from repro_torch.launch import edm_fleet

    ds = _dataset(tmp_path)
    cfg = EDMConfig(E_max=3, lib_block=3)
    monkeypatch.setenv("EDM_LOCAL_DEVICE_IDS", "0,0")
    for v in platform.RANK_ENV:
        monkeypatch.delenv(v, raising=False)
    spec = edm_fleet.init_fleet(tmp_path / "f", ds, cfg, device="cpu",
                                platform="cpu", distributed=True)
    assert spec["platform"] == "cpu" and spec["distributed"] is True
    assert spec["unit_rows"] == 2 * cfg.lib_block and spec["device"] == "cpu"
    w = edm_fleet.FleetWorker(tmp_path / "f", "w0", progress=False)
    assert w.devs == [torch.device("cpu")] * 2 and w.chunk == 6
    assert platform.current()["tier"] == "cpu"
    with pytest.raises(ValueError, match="no TPU tier"):
        edm_fleet.init_fleet(tmp_path / "g", ds, cfg, device="cpu", platform="tpu")
    assert not (tmp_path / "g" / "fleet.json").exists()


def test_spawned_workers_drop_the_rank_but_keep_their_devices(tmp_path,
                                                              monkeypatch):
    from repro_torch.launch import edm_fleet

    seen = {}

    class FakePopen:
        def __init__(self, cmd, env):
            seen.update(env)

    monkeypatch.setattr(edm_fleet.subprocess, "Popen", FakePopen)
    edm_fleet.spawn_worker(tmp_path, "w0", env={
        "EDM_COORDINATOR": "h:1", "EDM_NUM_PROCESSES": "2",
        "EDM_PROCESS_ID": "1", "EDM_LOCAL_DEVICE_IDS": "1"})
    assert not set(platform.RANK_ENV) & set(seen)
    assert seen["EDM_LOCAL_DEVICE_IDS"] == "1"


def _edm_run(tmp_path, *extra):
    from repro_torch.launch import edm_run

    return edm_run.main(["--synthetic", "8x150", "--e-max", "3",
                         "--out", str(tmp_path / "o"), *extra])


def test_edm_run_platform_cpu_runs_the_plain_engine(tmp_path, capsys):
    got = _edm_run(tmp_path, "--platform", "cpu", "--lib-block", "3")
    assert got["device"] == "cpu" and got["devices"] == ["cpu"]
    out = capsys.readouterr().out
    assert "platform: tier cpu" in out and "engine torch-reference" in out
    meta = json.loads((tmp_path / "o" / "causal_map" / "meta.json").read_text())
    assert meta["engine"] == "torch-reference"
    want = _edm_run(tmp_path / "b", "--device", "cpu", "--lib-block", "3")
    assert np.array_equal(np.asarray(got["result"].rho),
                          np.asarray(want["result"].rho))


@pytest.mark.parametrize("argv,match", [
    (["--platform", "tpu"], "no TPU tier"),
    (["--platform", "gpu", "--device", "cpu"], "conflicts with --platform"),
])
def test_edm_run_refuses_tpu_and_a_conflicting_device(tmp_path, capsys, argv,
                                                      match):
    with pytest.raises(SystemExit) as e:
        _edm_run(tmp_path, *argv)
    assert e.value.code != 0
    assert match in capsys.readouterr().err
    assert not (tmp_path / "o").exists()

