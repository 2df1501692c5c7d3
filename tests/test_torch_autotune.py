"""The port's recorded-timing autotuner (``repro_torch.runtime.autotune``)
against the JAX package's (``repro.runtime.autotune``) on the CPU, and
the port's ``edm_run --autotune / --tune-from / --no-telemetry``.

The JAX tests' decision-rule bodies (tests/test_telemetry.py: chunk
rows, the tile resize in both directions, the pinned kNN tile, the clamp
to N, no telemetry; tests/test_trace.py: the ttl, workers and
stream-depth rules) run through both packages; stores drawn from a numpy
seed and the store of the port's ``edm_run --workers 2 --device cpu``
go through both packages' ``replay``, ``recommend`` and ``apply_to_cfg``,
which must agree exactly.  Then the port's invariants: stores byte-equal
with telemetry on, off and under tuned shapes (untiled and tiled, with
significance), ``--tune-from`` a store without telemetry exits naming
why, and two gloo ranks write p0 / p1 JSONL, one history record, one
tuned.json, and apply the same shapes."""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

from torch_telemetry_fixtures import (  # noqa: E402
    PKGS,
    REPO,
    ctr,
    modules,
    port_fleet_store,
    random_store,
    span,
    write_worker,
)

J, P = modules("repro"), modules("repro_torch")
ARTIFACTS = ("causal_map", "rho_conv", "rho_trend", "pvals", "edges")
RUN = ["--synthetic", "16x300", "--e-max", "4", "--lib-sizes", "40,80",
       "--surrogates", "6", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _clean_telemetry(monkeypatch):
    monkeypatch.delenv("EDM_HISTORY", raising=False)
    monkeypatch.delenv("EDM_TELEMETRY", raising=False)
    for m in (J, P):
        m.telemetry.shutdown()
    yield
    for m in (J, P):
        m.telemetry.shutdown()


@pytest.fixture(params=PKGS)
def pkg(request):
    return modules(request.param)


@pytest.fixture(scope="module")
def fleet_store(tmp_path_factory):
    return port_fleet_store(tmp_path_factory.mktemp("fleet") / "out")


def _store(tmp_path, records, name="synth"):
    d = tmp_path / name
    write_worker(d, "w0", records)
    return d


CHUNK = span("sig", "chunk", 1010.0, 0.0, rows=8, chunk_rows=8, tile=32,
             n_tiles=4)
WRITE = span("store", "write_tile", 1011.0, 0.0)
CAL = ctr("engine", "knn_tile", 1000.0, value=256.0, Lc=400)
NREC = span("assemble", "causal_map", 1012.0, 0.1, N=512)


# ------------------------------------- the JAX tests' bodies, both packages
def test_geometry_rules(pkg, tmp_path):
    d = _store(tmp_path, [{**CHUNK, "dur_s": 4.0}, NREC, CAL], "a")
    t = pkg.autotune.recommend(d)["recommend"]
    assert t["chunk_rows"] == 40 and t["knn_tile_c"] == 256
    d = _store(tmp_path, [{**CHUNK, "dur_s": 4.0}, {**WRITE, "dur_s": 0.5},
                          NREC], "b")
    assert pkg.autotune.recommend(d)["recommend"]["target_tile"] == 64
    d = _store(tmp_path, [{**CHUNK, "dur_s": 40.0}, {**WRITE, "dur_s": 0.0001},
                          NREC], "c")
    assert pkg.autotune.recommend(d)["recommend"]["target_tile"] == 16
    d = _store(tmp_path, [{**CHUNK, "dur_s": 8.0},
                          {**NREC, "attrs": {"N": 24}}], "d")
    assert pkg.autotune.recommend(d)["recommend"]["chunk_rows"] <= 24


def test_no_telemetry_returns_none(pkg, tmp_path):
    assert pkg.autotune.recommend(tmp_path) is None
    with pytest.raises(SystemExit, match="no chunk telemetry"):
        pkg.autotune.main([str(tmp_path)])


def test_ttl_rule(pkg, tmp_path):
    held = [ctr("sig", "held", 1000.0 + i, value=100.0, uid=f"u{i}",
                outcome="done") for i in range(20)]
    d = _store(tmp_path, [{**CHUNK, "dur_s": 4.0}] + held, "a")
    rec = pkg.autotune.recommend(d)["recommend"]
    assert rec["ttl"] == pytest.approx(pkg.autotune.TTL_SAFETY * 100.0)
    d = _store(tmp_path, [{**CHUNK, "dur_s": 4.0},
                          ctr("sig", "held", 1000.0, value=0.5, uid="u0")], "b")
    assert pkg.autotune.recommend(d)["recommend"]["ttl"] == pkg.autotune.TTL_MIN
    d = _store(tmp_path, [{**CHUNK, "dur_s": 4.0}], "c")
    assert "ttl" not in pkg.autotune.recommend(d)["recommend"]


def test_workers_rule(pkg, tmp_path):
    chunks = [{**CHUNK, "dur_s": 40.0, "t": 1000.0 + i} for i in range(10)]
    for value, want in ((10.0, 10), (40.0, 2)):
        held = [ctr("sig", "held", 2000.0 + i, value=value, uid=f"u{i}")
                for i in range(20)]
        d = _store(tmp_path, chunks + held, f"w{want}")
        assert pkg.autotune.recommend(d)["recommend"]["workers"] == want


@pytest.mark.parametrize("gather,depth,want", [(2.0, 2, 3), (0.05, 3, 2),
                                               (0.5, 2, 2), (9.0, 4, 4)])
def test_stream_depth_rule(pkg, tmp_path, gather, depth, want):
    d = _store(tmp_path, [
        {**CHUNK, "dur_s": 10.0},
        span("phase2", "drain", 1011.0, gather + 0.01, tag="(0, 8)",
             in_flight=0, depth=depth, gather_s=gather)])
    assert pkg.autotune.recommend(d)["recommend"]["stream_depth"] == want
    assert want <= pkg.autotune.DEPTH_MAX


def test_write_load_roundtrip(pkg, tmp_path):
    d = _store(tmp_path, [{**CHUNK, "dur_s": 4.0}, NREC, CAL])
    tuned = pkg.autotune.recommend(d)
    p = pkg.autotune.write_tuned(d, tuned)
    assert p == d / "tuned.json" and pkg.autotune.load_tuned(d) == tuned
    assert pkg.autotune.load_tuned(tmp_path) is None
    p.write_text("{broken")
    assert pkg.autotune.load_tuned(d) is None


# ---------------------------------------------- the two packages, exactly
def _same_tuning(out):
    assert J.autotune.replay(out) == P.autotune.replay(out)
    tj, tp = J.autotune.recommend(out), P.autotune.recommend(out)
    assert tj == tp
    if tp is None:
        return tp
    from repro.core.types import EDMConfig as JaxConfig
    from repro_torch.core.types import EDMConfig

    fields = ("lib_block", "target_tile", "knn_tile_c", "stream_depth")
    for n_devices in (1, 2, 3):
        cj = J.autotune.apply_to_cfg(JaxConfig(E_max=4), tj, n_devices)
        cp = P.autotune.apply_to_cfg(EDMConfig(E_max=4), tp, n_devices)
        assert [getattr(cj, f) for f in fields] == [getattr(cp, f) for f in fields]
    return tp


@pytest.mark.parametrize("seed", range(6))
def test_seeded_stores_tune_as_the_jax_package(seed, tmp_path):
    tuned = _same_tuning(random_store(tmp_path, seed))
    assert set(tuned["recommend"]) >= {"chunk_rows", "target_tile",
                                       "knn_tile_c", "stream_depth", "ttl"}


def test_port_fleet_store_tunes_as_the_jax_package(fleet_store):
    """edm_run's run_config (workers, stream depth), the workers'
    chunk spans with their chunk_rows, drains and held counters."""
    ev = _same_tuning(fleet_store)["evidence"]
    assert ev["rec_workers"] == 2 and ev["rec_depth"] == 2
    assert ev["rec_chunk_rows"] == 8 and ev["held_n"] > 0


# --------------------------------------- the port's cap on a card's memory
#: the peak's slope in library rows measured on an H100 at 2,048 x 1,450,
#: E_max 20 (PERF.md, the autotune phase of chip_smoke.py)
MEASURED_ROW_BYTES = 25.97e6


def test_chunk_row_bytes_bound_the_measured_slope():
    """From the shapes alone (E_max tables, the most a bucketed run has):
    at or above the slope measured on the card, by at most a quarter."""
    from repro_torch.core.types import EDMConfig

    cfg = EDMConfig(E_max=20)
    row = P.autotune.chunk_row_bytes(cfg, 2048, 1450)
    assert MEASURED_ROW_BYTES <= row <= 1.25 * MEASURED_ROW_BYTES
    # the target block bounds the lookup's share: a wider map adds its rho
    # rows only, a narrower tile shrinks it; the bf16 distances save bytes
    assert (P.autotune.chunk_row_bytes(cfg, 16384, 1450) - row
            == 4 * (16384 - 2048) * (cfg.stream_depth + 1))
    import dataclasses

    assert P.autotune.chunk_row_bytes(dataclasses.replace(cfg, target_tile=512),
                                      2048, 1450) < row
    assert P.autotune.chunk_row_bytes(dataclasses.replace(cfg, dist_dtype="bfloat16"),
                                      2048, 1450) < row
    assert P.autotune.chunk_row_bytes(cfg, 2048, 1450, n_tables=4) < row


@pytest.mark.parametrize("chunk_rows,n_devices", [(16384, 1), (16384, 2), (8192, 1),
                                                  (2048, 1)])
def test_apply_caps_lib_block_to_a_stated_device_memory(chunk_rows, n_devices):
    """With the memory a slot may use, lib_block is the largest whose chunk
    fits FIT_SHARE of it (never above the recommendation); without it, or
    where the recommendation fits, the JAX package's apply exactly."""
    import dataclasses

    from repro.core.types import EDMConfig as JaxConfig
    from repro_torch.core.types import EDMConfig

    tuned = {"recommend": {"chunk_rows": chunk_rows, "target_tile": 1024,
                           "stream_depth": 3}}
    N, L, card = 16384, 1450, 80 * 10 ** 9
    want = J.autotune.apply_to_cfg(JaxConfig(E_max=20), tuned, n_devices)
    plain = P.autotune.apply_to_cfg(EDMConfig(E_max=20), tuned, n_devices)
    fields = ("lib_block", "target_tile", "knn_tile_c", "stream_depth")
    assert [getattr(plain, f) for f in fields] == [getattr(want, f) for f in fields]
    capped = P.autotune.apply_to_cfg(EDMConfig(E_max=20), tuned, n_devices, card, N, L)
    assert dataclasses.replace(capped, lib_block=plain.lib_block) == plain

    def chunk(lib_block):
        return (P.autotune.run_fixed_bytes(plain, N, L)
                + lib_block * P.autotune.chunk_row_bytes(plain, N, L))

    share = P.autotune.FIT_SHARE * card
    assert capped.lib_block <= plain.lib_block and chunk(capped.lib_block) <= share
    assert capped.lib_block == plain.lib_block or chunk(capped.lib_block + 1) > share
    huge = P.autotune.apply_to_cfg(EDMConfig(E_max=20), tuned, n_devices, 10 ** 15, N, L)
    assert huge == plain


def test_slot_free_bytes_is_none_off_the_card():
    import torch

    from repro_torch.launch import edm_run

    assert edm_run._slot_free_bytes([torch.device("cpu")] * 2, None, 3) is None


# ---------------------------------------------------- the port's edm_run
def _bytes(out) -> dict:
    return {a: (out / a / "data.npy").read_bytes() for a in ARTIFACTS}


@pytest.mark.parametrize("tile", [[], ["--target-tile", "5"]])
def test_stores_equal_with_telemetry_on_off_and_tuned(tile, tmp_path):
    """A: telemetry on with --autotune (records, writes tuned.json); B:
    --autotune --tune-from A (applies it: other shapes); C:
    --no-telemetry.  Every artifact byte-equal; C leaves no telemetry/,
    no history.jsonl; A's tuned.json is a fresh recommendation of A."""
    from repro_torch.launch import edm_run

    a, b, c = (tmp_path / x for x in "abc")
    sa = edm_run.main([*RUN, *tile, "--autotune", "--out", str(a)])
    sb = edm_run.main([*RUN, *tile, "--autotune", "--tune-from", str(a),
                       "--out", str(b)])
    edm_run.main([*RUN, *tile, "--no-telemetry", "--out", str(c)])
    assert _bytes(a) == _bytes(b) == _bytes(c)
    assert not (c / "telemetry").exists() and not (c / "history.jsonl").exists()
    assert sa["autotune"]["applied"] is None
    assert json.loads((a / "tuned.json").read_text()) == sa["autotune"]["wrote"]
    assert sa["autotune"]["wrote"]["recommend"] == P.autotune.recommend(a)["recommend"]
    applied = sb["autotune"]["applied"]
    assert applied == sa["autotune"]["wrote"]["recommend"]
    assert (sb["lib_block"], sb["target_tile"]) != (sa["lib_block"], sa["target_tile"])
    assert sb["lib_block"] == applied["chunk_rows"]


def test_tune_from_a_store_without_telemetry_exits_naming_why(tmp_path):
    from repro_torch.launch import edm_run

    src = tmp_path / "off"
    edm_run.main([*RUN, "--no-telemetry", "--out", str(src)])
    with pytest.raises(SystemExit, match="no tuned.json and no chunk "
                       "telemetry to replay"):
        edm_run.main([*RUN, "--autotune", "--tune-from", str(src),
                      "--out", str(tmp_path / "b")])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_share_the_tuned_shapes(tmp_path):
    """Each rank its own JSONL (p0, p1, no main); rank 0 alone writes the
    history record and tuned.json; both ranks apply rank 0's tuned
    shapes; the bytes equal one process's."""
    from repro_torch.launch import edm_run

    src, one, out = tmp_path / "src", tmp_path / "one", tmp_path / "ranks"
    edm_run.main([*RUN, "--autotune", "--out", str(src)])
    edm_run.main([*RUN, "--no-telemetry", "--out", str(one)])
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "OMP_NUM_THREADS": "1"}
    for k in ("EDM_LOCAL_DEVICE_IDS", "EDM_FAULTS"):
        env.pop(k, None)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.edm_run", *RUN, "--autotune",
         "--tune-from", str(src), "--out", str(out)],
        env={**env, "EDM_COORDINATOR": f"localhost:{port}",
             "EDM_NUM_PROCESSES": "2", "EDM_PROCESS_ID": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], logs
    applied = [ln for log in logs for ln in log.splitlines()
               if ln.startswith("autotune: applied ")]
    assert len(applied) == 2 and applied[0] == applied[1]
    want = json.loads((src / "tuned.json").read_text())["recommend"]
    assert applied[0] == f"autotune: applied {want} from {src}"
    assert sorted(p.name for p in (out / "telemetry").iterdir()) == [
        "p0.jsonl", "p1.jsonl"]
    assert len(P.history.load_history(out / "history.jsonl")) == 1
    assert sum("autotune: wrote" in log for log in logs) == 1
    assert (out / "tuned.json").exists()
    assert _bytes(out) == _bytes(one)
    # each rank records the world's chunk height and the world's rows
    rows = {}
    for _, rec in P.telemetry.iter_store_records(out):
        if rec["name"] == "chunk" and rec["stage"] == "phase2":
            assert rec["attrs"]["chunk_rows"] == 2 * (want["chunk_rows"] // 2)
            rows.setdefault(rec["worker"], 0)
            rows[rec["worker"]] += rec["attrs"]["rows"]
    assert rows["p0"] == 16 and 0 < rows["p1"] <= 16  # rank 0 is in every chunk
    assert np.array_equal(np.load(out / "causal_map" / "data.npy"),
                          np.load(one / "causal_map" / "data.npy"))
