"""Rows across ranks on the CPU: ``edm_run`` as W ``gloo`` ranks on
localhost (one process a rank, joined through the EDM_* contract), each
rank computing its share of every chunk (``core/pipeline.py::rank_plan``)
into its own manifest shard.

Held: the map, optE and every significance artifact byte-equal to one
process's; the map within 1e-5 of the JAX package's run with optE equal;
both packages' fsck call a rank-written store clean; a crash (or a
raise) armed in rank 1 after its first phase-2 block ends every rank
non-zero within the test's deadline, and a rerun at another world size
recomputes exactly the rows no shard covers, to the same bytes; the
in-process API without ``out_dir`` returns the whole map on every rank;
``--workers`` with the EDM_* variables still runs the fleet.  Every
world runs under one deadline; past it every rank is killed."""
import json
import os
import pathlib
import re
import shutil
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.pipeline import run_causal_inference as jax_run  # noqa: E402
from repro.core.types import EDMConfig as JaxConfig  # noqa: E402
from repro.data.synthetic import dummy_brain  # noqa: E402
from repro.runtime import integrity as jintegrity  # noqa: E402
from repro_torch.core.pipeline import rank_plan  # noqa: E402
from repro_torch.data.store import TileWriter  # noqa: E402
from repro_torch.runtime import integrity  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
DEADLINE_S = 150
N, L, E_MAX, LIB_BLOCK = 16, 300, 4, 3
ARGS = ("--synthetic", f"{N}x{L}", "--e-max", str(E_MAX), "--lib-block",
        str(LIB_BLOCK), "--device", "cpu")
SIG_ARGS = ("--lib-sizes", "40,80", "--surrogates", "6")
ARTIFACTS = ("causal_map", "rho_conv", "rho_trend", "pvals", "edges")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(extra=None) -> dict:
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "OMP_NUM_THREADS": "1"}
    for k in ("EDM_LOCAL_DEVICE_IDS", "EDM_FAULTS", "EDM_COORDINATOR",
              "EDM_NUM_PROCESSES", "EDM_PROCESS_ID"):
        env.pop(k, None)
    return {**env, **(extra or {})}


def run_ranks(W: int, out, *extra, code=None, slots=1, env_of=None):
    """W ranks of ``edm_run`` (or of ``code``, argv[1] = out) on
    localhost, rank r with ``env_of(r)`` added; (return codes, logs,
    seconds until the last rank ended).  Every rank is killed at the
    deadline."""
    port = _free_port()
    procs = []
    t0 = time.time()
    for r in range(W):
        env = _env({"EDM_COORDINATOR": f"localhost:{port}",
                    "EDM_NUM_PROCESSES": str(W), "EDM_PROCESS_ID": str(r),
                    **({"EDM_LOCAL_DEVICE_IDS": ",".join(["0"] * slots)}
                       if slots > 1 else {}),
                    **(env_of(r) if env_of else {})})
        cmd = ([sys.executable, "-c", code, str(out)] if code else
               [sys.executable, "-m", "repro_torch.launch.edm_run", *ARGS,
                "--out", str(out), *extra])
        procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    t_end = t0 + DEADLINE_S
    try:
        for p in procs:
            p.wait(timeout=max(0.1, t_end - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        logs = [p.communicate()[0] for p in procs]
    return [p.returncode for p in procs], logs, time.time() - t0


def _ok(rcs, logs):
    assert rcs == [0] * len(rcs), "\n".join(
        f"rank {r} rc {rc}:\n{log[-3000:]}" for r, (rc, log) in
        enumerate(zip(rcs, logs)))


def _one_process(out, *extra):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.edm_run", *ARGS, "--out",
         str(out), *extra], env=_env(), capture_output=True, text=True,
        timeout=DEADLINE_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _rows(log: str) -> list[tuple[int, int]]:
    return [(int(a), int(b)) for a, b in re.findall(r"ccm rows (\d+)\.\.(\d+) /", log)]


def _record(log: str) -> dict:
    m = re.search(r"^rank \d+/\d+ done in [0-9.]+s (\{.*\})$", log, re.M)
    assert m, log[-2000:]
    return json.loads(m.group(1))


def _same_bytes(a, b, name="causal_map"):
    return (pathlib.Path(a) / name / "data.npy").read_bytes() == \
        (pathlib.Path(b) / name / "data.npy").read_bytes()


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    base = tmp_path_factory.mktemp("one_process")
    _one_process(base / "main")
    _one_process(base / "sig", *SIG_ARGS)
    jres = jax_run(dummy_brain(N, L), JaxConfig(E_max=E_MAX))
    return {"main": base / "main", "sig": base / "sig", "jax": jres}


# W ranks x local slots a rank; one world in column tiles (col_order.npy
# by rank 0 alone)
WORLDS = {"W2": (2, 1, ()), "W3": (3, 1, ()),
          "W2_two_slots_tiled": (2, 2, ("--target-tile", "5"))}


@pytest.fixture(scope="module", params=sorted(WORLDS))
def world(request, tmp_path_factory):
    W, slots, extra = WORLDS[request.param]
    out = tmp_path_factory.mktemp(request.param) / "store"
    rcs, logs, _ = run_ranks(W, out, *extra, slots=slots)
    _ok(rcs, logs)
    return {"W": W, "slots": slots, "out": out, "logs": logs}


def test_rank_store_equals_one_process(world, single):
    out = world["out"]
    assert _same_bytes(out, single["main"])
    got = json.loads((out / "causal_map" / "meta.json").read_text())
    want = json.loads((single["main"] / "causal_map" / "meta.json").read_text())
    assert got["optE"] == want["optE"] and got["ranks"] == world["W"]
    W = world["W"]
    shards = sorted(p.name for p in out.glob("blocks*.json"))
    assert shards == [f"blocks.rank{r}.json" for r in range(W)]


def test_each_rank_computes_its_share_of_every_chunk(world):
    """Rank r's progress lines are exactly its rows of each chunk of
    W x slots x lib_block rows, and its record counts them."""
    W, slots = world["W"], world["slots"]
    chunk = W * slots * LIB_BLOCK
    plan = [(r, min(chunk, N - r)) for r in range(0, N, chunk)]
    for r, log in enumerate(world["logs"]):
        want = rank_plan(plan, slots, LIB_BLOCK, r, W)
        assert _rows(log) == [(r0, r0 + n) for r0, n in want]
        rec = _record(log)
        assert (rec["rank"], rec["world"]) == (r, W)
        assert rec["rows"] == sum(n for _, n in want)
        assert len(rec["devices"]) == slots
        assert f"rank {r}/{W} (" in log  # the summary line names the rank


def test_rank_map_matches_jax_run(world, single):
    got = np.load(world["out"] / "causal_map" / "data.npy")
    want = np.asarray(single["jax"].rho)
    assert np.abs(got - want).max() <= 1e-5
    meta = json.loads((world["out"] / "causal_map" / "meta.json").read_text())
    assert meta["optE"] == np.asarray(single["jax"].optE).tolist()


@pytest.mark.parametrize("fsck", ["port", "jax"])
def test_both_fscks_read_a_rank_store_clean(world, fsck):
    mod = integrity if fsck == "port" else jintegrity
    rep = mod.fsck_store(world["out"])
    assert rep["clean"], rep
    assert rep["artifacts"]["causal_map"]["status"] == "ok"


# ------------------------------------------------------------ significance
@pytest.fixture(scope="module")
def sig_world(tmp_path_factory):
    out = tmp_path_factory.mktemp("sig_W2") / "store"
    rcs, logs, _ = run_ranks(2, out, *SIG_ARGS)
    _ok(rcs, logs)
    return out


@pytest.mark.parametrize("artifact", ARTIFACTS)
def test_significance_across_ranks_equals_one_process(sig_world, single, artifact):
    assert _same_bytes(sig_world, single["sig"], artifact)
    assert sorted(p.name for p in (sig_world / "pvals").glob("blocks*.json")) \
        == ["blocks.rank0.json", "blocks.rank1.json"]


@pytest.mark.parametrize("fsck", ["port", "jax"])
def test_both_fscks_read_a_rank_significance_store_clean(sig_world, fsck):
    mod = integrity if fsck == "port" else jintegrity
    rep = mod.fsck_store(sig_world)
    assert rep["clean"], rep


# ----------------------------------------------------------------- failure
@pytest.fixture(scope="module", params=["crash", "error"])
def crashed(request, tmp_path_factory):
    """Two ranks, rank 1 armed to die (SIGKILL) or raise at its second
    block's rename: after its first phase-2 block is durable."""
    out = tmp_path_factory.mktemp(f"crashed_{request.param}") / "store"
    arm = {"EDM_FAULTS": f"tile_pre_rename:{request.param}@2"}
    rcs, logs, secs = run_ranks(2, out, env_of=lambda r: arm if r == 1 else {})
    return {"out": out, "rcs": rcs, "logs": logs, "secs": secs}


def test_a_rank_failure_ends_every_rank_nonzero(crashed):
    rcs, logs = crashed["rcs"], crashed["logs"]
    assert None not in rcs, "a rank was still running at the deadline"
    assert all(rc != 0 for rc in rcs), rcs
    assert crashed["secs"] < DEADLINE_S
    assert "another rank failed" in logs[0], logs[0][-2000:]
    cov = TileWriter(crashed["out"], N).covered()
    assert 0 < cov.sum() < N  # rank 1's first block, rank 0's blocks


def test_a_dead_rank_is_noticed_within_the_stage(tmp_path):
    """With a chunk of two rows (eight a rank), rank 0 meets rank 1 at
    every chunk of phase 2, so it notices rank 1's death there, naming
    the stage, and not only at the end of its share."""
    arm = {"EDM_FAULTS": "tile_pre_rename:crash@2"}
    rcs, logs, _ = run_ranks(2, tmp_path / "store", "--lib-block", "1",
                             env_of=lambda r: arm if r == 1 else {})
    assert None not in rcs and all(rc != 0 for rc in rcs), rcs
    assert "another rank failed before 'phase 2, rows from" in logs[0], \
        logs[0][-2000:]


@pytest.mark.parametrize("W", [1, 3])
def test_rerun_at_another_world_size_recomputes_only_uncovered_rows(
        crashed, single, W, tmp_path):
    out = tmp_path / "store"
    shutil.copytree(crashed["out"], out)
    uncovered = set(np.nonzero(~TileWriter(out, N).covered())[0].tolist())
    if W == 1:
        logs = [_one_process(out)]
    else:
        rcs, logs, _ = run_ranks(W, out)
        _ok(rcs, logs)
    redone = [i for log in logs for a, b in _rows(log) for i in range(a, b)]
    assert sorted(redone) == sorted(uncovered)
    assert _same_bytes(out, single["main"])
    assert integrity.fsck_store(out)["clean"]


# ------------------------------------------------------- in process, no store
IN_PROCESS = textwrap.dedent("""
    import pathlib, sys
    import numpy as np
    import torch.distributed as dist
    from repro_torch.core.pipeline import run_causal_inference, run_phase1
    from repro_torch.core.types import EDMConfig
    from repro_torch.data.synthetic import dummy_brain
    from repro_torch.inference import SignificanceConfig, run_significance
    from repro_torch.runtime import platform

    out = pathlib.Path(sys.argv[1])
    info = platform.init_distributed(device="cpu")
    ts = dummy_brain(%d, %d)
    cfg = EDMConfig(E_max=%d, lib_block=%d)
    res = run_causal_inference(ts, cfg, device="cpu", group=dist.group.WORLD)
    p1_rho, p1_optE = run_phase1(ts, cfg, device="cpu", group=dist.group.WORLD)
    sig = run_significance(ts, res.optE, res.rho, cfg,
                           SignificanceConfig(lib_sizes=(40, 80), n_surrogates=6),
                           device="cpu", group=dist.group.WORLD)
    np.savez(out / f"rank{info['process_id']}.npz", rho=res.rho, optE=res.optE,
             simplex_rho=res.simplex_rho, p1_rho=p1_rho, p1_optE=p1_optE,
             drho=sig.drho, trend=sig.trend,
             pvals=sig.pvals, edges=sig.edges)
    dist.destroy_process_group()
""" % (N, L, E_MAX, LIB_BLOCK))


def test_in_process_api_without_a_store_returns_the_whole_map_on_every_rank(
        tmp_path):
    from repro_torch.core.pipeline import run_causal_inference
    from repro_torch.core.types import EDMConfig
    from repro_torch.data.synthetic import dummy_brain as tdummy
    from repro_torch.inference import SignificanceConfig, run_significance

    rcs, logs, _ = run_ranks(2, tmp_path, code=IN_PROCESS)
    _ok(rcs, logs)
    ts = tdummy(N, L)
    cfg = EDMConfig(E_max=E_MAX, lib_block=LIB_BLOCK)
    res = run_causal_inference(ts, cfg, device="cpu")
    sig = run_significance(ts, res.optE, res.rho, cfg,
                           SignificanceConfig(lib_sizes=(40, 80), n_surrogates=6),
                           device="cpu")
    want = {"rho": res.rho, "optE": res.optE, "simplex_rho": res.simplex_rho,
            "p1_rho": res.simplex_rho, "p1_optE": res.optE,
            "drho": sig.drho, "trend": sig.trend, "pvals": sig.pvals,
            "edges": sig.edges}
    for r in range(2):
        got = np.load(tmp_path / f"rank{r}.npz")
        for name, a in want.items():
            assert got[name].tobytes() == np.asarray(a).tobytes(), (r, name)


# ------------------------------------------------------------------- fleet
def test_workers_with_the_rank_variables_still_run_the_fleet(single, tmp_path):
    """Two EDM_* ranks with ``--workers 1`` each: each rank supervises a
    fleet over the one store, as before rows across ranks existed."""
    out = tmp_path / "store"
    rcs, logs, _ = run_ranks(2, out, "--workers", "1")
    _ok(rcs, logs)
    assert all("fleet[1] causal map" in log for log in logs)
    assert not any(re.search(r"^rank \d+/\d+ done", log, re.M) for log in logs)
    assert (out / "fleet.json").exists()
    assert _same_bytes(out, single["main"])


# ------------------------------------------------------------- unit checks
@pytest.mark.parametrize("W,n,lib_block,N", [(1, 1, 3, 16), (2, 1, 3, 16),
                                             (3, 1, 2, 17), (2, 2, 3, 16),
                                             (4, 3, 5, 101)])
def test_rank_plan_splits_every_chunk_as_the_global_mesh(W, n, lib_block, N):
    """The ranks' shares of a chunk are the global slots' rows, process-
    major, disjoint and covering it; one rank's plan is the plan."""
    from repro_torch.core.pipeline import slot_spans

    chunk = W * n * lib_block
    plan = [(r, min(chunk, N - r)) for r in range(0, N, chunk)]
    shares = [rank_plan(plan, n, lib_block, r, W) for r in range(W)]
    for row0, valid in plan:
        rows = []
        for r in range(W):
            mine = [(a, b) for d, a, b in slot_spans(row0, valid, W * n, lib_block)
                    if r * n <= d < (r + 1) * n]
            got = [(a, a + k) for a, k in shares[r] if row0 <= a < row0 + valid]
            assert got == ([(mine[0][0], mine[-1][1])] if mine else [])
            rows += [i for a, b in got for i in range(a, b)]
        assert rows == list(range(row0, row0 + valid))
    assert rank_plan(plan, n, lib_block) == plan  # a world of one rank


def test_one_process_exchanges_are_no_ops():
    from repro_torch.runtime.ranks import Ranks

    one = Ranks(None)
    assert (one.rank, one.world, one.lead, one.writer_id) == (0, 1, True, None)
    one.barrier("x")
    assert one.share(7, "x") == 7 and one.chunk_checks(5, "x") is None
    counts = np.arange(3)
    assert one.sum(counts, "x") is counts
    m = np.zeros((2, 2))
    one.gather_rows([m], [(0, 1)], "x")
    assert not m.any()


def test_rank_devices():
    from repro_torch.runtime import platform

    spec = {"coordinator": "localhost:1", "num_processes": 2, "process_id": 1}
    cpu = torch.device("cpu")
    assert platform.rank_devices(spec, "cpu") == [cpu]
    two = {**spec, "local_device_ids": (0, 0)}
    assert platform.rank_devices(two, "cpu") == [cpu, cpu]
    assert platform.rank_device(two, "cpu") == cpu


def _counting_ranks(world: int):
    """A one-process :class:`Ranks` that claims ``world`` ranks and
    records the exchanges it is asked for instead of making them."""
    from repro_torch.runtime.ranks import Ranks

    r, met = Ranks(None), []
    r.world, r.barrier = world, met.append
    return r, met


@pytest.mark.parametrize("n_common,n_chunks", [(1, 1), (3, 4), (64, 64),
                                               (65, 65), (1000, 1001)])
def test_chunk_checks_meet_the_ranks_evenly_within_a_stage(n_common, n_chunks):
    """The ranks meet before chunk 0 and then at most every ceil(n /
    CHECKS) chunks, no more than CHECKS times, and never at a chunk that
    some rank does not have."""
    from repro_torch.runtime.ranks import CHECKS

    ranks, met = _counting_ranks(2)
    check = ranks.chunk_checks(n_common, "phase 2")
    at = []
    for i in range(n_chunks):
        n = len(met)
        check(10 * i)
        if len(met) > n:
            at.append(i)
    assert met[0] == "phase 2, rows from 0" and at[0] == 0
    assert len(at) <= CHECKS and at[-1] < n_common
    step = -(-n_common // CHECKS)
    assert all(b - a == step for a, b in zip(at, at[1:]))
    assert n_common - at[-1] <= step


def test_pipeline_chunk_checks_count_the_chunks_every_rank_has():
    """A last chunk too short to reach rank 2 is not one every rank has:
    the ranks meet only within the first chunks."""
    from repro_torch.core.pipeline import chunk_checks

    ranks, met = _counting_ranks(3)
    plan = [(0, 9), (9, 9), (18, 4)]  # 3 ranks x 1 slot x 3 rows; 4 rows last
    shares = [len(rank_plan(plan, 1, 3, r, 3)) for r in range(3)]
    assert shares == [3, 3, 2]
    check = chunk_checks(ranks, plan, 1, 3, "x")
    for row0 in (0, 9, 18):
        check(row0)
    assert met == ["x, rows from 0", "x, rows from 9"]
    assert chunk_checks(_counting_ranks(1)[0], plan, 1, 3, "x") is None
