"""The shard merge across the ranks of a ``torch.distributed`` group, on
the CPU: 2, 3 and 4 ``gloo`` ranks, each a process on localhost that
joins through the EDM_* contract (``runtime/platform.py::
init_distributed``).  ``merge_topk_collective`` (the butterfly at 2 and
4 ranks, all_gather + tree at 3) equals ``merge_topk_tree`` bit for bit
on every rank, and ``knn_tables_library_sharded(group=...)`` equals the
unsharded table.  Every world runs under one deadline well inside 120 s;
past it every rank is killed, so a rank that died hangs no test."""
import json
import os
import pathlib
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parents[1]
DEADLINE_S = 90

RANK = textwrap.dedent("""
    import json, pathlib, sys
    import numpy as np, torch
    import torch.distributed as dist
    from repro_torch.core import knn, pipeline
    from repro_torch.core.types import EDMConfig
    from repro_torch.runtime import platform

    out = pathlib.Path(sys.argv[1])
    info = platform.init_distributed(device="cpu")
    assert platform.init_distributed(device="cpu") == info  # idempotent
    rank, W = info["process_id"], info["num_processes"]
    assert info["backend"] == "gloo" and dist.get_world_size() == W
    rng = np.random.default_rng(0)  # the same inputs on every rank
    x = rng.standard_normal((2, 4, 45)).astype(np.float32)
    x[1, :, 30:40] = x[1, :, 0:10]  # ties across shards
    x = torch.tensor(x)
    cfg = EDMConfig(E_max=4, knn_tile_c=8)
    k = 7
    parts = [pipeline._shard_table(x, x, k, cfg, True, s, W, x.device)
             for s in range(W)]
    ci, cd = knn.merge_topk_collective(*parts[rank], k)
    ti, td = knn.merge_topk_tree([p[0] for p in parts], [p[1] for p in parts], k)
    si, sd = pipeline.knn_tables_library_sharded(
        x, x, k, cfg, exclude_self=True, group=dist.group.WORLD)
    ui, ud = knn.knn_tables_all_E_streaming(x, x, k, True, 8)
    np.savez(out / f"rank{rank}.npz", ci=ci.numpy(), cd=cd.numpy(),
             ti=ti.numpy(), td=td.numpy(), si=si.numpy(), sd=sd.numpy(),
             ui=ui.numpy(), ud=ud.numpy())
    (out / f"rank{rank}.json").write_text(json.dumps(info))
    dist.destroy_process_group()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_world(W: int, out: pathlib.Path, code: str = RANK) -> list:
    """W rank processes of ``code`` (argv[1] = ``out``); every rank's exit
    code, after all ended or the deadline killed them."""
    port = _free_port()
    procs = []
    for r in range(W):
        env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
               "OMP_NUM_THREADS": "1", "EDM_COORDINATOR": f"localhost:{port}",
               "EDM_NUM_PROCESSES": str(W), "EDM_PROCESS_ID": str(r)}
        env.pop("EDM_LOCAL_DEVICE_IDS", None)
        procs.append(subprocess.Popen([sys.executable, "-c", code, str(out)],
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    t_end = time.time() + DEADLINE_S
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
    rcs = [p.returncode for p in procs]
    assert rcs == [0] * W, "\n".join(f"rank {r} rc {rc}:\n{log[-2000:]}"
                                     for r, (rc, log) in enumerate(zip(rcs, logs)))
    return rcs


@pytest.fixture(scope="module", params=[2, 3, 4], ids=lambda w: f"W{w}")
def world(request, tmp_path_factory):
    W = request.param
    out = tmp_path_factory.mktemp(f"world{W}")
    run_world(W, out)
    return W, [dict(np.load(out / f"rank{r}.npz")) for r in range(W)], [
        json.loads((out / f"rank{r}.json").read_text()) for r in range(W)]


def _bits_equal(a, b, name):
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32), err_msg=name)


def test_collective_merge_equals_the_tree_on_every_rank(world):
    W, ranks, infos = world
    assert sorted(i["process_id"] for i in infos) == list(range(W))
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["ci"], got["ti"], err_msg=f"rank {r}")
        _bits_equal(got["cd"], got["td"], f"rank {r}")
        # the tree is the unsharded table (exclude_self, k = 7 of 45)
        np.testing.assert_array_equal(got["ti"], got["ui"])
        _bits_equal(got["td"], got["ud"], f"rank {r}")


def test_library_sharded_over_the_group_equals_the_unsharded_table(world):
    W, ranks, _ = world
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["si"], got["ui"], err_msg=f"rank {r}")
        _bits_equal(got["sd"], got["ud"], f"rank {r}")
    assert all(np.array_equal(ranks[0]["si"], g["si"]) for g in ranks[1:])
