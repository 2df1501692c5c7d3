"""The port's LM dry run (``launch/dryrun.py``) and its tools
(``bench/hillclimb.py``, ``bench/make_experiments.py``) against the JAX
package's on the CPU:

- ``optimized_cfg``, ``optimized_policy_kw``, the train configs and the
  skipped cells equal JAX's for all ten archs x four cells;
- ``n_params``, ``n_active_params`` and the model flops of every cell equal
  JAX's on the full configs (shapes only: JAX's ``eval_shape``, the port's
  meta-device module);
- the per-device argument bytes of the dense and moe smoke configs on a
  fake (2, 4) world, for train, prefill and decode, equal JAX's
  ``_build_lowered(...).compile().memory_analysis().argument_size_in_bytes``
  on a (2, 4) mesh with ``AxisType.Auto`` (run in a subprocess with eight
  fake XLA devices), but for two differences of layout the test names and
  holds to their bytes: a decode's ``pos`` is a host int in the port (JAX:
  a 4-byte int32 on the device), and each port MoE layer keeps its drop
  counter on the device (an int64, 8 bytes);
- a sharded matmul with a replicated operand counts the local product's
  operations on one device, not the global one's;
- sequence-parallel attention cuts minicpm-2b smoke's prefill operations
  a device, the flash operator counted from its positions;
- the CLI writes its JSON to ``--out`` or ``build/dryrun/`` (never under
  ``benchmarks/``), a skipped cell with ``cell_applicable``'s reason;
  hillclimb and make_experiments run on tiny JSONs, hillclimb refuses
  JAX's ``knn_impl`` variants by name.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.configs import cell_applicable as jcell_applicable  # noqa: E402
from repro.configs.base import shape_cell as jcell  # noqa: E402
from repro.launch import roofline as JRL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.bench import hillclimb, make_experiments  # noqa: E402
from repro_torch.configs import ARCHS, SHAPE_CELLS, cell_applicable, get_config  # noqa: E402
from repro_torch.configs.base import shape_cell  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import roofline as RL  # noqa: E402
from repro_torch.sharding import policy as POL  # noqa: E402

from test_torch_sharded_step import REPO  # noqa: E402


def _jax_dryrun():
    """JAX's ``launch/dryrun.py`` (its import sets XLA_FLAGS for 512 fake
    devices: put back for this process's children)."""
    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as JD
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return JD


JD = _jax_dryrun()


def _fields(c) -> dict:
    return dataclasses.asdict(c)


#: JAX's argument bytes of smoke cells on a (2, 4) mesh (argv: archs)
JAX_ARGS = textwrap.dedent("""
    import json, sys
    import jax
    from jax.sharding import AxisType
    import repro.launch.dryrun as JD
    from repro.configs import get_config, shape_cell
    from repro.sharding import policy as POL
    mesh = jax.make_mesh((2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
    out = {}
    for arch in sys.argv[1].split(","):
        cfg = get_config(arch, smoke=True)
        for cell in ("train_4k", "prefill_32k", "decode_32k"):
            low = JD._build_lowered(cfg, shape_cell(cell), mesh, POL.auto_policy(cfg, mesh),
                                    JD.train_config_for(arch), jax.random.PRNGKey(0))
            out[f"{arch}/{cell}"] = int(low.compile().memory_analysis().argument_size_in_bytes)
    print(json.dumps(out))
""")
ARG_ARCHS = ("qwen2-1.5b", "dbrx-132b")


@pytest.fixture(scope="module", autouse=True)
def jax_arg_proc():
    """JAX's lowering of the argument-bytes cells in a process of its own,
    started with the module's first test so that it runs beside the tests
    before the argument-bytes ones (the last in this file).  The backend's
    optimisation is off: it changes the machine code, not the buffers."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8 "
                        "--xla_backend_optimization_level=0 "
                        "--xla_llvm_disable_expensive_passes=true"}
    proc = subprocess.Popen([sys.executable, "-c", JAX_ARGS, ",".join(ARG_ARCHS)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def jax_arg_bytes(jax_arg_proc):
    out, err = jax_arg_proc.communicate(timeout=300)
    assert jax_arg_proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ARCHS)
def test_optimized_and_train_configs_equal_jax(arch):
    for cell in SHAPE_CELLS:
        jc, c = jget(arch), get_config(arch)
        jsc, sc = jcell(cell.name), shape_cell(cell.name)
        assert _fields(DR.optimized_cfg(c, sc)) == _fields(JD.optimized_cfg(jc, jsc)), cell
        assert DR.optimized_policy_kw(c, sc) == JD.optimized_policy_kw(jc, jsc), cell
        assert cell_applicable(c, sc) == jcell_applicable(jc, jsc), cell
    assert _fields(DR.train_config_for(arch)) == _fields(JD.train_config_for(arch))
    assert (_fields(DR.optimized_train_config_for(arch))
            == _fields(JD.optimized_train_config_for(arch)))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_model_flops_equal_jax(arch):
    jc, c = jget(arch), get_config(arch)
    shapes = jax.eval_shape(lambda: JT.init_params(jc, jax.random.PRNGKey(0)))
    j_params = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    j_active = JRL.active_params(jc, shapes)
    mine = DR.param_shapes(c)
    n_params = sum(int(np.prod(s)) for s in mine.values())
    n_active = RL.active_params(c, mine)
    assert (n_params, n_active) == (j_params, j_active)
    for cell in SHAPE_CELLS:
        n_tok = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
        assert (RL.model_flops(c, n_tok, n_params, n_active)
                == JRL.model_flops(jc, n_tok, j_params, j_active))


def test_sharded_matmul_counts_the_local_product():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard

    with DR.fake_world((2, 4), ("data", "model")) as mesh:
        with FakeTensorMode():
            a = DTensor.from_local(torch.empty(32, 256), mesh, [Shard(0), Replicate()],
                                   run_check=False)  # (64, 256), rows on "data"
            w = DTensor.from_local(torch.empty(256, 512), mesh, [Replicate(), Replicate()],
                                   run_check=False)  # replicated
            w2 = DTensor.from_local(torch.empty(256, 128), mesh, [Replicate(), Shard(1)],
                                    run_check=False)  # (256, 512), columns on "model"
            c = DR.DeviceCounter(mesh)
            with c:
                (a @ w).relu()
            c2 = DR.DeviceCounter(mesh)
            with c2:
                a @ w2
    assert c.flops == 2 * 32 * 256 * 512 != 2 * 64 * 256 * 512
    assert c2.flops == 2 * 32 * 256 * 128
    assert c.coll == c2.coll == {}
    # bytes: the local product's operands and result, once; the
    # elementwise relu after it (fusible into the product) moves none
    assert c.bytes == 4 * (32 * 256 + 256 * 512 + 32 * 512)
    assert c2.bytes == 4 * (32 * 256 + 256 * 128 + 32 * 128)


def test_seq_shard_cuts_the_prefill_operations_a_device():
    base = get_config("minicpm-2b", smoke=True)
    sc = shape_cell("prefill_32k")
    opt = DR.optimized_cfg(base, sc)
    assert opt.attn_seq_shard and opt.attn_impl == "chunked"
    on = DR.dry_cell("minicpm-2b", "prefill_32k", cfg=opt, variant="optimized")
    off = DR.dry_cell("minicpm-2b", "prefill_32k",
                      cfg=dataclasses.replace(opt, attn_seq_shard=False))
    assert on["attn_seq_shard"] and not off["attn_seq_shard"]
    assert on["roofline"]["flops_per_chip"] < off["roofline"]["flops_per_chip"]
    # the only collective it adds: the attention output's all-gather on "model"
    added = {k: n - off["collectives"]["counts"].get(k, {}).get("model", 0)
             for k, ax in on["collectives"]["counts"].items() for a, n in ax.items()
             if a == "model"}
    assert {k: n for k, n in added.items() if n} == {"all-gather": base.n_layers}
    mem = on["memory"]
    assert mem["peak_bytes_per_device"] == mem["argument_bytes"] + mem["temp_bytes"]


@pytest.mark.parametrize("mesh", [((), ()), ((2, 4), ("data", "model"))],
                         ids=["world_of_one", "2x4"])
def test_extrapolated_train_step_equals_the_full_depth(mesh):
    """From one and two layers to three: every count, byte and the peak of
    a training step as the three-layer trace gives them."""
    from repro_torch.configs.base import ShapeCell

    cfg = dataclasses.replace(get_config("qwen2-1.5b", smoke=True), n_layers=3)
    cell = ShapeCell("train_small", "train", 32, 8)
    full, ext = (DR.dry_cell("qwen2-1.5b", cell, cfg=cfg, mesh=mesh, extrapolate=e)
                 for e in (False, True))
    assert (full["depth"], ext["depth"]) == ("full", "extrapolated")
    for k in ("flops_per_chip", "bytes_per_chip", "coll_by_kind", "coll_by_axis"):
        assert ext["roofline"][k] == full["roofline"][k], k
    assert ext["collectives"] == full["collectives"]
    assert ext["memory"] == full["memory"]
    assert full["roofline"]["flops_per_chip"] > 0
    assert bool(full["collectives"]["counts"]) == bool(mesh[0])


def test_roofline_bench_reads_lm_dry_runs_beside_the_edm_ones(tmp_path):
    """``bench.run roofline`` reads every JSON of the dry-run directory,
    which the LM dry run shares: a cell's row, a skipped cell's SKIP."""
    import torch as _torch

    from repro_torch.bench import run as brun

    d = tmp_path / "dry"
    d.mkdir()
    cell = DR.dry_cell("smollm-135m", "decode_32k", cfg=get_config("smollm-135m", smoke=True),
                       mesh=((), ()))
    skipped = DR.dry_cell("qwen2-1.5b", "long_500k")
    assert "skipped" in skipped
    for i, r in enumerate((cell, skipped)):
        (d / f"{i}.json").write_text(json.dumps(r))
    rows = brun.roofline_summary(brun.Bench(_torch.device("cpu"), tmp_path / "out"), d)["rows"]
    assert [r["name"] for r in rows] == ["roofline_smollm-135m_decode_32k_1",
                                         "roofline_qwen2-1.5b_long_500k_16x16"]
    assert rows[0]["derived"].startswith(f"bottleneck={cell['roofline']['bottleneck']};")
    assert rows[1]["derived"] == "SKIP"


def test_cli_writes_to_out_and_build_dryrun(tmp_path, monkeypatch):
    assert DR.RESULTS_DIR == REPO / "build" / "dryrun"
    assert "benchmarks" not in DR.RESULTS_DIR.parts
    out = tmp_path / "one.json"
    DR.main(["--arch", "qwen2-1.5b", "--cell", "decode_32k", "--smoke", "--out", str(out)])
    res = json.loads(out.read_text())
    for key in ("n_params", "n_active_params", "memory", "roofline", "model_flops_global",
                "model_flops_per_chip", "useful_flops_ratio", "trace_s", "collectives"):
        assert key in res, key
    assert set(res["roofline"]["coll_by_axis"]) <= {"data", "model"}
    assert res["roofline"]["links"]["model"]["crosses_nodes"]  # 16 ranks, 8 a node
    monkeypatch.setattr(DR, "RESULTS_DIR", tmp_path / "build" / "dryrun")
    DR.main(["--arch", "qwen2-1.5b", "--cell", "long_500k"])
    skipped = json.loads((tmp_path / "build" / "dryrun" /
                          "qwen2-1.5b__long_500k__16x16.json").read_text())
    assert skipped["skipped"] == cell_applicable(get_config("qwen2-1.5b"),
                                                 shape_cell("long_500k"))[1]


def test_hillclimb_and_make_experiments_on_tiny_jsons(tmp_path, capsys):
    assert hillclimb.RESULTS == REPO / "build" / "hillclimb"
    assert set(hillclimb.TARGETS) == {"minicpm-prefill", "minicpm-train", "whisper-train",
                                      "smollm-train", "mamba2-train", "grok-train"}
    h = tmp_path / "h.json"
    res = hillclimb.main(["--target", "minicpm-prefill", "--variant",
                          "chunked+last+seq_shard", "--smoke", "--out", str(h)])
    assert res["variant"] == "chunked+last+seq_shard" and res["attn_seq_shard"]
    with pytest.raises(SystemExit, match="knn_impl"):
        hillclimb.main(["--target", "edm", "--variant", "unroll+lib4"])
    d = tmp_path / "dry"
    for opt in ([], ["--optimized"]):
        DR.main(["--arch", "smollm-135m", "--cell", "decode_32k", "--smoke", *opt,
                 "--out", str(d / f"smollm-135m__decode_32k__16x16{'__opt' if opt else ''}.json")])
    (d / "subject11.json").write_text(json.dumps({
        "arch": "edm-subject11", "cell": "ccm_N101729_L8528", "chunk_s": {"total": 1.5},
        "roofline": {"t_compute_s": 0.1, "t_memory_s": 0.01, "bottleneck": "compute"},
        "chunk_share_of_bound": 0.07, "memory": {"peak_bytes_per_device": 2 ** 31},
        "card": "NVIDIA H100 80GB HBM3, 700.00 W"}))
    text = make_experiments.main(["--dir", str(d)])
    assert "| smollm-135m | decode_32k |" in text
    assert "edm-subject11" in text and "Baseline vs optimized" in text
    assert text.count("| smollm-135m | decode_32k |") == 2  # baseline row and opt row


@pytest.mark.parametrize("arch", ARG_ARCHS)
@pytest.mark.parametrize("cell", ["train_4k", "prefill_32k", "decode_32k"])
def test_argument_bytes_equal_jax_on_a_2x4_mesh(jax_arg_bytes, arch, cell):
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg, sc = get_config(arch, smoke=True), shape_cell(cell)
    with DR.fake_world((2, 4), ("data", "model")) as mesh:
        pol = POL.auto_policy(cfg, mesh)
        with FakeTensorMode():
            args, _, _ = DR.build_step(cfg, sc, DR.train_config_for(arch), pol)
            exact = DR.storage_bytes(args, 1) + DR.batch_bytes(cfg, sc, pol, 1)
            alloc = DR.storage_bytes(args) + DR.batch_bytes(cfg, sc, pol)
    # by design: the decode's position is a host int (JAX: an int32 on the
    # device); a MoE layer's drop counter lives on the device (int64)
    explained = (-4 if sc.kind == "decode" else 0) + 8 * (cfg.n_layers if cfg.n_experts else 0)
    assert exact - jax_arg_bytes[f"{arch}/{cell}"] == explained
    assert exact <= alloc < exact + DR.GRANULE * 400  # each storage rounded up to 512
