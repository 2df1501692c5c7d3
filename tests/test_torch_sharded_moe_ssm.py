"""The moe and ssm families' sharded paths on the CPU, in gloo worlds of
four ranks (``tests/torch_sharded_ranks.py``, job ``moe_ssm``; one world
a mesh, each shared by its tests), against the JAX package's
single-device runs from the same state:

- mesh (1, 4): one Adafactor step of dbrx-132b smoke (expert-parallel:
  one of its four experts a rank) and of the same with six experts
  (tensor-parallel inside each expert: 4 does not divide 6); prefill and
  four decode steps of dbrx, grok-1-314b (GELU experts), dbrx with six
  experts and mamba2-2.7b (two of its eight SSD heads a rank; in_proj's
  296 columns split 74 a rank, across its z / x / B / C / dt segments);
- mesh (2, 2), FSDP: one Adafactor step of dbrx at B 4 x S 16 (its one
  64-token MoE group spans both data shards), one AdamW step of mamba2,
  and a dbrx prefill whose capacity (factor 0.5) drops assignments of a
  group that spans both data shards.

Tolerances: the loss rtol 2e-5, parameters rtol 2e-3 / atol 2e-5 (JAX's
own sharded test, tests/test_sharding.py), Adafactor's accumulators rtol
2e-3 / atol 1e-6 of the leaf's largest entry, serving logits within
1e-5.  Routed and dropped counts summed over the ranks equal one
process's; the state created shard by shard gathers bit-equal to
``init_params``'s; a checkpoint saved at (1, 4) restores at (2, 2) bit
for bit, its expert-parallel leaves and accumulators placed by their
specs.  The JAX references run while the ranks do.
"""
import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import TokenStream  # noqa: E402
from repro_torch.launch.steps import make_decode_step, make_prefill_step  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.sharding import policy as POL  # noqa: E402

import torch_sharded_ranks as R  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
DEADLINE_S = 150
B, S_TRAIN, P, N_DEC = 4, 16, 8, 4
SERVE_TOL = 1e-5
#: name: (arch, config overrides, optimizer)
TRAIN = {"dbrx": ("dbrx-132b", {}, "adafactor"),
         "dbrx_e6": ("dbrx-132b", {"n_experts": 6}, "adafactor"),
         "mamba2": ("mamba2-2.7b", {}, "adamw")}
#: name: (arch, config overrides)
SERVE = {"dbrx": ("dbrx-132b", {}), "grok": ("grok-1-314b", {}),
         "dbrx_e6": ("dbrx-132b", {"n_experts": 6}), "mamba2": ("mamba2-2.7b", {}),
         "dbrx_cf05": ("dbrx-132b", {"capacity_factor": 0.5})}
#: mesh tag: (model axis, train cases, serve cases, shard-by-shard cases)
WORLDS = {"14": (4, ("dbrx", "dbrx_e6"), ("dbrx", "grok", "dbrx_e6", "mamba2"),
                 ("dbrx", "mamba2")),
          "22": (2, ("dbrx", "mamba2"), ("dbrx_cf05",), ("dbrx",))}
#: JAX initialises these at zero: drawn non-zero so that no term hides
ZERO_LEAVES = ("b", "bias", "conv_b", "dt_bias")
_JAX: dict = {}


def _jcfg(arch, over):
    return dataclasses.replace(jget(arch, smoke=True), **over)


def _pcfg(arch, over):
    return dataclasses.replace(get_config(arch, smoke=True), **over)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _nonzero(tree, seed=9):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (0.02 * rng.standard_normal(a.shape)).astype(a.dtype)
        if str(path[-1].key) in ZERO_LEAVES else a, tree)


def _flat_npz(tree) -> dict:
    return {f"p.{k}": v for k, v in T.unstack_jax_tree(tree).items()}


def _port_model(cfg, flat: dict):
    model = T.LM(cfg, torch.device("cpu"))
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.from_numpy(flat[name]))
    return model


# --------------------------------------------------------------- references
def _train_inputs(name, path):
    """JAX's initial state of a train case (zero leaves drawn non-zero),
    written for the ranks; the state and tokens kept for the reference."""
    arch, over, opt = TRAIN[name]
    jc = _jcfg(arch, over)
    jtc = JTrainConfig(optimizer=opt, **R.TRAIN_KW)
    st = _np(JS.TrainState.create(jc, jtc, jax.random.PRNGKey(0)))
    st = dataclasses.replace(st, params=_nonzero(st.params))
    tokens = TokenStream(jc.vocab_size, B, S_TRAIN, 0).batch_at(0)["tokens"]
    np.savez(path, tokens=tokens, **_flat_npz(st.params))
    return st, tokens


def _train_want(name, st, tokens) -> dict:
    """JAX's jitted single-device step, and the port's one-process routed
    and dropped counts of the step's forward (once a module per case)."""
    if ("train", name) not in _JAX:
        arch, over, opt = TRAIN[name]
        jc = _jcfg(arch, over)
        jtc = JTrainConfig(optimizer=opt, **R.TRAIN_KW)
        after, metrics = jax.jit(JS.make_train_step(jc, jtc))(
            jax.tree.map(jnp.asarray, st), {"tokens": jnp.asarray(tokens)})
        want = {"loss": float(metrics["loss"]),
                "params": T.unstack_jax_tree(_np(after.params)),
                "opt": _np(after.opt)}
        cfg = _pcfg(arch, over)
        model = _port_model(cfg, T.unstack_jax_tree(st.params))
        with torch.no_grad():
            T.forward(model, {"tokens": tokens}, cfg, remat=False)
        want["counts"] = MOE.drop_counts(model)
        _JAX[("train", name)] = want
    return _JAX[("train", name)]


def _serve_inputs(name, path):
    arch, over = SERVE[name]
    params = _nonzero(_np(JT.init_params(_jcfg(arch, over), jax.random.PRNGKey(1))))
    rng = np.random.default_rng(4)
    vocab = _jcfg(arch, over).vocab_size
    tokens = rng.integers(0, vocab, (B, P)).astype(np.int32)
    dec = rng.integers(0, vocab, (N_DEC, B, 1)).astype(np.int32)
    np.savez(path, tokens=tokens, dec_tokens=dec, **_flat_npz(params))
    return params, tokens, dec


def _serve_want(name, params, tokens, dec) -> dict:
    """JAX's jitted prefill and decode steps on the given tokens, and the
    port's one-process counts of the same calls."""
    if ("serve", name) not in _JAX:
        arch, over = SERVE[name]
        jc = _jcfg(arch, over)
        jp = jax.tree.map(jnp.asarray, params)
        logits, cache = jax.jit(JS.make_prefill_step(jc))(jp, {"tokens": jnp.asarray(tokens)})
        if "k" in cache:  # room for the decode steps
            big = JT.init_cache(jc, B, P + N_DEC)
            cache = jax.tree.map(lambda z, c: z.at[:, :, :P].set(c), big, cache)
        want = {"prefill": np.asarray(logits)}
        decode = jax.jit(JS.make_decode_step(jc))
        for i in range(N_DEC):
            lg, cache = decode(jp, {"token": jnp.asarray(dec[i]), "pos": jnp.int32(P + i)},
                               cache)
            want[f"decode{i}"] = np.asarray(lg)
        cfg = dataclasses.replace(_pcfg(arch, over), attn_impl="chunked")
        model = _port_model(cfg, T.unstack_jax_tree(params))
        _, pc = make_prefill_step(cfg, device="cpu")(model, {"tokens": tokens})
        if "k" in pc:
            big = T.init_cache(cfg, B, P + N_DEC, device="cpu")
            for k in pc:
                big[k][:, :, :P] = pc[k]
            pc = big
        for i in range(N_DEC):
            _, pc = make_decode_step(cfg, device="cpu")(model, {"token": dec[i],
                                                                "pos": P + i}, pc)
        want["counts"] = MOE.drop_counts(model)
        _JAX[("serve", name)] = want
    return _JAX[("serve", name)]


# ------------------------------------------------------------------- worlds
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start_world(d: pathlib.Path, W: int = 4, job: str = "moe_ssm"):
    """``W`` rank processes of ``torch_sharded_ranks.py <job> <d>``."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "OMP_NUM_THREADS": "1"}
    for k in ("EDM_LOCAL_DEVICE_IDS", "EDM_FAULTS"):
        env.pop(k, None)
    cmd = [sys.executable, str(REPO / "tests" / "torch_sharded_ranks.py"), job, str(d)]
    return [subprocess.Popen(cmd, env={
        **env, "EDM_COORDINATOR": f"localhost:{port}", "EDM_NUM_PROCESSES": str(W),
        "EDM_PROCESS_ID": str(r)}, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(W)]


def _finish_world(procs, t_end: float) -> list:
    """Wait for every rank until ``t_end`` (killing any left); every rank
    must exit 0.  Returns their logs."""
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
    assert rcs == [0] * len(procs), "\n".join(
        f"rank {r} rc {rc}:\n{log[-3000:]}" for r, (rc, log) in enumerate(zip(rcs, logs)))
    return logs


def _world(tag, d: pathlib.Path, restore_from=None) -> dict:
    """Run mesh ``tag``'s world on its cases; the JAX references run
    meanwhile.  Returns the ranks' records and the references."""
    model, trains, serves, inits = WORLDS[tag]
    cases = ([{"kind": "train", "name": f"train_{n}", "arch": TRAIN[n][0],
               "over": TRAIN[n][1], "opt": TRAIN[n][2], "save": tag == "14" and n == "dbrx"}
              for n in trains]
             + [{"kind": "serve", "name": f"serve_{n}", "arch": SERVE[n][0],
                 "over": SERVE[n][1]} for n in serves]
             + [{"kind": "init", "name": f"init_{n}", "arch": TRAIN[n][0],
                 "over": TRAIN[n][1], "opt": TRAIN[n][2]} for n in inits])
    if restore_from is not None:
        cases.append({"kind": "restore", "name": "restore_dbrx", "arch": "dbrx-132b",
                      "opt": "adafactor", "from": str(restore_from)})
    (d / "cases.json").write_text(json.dumps({"model": model, "cases": cases}))
    ins = {("train", n): _train_inputs(n, d / f"train_{n}_in.npz") for n in trains}
    ins.update({("serve", n): _serve_inputs(n, d / f"serve_{n}_in.npz") for n in serves})
    procs = _start_world(d)
    t_end = time.time() + DEADLINE_S
    try:
        want = {f"train_{n}": _train_want(n, *ins[("train", n)]) for n in trains}
        want.update({f"serve_{n}": _serve_want(n, *ins[("serve", n)]) for n in serves})
    finally:
        _finish_world(procs, t_end)
    got = [dict(np.load(d / f"moe_ssm_rank{r}.npz")) for r in range(4)]
    return {"got": got, "want": want, "dir": d, "model": model}


@pytest.fixture(scope="module")
def world14(tmp_path_factory):
    return _world("14", tmp_path_factory.mktemp("moe_ssm_14"))


@pytest.fixture(scope="module")
def world22(tmp_path_factory, world14):
    return _world("22", tmp_path_factory.mktemp("moe_ssm_22"), restore_from=world14["dir"])


def _w(request, tag):
    return request.getfixturevalue(f"world{tag}")


# -------------------------------------------------------------------- tests
TRAIN_CASES = [("14", "dbrx"), ("14", "dbrx_e6"), ("22", "dbrx"), ("22", "mamba2")]


@pytest.mark.parametrize("tag,name", TRAIN_CASES, ids=[f"{t}-{n}" for t, n in TRAIN_CASES])
def test_sharded_train_step_matches_jax_single_device_step(request, tag, name):
    w = _w(request, tag)
    want = w["want"][f"train_{name}"]
    for g in w["got"]:  # every rank holds the same loss
        np.testing.assert_allclose(float(g[f"train_{name}.loss"]), want["loss"], rtol=2e-5)
    g = w["got"][0]
    for k, v in want["params"].items():
        np.testing.assert_allclose(g[f"train_{name}.p.{k}"], v, rtol=2e-3, atol=2e-5,
                                   err_msg=k)


class _Mesh:
    """A stand-in mesh of the world's shape (specs alone)."""

    def __init__(self, model):
        self.axis_names = ("data", "model")
        self.shape = {"data": 4 // model, "model": model}


def _local_shape(shape, spec, sizes) -> tuple:
    out = list(shape)
    for d, ax in enumerate(spec):
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            if a is not None:
                out[d] //= sizes[a]
    return tuple(out)


ADAFACTOR_CASES = [c for c in TRAIN_CASES if TRAIN[c[1]][2] == "adafactor"]


@pytest.mark.parametrize("tag,name", ADAFACTOR_CASES,
                         ids=[f"{t}-{n}" for t, n in ADAFACTOR_CASES])
def test_adafactor_accumulators_match_jax_placed_by_opt_specs(request, tag, name):
    from repro_torch.configs.base import TrainConfig

    w = _w(request, tag)
    jacc = w["want"][f"train_{name}"]["opt"]["acc"]
    arch, over, opt = TRAIN[name]
    cfg = _pcfg(arch, over)
    meta = T.LM(cfg, torch.device("meta"))
    pol = POL.ShardingPolicy(mesh=_Mesh(w["model"]), fsdp=True)
    specs = POL.opt_specs(pol, POL.param_specs(pol, meta), meta, TrainConfig(optimizer=opt))
    sizes = {"data": 4 // w["model"], "model": w["model"]}
    g = w["got"][0]
    n = 0
    for leaf, accs in specs["acc"].items():
        node = jacc
        for part in leaf.split("."):
            node = node[part]
        for k, spec in accs.items():
            want = np.asarray(node[k], np.float32)
            got = g[f"train_{name}.opt.acc:{leaf}:{k}"]
            np.testing.assert_allclose(got, want, rtol=2e-3,
                                       atol=1e-6 * float(np.abs(want).max()),
                                       err_msg=f"{leaf}.{k}")
            assert tuple(g[f"train_{name}.opt_local.acc:{leaf}:{k}"]) == _local_shape(
                want.shape, spec, sizes), (leaf, k)
            n += 1
    assert n == sum(len(a) for a in _jacc_leaves(jacc))


def _jacc_leaves(tree):
    """The accumulator dicts of JAX's Adafactor tree."""
    if set(tree) <= {"vr", "vc", "v"}:
        return [tree]
    return [a for v in tree.values() for a in _jacc_leaves(v)]


SERVE_CASES = [("14", n) for n in WORLDS["14"][2]] + [("22", n) for n in WORLDS["22"][2]]


@pytest.mark.parametrize("tag,name", SERVE_CASES, ids=[f"{t}-{n}" for t, n in SERVE_CASES])
def test_sharded_prefill_and_decode_match_jax(request, tag, name):
    w = _w(request, tag)
    want = w["want"][f"serve_{name}"]
    for g in w["got"]:
        for k in ["prefill"] + [f"decode{i}" for i in range(N_DEC)]:
            np.testing.assert_allclose(g[f"serve_{name}.{k}"], want[k], atol=SERVE_TOL,
                                       rtol=0, err_msg=k)


COUNT_CASES = ([(t, f"train_{n}") for t, n in TRAIN_CASES if TRAIN[n][0] != "mamba2-2.7b"]
               + [(t, f"serve_{n}") for t, n in SERVE_CASES if SERVE[n][0] != "mamba2-2.7b"])


@pytest.mark.parametrize("tag,name", COUNT_CASES, ids=[f"{t}-{n}" for t, n in COUNT_CASES])
def test_routed_and_dropped_summed_over_the_world_equal_one_process(request, tag, name):
    w = _w(request, tag)
    routed = sum(int(g[f"{name}.routed"]) for g in w["got"])
    dropped = sum(int(g[f"{name}.dropped"]) for g in w["got"])
    assert (routed, dropped) == w["want"][name]["counts"]
    if name in ("serve_dbrx_cf05", "train_dbrx_e6"):  # the capacity did drop
        assert dropped > 0


INIT_CASES = [("14", "dbrx"), ("14", "mamba2"), ("22", "dbrx")]


@pytest.mark.parametrize("tag,name", INIT_CASES, ids=[f"{t}-{n}" for t, n in INIT_CASES])
def test_state_created_shard_by_shard_gathers_to_init_params(request, tag, name):
    w = _w(request, tag)
    arch, over, _ = TRAIN[name]
    ref = T.init_params(_pcfg(arch, over), torch.Generator("cpu").manual_seed(0), "cpu")
    g = w["got"][0]
    for k, p in ref.named_parameters():
        got = torch.from_numpy(g[f"init_{name}.p.{k}"])
        assert got.dtype == p.dtype and torch.equal(got.view(torch.uint8),
                                                    p.detach().view(torch.uint8)), k
    opt = [k for k in g if k.startswith(f"init_{name}.opt.")]
    assert opt and all(not np.any(g[k]) for k in opt)


def test_expert_head_and_cache_placements(world14, world22):
    g14, g22 = world14["got"][0], world22["got"][0]
    # expert-parallel: one of four experts a rank; at (2, 2) two, d on data
    assert tuple(g14["train_dbrx.local_w_up"]) == (1, 64, 128)
    assert tuple(g22["train_dbrx.local_w_up"]) == (2, 32, 128)
    # six experts under four: tensor-parallel inside each, f on model
    assert tuple(g14["train_dbrx_e6.local_w_up"]) == (6, 64, 32)
    # the ssm cache on heads (2 of 8 a rank), the conv cache on channels
    assert tuple(g14["serve_mamba2.cache_local.ssm"]) == (4, B, 2, 16, 16)
    assert tuple(g14["serve_mamba2.cache_local.conv"]) == (4, B, 3, 160 // 4)
    # the moe KV cache along the sequence on model
    assert tuple(g14["serve_dbrx.cache_local.k"]) == (2, B, P // 4, 2, 16)


def test_checkpoint_saved_at_one_mesh_restores_at_another(world14, world22):
    saved, back = world14["got"][0], world22["got"][0]
    keys = [k[len("train_dbrx."):] for k in saved
            if k.startswith(("train_dbrx.p.", "train_dbrx.opt."))]
    assert any(k.startswith("opt.acc:blocks.moe.w_up") for k in keys)
    for k in keys:
        assert np.array_equal(back[f"restore_dbrx.{k}"], saved[f"train_dbrx.{k}"]), k
    assert tuple(back["restore_dbrx.local_w_up"]) == (2, 32, 128)


@pytest.mark.parametrize("arch", ["dbrx-132b", "mamba2-2.7b"])
def test_train_cli_runs_the_moe_and_ssm_families_on_a_world_of_ranks(tmp_path, arch):
    """``launch/train.py --arch <arch> --smoke`` as two ranks: the state
    created shard by shard on the CLI's all-data mesh, two steps, a
    finite loss on every rank."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch, "--smoke",
           "--steps", "2", "--batch", "4", "--seq", "16", "--log-every", "1",
           "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck")]
    procs = [subprocess.Popen(cmd, env={**env, "EDM_COORDINATOR": f"localhost:{port}",
                                        "EDM_NUM_PROCESSES": "2", "EDM_PROCESS_ID": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    for log in _finish_world(procs, time.time() + DEADLINE_S):
        assert "mesh {'data': 2, 'model': 1}" in log
        last = log.strip().splitlines()[-1]
        assert last.startswith("done at step 2; final loss ")
        assert np.isfinite(float(last.rsplit(" ", 1)[-1]))
