"""The hybrid, audio and vlm families' sharded paths on the CPU, in gloo
worlds of four ranks (``tests/torch_sharded_ranks.py``, job
``hybrid_cross``; one world a mesh, each shared by its tests), against
the JAX package's single-device runs from the same state:

- mesh (1, 4): one AdamW step of zamba2-7b smoke (one attention head and
  two SSD heads a rank, the LoRA ``b_*`` split on dout), whisper-medium
  smoke and llama-3.2-vision-11b smoke (H 4, K 2: the kv heads
  replicated under four query-head shards); prefill and four decode
  steps of each through a cache grown by ``place.grow_cache`` (whisper's
  16 frames and the vlm's 8 patches sharded 4 and 2 a rank along the
  source sequence);
- mesh (2, 2), FSDP: one Adafactor step of zamba2 (the shared block's
  gathered weights reused in every unit) and of llama-vision; serving of
  llama-vision with 9 patches, whose cross cache falls back to kv heads
  as the full config's 1,601 do.

Tolerances as tests/test_torch_sharded_moe_ssm.py: the loss rtol 2e-5,
parameters rtol 2e-3 / atol 2e-5 (JAX's own sharded test,
tests/test_sharding.py), Adafactor's accumulators rtol 2e-3 / atol 1e-6
of the leaf's largest entry, serving logits within 1e-5.  The state
created shard by shard gathers bit-equal to ``init_params``'s; a zamba2
checkpoint saved at (1, 4) restores at (2, 2) bit for bit; a decode
moves no cross cache (no DTensor of a cross-cache layer's shape is
redistributed).  The JAX references run while the ranks do; JAX's
zero-initialised leaves (biases, the LoRA ``b_*``, the vlm gates) are
drawn non-zero first.
"""
import dataclasses
import json
import os
import pathlib
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
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.data.pipeline import TokenStream  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.sharding import policy as POL  # noqa: E402

import torch_sharded_ranks as R  # noqa: E402
from test_torch_sharded_moe_ssm import (  # noqa: E402
    REPO, _finish_world, _flat_npz, _free_port, _jacc_leaves, _local_shape, _Mesh, _np,
    _start_world)

DEADLINE_S = 150
B, S_TRAIN, P, N_DEC = 4, 16, 8, 4
SERVE_TOL = 1e-5
HYBRID, AUDIO, VLM = "zamba2-7b", "whisper-medium", "llama-3.2-vision-11b"
#: name: (arch, config overrides, optimizer)
TRAIN = {"zamba2": (HYBRID, {}, "adamw"), "whisper": (AUDIO, {}, "adamw"),
         "vlm": (VLM, {}, "adamw"), "zamba2_af": (HYBRID, {}, "adafactor"),
         "vlm_af": (VLM, {}, "adafactor")}
#: name: (arch, config overrides)
SERVE = {"zamba2": (HYBRID, {}), "whisper": (AUDIO, {}), "vlm": (VLM, {}),
         "vlm9": (VLM, {"n_frontend_tokens": 9})}
#: mesh tag: (model axis, train cases, serve cases, shard-by-shard cases)
WORLDS = {"14": (4, ("zamba2", "whisper", "vlm"), ("zamba2", "whisper", "vlm"),
                 ("zamba2", "whisper", "vlm")),
          "22": (2, ("zamba2_af", "vlm_af"), ("vlm9",), ())}
#: parameters whose local shapes the train cases record
LOCAL = ("lora.0.b_q", "lora.0.a_q", "shared.wq.w", "enc_pos", "cross.0.xattn.wk.w")
#: JAX initialises these at zero: drawn non-zero so that no term hides
ZERO_LEAVES = ("b", "bias", "conv_b", "dt_bias", "b_q", "b_k", "b_v", "gate_attn",
               "gate_mlp")
_JAX: dict = {}


def _jcfg(arch, over):
    return dataclasses.replace(jget(arch, smoke=True), **over)


def _pcfg(arch, over):
    return dataclasses.replace(get_config(arch, smoke=True), **over)


def _nonzero(tree, seed=9):
    """The zero leaves drawn: the gates 0.3 + 0.6 U(0, 1), the rest
    0.02 N(0, 1)."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        leaf = str(path[-1].key)
        if leaf not in ZERO_LEAVES:
            return a
        r = (0.3 + 0.6 * rng.uniform(size=a.shape) if leaf.startswith("gate")
             else 0.02 * rng.standard_normal(a.shape))
        return np.asarray(r, np.float32).astype(a.dtype)

    return jax.tree_util.tree_map_with_path(draw, tree)


def _frontend(cfg, n_batch, rng) -> dict:
    key = T.FRONTEND.get(cfg.family)
    if key is None:
        return {}
    return {key: (0.1 * rng.standard_normal(
        (n_batch, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)}


# --------------------------------------------------------------- references
def _train_inputs(name, path):
    arch, over, opt = TRAIN[name]
    jc = _jcfg(arch, over)
    jtc = JTrainConfig(optimizer=opt, **R.TRAIN_KW)
    st = _np(JS.TrainState.create(jc, jtc, jax.random.PRNGKey(0)))
    st = dataclasses.replace(st, params=_nonzero(st.params))
    batch = {"tokens": TokenStream(jc.vocab_size, B, S_TRAIN, 0).batch_at(0)["tokens"],
             **_frontend(jc, B, np.random.default_rng(3))}
    np.savez(path, **batch, **_flat_npz(st.params))
    return st, batch


def _train_want(name, st, batch) -> dict:
    if ("train", name) not in _JAX:
        arch, over, opt = TRAIN[name]
        jtc = JTrainConfig(optimizer=opt, **R.TRAIN_KW)
        after, metrics = jax.jit(JS.make_train_step(_jcfg(arch, over), jtc))(
            jax.tree.map(jnp.asarray, st), {k: jnp.asarray(v) for k, v in batch.items()})
        _JAX[("train", name)] = {"loss": float(metrics["loss"]),
                                 "params": T.unstack_jax_tree(_np(after.params)),
                                 "opt": _np(after.opt)}
    return _JAX[("train", name)]


def _serve_inputs(name, path):
    arch, over = SERVE[name]
    jc = _jcfg(arch, over)
    params = _nonzero(_np(JT.init_params(jc, jax.random.PRNGKey(1))))
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, jc.vocab_size, (B, P)).astype(np.int32),
             **_frontend(jc, B, rng)}
    dec = rng.integers(0, jc.vocab_size, (N_DEC, B, 1)).astype(np.int32)
    np.savez(path, dec_tokens=dec, **batch, **_flat_npz(params))
    return params, batch, dec


def _grow_jax(big, cache):
    """JAX's prefill cache in a longer zero one: every self-attention k / v
    on its sequence axis (ndim - 3), the other entries as they are."""
    def put(path, z, c):
        if str(path[-1].key) in ("k", "v"):
            return jax.lax.dynamic_update_slice_in_dim(z, c.astype(z.dtype), 0,
                                                       axis=z.ndim - 3)
        return c

    return jax.tree_util.tree_map_with_path(put, big, cache)


def _serve_want(name, params, batch, dec) -> dict:
    if ("serve", name) not in _JAX:
        arch, over = SERVE[name]
        jc = _jcfg(arch, over)
        jp = jax.tree.map(jnp.asarray, params)
        logits, cache = jax.jit(JS.make_prefill_step(jc))(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
        cache = _grow_jax(JT.init_cache(jc, B, P + N_DEC), cache)
        want = {"prefill": np.asarray(logits)}
        decode = jax.jit(JS.make_decode_step(jc))
        for i in range(N_DEC):
            lg, cache = decode(jp, {"token": jnp.asarray(dec[i]), "pos": jnp.int32(P + i)},
                               cache)
            want[f"decode{i}"] = np.asarray(lg)
        _JAX[("serve", name)] = want
    return _JAX[("serve", name)]


# ------------------------------------------------------------------- worlds
def _world(tag, d: pathlib.Path, restore_from=None) -> dict:
    """Run mesh ``tag``'s world on its cases; the JAX references run
    meanwhile.  Returns the ranks' records and the references."""
    model, trains, serves, inits = WORLDS[tag]
    cases = ([{"kind": "train", "name": f"train_{n}", "arch": TRAIN[n][0],
               "over": TRAIN[n][1], "opt": TRAIN[n][2], "local": LOCAL,
               "save": tag == "14" and n == "zamba2"} for n in trains]
             + [{"kind": "serve", "name": f"serve_{n}", "arch": SERVE[n][0],
                 "over": SERVE[n][1], "watch": True} for n in serves]
             + [{"kind": "init", "name": f"init_{n}", "arch": TRAIN[n][0],
                 "over": TRAIN[n][1], "opt": TRAIN[n][2]} for n in inits])
    for c in cases:  # the parameters this arch has
        names = dict(T.LM(_pcfg(c["arch"], c["over"]), torch.device("meta")).named_parameters())
        c["local"] = [n for n in c.get("local", ()) if n in names]
    if restore_from is not None:
        cases.append({"kind": "restore", "name": "restore_zamba2", "arch": HYBRID,
                      "opt": "adamw", "from": str(restore_from), "local": ["lora.0.a_q"]})
    (d / "cases.json").write_text(json.dumps({"model": model, "cases": cases}))
    ins = {("train", n): _train_inputs(n, d / f"train_{n}_in.npz") for n in trains}
    ins.update({("serve", n): _serve_inputs(n, d / f"serve_{n}_in.npz") for n in serves})
    procs = _start_world(d, job="hybrid_cross")
    t_end = time.time() + DEADLINE_S
    try:
        want = {f"train_{n}": _train_want(n, *ins[("train", n)]) for n in trains}
        want.update({f"serve_{n}": _serve_want(n, *ins[("serve", n)]) for n in serves})
    finally:
        _finish_world(procs, t_end)
    got = [dict(np.load(d / f"hybrid_cross_rank{r}.npz")) for r in range(4)]
    return {"got": got, "want": want, "dir": d, "model": model}


@pytest.fixture(scope="module")
def world14(tmp_path_factory):
    return _world("14", tmp_path_factory.mktemp("hybrid_cross_14"))


@pytest.fixture(scope="module")
def world22(tmp_path_factory, world14):
    return _world("22", tmp_path_factory.mktemp("hybrid_cross_22"),
                  restore_from=world14["dir"])


def _w(request, tag):
    return request.getfixturevalue(f"world{tag}")


# -------------------------------------------------------------------- tests
TRAIN_CASES = [("14", n) for n in WORLDS["14"][1]] + [("22", n) for n in WORLDS["22"][1]]


@pytest.mark.parametrize("tag,name", TRAIN_CASES, ids=[f"{t}-{n}" for t, n in TRAIN_CASES])
def test_sharded_train_step_matches_jax_single_device_step(request, tag, name):
    w = _w(request, tag)
    want = w["want"][f"train_{name}"]
    for g in w["got"]:  # every rank holds the same loss
        np.testing.assert_allclose(float(g[f"train_{name}.loss"]), want["loss"], rtol=2e-5)
    g = w["got"][0]
    assert set(want["params"]) == {k[len(f"train_{name}.p."):] for k in g
                                   if k.startswith(f"train_{name}.p.")}
    for k, v in want["params"].items():
        np.testing.assert_allclose(g[f"train_{name}.p.{k}"], v, rtol=2e-3, atol=2e-5,
                                   err_msg=k)


ADAFACTOR_CASES = [c for c in TRAIN_CASES if TRAIN[c[1]][2] == "adafactor"]


@pytest.mark.parametrize("tag,name", ADAFACTOR_CASES,
                         ids=[f"{t}-{n}" for t, n in ADAFACTOR_CASES])
def test_adafactor_accumulators_of_stacked_leaves_match_jax(request, tag, name):
    """Adafactor's factored moments over JAX's stacked leaves (``mamba``
    on two stacked axes, ``lora``, ``selfs``, ``cross``): equal to JAX's,
    each placed by ``policy.opt_specs``."""
    w = _w(request, tag)
    jacc = w["want"][f"train_{name}"]["opt"]["acc"]
    arch, over, opt = TRAIN[name]
    meta = T.LM(_pcfg(arch, over), torch.device("meta"))
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
    assert any(leaf.startswith(("mamba.", "selfs.")) for leaf in specs["acc"])


SERVE_CASES = [("14", n) for n in WORLDS["14"][2]] + [("22", n) for n in WORLDS["22"][2]]


@pytest.mark.parametrize("tag,name", SERVE_CASES, ids=[f"{t}-{n}" for t, n in SERVE_CASES])
def test_sharded_prefill_and_decode_match_jax(request, tag, name):
    w = _w(request, tag)
    want = w["want"][f"serve_{name}"]
    for g in w["got"]:
        for k in ["prefill"] + [f"decode{i}" for i in range(N_DEC)]:
            np.testing.assert_allclose(g[f"serve_{name}.{k}"], want[k], atol=SERVE_TOL,
                                       rtol=0, err_msg=k)


CROSS_CASES = [c for c in SERVE_CASES if SERVE[c[1]][0] != HYBRID]


@pytest.mark.parametrize("tag,name", CROSS_CASES, ids=[f"{t}-{n}" for t, n in CROSS_CASES])
def test_decode_reads_the_cross_cache_where_it_lies(request, tag, name):
    """No DTensor of a cross-cache layer's shape (B, source, K, dh) is
    redistributed in a decode step: along the source sequence each rank
    attends over its own frames or patches (the split softmax), on kv
    heads over its own heads."""
    w = _w(request, tag)
    cfg = _pcfg(*SERVE[name])
    layer = [B, cfg.n_frontend_tokens, cfg.n_kv_heads, cfg.head_dim]
    for g in w["got"]:
        moved = json.loads(str(g[f"serve_{name}.decode_redistributed"]))
        assert moved, "the watch saw no redistribute at all"
        assert layer not in moved, moved


def test_cache_and_lora_placements(world14, world22):
    g14, g22 = world14["got"][0], world22["got"][0]
    # zamba2 at (1, 4): the shared block's KV along the sequence, the SSD
    # states on heads (2 of 8 a rank), x0 on the batch (replicated here);
    # the LoRA b on dout (one head of 16 a rank), a whole at model 4
    assert tuple(g14["serve_zamba2.cache_local.attn:k"]) == (2, B, P // 4, 4, 16)
    assert tuple(g14["serve_zamba2.grown_local.attn:k"]) == (2, B, (P + N_DEC) // 4, 4, 16)
    assert tuple(g14["serve_zamba2.cache_local.ssm:ssm"]) == (2, 2, B, 2, 16, 16)
    assert tuple(g14["serve_zamba2.grown_local.ssm:ssm"]) == (2, 2, B, 2, 16, 16)
    assert tuple(g14["serve_zamba2.cache_local.x0"]) == (B, 1, 64)
    assert tuple(g14["train_zamba2.local.lora.0.b_q"]) == (4, 16)
    assert tuple(g14["train_zamba2.local.lora.0.a_q"]) == (128, 4)
    # (2, 2), FSDP: a on data (its 2d rows), b on model
    assert tuple(g22["train_zamba2_af.local.lora.0.a_q"]) == (64, 4)
    assert tuple(g22["train_zamba2_af.local.lora.0.b_q"]) == (4, 32)
    # whisper: its 16 frames 4 a rank, enc_pos on d
    assert tuple(g14["serve_whisper.cache_local.xk"]) == (2, B, 4, 4, 16)
    assert tuple(g14["serve_whisper.grown_local.xk"]) == (2, B, 4, 4, 16)
    assert tuple(g14["train_whisper.local.enc_pos"]) == (16, 16)
    # the vlm: its self KV (units, period - 1, ...) along the sequence, its 8
    # patches 2 a rank; at (2, 2) 9 patches fall back to kv heads (1 of 2),
    # the self KV stays along the sequence
    assert tuple(g14["serve_vlm.grown_local.k"]) == (2, 4, B, (P + N_DEC) // 4, 2, 16)
    assert tuple(g14["serve_vlm.cache_local.xk"]) == (2, B, 2, 2, 16)
    assert tuple(g22["serve_vlm9.cache_local.xk"]) == (2, B // 2, 9, 1, 16)
    assert tuple(g22["serve_vlm9.grown_local.k"]) == (2, 4, B // 2, (P + N_DEC) // 2, 2, 16)


INIT_CASES = [("14", n) for n in WORLDS["14"][3]]


@pytest.mark.parametrize("tag,name", INIT_CASES, ids=[f"{t}-{n}" for t, n in INIT_CASES])
def test_state_created_shard_by_shard_gathers_to_init_params(request, tag, name):
    w = _w(request, tag)
    arch, over, _ = TRAIN[name]
    ref = T.init_params(_pcfg(arch, over), torch.Generator("cpu").manual_seed(0), "cpu")
    g = w["got"][0]
    for k, p in ref.named_parameters():
        got = torch.from_numpy(g[f"init_{name}.p.{k}"]).reshape(-1)  # the gates are 0-d
        assert got.dtype == p.dtype and torch.equal(
            got.view(torch.uint8), p.detach().reshape(-1).view(torch.uint8)), k
    opt = [k for k in g if k.startswith(f"init_{name}.opt.")]
    assert opt and all(not np.any(g[k]) for k in opt)


def test_zamba2_checkpoint_saved_at_one_mesh_restores_at_another(world14, world22):
    saved, back = world14["got"][0], world22["got"][0]
    keys = [k[len("train_zamba2."):] for k in saved
            if k.startswith(("train_zamba2.p.", "train_zamba2.opt."))]
    assert any(k.startswith("p.shared.") for k in keys)
    assert any(k.startswith("opt.m:lora.1.") for k in keys)
    for k in keys:
        assert np.array_equal(back[f"restore_zamba2.{k}"], saved[f"train_zamba2.{k}"]), k
    assert tuple(back["restore_zamba2.local.lora.0.a_q"]) == (64, 4)


@pytest.mark.parametrize("arch", [HYBRID, AUDIO, VLM])
def test_train_cli_runs_the_family_on_a_world_of_ranks(tmp_path, arch):
    """``launch/train.py --arch <arch> --smoke`` as two ranks: the state
    created shard by shard on the CLI's all-data mesh, the frames or
    patches placed with the tokens, two steps, a finite loss on every
    rank."""
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
