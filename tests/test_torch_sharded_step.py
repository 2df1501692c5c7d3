"""The port's sharded LM paths on the CPU, in gloo worlds of ranks (one
process a rank, joined through the EDM_* contract, every world under one
deadline), against the JAX package's single-device runs:

- qwen2-1.5b smoke, mesh (2 data, 2 model), FSDP: one sharded train step
  against JAX's jitted single-device step from the same state, at the
  tolerances of JAX's own sharded test (tests/test_sharding.py: loss rtol
  2e-5, parameters rtol 2e-3 / atol 2e-5);
- the sharded prefill (cache sized to the prompt, KV along the sequence
  on "model") and four decode steps over the grown cache (the flash-decode
  all-reduce) against JAX's unsharded prefill and decode, within 1e-5;
  the same at mesh (1, 4) for qwen2.5-3b smoke, whose two kv heads stay
  replicated under four query-head shards;
- ``compressed_psum`` over four ranks within 1e-6 of JAX's, run on four
  fake CPU devices in a subprocess, on the same per-worker gradients;
- the Prefetcher places batches by the batch specs;
- the train CLI as two ranks saves a checkpoint that a world of one
  resumes, to the bits of a world-of-one run from the same checkpoint,
  the sharded steps within JAX's sharded tolerances of unbroken
  world-of-one steps.
"""
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
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager, _flatten  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.data.pipeline import Prefetcher, TokenStream  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.steps import TrainState, make_train_step  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

import torch_sharded_ranks as R  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
DEADLINE_S = 150
SERVE_TOL = 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_world(W: int, cmd_of, cwd=None):
    """W ranks of ``cmd_of(r)`` joined on localhost; every rank is killed
    at the deadline.  Returns (return codes, logs)."""
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "OMP_NUM_THREADS": "1"}
    for k in ("EDM_LOCAL_DEVICE_IDS", "EDM_FAULTS"):
        env.pop(k, None)
    procs = [subprocess.Popen(cmd_of(r), cwd=cwd, env={
        **env, "EDM_COORDINATOR": f"localhost:{port}", "EDM_NUM_PROCESSES": str(W),
        "EDM_PROCESS_ID": str(r)}, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(W)]
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
    assert rcs == [0] * W, "\n".join(f"rank {r} rc {rc}:\n{log[-3000:]}"
                                     for r, (rc, log) in enumerate(zip(rcs, logs)))
    return rcs, logs


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _serve_inputs(arch, d: pathlib.Path) -> dict:
    """JAX's prefill and decode of ``arch`` smoke, its biases drawn
    non-zero; writes the parameters and tokens the ranks read and returns
    JAX's logits."""
    jc = jget(arch, smoke=True)
    params = JT.init_params(jc, jax.random.PRNGKey(1))
    rng = np.random.default_rng(4)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(0.02 * rng.standard_normal(a.shape), a.dtype)
        if str(path[-1].key) == "b" else a, params)
    B, P, n = R.SERVE_B, R.SERVE_P, R.SERVE_DECODE
    tokens = rng.integers(0, jc.vocab_size, (B, P)).astype(np.int32)
    logits, cache = JS.make_prefill_step(jc)(params, {"tokens": jnp.asarray(tokens)})
    big = JT.init_cache(jc, B, P + n)
    cache = jax.tree.map(lambda z, c: z.at[:, :, :P].set(c), big, cache)
    want = {"prefill": np.asarray(logits)}
    tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
    dec_tokens = []
    decode = JS.make_decode_step(jc)
    for i in range(n):
        dec_tokens.append(np.asarray(tok))
        lg, cache = decode(params, {"token": tok, "pos": jnp.int32(P + i)}, cache)
        want[f"decode{i}"] = np.asarray(lg)
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
    flat = T.unstack_jax_tree(_np(params))
    np.savez(d / "serve_in.npz", tokens=tokens, dec_tokens=np.stack(dec_tokens),
             **{f"p.{k}": v for k, v in flat.items()})
    return want


#: JAX's compressed_psum on four fake CPU devices (argv: input npz, output npz)
JAX_PSUM = textwrap.dedent("""
    import sys, numpy as np, jax, jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    from repro.optim import grad_compress as GC
    d = np.load(sys.argv[1])
    mesh = jax.make_mesh((4,), ("data",))
    def body(g_loc, e_loc):
        m, ne = GC.compressed_psum(g_loc[0], e_loc[0], ("data",))
        return m[None], ne[None]
    f = shard_map(body, mesh=mesh, in_specs=(P("data", None), P("data", None)),
                  out_specs=(P("data", None), P("data", None)), check_rep=False)
    with mesh:
        m, e = f(jnp.asarray(d["g"]), jnp.asarray(d["err"]))
    np.savez(sys.argv[2], mean=np.asarray(m), err=np.asarray(e))
""")


@pytest.fixture(scope="module")
def main_world(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_main")
    # JAX's single-device train step from its own initial state
    jc = jget("qwen2-1.5b", smoke=True)
    jtc = JTrainConfig(**R.TRAIN_KW)
    state = JS.TrainState.create(jc, jtc, jax.random.PRNGKey(0))
    tokens = TokenStream(jc.vocab_size, R.TRAIN_B, R.TRAIN_S, 0).batch_at(0)["tokens"]
    after, metrics = jax.jit(JS.make_train_step(jc, jtc))(state, {"tokens": jnp.asarray(tokens)})
    np.savez(d / "train_in.npz", tokens=tokens,
             **{f"p.{k}": v for k, v in T.unstack_jax_tree(_np(state.params)).items()})
    want = {"loss": float(metrics["loss"]), "params": T.unstack_jax_tree(_np(after.params))}
    want["serve"] = _serve_inputs("qwen2-1.5b", d)
    # per-worker gradients; JAX's compressed psum over four fake devices
    rng = np.random.default_rng(11)
    g = rng.standard_normal((4, 64)).astype(np.float32)
    err = (0.01 * rng.standard_normal((4, 64))).astype(np.float32)
    np.savez(d / "psum_in.npz", g=g, err=err)
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    r = subprocess.run([sys.executable, "-c", JAX_PSUM, str(d / "psum_in.npz"),
                        str(d / "psum_jax.npz")], env=env, capture_output=True, text=True,
                       timeout=DEADLINE_S)
    assert r.returncode == 0, r.stderr[-3000:]
    want["psum"] = dict(np.load(d / "psum_jax.npz"))
    run_world(4, lambda rk: [sys.executable, str(REPO / "tests" / "torch_sharded_ranks.py"),
                             "main", str(d)])
    got = [dict(np.load(d / f"main_rank{rk}.npz")) for rk in range(4)]
    return got, want


def test_sharded_train_step_matches_jax_single_device_step(main_world):
    got, want = main_world
    for g in got:  # every rank holds the same loss and the same whole state
        np.testing.assert_allclose(float(g["loss"]), want["loss"], rtol=2e-5)
        for name, w in want["params"].items():
            np.testing.assert_allclose(g[f"p.{name}"], w, rtol=2e-3, atol=2e-5,
                                       err_msg=name)
    # FSDP on data and TP on model: the embedding's vocab on model, d on data
    assert tuple(got[0]["local_tok_shape"]) == (512 // 2, 64 // 2)
    assert int(got[0]["n_degraded"]) == 0


def test_sharded_prefill_and_decode_match_jax(main_world):
    got, want = main_world
    # KV along the sequence on "model", the batch on "data"
    assert tuple(got[0]["serve.cache_local_k"]) == (2, R.SERVE_B // 2, R.SERVE_P // 2, 2, 16)
    for g in got:
        for k, w in want["serve"].items():
            np.testing.assert_allclose(g[f"serve.{k}"], w, atol=SERVE_TOL, rtol=0,
                                       err_msg=k)


def test_compressed_psum_matches_jax_over_four_ranks(main_world):
    got, want = main_world
    for r, g in enumerate(got):
        np.testing.assert_allclose(g["psum_mean"], want["psum"]["mean"][r], atol=1e-6, rtol=0)
        np.testing.assert_allclose(g["psum_err"], want["psum"]["err"][r], atol=1e-6, rtol=0)


def test_prefetcher_places_batches_by_the_batch_specs(main_world):
    got, _ = main_world
    g = got[0]
    assert int(g["prefetch_n"]) == 3 and bool(g["prefetch_equal"])
    assert tuple(g["prefetch_local"]) == (2, 8)  # batch on data (2), model replicated


def test_sharded_serve_with_replicated_kv_heads_matches_jax(tmp_path):
    want = _serve_inputs("qwen2.5-3b", tmp_path)
    run_world(4, lambda rk: [sys.executable, str(REPO / "tests" / "torch_sharded_ranks.py"),
                             "tp4", str(tmp_path)])
    for rk in range(4):
        g = dict(np.load(tmp_path / f"tp4_rank{rk}.npz"))
        assert tuple(g["serve.cache_local_k"]) == (2, R.SERVE_B, R.SERVE_P // 4, 2, 16)
        for k, w in want.items():
            np.testing.assert_allclose(g[f"serve.{k}"], w, atol=SERVE_TOL, rtol=0,
                                       err_msg=k)


def test_prefetcher_moves_batches_to_the_device():
    stream = TokenStream(100, 2, 5, seed=1)
    pf = Prefetcher(stream, prefetch=1, n_steps=4, device="cpu")
    got = list(pf)
    assert len(got) == 4
    for i, b in enumerate(got):
        assert isinstance(b["tokens"], torch.Tensor)
        np.testing.assert_array_equal(b["tokens"].numpy(), stream.batch_at(i)["tokens"])
    pf = Prefetcher(stream, prefetch=1, device="cpu")
    first = next(iter(pf))
    pf.stop()
    np.testing.assert_array_equal(first["tokens"].numpy(), stream.batch_at(0)["tokens"])


def test_train_cli_across_two_ranks_resumes_at_world_one(tmp_path, capsys):
    ck = tmp_path / "ck"
    args = ["--smoke", "--batch", "4", "--seq", "16", "--save-every", "3",
            "--log-every", "1", "--device", "cpu", "--ckpt-dir", str(ck)]
    _, logs = run_world(2, lambda rk: [sys.executable, "-m", "repro_torch.launch.train",
                                       *args, "--steps", "6"])
    for log in logs:
        assert "mesh {'data': 2, 'model': 1}" in log
        assert log.strip().splitlines()[-1].startswith("done at step 6; final loss ")
    assert CheckpointManager(ck).all_steps() == [3, 6]
    # the world of one resumes from the world of two's step 6
    state, step, _ = train.main([*args, "--steps", "9"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == "resumed from step 6" and step == 9
    # ... to the bits of a world-of-one run from the same checkpoint
    cfg = get_config("smollm-135m", smoke=True)
    tc = TrainConfig(lr=3e-4, total_steps=9, warmup_steps=1)
    like = TrainState.create(cfg, tc, device="cpu")
    ref = CheckpointManager(ck).restore(6, like)
    stepf = make_train_step(cfg, tc, device="cpu")
    stream = TokenStream(cfg.vocab_size, 4, 16, seed=tc.seed)
    for i in range(6, 9):
        ref, _ = stepf(ref, stream.batch_at(i))
    fa, fb = _flatten(state), _flatten(ref)
    for k in fa:
        assert torch.equal(fa[k].detach().view(-1).view(torch.uint8),
                           fb[k].detach().view(-1).view(torch.uint8)), k
    # the two ranks' six steps against six unbroken steps of one process
    one = TrainState.create(cfg, TrainConfig(lr=3e-4, total_steps=6, warmup_steps=1),
                            device="cpu")
    step6 = make_train_step(cfg, TrainConfig(lr=3e-4, total_steps=6, warmup_steps=1),
                            device="cpu")
    for i in range(6):
        one, _ = step6(one, stream.batch_at(i))
    two = CheckpointManager(ck).restore(6, like)
    for (k, a), (_, b) in zip(one.params.named_parameters(), two.params.named_parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(), rtol=2e-3,
                                   atol=2e-5, err_msg=k)
