"""Sequence-parallel attention (``attn_seq_shard``) of the port against the
JAX package on the CPU:

- without a sharding context the flag changes nothing: the port's forward
  and prefill of smollm-135m smoke with it equal JAX's logits (JAX's
  ``constrain_seq_parallel`` is a no-op outside its context), both
  attention routes;
- the plain version at a rank's positions (a contiguous run, or C / n
  rows of every chunk of C) against JAX's ``_sdpa_dense`` with the same
  ``q_pos``; one rank's rows of ``seq_rank_attention``, stitched over the
  ranks, against the whole attention;
- ``FlashAttnFn`` with positions (its backward's key bounds from the
  positions' host copy) against the plain version's autograd;
- a gloo world of four ranks at mesh (1, 4) (tests/torch_sharded_ranks.py,
  job ``seq``): smollm-135m smoke (3 heads and 3 kv heads, which 4 does
  not divide), chunks of 8 over 16 positions (2 rows of every chunk a
  rank): the prefill's logits (chunked and xla) and one train step's loss
  and parameters against JAX's single-device runs, within the tolerances
  of JAX's sharded test (loss rtol 2e-5, parameters rtol 2e-3 / atol
  2e-5, logits 1e-5); and the route adds to the prefill one all-gather on
  "model" a layer, of the attention output's bytes, and moves no k or v.
"""
import concurrent.futures
import dataclasses
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import model_config_from_jax  # noqa: E402
from repro_torch.kernels.flash_attn.ops import (FlashAttnFn, block_positions,  # noqa: E402
                                                host_positions)
from repro_torch.kernels.flash_attn.ref import flash_attn_ref  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.sharding import attention as SA  # noqa: E402

import torch_sharded_ranks as R  # noqa: E402
from test_torch_sharded_step import REPO, run_world  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
B, P = 2, 32
#: the gloo world's config: chunks of 8 over 16 positions, 4 ranks
WORLD_OVER = dict(attn_impl="chunked", attn_chunk=8)
WORLD_B, WORLD_S = 4, 16


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("impl", ["xla", "chunked"])
def test_seq_shard_without_a_policy_gives_jax_logits(impl):
    jc = dataclasses.replace(jget("smollm-135m", smoke=True), attn_impl=impl,
                             attn_chunk=8, attn_seq_shard=True)
    cfg = model_config_from_jax(dataclasses.asdict(jc))
    params = JT.init_params(jc, jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(0, jc.vocab_size, (B, P)).astype(np.int32)
    want_fwd, _ = JT.forward(params, {"tokens": jnp.asarray(toks)}, jc, remat=False)
    want_pre, _ = JS.make_prefill_step(jc)(params, {"tokens": jnp.asarray(toks)})
    model = T.params_from_jax(jax.tree.map(np.asarray, params), cfg, "cpu")
    with torch.no_grad():
        got_fwd, _ = T.forward(model, {"tokens": toks}, cfg, remat=False)
    got_pre, _ = S.make_prefill_step(cfg, device="cpu")(model, {"tokens": toks})
    np.testing.assert_allclose(_np(got_fwd), np.asarray(want_fwd), **TOL)
    np.testing.assert_allclose(_np(got_pre), np.asarray(want_pre), **TOL)


def _qkv(Sq, Sk, H=4, K=2, dh=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, Sq, H, dh)).astype(np.float32),
            rng.standard_normal((2, Sk, K, dh)).astype(np.float32),
            rng.standard_normal((2, Sk, K, dh)).astype(np.float32))


#: (rows a block, period, offset): rank 1 of 4 over 64 positions, striped
#: in chunks of 16 (4 rows of each) and contiguous
LAYOUTS = {"striped": (4, 16, 4), "contiguous": (16, 64, 16)}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_plain_version_at_rank_positions_matches_jax_sdpa_dense(layout):
    block, period, off = LAYOUTS[layout]
    q, k, v = _qkv(16, 64)
    pos = block_positions(16, block, period, off, "cpu")
    want = JL._sdpa_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True,
                          jnp.asarray(host_positions(pos)))
    got = flash_attn_ref(*map(torch.from_numpy, (q, k, v)), True, pos)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    assert host_positions(pos).tolist() == pos.tolist()


@pytest.mark.parametrize("impl,chunk", [("chunked", 16), ("chunked", 64), ("xla", 16)])
def test_rank_rows_stitch_to_the_whole_attention(impl, chunk):
    q, k, v = map(torch.from_numpy, _qkv(64, 64, seed=3))
    n = 4
    outs = [SA.seq_rank_attention(q, k, v, r, n, chunk, True, impl) for r in range(n)]
    block, period = SA.seq_layout(64, n, impl, chunk)
    got = SA.seq_stitch(outs, n, block, period)
    np.testing.assert_allclose(_np(got), _np(flash_attn_ref(q, k, v, True)), **TOL)
    assert SA.seq_layout(64, 3, impl, chunk) is None  # 3 divides neither


@pytest.mark.parametrize("chunk", [3, 8])
def test_flash_fn_with_positions_matches_the_plain_autograd(chunk):
    q, k, v = _qkv(16, 64, seed=5)
    pos = block_positions(16, 4, 16, 8, "cpu")  # rank 2 of 4, chunks of 16
    g = torch.from_numpy(np.random.default_rng(6).standard_normal(q.shape).astype(np.float32))

    def grads(fn):
        ts = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        (fn(*ts) * g).sum().backward()
        return [t.grad for t in ts]

    got = grads(lambda a, b, c: FlashAttnFn.apply(a, b, c, True, chunk, pos))
    want = grads(lambda a, b, c: flash_attn_ref(a, b, c, True, pos))
    for x, y in zip(got, want):
        np.testing.assert_allclose(_np(x), _np(y), rtol=1e-5, atol=1e-6)
    # the keys past the rows' last position (59) get no gradient
    assert float(got[1][:, 60:].abs().max()) == 0.0 < float(got[1][:, 59].abs().max())


@pytest.fixture(scope="module", autouse=True)
def seq_world_started(tmp_path_factory):
    """The gloo world's inputs (JAX's state and tokens), and the world
    itself started in a thread with the module's first test, so that its
    ranks run beside the tests before ``seq_world``."""
    d = tmp_path_factory.mktemp("seq_shard")
    jc = dataclasses.replace(jget("smollm-135m", smoke=True), attn_seq_shard=True,
                             **WORLD_OVER)
    jtc = JTrainConfig(**R.TRAIN_KW)
    state = JS.TrainState.create(jc, jtc, jax.random.PRNGKey(2))
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jc.vocab_size, (WORLD_B, WORLD_S)).astype(np.int32)
    ttoks = rng.integers(0, jc.vocab_size, (WORLD_B, WORLD_S)).astype(np.int32)
    flat = T.unstack_jax_tree(jax.tree.map(np.asarray, state.params))
    np.savez(d / "seq_in.npz", tokens=toks, train_tokens=ttoks,
             over=json.dumps(WORLD_OVER), **{f"p.{k}": v for k, v in flat.items()})
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        world = pool.submit(run_world, 4, lambda r: [
            sys.executable, str(REPO / "tests" / "torch_sharded_ranks.py"), "seq", str(d)])
        yield d, jc, jtc, state, toks, ttoks, world


@pytest.fixture(scope="module")
def seq_world(seq_world_started):
    d, jc, jtc, state, toks, ttoks, world = seq_world_started
    params = state.params
    want = {"prefill": np.asarray(JS.make_prefill_step(jc)(params, {"tokens": jnp.asarray(toks)})[0])}
    jx = dataclasses.replace(jc, attn_impl="xla")
    want["xla"] = np.asarray(JS.make_prefill_step(jx)(params, {"tokens": jnp.asarray(toks)})[0])
    after, metrics = jax.jit(JS.make_train_step(jc, jtc))(state, {"tokens": jnp.asarray(ttoks)})
    want["loss"] = float(metrics["loss"])
    want["params"] = T.unstack_jax_tree(jax.tree.map(np.asarray, after.params))
    world.result()
    return [dict(np.load(d / f"seq_rank{r}.npz")) for r in range(4)], want


def test_sequence_parallel_prefill_matches_jax(seq_world):
    got, want = seq_world
    for g in got:
        np.testing.assert_allclose(g["seq.prefill"], want["prefill"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(g["plain.prefill"], want["prefill"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(g["xla.prefill"], want["xla"], atol=1e-5, rtol=0)


def test_sequence_parallel_train_step_matches_jax(seq_world):
    got, want = seq_world
    for g in got:
        np.testing.assert_allclose(float(g["loss"]), want["loss"], rtol=2e-5)
        for name, w in want["params"].items():
            np.testing.assert_allclose(g[f"p.{name}"], w, rtol=2e-3, atol=2e-5,
                                       err_msg=name)


def test_sequence_parallel_route_adds_only_the_output_gather(seq_world):
    got, _ = seq_world
    cfg = jget("smollm-135m", smoke=True)
    out_bytes = WORLD_B * WORLD_S * cfg.n_heads * (cfg.d_model // cfg.n_heads) * 4
    for tag in ("seq", "xla"):
        seq, plain = json.loads(str(got[0][f"{tag}.coll"])), json.loads(str(got[0]["plain.coll"]))
        added = {k: {a: n - plain["counts"].get(k, {}).get(a, 0) for a, n in ax.items()}
                 for k, ax in seq["counts"].items()}
        added = {k: {a: n for a, n in ax.items() if n} for k, ax in added.items()}
        assert {k: ax for k, ax in added.items() if ax} == {"all-gather": {"model": cfg.n_layers}}
        assert (seq["bytes"]["all-gather"]["model"] - plain["bytes"]["all-gather"]["model"]
                == cfg.n_layers * out_bytes)
        for k in plain["counts"]:  # nothing else moves: no k or v
            if k != "all-gather":
                assert seq["bytes"][k] == plain["bytes"][k], k
