"""The port's dense LM (``repro_torch.models.transformer`` and
``repro_torch.launch.steps``) against the JAX package's on the CPU, for
the four dense smoke configs (tied and untied embeddings, MHA and GQA,
QKV bias), both attention routes, with the JAX weights carried across by
``params_from_jax``.

Tolerances (docs/PORT.md): float32 logits and caches within
1e-5 + 1e-5 |want| (the same f32 operations, sums in another order);
the port's own prefill + decode against its forward within 2e-4, the
JAX test's bound (tests/test_models.py); bfloat16 logits within
2^-6 (1 + |want|), four bf16 steps: the logits are bf16 products, and
both packages round to bf16 after every op but at different places (ATen
computes silu inside a bf16 op in f32), so two runs may differ by a
step or two.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config, model_config_from_jax  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

DENSE = ("smollm-135m", "qwen2-1.5b", "qwen2.5-3b", "minicpm-2b")
B, P = 2, 32  # batch, prompt; the decode adds token P
TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2.0 ** -6, atol=2.0 ** -6)
_JAX: dict = {}


def _cfgs(arch, impl, **kw):
    jc = dataclasses.replace(jget(arch, smoke=True), attn_impl=impl, **kw)
    return jc, model_config_from_jax(dataclasses.asdict(jc))


def _tokens(cfg, n=P + 1, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n)).astype(np.int32)


def _jax_run(arch, impl):
    """JAX forward, prefill (full cache and longer cache) and decode of one
    config, computed once per module."""
    key = (arch, impl)
    if key not in _JAX:
        jc, _ = _cfgs(arch, impl)
        params = JT.init_params(jc, jax.random.PRNGKey(0))
        toks = jnp.asarray(_tokens(jc))
        out = {"tree": jax.tree.map(np.asarray, params)}
        out["forward"] = JT.forward(params, {"tokens": toks}, jc, remat=False)[0]
        out["prefill"], out["prefill_cache"] = JS.make_prefill_step(jc)(
            params, {"tokens": toks[:, :P]})
        lp, cache = JT.prefill(params, {"tokens": toks[:, :P]},
                               JT.init_cache(jc, B, P + 1), jc, remat=False)
        out["prefill_long"], out["prefill_long_cache"] = lp, cache
        out["decode"], out["decode_cache"] = JS.make_decode_step(jc)(
            params, {"token": toks[:, P:], "pos": jnp.asarray(P, jnp.int32)}, cache)
        _JAX[key] = jax.tree.map(np.asarray, out)
    return _JAX[key]


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want),
                               **(tol or TOL))


@pytest.mark.parametrize("impl", ["xla", "chunked"])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_prefill_decode_match_jax(arch, impl):
    jc, tc = _cfgs(arch, impl)
    want = _jax_run(arch, impl)
    model = T.params_from_jax(want["tree"], tc, device="cpu")
    toks = _tokens(tc)
    logits, aux = T.forward(model, {"tokens": toks}, tc)
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    _close(logits, want["forward"])

    lp, cache = S.make_prefill_step(tc, device="cpu")(model, {"tokens": toks[:, :P]})
    _close(lp, want["prefill"])
    for name in ("k", "v"):
        _close(cache[name], want["prefill_cache"][name])

    cache = T.init_cache(tc, B, P + 1, device="cpu")
    lp, cache = T.prefill(model, {"tokens": toks[:, :P]}, cache, tc)
    _close(lp, want["prefill_long"])
    ld, cache = S.make_decode_step(tc, device="cpu")(
        model, {"token": toks[:, P:], "pos": P}, cache)
    _close(ld, want["decode"])
    for name in ("k", "v"):
        _close(cache[name], want["decode_cache"][name])


@pytest.mark.parametrize("impl", ["xla", "chunked"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_matches_own_forward(arch, impl):
    """As tests/test_models.py::test_prefill_decode_matches_forward, on the
    port alone: 32 prompt tokens into a cache of 33, then token 32."""
    _, tc = _cfgs(arch, impl)
    model = T.init_params(tc, torch.Generator().manual_seed(1), device="cpu")
    toks = _tokens(tc, seed=3)
    full, _ = T.forward(model, {"tokens": toks}, tc)
    cache = T.init_cache(tc, B, P + 1, dtype=torch.float32, device="cpu")
    lp, cache = T.prefill(model, {"tokens": toks[:, :P]}, cache, tc)
    _close(lp, full[:, :P].numpy(), rtol=2e-4, atol=2e-4)
    ld, _ = T.decode_step(model, {"token": toks[:, P:], "pos": torch.tensor(P)}, cache, tc)
    _close(ld[:, 0], full[:, P].numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "smollm-135m"])
def test_prefill_last_only_matches_jax(arch):
    jc, tc = _cfgs(arch, "chunked", prefill_last_only=True)
    params = JT.init_params(jc, jax.random.PRNGKey(4))
    toks = _tokens(jc, n=P)
    want, _ = JS.make_prefill_step(jc)(params, {"tokens": jnp.asarray(toks)})
    model = T.params_from_jax(jax.tree.map(np.asarray, params), tc, device="cpu")
    got, _ = S.make_prefill_step(tc, device="cpu")(model, {"tokens": toks})
    assert tuple(got.shape) == (B, 1, tc.padded_vocab)
    _close(got, want)


@pytest.mark.parametrize("impl", ["xla", "chunked"])
def test_bf16_model_within_bf16_tolerance_of_jax(impl):
    jc, tc = _cfgs("qwen2.5-3b", impl, dtype="bfloat16")
    params = JT.init_params(jc, jax.random.PRNGKey(5))
    toks = _tokens(jc)
    want, _ = JT.forward(params, {"tokens": jnp.asarray(toks)}, jc, remat=False)
    model = T.params_from_jax(jax.tree.map(np.asarray, params), tc, device="cpu")
    assert model.embed.tok.dtype == torch.bfloat16
    got, _ = T.forward(model, {"tokens": toks}, tc)
    _close(got, want, **BF16_TOL)
    lp, cache = S.make_prefill_step(tc, device="cpu")(model, {"tokens": toks[:, :P]})
    assert cache["k"].dtype == torch.bfloat16
    _close(lp, np.asarray(want)[:, :P], **BF16_TOL)


@pytest.mark.parametrize("impl", ["xla", "chunked"])
def test_dense_variant_layernorm_gelu_learned_positions_matches_jax(impl):
    """The dense family's other branches: LayerNorm, the gelu MLP with
    biases, learned positions (no rope), tied embeddings."""
    jc, tc = _cfgs("qwen2.5-3b", impl, norm="layernorm", mlp_act="gelu",
                   pos="learned", tie_embeddings=True)
    params = JT.init_params(jc, jax.random.PRNGKey(7))
    toks = _tokens(jc)
    want, _ = JT.forward(params, {"tokens": jnp.asarray(toks)}, jc, remat=False)
    jcache = JT.init_cache(jc, B, P + 1)
    _, jcache = JT.prefill(params, {"tokens": jnp.asarray(toks[:, :P])}, jcache, jc,
                           remat=False)
    jd, _ = JT.decode_step(params, {"token": jnp.asarray(toks[:, P:]),
                                    "pos": jnp.asarray(P, jnp.int32)}, jcache, jc)
    model = T.params_from_jax(jax.tree.map(np.asarray, params), tc, device="cpu")
    _close(T.forward(model, {"tokens": toks}, tc)[0], want)
    cache = T.init_cache(tc, B, P + 1, device="cpu")
    _, cache = T.prefill(model, {"tokens": toks[:, :P]}, cache, tc)
    _close(T.decode_step(model, {"token": toks[:, P:], "pos": P}, cache, tc)[0], jd)


def test_params_from_jax_loads_every_weight_exactly():
    jc, tc = _cfgs("qwen2.5-3b", "xla")
    tree = jax.tree.map(np.asarray, JT.init_params(jc, jax.random.PRNGKey(6)))
    model = T.params_from_jax(tree, tc, device="cpu")
    np.testing.assert_array_equal(model.blocks[1].attn.wq.b.numpy(),
                                  tree["blocks"]["attn"]["wq"]["b"][1])
    np.testing.assert_array_equal(model.embed.lm_head.numpy(), tree["embed"]["lm_head"])
    n_jax = sum(a.size for a in jax.tree.leaves(tree))
    assert sum(p.numel() for p in model.parameters()) == n_jax


def test_params_from_jax_refuses_a_tree_of_another_model():
    jc, tc = _cfgs("qwen2.5-3b", "xla")
    tree = jax.tree.map(np.asarray, JT.init_params(jc, jax.random.PRNGKey(6)))
    del tree["embed"]["lm_head"]
    with pytest.raises(ValueError, match="lm_head"):
        T.params_from_jax(tree, tc, device="cpu")
    _, tied = _cfgs("minicpm-2b", "xla")
    with pytest.raises(ValueError):
        T.params_from_jax(jax.tree.map(np.asarray, JT.init_params(
            jc, jax.random.PRNGKey(6))), tied, device="cpu")


@pytest.mark.parametrize("arch", DENSE)
def test_init_params_scheme(arch):
    """N(0, 0.02) weights, norm scales at one, biases at zero, the config's
    dtype; the same generator seed gives the same weights."""
    cfg = get_config(arch, smoke=True)
    a = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q) and p.dtype == torch.float32 and not p.requires_grad
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            assert bool((p == 1).all())
        elif leaf in ("b", "bias"):
            assert not p.any()
        else:
            assert abs(float(p.std()) - 0.02) < 0.004
    assert (a.embed.lm_head is None) == cfg.tie_embeddings


# ------------------------------------------------------------- refusals
@pytest.mark.parametrize("arch", ["dbrx-132b", "mamba2-2.7b", "zamba2-7b",
                                  "whisper-medium", "llama-3.2-vision-11b"])
def test_other_families_raise_naming_the_family(arch):
    cfg = get_config(arch, smoke=True)
    for call in (lambda: T.init_params(cfg, device="cpu"),
                 lambda: T.init_cache(cfg, 1, 8, device="cpu"),
                 lambda: T.forward(None, {"tokens": np.zeros((1, 4), np.int32)}, cfg)):
        with pytest.raises(NotImplementedError, match=cfg.family):
            call()


def test_dense_config_with_experts_raises():
    cfg = dataclasses.replace(get_config("qwen2.5-3b", smoke=True), n_experts=4,
                              experts_per_tok=2)
    with pytest.raises(NotImplementedError, match="n_experts"):
        T.init_params(cfg, device="cpu")


def test_seq_shard_and_sharding_policy_raise():
    cfg = dataclasses.replace(get_config("qwen2.5-3b", smoke=True), attn_seq_shard=True)
    model = T.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="sharding"):
        T.forward(model, {"tokens": _tokens(cfg, n=8)}, cfg)
    with pytest.raises(NotImplementedError, match="sharding"):
        S.make_prefill_step(cfg, policy=object(), device="cpu")


@pytest.mark.parametrize("pos,n", [(P + 1, 1), (P + 5, 1), (P, 2)])
def test_decode_past_the_cache_raises(pos, n):
    cfg = get_config("qwen2.5-3b", smoke=True)
    model = T.init_params(cfg, device="cpu")
    cache = T.init_cache(cfg, B, P + 1, device="cpu")
    with pytest.raises(ValueError, match="past the cache"):
        if n == 1:
            T.decode_step(model, {"token": _tokens(cfg, n=1), "pos": pos}, cache, cfg)
        else:
            T.prefill(model, {"tokens": _tokens(cfg, n=P + n)}, cache, cfg)


def test_decode_writes_where_jax_writes():
    """Every in-range position: the decode's keys land in slot pos."""
    cfg = get_config("smollm-135m", smoke=True)
    model = T.init_params(cfg, device="cpu")
    toks = _tokens(cfg, n=6)
    cache = T.init_cache(cfg, B, 6, device="cpu")
    for pos in range(6):
        _, cache = T.decode_step(model, {"token": toks[:, pos:pos + 1], "pos": pos},
                                 cache, cfg)
        assert bool(cache["k"][:, :, pos].any()) and not cache["k"][:, :, pos + 1:].any()


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    cfg = get_config("qwen2.5-3b", smoke=True)
    for call in (lambda: T.init_params(cfg), lambda: T.init_cache(cfg, 1, 8),
                 lambda: T.init_params(cfg, device="cuda"),
                 lambda: S.make_prefill_step(cfg), lambda: S.make_decode_step(cfg),
                 lambda: T.params_from_jax({}, cfg)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
