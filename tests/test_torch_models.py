"""The port's LM (``repro_torch.models.transformer`` and
``repro_torch.launch.steps``) against the JAX package's on the CPU, for
the four dense smoke configs (tied and untied embeddings, MHA and GQA,
QKV bias), the moe smoke configs (dbrx-132b: swiglu experts; grok-1-314b:
gelu experts), a dense config with experts and the ssm smoke config
(mamba2-2.7b), both attention routes, with the JAX weights carried across
by ``params_from_jax``.  The hybrid, audio and vlm families have their
own files (test_torch_hybrid.py, test_torch_cross.py).

Tolerances (docs/PORT.md): float32 logits and caches within
1e-5 + 1e-5 |want| (the same f32 operations, sums in another order), the
MoE aux loss within 1e-6; the port's own prefill + decode against its
forward within 2e-4, the JAX test's bound (tests/test_models.py), with
drop-free MoE capacity there as in that test (capacity is grouping-
dependent, and a prompt groups its tokens otherwise than the full
sequence); bfloat16 logits within 2^-6 (1 + |want|), four bf16 steps:
the logits are bf16 products, and both packages round to bf16 after
every op but at different places (ATen computes silu inside a bf16 op in
f32), so two runs may differ by a step or two.
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
MOE_SSM = ("dbrx-132b", "grok-1-314b", "mamba2-2.7b")
AUX_TOL = 1e-6
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
        out["forward"], out["aux"] = JT.forward(params, {"tokens": toks}, jc, remat=False)
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
@pytest.mark.parametrize("arch", DENSE + MOE_SSM)
def test_forward_prefill_decode_match_jax(arch, impl):
    jc, tc = _cfgs(arch, impl)
    want = _jax_run(arch, impl)
    model = T.params_from_jax(want["tree"], tc, device="cpu")
    toks = _tokens(tc)
    logits, aux = T.forward(model, {"tokens": toks}, tc)
    assert logits.dtype == torch.float32 and aux.dtype == torch.float32
    assert abs(float(aux) - float(want["aux"])) <= AUX_TOL
    assert (float(aux) > 0) == (tc.n_experts > 0)
    _close(logits, want["forward"])

    lp, cache = S.make_prefill_step(tc, device="cpu")(model, {"tokens": toks[:, :P]})
    _close(lp, want["prefill"])
    assert set(cache) == set(want["prefill_cache"])
    for name in cache:
        _close(cache[name], want["prefill_cache"][name])

    cache = T.init_cache(tc, B, P + 1, device="cpu")
    lp, cache = T.prefill(model, {"tokens": toks[:, :P]}, cache, tc)
    _close(lp, want["prefill_long"])
    ld, cache = S.make_decode_step(tc, device="cpu")(
        model, {"token": toks[:, P:], "pos": P}, cache)
    _close(ld, want["decode"])
    for name in cache:
        _close(cache[name], want["decode_cache"][name])


@pytest.mark.parametrize("impl", ["xla", "chunked"])
@pytest.mark.parametrize("arch", DENSE + MOE_SSM)
def test_prefill_decode_matches_own_forward(arch, impl):
    """As tests/test_models.py::test_prefill_decode_matches_forward, on the
    port alone: 32 prompt tokens into a cache of 33, then token 32; MoE
    capacity drop-free, as there."""
    _, tc = _cfgs(arch, impl)
    if tc.n_experts:
        tc = dataclasses.replace(tc, capacity_factor=tc.n_experts / tc.experts_per_tok)
    model = T.init_params(tc, torch.Generator().manual_seed(1), device="cpu")
    toks = _tokens(tc, seed=3)
    full, _ = T.forward(model, {"tokens": toks}, tc)
    cache = T.init_cache(tc, B, P + 1, dtype=torch.float32, device="cpu")
    lp, cache = T.prefill(model, {"tokens": toks[:, :P]}, cache, tc)
    _close(lp, full[:, :P].detach().numpy(), rtol=2e-4, atol=2e-4)
    ld, _ = T.decode_step(model, {"token": toks[:, P:], "pos": torch.tensor(P)}, cache, tc)
    _close(ld[:, 0], full[:, P].detach().numpy(), rtol=2e-4, atol=2e-4)


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


@pytest.mark.parametrize("arch,impl", [("dbrx-132b", "xla"), ("dbrx-132b", "chunked"),
                                       ("mamba2-2.7b", "xla")])
def test_bf16_moe_and_ssm_within_bf16_tolerance_of_jax(arch, impl):
    """bf16 dbrx and mamba2: forward, prefill and decode; the float32
    leaves (router, A_log, D, dt_bias) stay float32.  JAX runs its layer
    loop unscanned (``scan_layers=False``, op by op, rounding after every
    op as the port does): its scanned forward compiles the layer body,
    whose fusions round bf16 elsewhere, and on these inputs that moves
    two dbrx positions by 0.045 against its own unscanned forward (where
    the port is within one bf16 step of the unscanned one)."""
    jc, tc = _cfgs(arch, impl, dtype="bfloat16", scan_layers=False)
    params = JT.init_params(jc, jax.random.PRNGKey(5))
    toks = _tokens(jc)
    want, _ = JT.forward(params, {"tokens": jnp.asarray(toks)}, jc, remat=False)
    jcache = JT.init_cache(jc, B, P + 1)
    _, jcache = JT.prefill(params, {"tokens": jnp.asarray(toks[:, :P])}, jcache, jc,
                           remat=False)
    jd, _ = JT.decode_step(params, {"token": jnp.asarray(toks[:, P:]),
                                    "pos": jnp.asarray(P, jnp.int32)}, jcache, jc)
    model = T.params_from_jax(jax.tree.map(np.asarray, params), tc, device="cpu")
    assert model.embed.tok.dtype == torch.bfloat16
    got, _ = T.forward(model, {"tokens": toks}, tc)
    _close(got, want, **BF16_TOL)
    cache = T.init_cache(tc, B, P + 1, device="cpu")
    lp, cache = T.prefill(model, {"tokens": toks[:, :P]}, cache, tc)
    _close(lp, np.asarray(want)[:, :P], **BF16_TOL)
    ld, cache = T.decode_step(model, {"token": toks[:, P:], "pos": P}, cache, tc)
    _close(ld, jd, **BF16_TOL)
    if tc.family == "ssm":
        assert cache["conv"].dtype == torch.bfloat16 and cache["ssm"].dtype == torch.float32


@pytest.mark.parametrize("impl", ["xla", "chunked"])
def test_dense_config_with_experts_matches_jax(impl):
    """A dense-family config with n_experts = 4: its blocks take the MoE
    layer (as JAX's do), forward with the aux loss, prefill and decode."""
    jc, tc = _cfgs("qwen2.5-3b", impl, n_experts=4, experts_per_tok=2,
                   moe_group_size=16)
    params = JT.init_params(jc, jax.random.PRNGKey(8))
    assert "moe" in params["blocks"] and "mlp" not in params["blocks"]
    toks = _tokens(jc)
    want, want_aux = JT.forward(params, {"tokens": jnp.asarray(toks)}, jc, remat=False)
    jcache = JT.init_cache(jc, B, P + 1)
    jp, jcache = JT.prefill(params, {"tokens": jnp.asarray(toks[:, :P])}, jcache, jc,
                            remat=False)
    jd, jcache = JT.decode_step(params, {"token": jnp.asarray(toks[:, P:]),
                                         "pos": jnp.asarray(P, jnp.int32)}, jcache, jc)
    model = T.params_from_jax(jax.tree.map(np.asarray, params), tc, device="cpu")
    got, aux = T.forward(model, {"tokens": toks}, tc)
    _close(got, want)
    assert abs(float(aux) - float(want_aux)) <= AUX_TOL and float(aux) > 0
    cache = T.init_cache(tc, B, P + 1, device="cpu")
    lp, cache = T.prefill(model, {"tokens": toks[:, :P]}, cache, tc)
    _close(lp, jp)
    ld, cache = T.decode_step(model, {"token": toks[:, P:], "pos": P}, cache, tc)
    _close(ld, jd)
    for name in ("k", "v"):
        _close(cache[name], jcache[name])


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
    np.testing.assert_array_equal(model.blocks[1].attn.wq.b.detach().numpy(),
                                  tree["blocks"]["attn"]["wq"]["b"][1])
    np.testing.assert_array_equal(model.embed.lm_head.detach().numpy(), tree["embed"]["lm_head"])
    n_jax = sum(a.size for a in jax.tree.leaves(tree))
    assert sum(p.numel() for p in model.parameters()) == n_jax


@pytest.mark.parametrize("arch", ["dbrx-132b", "mamba2-2.7b"])
def test_params_from_jax_keeps_f32_leaves_in_a_bf16_model(arch):
    """Each leaf takes the dtype of the port's parameter: the MoE router
    and the Mamba2 A_log, D and dt_bias stay float32 (and exact) in a
    bfloat16 model; the rest is bfloat16, as in the JAX tree."""
    jc, tc = _cfgs(arch, "xla", dtype="bfloat16")
    tree = jax.tree.map(np.asarray, JT.init_params(jc, jax.random.PRNGKey(6)))
    model = T.params_from_jax(tree, tc, device="cpu")
    f32 = {"router", "A_log", "D", "dt_bias"}
    seen = set()
    for path, arr in T._flatten(tree):
        name = ".".join(("blocks", "1") + path[1:]) if path[0] == "blocks" else ".".join(path)
        prm = model.get_parameter(name)
        leaf = path[-1]
        want_dtype = torch.float32 if leaf in f32 else torch.bfloat16
        assert prm.dtype == want_dtype, name
        assert str(arr.dtype) == ("float32" if leaf in f32 else "bfloat16"), name
        a = arr[1] if path[0] == "blocks" else arr
        np.testing.assert_array_equal(prm.float().detach().numpy(), np.asarray(a, np.float32))
        seen.add(leaf)
    assert f32 & seen == ({"router"} if arch == "dbrx-132b" else {"A_log", "D", "dt_bias"})


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


@pytest.mark.parametrize("arch", DENSE + MOE_SSM)
def test_init_params_scheme(arch):
    """JAX's scheme leaf by leaf: N(0, 0.02) weights (``conv_w`` N(0,
    0.1)), norm scales and ``D`` at one, biases, ``conv_b`` and
    ``dt_bias`` at zero, ``A_log`` = log(linspace(1, 16, H)); the config's
    dtype (f32 here); the same generator seed gives the same weights."""
    cfg = get_config(arch, smoke=True)
    a = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    leaves = set()
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q) and p.dtype == torch.float32 and p.requires_grad
        leaf = name.rsplit(".", 1)[-1]
        leaves.add(leaf)
        if leaf in ("scale", "norm_scale", "D"):
            assert bool((p == 1).all())
        elif leaf in ("b", "bias", "conv_b", "dt_bias"):
            assert not p.any()
        elif leaf == "A_log":
            want = np.log(np.linspace(1.0, 16.0, p.shape[0], dtype=np.float32))
            np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-6)
        else:
            std = 0.1 if leaf == "conv_w" else 0.02
            assert abs(float(p.std()) - std) < 0.2 * std, name
    assert (a.embed.lm_head is None) == cfg.tie_embeddings
    if cfg.family == "ssm":
        assert {"conv_w", "conv_b", "A_log", "D", "dt_bias", "norm_scale"} <= leaves
    if cfg.n_experts:
        assert {"router", "w_up", "w_down"} <= leaves


# ------------------------------------------------------------- refusals
def test_unknown_family_raises_value_error():
    """As JAX's dispatch: every entry point refuses a family it does not
    know with ValueError naming it."""
    cfg = dataclasses.replace(get_config("qwen2.5-3b", smoke=True), family="rnn")
    model = T.init_params(get_config("qwen2.5-3b", smoke=True), device="cpu")
    for call in (lambda: T.init_params(cfg, device="cpu"),
                 lambda: T.init_cache(cfg, 1, 8, device="cpu"),
                 lambda: T.params_from_jax({}, cfg, device="cpu"),
                 lambda: T.forward(model, {"tokens": np.zeros((1, 4), np.int32)}, cfg),
                 lambda: T.prefill(model, {"tokens": np.zeros((1, 4), np.int32)}, {}, cfg),
                 lambda: T.decode_step(model, {"token": np.zeros((1, 1), np.int32),
                                               "pos": 0}, {}, cfg)):
        with pytest.raises(ValueError, match="rnn"):
            call()


def test_seq_shard_and_sharding_policy_raise():
    cfg = dataclasses.replace(get_config("qwen2.5-3b", smoke=True), attn_seq_shard=True)
    model = T.init_params(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="sharding"):
        T.forward(model, {"tokens": _tokens(cfg, n=8)}, cfg)
    # so it does in the audio family's attention; a sharding policy is
    # taken by every family (the hybrid's too: no family refuses one)
    audio = dataclasses.replace(get_config("whisper-medium", smoke=True),
                                attn_seq_shard=True)
    b = _tokens(audio, n=8)
    rng = np.random.default_rng(0)
    with pytest.raises(NotImplementedError, match="sharding"):
        T.forward(T.init_params(audio, device="cpu"),
                  {"tokens": b, "audio": rng.standard_normal(
                      (b.shape[0], audio.n_frontend_tokens, audio.d_model))}, audio)
    assert callable(S.make_prefill_step(get_config("zamba2-7b", smoke=True),
                                        policy=object(), device="cpu"))


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


def test_ssm_decode_takes_any_pos():
    """The ssm cache has no length: a decode at any ``pos`` (past the
    cache length given to init_cache too) computes the same step."""
    cfg = get_config("mamba2-2.7b", smoke=True)
    model = T.init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    toks = _tokens(cfg, n=P + 1)
    want = None
    for pos in (P, 0, P + 1, 10 ** 6):
        cache = T.init_cache(cfg, B, 4, device="cpu")
        _, cache = T.prefill(model, {"tokens": toks[:, :P]}, cache, cfg)
        ld, cache = T.decode_step(model, {"token": toks[:, P:], "pos": pos}, cache, cfg)
        if want is None:
            want = ld
        assert torch.equal(ld, want)
        assert tuple(cache["ssm"].shape[:2]) == (cfg.n_layers, B)


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
    for arch in ("qwen2.5-3b", "dbrx-132b", "mamba2-2.7b", "zamba2-7b",
                 "whisper-medium", "llama-3.2-vision-11b"):
        cfg = get_config(arch, smoke=True)
        for call in (lambda: T.init_params(cfg), lambda: T.init_cache(cfg, 1, 8),
                     lambda: T.init_params(cfg, device="cuda"),
                     lambda: S.make_prefill_step(cfg), lambda: S.make_decode_step(cfg),
                     lambda: T.params_from_jax({}, cfg)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
