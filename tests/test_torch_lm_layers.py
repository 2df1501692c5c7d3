"""The port's LM layers (``repro_torch.models.layers``) against the JAX
package's (``repro.models.layers``) on the CPU, with the JAX parameters
carried across (random norm scales and biases, so none is trivial).

Tolerance (docs/PORT.md): float32, |diff| <= 1e-5 + 1e-5 |want| — the
same f32 operations, with matmul and softmax sums in another order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _randomize(tree, seed):
    """Every leaf replaced by seeded numpy values (scales around one)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for path, a in T._flatten(tree):
        base = 1.0 if path[-1] == "scale" else 0.0
        flat[path] = (base + 0.2 * rng.standard_normal(a.shape)).astype(np.float32)
    out = {}
    for path, a in flat.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = a
    return out


def _load(module, tree):
    params = dict(module.named_parameters())
    flat = {".".join(p): a for p, a in T._flatten(tree)}
    assert set(flat) == set(params)
    with torch.no_grad():
        for name, prm in params.items():
            prm.copy_(torch.tensor(flat[name]))
    return module


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------- basics
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_jax(kind):
    tree = _randomize(JL.init_norm(kind, 24, jnp.float32), 1)
    mod = _load(L.Norm(kind, 24, torch.float32, "cpu"), tree)
    x = 3.0 * _x((2, 5, 24), 2)
    want = np.asarray(JL.apply_norm(kind, _jtree(tree), jnp.asarray(x)))
    got = L.apply_norm(kind, mod, torch.tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)
    fn = L.rms_norm if kind == "rmsnorm" else L.layer_norm
    np.testing.assert_array_equal(fn(mod, torch.tensor(x)).detach().numpy(), got)


@pytest.mark.parametrize("bias", [False, True])
def test_linear_matches_jax(bias):
    tree = _randomize(JL.init_linear(jax.random.PRNGKey(0), 16, 12, jnp.float32, bias), 3)
    mod = _load(L.Linear(16, 12, torch.float32, "cpu", bias), tree)
    x = _x((2, 7, 16), 4)
    want = np.asarray(JL.linear(_jtree(tree), jnp.asarray(x)))
    np.testing.assert_allclose(L.linear(mod, torch.tensor(x)).detach().numpy(), want, **TOL)


@pytest.mark.parametrize("theta,start,batched", [(1.0e4, 0, False), (1.0e6, 0, False),
                                                  (1.0e6, 2000, False), (1.0e4, 5, True)])
def test_rope_matches_jax(theta, start, batched):
    x = _x((2, 9, 3, 16), 5)
    pos = np.arange(start, start + 9)
    if batched:
        pos = np.stack([pos, pos + 3])
    want = np.asarray(JL.rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = L.rope(torch.tensor(x), torch.tensor(pos), theta).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_rope_keeps_bf16():
    x = torch.tensor(_x((1, 4, 2, 8), 6)).to(torch.bfloat16)
    assert L.rope(x, torch.arange(4), 1e4).dtype == torch.bfloat16


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_mlp_matches_jax(act):
    tree = _randomize(JL.init_mlp(jax.random.PRNGKey(1), 16, 40, act, jnp.float32), 7)
    mod = _load(L.MLP(16, 40, act, torch.float32, "cpu"), tree)
    x = _x((2, 6, 16), 8)
    want = np.asarray(JL.mlp_fwd(_jtree(tree), jnp.asarray(x), act))
    np.testing.assert_allclose(L.mlp_fwd(mod, torch.tensor(x), act).detach().numpy(), want, **TOL)


# ------------------------------------------------------------- attention
# (attn_impl, JAX's chunk, JAX's unroll): the port has no chunking knobs
# (the kernel takes any length), so chunk and unroll go to the JAX side only
IMPLS = [("xla", 1024, False), ("chunked", 1024, False), ("chunked", 8, False),
         ("chunked", 8, True)]
BRANCHES = ["self", "full_cache_prefill", "prefill_longer_cache",
            "prefill_at_offset", "decode", "cross_cached", "cross_kv_src"]
B, S, D, H, K, DH, S_MAX, S_SRC = 2, 16, 32, 4, 2, 8, 24, 12


def _dims(impl, cross):
    return dict(d_model=D, n_heads=H, n_kv_heads=K, d_head=DH, qkv_bias=True,
                rope_theta=1.0e4, use_rope=not cross, causal=not cross,
                kv_d_model=D if cross else None, impl=impl)


def _branch_inputs(branch, rng):
    """(x, kwargs as numpy) of one attention_fwd branch."""
    cache = lambda n: {"k": 0.5 * rng.standard_normal((B, n, K, DH)).astype(np.float32),  # noqa: E731
                       "v": 0.5 * rng.standard_normal((B, n, K, DH)).astype(np.float32)}
    Sq = {"decode": 1, "prefill_at_offset": 8}.get(branch, S)
    x = rng.standard_normal((B, Sq, D)).astype(np.float32)
    kw = {
        "self": {},
        "full_cache_prefill": {"cache": cache(S), "cache_pos": 0},
        "prefill_longer_cache": {"cache": cache(S_MAX), "cache_pos": 0},
        "prefill_at_offset": {"cache": cache(S_MAX), "cache_pos": 4},
        "decode": {"cache": cache(S_MAX), "cache_pos": 10},
        "cross_cached": {"cache": cache(S_SRC)},
        "cross_kv_src": {"kv_src": rng.standard_normal((B, S_SRC, D)).astype(np.float32)},
    }[branch]
    return x, kw


@pytest.mark.parametrize("impl,chunk,unroll", IMPLS)
@pytest.mark.parametrize("branch", BRANCHES)
def test_attention_branches_match_jax(branch, impl, chunk, unroll):
    cross = branch.startswith("cross")
    dims = _dims(impl, cross)
    ja = JL.AttnDims(**dims, chunk=chunk, unroll=unroll)
    ta = L.AttnDims(**dims)
    tree = _randomize(JL.init_attention(jax.random.PRNGKey(2), ja, jnp.float32), 9)
    mod = _load(L.Attention(ta, torch.float32, "cpu"), tree)
    x, kw = _branch_inputs(branch, np.random.default_rng(10))
    jkw = {k: (jax.tree.map(jnp.asarray, v) if k != "cache_pos" else v)
           for k, v in kw.items()}
    tkw = {k: (jax.tree.map(torch.tensor, v) if k != "cache_pos" else v)
           for k, v in kw.items()}
    jy, jcache = JL.attention_fwd(_jtree(tree), ja, jnp.asarray(x), **jkw)
    ty, tcache = L.attention_fwd(mod, ta, torch.tensor(x), **tkw)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **TOL)
    assert (jcache is None) == (tcache is None)
    if jcache is not None:
        for name in ("k", "v"):
            np.testing.assert_allclose(tcache[name].detach().numpy(), np.asarray(jcache[name]),
                                       **TOL)


@pytest.mark.parametrize("impl,chunk,unroll", IMPLS)
def test_attention_equals_jax_sdpa_chunked(impl, chunk, unroll):
    """The port's routed attention against the JAX ``_sdpa_chunked`` (a
    chunk that divides S) and ``_sdpa_dense``, on the same q, k, v."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((B, S, H, DH)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, K, DH)).astype(np.float32) for _ in range(2))
    got = L._sdpa(*(torch.tensor(a) for a in (q, k, v)), causal=True, impl=impl).detach().numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    np.testing.assert_allclose(got, np.asarray(JL._sdpa_chunked(
        jq, jk, jv, True, chunk=chunk, unroll=unroll)), **TOL)
    np.testing.assert_allclose(got, np.asarray(JL._sdpa_dense(jq, jk, jv, True)), **TOL)


@pytest.mark.parametrize("branch", BRANCHES)
def test_chunked_routes_to_the_flash_kernel_exactly_where_jax_would_chunk(branch,
                                                                          monkeypatch):
    """impl='chunked' reaches kernels.flash_attn for every Sq > 1 without
    q_pos (self, full-cache prefill, cross); decode and prefill into a
    longer cache (q_pos) stay on the dense version; 'xla' never calls it."""
    calls = []

    def spy(q, k, v, causal):
        calls.append(causal)
        return L.flash_attn_ref(q, k, v, causal)

    from repro_torch.kernels.flash_attn import ops

    monkeypatch.setattr(L, "flash_attn", spy)
    monkeypatch.setattr(ops, "flash_attn", spy)  # FlashAttnFn's forward, under grad
    x, kw = _branch_inputs(branch, np.random.default_rng(12))
    kw = {k: (jax.tree.map(torch.tensor, v) if k != "cache_pos" else v)
          for k, v in kw.items()}
    cross = branch.startswith("cross")
    for impl in ("xla", "chunked"):
        ta = L.AttnDims(**_dims(impl, cross))
        mod = L.Attention(ta, torch.float32, "cpu")
        with torch.no_grad():
            for p in mod.parameters():
                p.normal_(0.0, 0.1)
        L.attention_fwd(mod, ta, torch.tensor(x), **kw)
    want = {"self": [True], "full_cache_prefill": [True], "cross_cached": [False],
            "cross_kv_src": [False]}.get(branch, [])
    assert calls == want


def test_seq_shard_raises_naming_sharding():
    q = torch.zeros((1, 4, 2, 8))
    with pytest.raises(NotImplementedError, match="sharding"):
        L._sdpa(q, q, q, True, impl="chunked", seq_shard=True)


@pytest.mark.parametrize("cache_pos,Sq", [(24, 1), (20, 8), (-1, 1)])
def test_cache_write_past_the_end_raises(cache_pos, Sq):
    ta = L.AttnDims(**_dims("xla", False))
    mod = L.Attention(ta, torch.float32, "cpu")
    cache = {"k": torch.zeros((B, S_MAX, K, DH)), "v": torch.zeros((B, S_MAX, K, DH))}
    with pytest.raises(ValueError, match="past the cache|runs past"):
        L.attention_fwd(mod, ta, torch.zeros((B, Sq, D)), cache=cache,
                        cache_pos=cache_pos)
    assert not cache["k"].any()
