"""Shared fixtures of the LM family parity tests (test_torch_hybrid.py,
test_torch_cross.py): the smoke configs of both packages, numpy-seeded
batches (tokens; audio frames and image patches 0.1 N(0, 1), as in
tests/test_models.py), JAX weights whose zero-initialised leaves (LoRA
``b_*``, the vlm gates, biases) are drawn non-zero so that no branch
hides behind a zero, and one JAX run per (arch, route).

Tolerances (docs/PORT.md): float32 within 1e-5 + 1e-5 |want|; the port's
own prefill + decode against its forward within 2e-4 (tests/test_models.py);
bfloat16 within 2^-6 (1 + |want|)."""
import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro_torch.configs import model_config_from_jax
from repro_torch.launch import steps as S
from repro_torch.models import transformer as T

B, P = 2, 32  # batch, prompt; the decode adds token P
TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=2.0 ** -6, atol=2.0 ** -6)
#: leaves JAX initialises at zero; drawn non-zero before the weights cross
ZERO_LEAVES = ("b_q", "b_k", "b_v", "gate_attn", "gate_mlp", "b", "bias")
_JAX: dict = {}


def cfgs(arch, impl="xla", **kw):
    jc = dataclasses.replace(jget(arch, smoke=True), attn_impl=impl, **kw)
    return jc, model_config_from_jax(dataclasses.asdict(jc))


def batch(cfg, n=P + 1, seed=2) -> dict:
    """tokens (B, n) and, for audio / vlm, the frontend's embeddings."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)}
    key = T.FRONTEND.get(cfg.family)
    if key is not None:
        out[key] = (0.1 * rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)
    return out


def prompt(b: dict, n=P) -> dict:
    return {**b, "tokens": b["tokens"][:, :n]}


def nonzero_tree(tree, seed=9):
    """``tree`` (numpy leaves) with every ZERO_LEAVES leaf drawn from the
    seed: gates 0.3 + 0.6 U(0, 1) (tanh 0.29-0.72), the rest 0.02 N(0, 1),
    each in its own dtype."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        leaf = str(path[-1].key)
        if leaf not in ZERO_LEAVES:
            return a
        r = (0.3 + 0.6 * rng.uniform(size=a.shape) if leaf.startswith("gate")
             else 0.02 * rng.standard_normal(a.shape))
        return np.asarray(r, np.float32).astype(a.dtype)

    return jax.tree_util.tree_map_with_path(draw, tree)


def jax_params(jc, seed=0):
    """The JAX tree (numpy leaves, zero leaves drawn non-zero)."""
    return nonzero_tree(jax.tree.map(np.asarray, JT.init_params(jc, jax.random.PRNGKey(seed))))


def jnp_batch(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def jax_run(arch, impl):
    """JAX forward, make_prefill_step, prefill into a cache of P + 1 and
    the decode of token P, once a module per (arch, route)."""
    key = (arch, impl)
    if key not in _JAX:
        jc, _ = cfgs(arch, impl)
        tree = jax_params(jc)
        params = jax.tree.map(jnp.asarray, tree)
        b = batch(jc)
        out = {"tree": tree}
        out["forward"], _ = JT.forward(params, jnp_batch(b), jc, remat=False)
        out["prefill"], out["prefill_cache"] = JS.make_prefill_step(jc)(
            params, jnp_batch(prompt(b)))
        lp, cache = JT.prefill(params, jnp_batch(prompt(b)), JT.init_cache(jc, B, P + 1),
                               jc, remat=False)
        out["prefill_long"], out["prefill_long_cache"] = lp, cache
        out["decode"], out["decode_cache"] = JS.make_decode_step(jc)(
            params, {"token": jnp.asarray(b["tokens"][:, P:]),
                     "pos": jnp.asarray(P, jnp.int32)}, cache)
        _JAX[key] = jax.tree.map(np.asarray, out)
    return _JAX[key]


def close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def close_tree(got: dict, want: dict, **tol):
    """Every leaf of a (nested) cache, key for key."""
    assert set(got) == set(want), (sorted(got), sorted(want))
    for name in got:
        if isinstance(got[name], dict):
            close_tree(got[name], want[name], **tol)
        else:
            assert tuple(got[name].shape) == tuple(np.shape(want[name])), name
            close(got[name], want[name], **tol)


def check_against_jax(arch, impl):
    """The port's forward, make_prefill_step (logits and every cache leaf),
    prefill into a longer cache and decode against JAX's, float32."""
    jc, tc = cfgs(arch, impl)
    want = jax_run(arch, impl)
    model = T.params_from_jax(want["tree"], tc, device="cpu")
    b = batch(tc)
    logits, aux = T.forward(model, b, tc)
    assert float(aux) == 0.0
    close(logits, want["forward"])
    lp, cache = S.make_prefill_step(tc, device="cpu")(model, prompt(b))
    close(lp, want["prefill"])
    close_tree(cache, want["prefill_cache"])
    cache = T.init_cache(tc, B, P + 1, device="cpu")
    lp, cache = T.prefill(model, prompt(b), cache, tc)
    close(lp, want["prefill_long"])
    close_tree(cache, want["prefill_long_cache"])
    ld, cache = S.make_decode_step(tc, device="cpu")(
        model, {"token": b["tokens"][:, P:], "pos": P}, cache)
    close(ld, want["decode"])
    close_tree(cache, want["decode_cache"])


def port_params(tc, seed=1):
    """init_params, then the zero leaves drawn non-zero (as nonzero_tree)."""
    model = T.init_params(tc, torch.Generator().manual_seed(seed), device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.startswith("gate"):
                prm.copy_(0.3 + 0.6 * torch.rand(prm.shape, generator=g))
            elif leaf in ZERO_LEAVES:
                prm.copy_(0.02 * torch.randn(prm.shape, generator=g))
    return model


def check_own_forward(arch, impl, n=P):
    """The port alone: an n-token prompt into a cache of n + 1, then token
    n, against its own forward of n + 1 tokens, within 2e-4."""
    _, tc = cfgs(arch, impl)
    model = port_params(tc)
    b = batch(tc, n=n + 1, seed=3)
    full, _ = T.forward(model, b, tc)
    cache = T.init_cache(tc, B, n + 1, dtype=torch.float32, device="cpu")
    lp, cache = T.prefill(model, prompt(b, n), cache, tc)
    close(lp, full[:, :n].detach().numpy(), **STEP_TOL)
    ld, _ = T.decode_step(model, {"token": b["tokens"][:, n:], "pos": torch.tensor(n)},
                          cache, tc)
    close(ld[:, 0], full[:, n].detach().numpy(), **STEP_TOL)


def check_bf16(arch, impl):
    """bf16 forward, prefill and decode against JAX's (its layer loop
    unscanned where the family reads ``scan_layers``), within 2^-6 (1 +
    |want|); float32 leaves stay float32."""
    jc, tc = cfgs(arch, impl, dtype="bfloat16", scan_layers=False)
    tree = jax_params(jc, seed=5)
    params = jax.tree.map(jnp.asarray, tree)
    b = batch(jc)
    want, _ = JT.forward(params, jnp_batch(b), jc, remat=False)
    jcache = JT.init_cache(jc, B, P + 1)
    jp, jcache = JT.prefill(params, jnp_batch(prompt(b)), jcache, jc, remat=False)
    jd, _ = JT.decode_step(params, {"token": jnp.asarray(b["tokens"][:, P:]),
                                    "pos": jnp.asarray(P, jnp.int32)}, jcache, jc)
    model = T.params_from_jax(tree, tc, device="cpu")
    assert model.embed.tok.dtype == torch.bfloat16
    got, _ = T.forward(model, b, tc)
    close(got, want, **BF16_TOL)
    cache = T.init_cache(tc, B, P + 1, device="cpu")
    lp, cache = T.prefill(model, prompt(b), cache, tc)
    close(lp, jp, **BF16_TOL)
    ld, cache = T.decode_step(model, {"token": b["tokens"][:, P:], "pos": P}, cache, tc)
    close(ld, jd, **BF16_TOL)
    return model, cache


def check_last_only(arch):
    jc, tc = cfgs(arch, "chunked", prefill_last_only=True)
    tree = jax_params(jc, seed=4)
    b = prompt(batch(jc))
    want, _ = JS.make_prefill_step(jc)(jax.tree.map(jnp.asarray, tree), jnp_batch(b))
    model = T.params_from_jax(tree, tc, device="cpu")
    got, _ = S.make_prefill_step(tc, device="cpu")(model, b)
    assert tuple(got.shape) == (B, 1, tc.padded_vocab)
    close(got, want)


def flash_spy(monkeypatch):
    """Count the calls that reach ``flash_attn`` (the kernel route; its
    plain version on the CPU) by causal flag, and the plain-route calls."""
    from repro_torch.models import layers as L

    calls = {"kernel": [], "plain": 0}
    real_ref = L.flash_attn_ref

    def kernel(q, k, v, causal):
        calls["kernel"].append((causal, q.shape[1], k.shape[1]))
        return real_ref(q, k, v, causal)

    def plain(*a, **kw):
        calls["plain"] += 1
        return real_ref(*a, **kw)

    monkeypatch.setattr(L, "flash_attn", kernel)
    monkeypatch.setattr(L, "flash_attn_ref", plain)
    return calls
