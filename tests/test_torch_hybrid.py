"""The port's hybrid family (zamba2: Mamba2 blocks and one shared
attention + MLP block with a LoRA a unit) against the JAX package's on
the CPU, the smoke config, both attention routes, the JAX weights carried
across by ``params_from_jax`` with the LoRA ``b_*`` drawn non-zero
(JAX initialises them at zero, where a port without its LoRA would
match).  Tolerances as tests/test_torch_models.py (torch_lm_fixtures.py).

JAX's shared block passes ``q_pos`` whenever it is given a cache; the
port's full-cache prefill drops it (the same causal, top-left function)
and so reaches the flash kernel, which the route test counts.  JAX's
conv window of a prompt under 3 steps wraps around (ROADMAP queue 3), so
the 1- and 2-token prompts are held to the port's own forward."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_lm_fixtures as F  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCH = "zamba2-7b"


@pytest.mark.parametrize("impl", ["xla", "chunked"])
def test_hybrid_forward_prefill_decode_match_jax(impl):
    F.check_against_jax(ARCH, impl)


@pytest.mark.parametrize("impl", ["xla", "chunked"])
def test_hybrid_prefill_decode_matches_own_forward(impl):
    F.check_own_forward(ARCH, impl)


@pytest.mark.parametrize("impl", ["xla", "chunked"])
@pytest.mark.parametrize("n", [1, 2])
def test_hybrid_short_prompt_continues_its_forward(n, impl):
    """A prompt of 1 or 2 tokens (below the conv window of 3): the prefill
    state (zero rows, then the raw conv inputs) and the decode of the
    next token give the forward's logits."""
    F.check_own_forward(ARCH, impl, n=n)


@pytest.mark.parametrize("impl", ["xla", "chunked"])
def test_hybrid_bf16_within_bf16_tolerance_of_jax(impl):
    model, cache = F.check_bf16(ARCH, impl)
    assert model.lora[0].b_q.dtype == torch.bfloat16
    assert model.mamba[0][0].mixer.A_log.dtype == torch.float32
    assert cache["ssm"]["conv"].dtype == torch.bfloat16
    assert cache["ssm"]["ssm"].dtype == torch.float32


def test_hybrid_prefill_last_only_matches_jax():
    F.check_last_only(ARCH)


def test_hybrid_cache_layout_equals_jax():
    jc, tc = F.cfgs(ARCH)
    want = JT.init_cache(jc, F.B, 7)
    got = T.init_cache(tc, F.B, 7, device="cpu")
    assert set(got) == {"ssm", "attn", "x0"} == set(want)
    for part in ("ssm", "attn"):
        assert set(got[part]) == set(want[part])
        for name, val in got[part].items():
            assert tuple(val.shape) == want[part][name].shape, (part, name)
            assert str(val.dtype).split(".")[1] == str(want[part][name].dtype)
    assert tuple(got["x0"].shape) == want["x0"].shape == (F.B, 1, tc.d_model)
    n_units, m = T._hybrid_counts(tc)
    assert got["ssm"]["conv"].shape[:2] == (n_units, m) and got["attn"]["k"].shape[0] == n_units


def test_full_cache_prefill_takes_the_kernel_route_and_a_longer_cache_does_not(
        monkeypatch):
    """chunked: a prefill into a cache as long as the prompt reaches the
    flash kernel once a unit (causal, over the prompt's own keys); into a
    longer cache, and in decode, every shared-block call is the plain
    version with q_pos.  xla never reaches the kernel."""
    _, tc = F.cfgs(ARCH, "chunked")
    n_units, _ = T._hybrid_counts(tc)
    model = F.port_params(tc)
    b = F.batch(tc)
    calls = F.flash_spy(monkeypatch)
    S.make_prefill_step(tc, device="cpu")(model, F.prompt(b))
    assert calls["kernel"] == [(True, F.P, F.P)] * n_units and calls["plain"] == 0
    calls["kernel"].clear()
    cache = T.init_cache(tc, F.B, F.P + 1, device="cpu")
    T.prefill(model, F.prompt(b), cache, tc)
    T.decode_step(model, {"token": b["tokens"][:, F.P:], "pos": F.P}, cache, tc)
    assert calls["kernel"] == [] and calls["plain"] == 2 * n_units
    _, xc = F.cfgs(ARCH, "xla")
    calls["plain"] = 0
    S.make_prefill_step(xc, device="cpu")(model, F.prompt(b))
    assert calls["kernel"] == [] and calls["plain"] == n_units


def test_full_cache_prefill_without_q_pos_is_jaxs_function():
    """The kernel route's function (causal, no q_pos, over the fresh keys)
    equals JAX's shared-block call (q_pos = arange(S) over the written
    cache) on the same q, k, v."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 12, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, 12, 2, 8)).astype(np.float32) for _ in range(2))
    cache = {"k": torch.zeros((2, 12, 2, 8)), "v": torch.zeros((2, 12, 2, 8))}
    got = L.cached_attention(*(torch.tensor(a) for a in (q, k, v)), cache, 0,
                             impl="chunked")
    want = JL._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                    q_pos=jnp.arange(12), impl="chunked", chunk=4)
    F.close(got, want)
    F.close(cache["k"], k)


def test_hybrid_decode_reads_its_own_token_as_x0():
    """As JAX: the decode's x0 is the decode token's embedding; the
    cache's ``x0`` is carried, never read nor written."""
    _, tc = F.cfgs(ARCH)
    model = F.port_params(tc)
    b = F.batch(tc)
    outs = []
    for fill in (0.0, 7.0):
        cache = T.init_cache(tc, F.B, F.P + 1, device="cpu")
        T.prefill(model, F.prompt(b), cache, tc)
        cache["x0"].fill_(fill)
        ld, cache = T.decode_step(model, {"token": b["tokens"][:, F.P:], "pos": F.P},
                                  cache, tc)
        assert bool((cache["x0"] == fill).all())
        outs.append(ld)
    assert torch.equal(*outs)


def test_hybrid_params_from_jax_unstacks_units_and_blocks():
    """``mamba`` on two stacked axes (unit, block), ``lora`` on one, the
    shared block as it is; every weight exact, the counts equal."""
    jc, tc = F.cfgs(ARCH)
    tree = F.jax_params(jc, seed=6)
    model = T.params_from_jax(tree, tc, device="cpu")
    np.testing.assert_array_equal(model.mamba[1][0].mixer.A_log.detach().numpy(),
                                  tree["mamba"]["mixer"]["A_log"][1, 0])
    np.testing.assert_array_equal(model.get_parameter("mamba.0.1.mixer.in_proj.w").detach().numpy(),
                                  tree["mamba"]["mixer"]["in_proj"]["w"][0, 1])
    np.testing.assert_array_equal(model.get_parameter("lora.1.b_v").detach().numpy(),
                                  tree["lora"]["b_v"][1])
    assert model.lora[1].b_v.any()
    np.testing.assert_array_equal(model.get_parameter("shared.wq.w").detach().numpy(),
                                  tree["shared"]["wq"]["w"])
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in jax.tree.leaves(tree))


def test_hybrid_params_from_jax_refuses_a_tree_of_another_family():
    _, tc = F.cfgs(ARCH)
    jc_dense, _ = F.cfgs("qwen2.5-3b")
    dense = jax.tree.map(np.asarray, JT.init_params(jc_dense, jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="differ"):
        T.params_from_jax(dense, tc, device="cpu")
    jc_ssm, _ = F.cfgs("mamba2-2.7b")
    ssm = jax.tree.map(np.asarray, JT.init_params(jc_ssm, jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="mamba"):
        T.params_from_jax(ssm, tc, device="cpu")


def test_hybrid_init_params_scheme():
    """JAX's zeros: the LoRA ``b_*`` (so an initialised model's LoRA adds
    nothing); ``a_*`` N(0, 0.02); the shared block's norms of width 2d."""
    _, tc = F.cfgs(ARCH)
    a = T.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    b = T.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q) and p.requires_grad, name
    for lora in a.lora:
        for nm in "qkv":
            assert not getattr(lora, f"b_{nm}").any()
            w = getattr(lora, f"a_{nm}")
            assert w.shape == (2 * tc.d_model, tc.lora_rank)
            assert abs(float(w.std()) - 0.02) < 0.004
    assert a.shared.ln1.scale.shape == (2 * tc.d_model,) and bool((a.shared.ln1.scale == 1).all())
    assert a.shared.w_up.b is None and a.shared.w_down.b is None
