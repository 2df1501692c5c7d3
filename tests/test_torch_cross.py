"""The port's cross-attention families against the JAX package's on the
CPU: audio (whisper: a non-causal encoder over frame embeddings, a
decoder with causal self-attention and cross-attention over the
encoder) and vlm (llama-3.2-vision: units of decoder blocks with a gated
cross-attention block over image embeddings before the last one).  The
smoke configs, both attention routes, the JAX weights carried across by
``params_from_jax`` with the vlm gates and the biases drawn non-zero
(JAX initialises the gates at zero, where a port without its
cross-attention would match).  Audio frames and image patches are
0.1 N(0, 1), as in tests/test_models.py.  Tolerances as
tests/test_torch_models.py (torch_lm_fixtures.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import torch_lm_fixtures as F  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCHS = ("whisper-medium", "llama-3.2-vision-11b")


@pytest.mark.parametrize("impl", ["xla", "chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_jax(arch, impl):
    F.check_against_jax(arch, impl)


@pytest.mark.parametrize("impl", ["xla", "chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_own_forward(arch, impl):
    F.check_own_forward(arch, impl)


@pytest.mark.parametrize("impl", ["xla", "chunked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_within_bf16_tolerance_of_jax(arch, impl):
    model, cache = F.check_bf16(arch, impl)
    assert cache["xk"].dtype == torch.bfloat16
    if arch.startswith("llama"):
        assert model.cross[0].gate_attn.dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_last_only_matches_jax(arch):
    F.check_last_only(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_layout_equals_jax(arch):
    jc, tc = F.cfgs(arch)
    want = JT.init_cache(jc, F.B, 7)
    got = T.init_cache(tc, F.B, 7, device="cpu")
    assert set(got) == set(want) == {"k", "v", "xk", "xv"}
    for name, val in got.items():
        assert tuple(val.shape) == want[name].shape, name
        assert str(val.dtype).split(".")[1] == str(want[name].dtype)


def test_flash_routes_of_an_audio_prefill_and_decode(monkeypatch):
    """chunked: the encoder's non-causal attention (frames x frames), each
    decoder layer's causal self-attention and its cross-attention (prompt x
    frames) reach the kernel; decode stays plain (one query) and does not
    run the encoder."""
    _, tc = F.cfgs("whisper-medium", "chunked")
    model = F.port_params(tc)
    b = F.batch(tc)
    calls = F.flash_spy(monkeypatch)
    _, cache = S.make_prefill_step(tc, device="cpu")(model, F.prompt(b))
    nf = tc.n_frontend_tokens
    enc = [(False, nf, nf)] * tc.n_enc_layers
    dec = [(True, F.P, F.P), (False, F.P, nf)] * tc.n_layers
    assert calls["kernel"] == enc + dec and calls["plain"] == 0
    calls["kernel"].clear()
    big = T.init_cache(tc, F.B, F.P + 1, device="cpu")
    for name in cache:
        big[name][:, :, : cache[name].shape[2]] = cache[name]
    monkeypatch.setattr(T, "_encode_audio", None)  # decode must not call it
    T.decode_step(model, {"token": b["tokens"][:, F.P:], "pos": F.P}, big, tc)
    assert calls["kernel"] == [] and calls["plain"] == 2 * tc.n_layers


def test_flash_routes_of_a_vlm_prefill_and_decode(monkeypatch):
    """chunked: each unit's period - 1 causal self-attentions and its one
    cross-attention (prompt x patches) reach the kernel, the cross before
    the unit's last self layer; decode stays plain."""
    _, tc = F.cfgs("llama-3.2-vision-11b", "chunked")
    n_units, period = T._vlm_counts(tc)
    model = F.port_params(tc)
    b = F.batch(tc)
    calls = F.flash_spy(monkeypatch)
    S.make_prefill_step(tc, device="cpu")(model, F.prompt(b))
    selfs = [(True, F.P, F.P)]
    unit = selfs * (period - 2) + [(False, F.P, tc.n_frontend_tokens)] + selfs
    assert calls["kernel"] == unit * n_units and calls["plain"] == 0
    calls["kernel"].clear()
    cache = T.init_cache(tc, F.B, F.P + 1, device="cpu")
    T.prefill(model, F.prompt(b), cache, tc)
    calls["kernel"].clear()
    calls["plain"] = 0
    T.decode_step(model, {"token": b["tokens"][:, F.P:], "pos": F.P}, cache, tc)
    assert calls["kernel"] == [] and calls["plain"] == n_units * period


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_unstacks_every_stacked_tree(arch):
    """audio: ``enc_blocks`` and ``dec_blocks`` on one stacked axis,
    ``enc_pos`` and ``enc_ln_f`` as they are; vlm: ``selfs`` on two
    (unit, layer), ``cross`` on one.  Every weight exact, the counts
    equal, the gates float32 in a bf16 model."""
    jc, tc = F.cfgs(arch, dtype="bfloat16")
    tree = F.jax_params(jc, seed=6)
    model = T.params_from_jax(tree, tc, device="cpu")
    if tc.family == "audio":
        pairs = {"enc_blocks.1.attn.wq.b": tree["enc_blocks"]["attn"]["wq"]["b"][1],
                 "dec_blocks.0.xattn.wk.w": tree["dec_blocks"]["xattn"]["wk"]["w"][0],
                 "dec_blocks.1.ln3.bias": tree["dec_blocks"]["ln3"]["bias"][1],
                 "enc_pos": tree["enc_pos"], "enc_ln_f.scale": tree["enc_ln_f"]["scale"]}
    else:
        pairs = {"selfs.1.2.attn.wq.w": tree["selfs"]["attn"]["wq"]["w"][1, 2],
                 "selfs.0.3.mlp.w_up.w": tree["selfs"]["mlp"]["w_up"]["w"][0, 3],
                 "cross.1.gate_attn": tree["cross"]["gate_attn"][1],
                 "cross.0.xattn.wv.w": tree["cross"]["xattn"]["wv"]["w"][0]}
        assert model.cross[1].gate_mlp.dtype == torch.float32
        assert float(model.cross[1].gate_attn) != 0.0
    for name, want in pairs.items():
        got = model.get_parameter(name)
        np.testing.assert_array_equal(got.float().detach().numpy(), np.asarray(want, np.float32))
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in jax.tree.leaves(tree))


def test_params_from_jax_refuses_a_tree_of_another_family():
    _, whisper = F.cfgs("whisper-medium")
    _, vlm = F.cfgs("llama-3.2-vision-11b")
    jc_vlm, _ = F.cfgs("llama-3.2-vision-11b")
    tree = jax.tree.map(np.asarray, JT.init_params(jc_vlm, jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="differ"):
        T.params_from_jax(tree, whisper, device="cpu")
    del tree["cross"]["gate_mlp"]
    with pytest.raises(ValueError, match="gate_mlp"):
        T.params_from_jax(tree, vlm, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_scheme(arch):
    """JAX's zeros: the vlm gates (float32 scalars, so an initialised
    model's cross blocks add nothing) and the biases; ``enc_pos``
    N(0, 0.02); the same seed gives the same weights."""
    _, tc = F.cfgs(arch, dtype="bfloat16")
    a = T.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    b = T.init_params(tc, torch.Generator().manual_seed(0), device="cpu")
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q) and p.requires_grad, name
        leaf = name.rsplit(".", 1)[-1]
        if leaf.startswith("gate"):
            assert p.dtype == torch.float32 and p.shape == () and float(p) == 0.0
        elif leaf in ("b", "bias"):
            assert p.dtype == torch.bfloat16 and not p.any(), name
    if tc.family == "audio":
        assert a.enc_pos.shape == (tc.n_frontend_tokens, tc.d_model)
        assert abs(float(a.enc_pos.float().std()) - 0.02) < 0.004
    else:
        assert len(a.cross) == len(a.selfs) == T._vlm_counts(tc)[0]
