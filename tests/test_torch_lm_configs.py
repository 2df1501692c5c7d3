"""The port's LM configs (``repro_torch.configs``) and token stream
(``repro_torch.data.pipeline``) equal the JAX package's: every field of
every architecture, full and smoke, and every batch."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as JC  # noqa: E402
from repro.configs import base as JB  # noqa: E402
from repro.data.pipeline import TokenStream as JTokenStream  # noqa: E402
from repro_torch import configs as C  # noqa: E402
from repro_torch.configs import base as CB  # noqa: E402
from repro_torch.data.pipeline import TokenStream  # noqa: E402


def test_registry_lists_the_same_architectures():
    assert C.ARCHS == JC.ARCHS and C.list_archs() == JC.list_archs()


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", JC.ARCHS)
def test_get_config_equals_jax_field_for_field(arch, smoke):
    got, want = C.get_config(arch, smoke), JC.get_config(arch, smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.head_dim, got.padded_vocab, got.is_enc_dec) == (
        want.head_dim, want.padded_vocab, want.is_enc_dec)
    assert C.model_config_from_jax(dataclasses.asdict(want)) == got


def test_qwen2_5_3b_full_width():
    cfg = C.get_config("qwen2.5-3b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.padded_vocab, cfg.qkv_bias, cfg.rope_theta,
            cfg.tie_embeddings, cfg.dtype) == (36, 2048, 16, 2, 128, 11008, 152064,
                                               True, 1.0e6, False, "bfloat16")


def test_schema_fields_and_shape_cells_equal_jax():
    assert [(f.name, f.default) for f in dataclasses.fields(CB.ModelConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(JB.ModelConfig)]
    assert [dataclasses.asdict(c) for c in CB.SHAPE_CELLS] == [
        dataclasses.asdict(c) for c in JB.SHAPE_CELLS]
    for c in JB.SHAPE_CELLS:
        assert dataclasses.asdict(CB.shape_cell(c.name)) == dataclasses.asdict(c)
    with pytest.raises(KeyError):
        CB.shape_cell("train_1m")


@pytest.mark.parametrize("arch", JC.ARCHS)
def test_cell_applicable_equals_jax(arch):
    for cell in JB.SHAPE_CELLS:
        assert C.cell_applicable(C.get_config(arch), CB.shape_cell(cell.name)) == \
            JC.cell_applicable(JC.get_config(arch), cell)


def test_model_config_from_jax_refuses_unknown_fields():
    d = dataclasses.asdict(JC.get_config("qwen2.5-3b"))
    with pytest.raises(ValueError, match="bogus"):
        C.model_config_from_jax({**d, "bogus": 1})


@pytest.mark.parametrize("seed,steps", [(0, (0, 1, 7)), (3, (2,))])
def test_token_stream_batches_equal_jax(seed, steps):
    extra = {"audio": ((2, 5, 4), np.float32)}
    got, want = (cls(512, 2, 33, seed=seed, extra_specs=extra)
                 for cls in (TokenStream, JTokenStream))
    for step in steps:
        a, b = got.batch_at(step), want.batch_at(step)
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    it = iter(got)
    for step in range(3):
        np.testing.assert_array_equal(next(it)["tokens"], want.batch_at(step)["tokens"])


def test_token_stream_at_serving_width():
    """The smoke's requests: four of 2048 tokens over qwen2.5-3b's vocab."""
    tok = TokenStream(151936, 4, 2048, seed=0).batch_at(0)["tokens"]
    np.testing.assert_array_equal(
        tok, JTokenStream(151936, 4, 2048, seed=0).batch_at(0)["tokens"])
    assert tok.shape == (4, 2048) and tok.dtype == np.int32 and tok.max() < 151936
