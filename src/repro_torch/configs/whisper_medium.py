"""whisper-medium [audio] — arXiv:2212.04356 (unverified).

24 encoder + 24 decoder layers, d=1024, 16 heads, LayerNorm, GELU,
learned positions; conv audio frontend is a stub (input_specs supplies
1500 precomputed frame embeddings).  Vocab 51,865 is padded to 51,968
(multiple of 256) for TP divisibility — DESIGN.md SS6.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium", family="audio",
        n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16,
        n_kv_heads=16, d_ff=4096, vocab_size=51865,
        qkv_bias=True, norm="layernorm", pos="learned", mlp_act="gelu",
        n_frontend_tokens=1500,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium-smoke", family="audio",
        n_layers=2, n_enc_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab_size=512,
        qkv_bias=True, norm="layernorm", pos="learned", mlp_act="gelu",
        n_frontend_tokens=16, dtype="float32", vocab_pad_multiple=8,
    )
