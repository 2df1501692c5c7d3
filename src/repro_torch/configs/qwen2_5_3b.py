"""qwen2.5-3b [dense] — hf:Qwen/Qwen2.5-3B (hf-verified).

GQA 16H/2KV with QKV bias, d_head=128.  The published checkpoint ties its
embeddings (3.09B parameters, 2.77B without them); this config, like the
JAX package's, leaves ``tie_embeddings`` False, so its model carries an
untied lm_head of 151,936 x 2,048 more (3.40B)."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b", family="dense",
        n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2,
        d_ff=11008, vocab_size=151936, d_head=128,
        qkv_bias=True, rope_theta=1.0e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=512, d_head=16, qkv_bias=True,
        dtype="float32", vocab_pad_multiple=8,
    )
