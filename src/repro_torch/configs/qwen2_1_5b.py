"""qwen2-1.5b [dense] — arXiv:2407.10671 (hf-verified).

GQA 12H/2KV with QKV bias, d_head=128 (> d_model/n_heads: Qwen2 uses
fixed 128 head dim)."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b", family="dense",
        n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
        d_ff=8960, vocab_size=151936, d_head=128,
        qkv_bias=True, rope_theta=1.0e6,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=512, d_head=16, qkv_bias=True,
        dtype="float32", vocab_pad_multiple=8,
    )
