"""llama-3.2-vision-11b [vlm] — hf:meta-llama/Llama-3.2-11B-Vision (unverified).

40 decoder layers, 8 of them gated cross-attention over image patch
embeddings (period 5); vision frontend is a stub (input_specs supplies
precomputed patch embeddings, 1601 tokens for 560px/14 + CLS).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b", family="vlm",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=128256, rope_theta=5.0e5,
        cross_attn_period=5, n_frontend_tokens=1601,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b-smoke", family="vlm",
        n_layers=10, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=512, cross_attn_period=5,
        n_frontend_tokens=8, dtype="float32", vocab_pad_multiple=8,
    )
