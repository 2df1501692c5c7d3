"""grok-1-314b [moe] — hf:xai-org/grok-1 (unverified).

64L, d=6144, 48H/8KV GQA, 8 experts top-2, d_ff=32768 per expert,
GELU experts."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b", family="moe",
        n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=32768, vocab_size=131072, d_head=128, mlp_act="gelu",
        n_experts=8, experts_per_tok=2,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=512, d_head=16, mlp_act="gelu",
        n_experts=4, experts_per_tok=2, moe_group_size=64,
        dtype="float32", vocab_pad_multiple=8,
    )
