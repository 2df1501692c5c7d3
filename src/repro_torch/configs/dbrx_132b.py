"""dbrx-132b [moe] — hf:databricks/dbrx-base (unverified).

40L, d=6144, 48H/8KV GQA, 16 experts top-4 fine-grained (d_ff=10752
per expert)."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=10752, vocab_size=100352, d_head=128, rope_theta=5.0e5,
        n_experts=16, experts_per_tok=4,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=512, d_head=16,
        n_experts=4, experts_per_tok=2, moe_group_size=64,
        dtype="float32", vocab_pad_multiple=8,
    )
