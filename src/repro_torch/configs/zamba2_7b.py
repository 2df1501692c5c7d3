"""zamba2-7b [hybrid] — arXiv:2411.15242 (unverified).

81 layers tiling the unit (mamba2, mamba2, shared-attention): 54 Mamba2
blocks + 27 applications of ONE shared attention+MLP block reading
concat(h, h0), with per-application LoRA adapters on q/k/v.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b", family="hybrid",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
        d_ff=14336, vocab_size=32000, d_head=112,
        ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_chunk=128,
        hybrid_pattern=("m", "m", "a"), lora_rank=64,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b-smoke", family="hybrid",
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=512, d_head=16,
        ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_chunk=16,
        hybrid_pattern=("m", "m", "a"), lora_rank=4,
        dtype="float32", vocab_pad_multiple=8,
    )
