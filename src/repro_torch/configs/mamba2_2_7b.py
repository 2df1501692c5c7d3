"""mamba2-2.7b [ssm] — arXiv:2405.21060 (unverified).

Attention-free SSD: 64 Mamba2 layers, d=2560, d_state=128, head_dim 64
(d_inner 5120 -> 80 SSD heads).  O(1) decode state => runs long_500k."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b", family="ssm",
        n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab_size=50280, d_head=1,
        ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=128,
        pos="none",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b-smoke", family="ssm",
        n_layers=4, d_model=64, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab_size=512, d_head=1,
        ssm_state=16, ssm_expand=2, ssm_head_dim=16, ssm_chunk=16,
        pos="none", dtype="float32", vocab_pad_multiple=8,
    )
