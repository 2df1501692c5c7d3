"""minicpm-2b [dense] — arXiv:2404.06395 (hf-verified).

Llama-like, 36H full MHA (kv=36), tied embeddings, WSD schedule
(schedule lives in TrainConfig; arch itself is llama-like)."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b", family="dense",
        n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
        d_ff=5760, vocab_size=122753, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=512, tie_embeddings=True,
        dtype="float32", vocab_pad_multiple=8,
    )
