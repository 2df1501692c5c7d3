"""smollm-135m [dense] — hf:HuggingFaceTB/SmolLM-135M (hf-verified).

Llama-arch small: 30L, d=576, 9H/3KV, tied embeddings.  Also the
~100M-class model of the examples/train_lm.py end-to-end run."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m", family="dense",
        n_layers=30, d_model=576, n_heads=9, n_kv_heads=3,
        d_ff=1536, vocab_size=49152, tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m-smoke", family="dense",
        n_layers=2, d_model=48, n_heads=3, n_kv_heads=3,
        d_ff=128, vocab_size=512, tie_embeddings=True,
        dtype="float32", vocab_pad_multiple=8,
    )
