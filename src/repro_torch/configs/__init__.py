"""Architecture registry of the port: arch id -> ModelConfig.

The same ten architectures as the JAX package's ``configs/``, each a
pure-data module copied from it, with the same full and smoke configs
(``get_config`` equals the JAX one field for field).  ``input_specs``
and ``cache_specs`` give every model input and the decode cache of a
shape cell as meta-device tensors (shape and dtype, nothing allocated),
where JAX gives ``ShapeDtypeStruct``s.
"""
from __future__ import annotations

import importlib

import torch

from repro_torch.configs.base import (  # noqa: F401  (re-exported)
    SHAPE_CELLS,
    ModelConfig,
    ShapeCell,
    model_config_from_jax,
    shape_cell,
)

ARCHS = (
    "llama-3.2-vision-11b",
    "zamba2-7b",
    "whisper-medium",
    "qwen2-1.5b",
    "minicpm-2b",
    "smollm-135m",
    "qwen2.5-3b",
    "mamba2-2.7b",
    "dbrx-132b",
    "grok-1-314b",
)

_MODULES = {
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "zamba2-7b": "zamba2_7b",
    "whisper-medium": "whisper_medium",
    "qwen2-1.5b": "qwen2_1_5b",
    "minicpm-2b": "minicpm_2b",
    "smollm-135m": "smollm_135m",
    "qwen2.5-3b": "qwen2_5_3b",
    "mamba2-2.7b": "mamba2_2_7b",
    "dbrx-132b": "dbrx_132b",
    "grok-1-314b": "grok_1_314b",
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.smoke_config() if smoke else mod.config()


def list_archs() -> tuple[str, ...]:
    return ARCHS


def cell_applicable(cfg: ModelConfig, cell: ShapeCell) -> tuple[bool, str]:
    """long_500k needs sub-quadratic context state: ssm/hybrid only."""
    if cell.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return False, "pure full-attention arch: no sub-quadratic path at 512k"
    return True, ""


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """Meta-device stand-ins for every model input of this cell.

    train / prefill: the full batch (tokens, and the audio frames or image
    patches of those families in the config's dtype); decode: one new
    token and its position (the cache is :func:`cache_specs`)."""
    B, S = cell.global_batch, cell.seq_len
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")
    act = getattr(torch, cfg.dtype)
    if cell.kind in ("train", "prefill"):
        batch = {"tokens": meta((B, S), torch.int32)}
        if cfg.family == "audio":
            batch["audio"] = meta((B, cfg.n_frontend_tokens, cfg.d_model), act)
        if cfg.family == "vlm":
            batch["image_embeds"] = meta((B, cfg.n_frontend_tokens, cfg.d_model), act)
        return batch
    return {"token": meta((B, 1), torch.int32), "pos": meta((), torch.int32)}


def cache_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """The decode cache of this cell on the meta device (no allocation)."""
    from repro_torch.models import transformer

    return transformer.init_cache(cfg, cell.global_batch, cell.seq_len, device="meta")
