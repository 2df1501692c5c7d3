"""Model configuration schema of the port's LM side.

``ModelConfig``, ``ShapeCell``, ``SHAPE_CELLS``, ``shape_cell`` and
``TrainConfig`` are copies of the JAX package's ``configs/base.py``
(field for field, same defaults), so a config means the same model and
the same training run in both packages.  ``model_config_from_jax`` maps
a JAX model config across.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: Optional[int] = None
    # attention
    qkv_bias: bool = False
    rope_theta: float = 1.0e4
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    pos: str = "rope"  # rope | learned | none
    mlp_act: str = "swiglu"  # swiglu | gelu
    # moe
    n_experts: int = 0
    experts_per_tok: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 1024
    # ssm (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    # hybrid (zamba2): repeating unit of n_layers, e.g. ("m","m","a") —
    # "a" is the SHARED attention block (one param set + per-use LoRA)
    hybrid_pattern: Tuple[str, ...] = ()
    lora_rank: int = 0
    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    n_frontend_tokens: int = 0  # audio frames / image patches (stub frontend)
    # vlm: a cross-attention block replaces every k-th decoder layer
    cross_attn_period: int = 0
    # misc
    dtype: str = "bfloat16"
    vocab_pad_multiple: int = 256
    tie_embeddings: bool = False
    # scan-over-layers (compile-time friendly).  False unrolls the layer
    # loop — used by the dry-run's per-layer cost extrapolation, since XLA
    # cost_analysis counts while-loop bodies once (launch/dryrun.py).
    scan_layers: bool = True
    # attention implementation: "xla" (materialized S^2 logits) or
    # "chunked" (flash-style online-softmax over KV blocks; see SSPerf)
    attn_impl: str = "xla"
    attn_chunk: int = 1024
    # serving prefill emits only the last position's logits (the next-token
    # distribution) instead of (B, S, V) — SSPerf hillclimb knob
    prefill_last_only: bool = False
    # sequence-parallel attention: shard the query-sequence dim over the
    # model axis inside attention (16x less attention compute/memory per chip
    # for archs whose head count does not divide the axis) — SSPerf knob
    attn_seq_shard: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def is_enc_dec(self) -> bool:
        return self.n_enc_layers > 0


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) column of the assigned grid."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPE_CELLS = (
    ShapeCell("train_4k", "train", 4096, 256),
    ShapeCell("prefill_32k", "prefill", 32768, 32),
    ShapeCell("decode_32k", "decode", 32768, 128),
    ShapeCell("long_500k", "decode", 524288, 1),
)


def shape_cell(name: str) -> ShapeCell:
    for c in SHAPE_CELLS:
        if c.name == name:
            return c
    raise KeyError(name)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adamw"  # adamw | adafactor
    moment_dtype: str = "float32"  # bfloat16 halves AdamW moment memory
    lr: float = 3e-4
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    schedule: str = "cosine"  # cosine | wsd | constant
    warmup_steps: int = 100
    total_steps: int = 1000
    remat: bool = True
    microbatch: int = 0  # >0: gradient accumulation micro-batch size
    grad_compression: bool = False  # int8 + error feedback all-reduce
    moe_aux_weight: float = 0.01
    seed: int = 0


def model_config_from_jax(d: dict) -> ModelConfig:
    """Port config from ``dataclasses.asdict`` of a JAX ``ModelConfig``.

    Every field is kept; a field the port does not know raises.
    """
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = set(d) - fields
    if unknown:
        raise ValueError(f"config fields not in the port's ModelConfig: {sorted(unknown)}")
    kw = dict(d)
    if "hybrid_pattern" in kw:
        kw["hybrid_pattern"] = tuple(kw["hybrid_pattern"])
    return ModelConfig(**kw)
