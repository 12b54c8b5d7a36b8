"""Architecture configuration (port of ``repro/configs/base.py``).

Same field names and sub-config dataclasses as the reference
``ArchConfig`` (MoE, MLA, RG-LRU, SSD, encoder-decoder); ``torch_dtype``
takes the place of ``jnp_dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_d_ff: int
    capacity_factor: float = 1.25
    shared_experts: int = 0          # deepseek: 1 shared expert
    shared_d_ff: int = 0
    residual_dense: bool = False     # arctic: dense FFN branch in parallel
    residual_d_ff: int = 0
    first_k_dense: int = 0           # deepseek: first 3 layers are dense
    first_dense_d_ff: int = 0
    router_aux_weight: float = 0.001


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int
    conv_width: int = 4
    attn_period: int = 3        # 1 attention layer per `period` (griffin 1:2)
    window: int = 2048          # local-attention window


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 128


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    encoder_layers: int
    encoder_frames: int = 1500   # whisper: fixed 30 s of 2x-downsampled frames


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    activation: str = "silu"      # silu -> SwiGLU; gelu -> GeGLU; gelu_mlp -> plain GELU
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    norm: str = "rms"             # rms | layer
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    rglru: Optional[RGLRUConfig] = None
    ssd: Optional[SSDConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm_stub: bool = False        # inputs include precomputed patch embeddings
    mtp: bool = False
    mtp_weight: float = 0.3
    use_stem: bool = True
    embed_scale: bool = False     # gemma-family sqrt(d_model) embedding scale
    sub_quadratic: bool = False
    fsdp_weights: bool = False
    train_microbatches: int = 1
    dtype: str = "bfloat16"
    approx_params: float = 0.0
    approx_active_params: float = 0.0

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    @property
    def embed_scale_flag(self) -> bool:
        return self.embed_scale or self.family == "hybrid"

    @property
    def padded_vocab(self) -> int:
        """Embedding-table / logits vocab padded to a multiple of 256."""
        return -(-self.vocab_size // 256) * 256

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class RunShape:
    """One (input-shape) cell: a global batch of ``global_batch`` sequences
    of ``seq_len`` tokens, trained, prefilled or decoded."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


TRAIN_4K = RunShape("train_4k", 4096, 256, "train")
PREFILL_32K = RunShape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = RunShape("decode_32k", 32768, 128, "decode")
LONG_500K = RunShape("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shapes_for(cfg: ArchConfig):
    """The shape set of ``cfg``: long_500k only for the sub-quadratic
    architectures."""
    if cfg.sub_quadratic:
        return ALL_SHAPES
    return (TRAIN_4K, PREFILL_32K, DECODE_32K)
