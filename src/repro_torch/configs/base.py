"""Architecture configuration (port of ``repro/configs/base.py``).

Same field names as the reference ``ArchConfig``; ``torch_dtype`` takes the
place of ``jnp_dtype``.  Only the dense family is served by this port, so
the sub-configs of the other families (MoE, MLA, RG-LRU, SSD, enc-dec) are
carried as opaque optional values.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


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
    moe: Optional[Any] = None
    mla: Optional[Any] = None
    rglru: Optional[Any] = None
    ssd: Optional[Any] = None
    encdec: Optional[Any] = None
    vlm_stub: bool = False
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
