"""Config registry of the port: ``get_config(arch_id)`` + ``reduced``.

The reference's registry name for name: the assigned architectures (dense,
MoE, MLA + MoE, SSM, hybrid RG-LRU + local attention, encoder-decoder and
the VLM stub) and the paper's own dense evaluation backbones
(``llama3.1-8b`` and ``qwen3-8b``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.arctic_480b import CONFIG as ARCTIC_480B
from repro_torch.configs.base import (ALL_SHAPES, DECODE_32K,  # noqa: F401
                                      LONG_500K, PREFILL_32K, TRAIN_4K,
                                      ArchConfig, EncDecConfig, MLAConfig,
                                      MoEConfig, RGLRUConfig, RunShape,
                                      SSDConfig, shapes_for)
from repro_torch.configs.deepseek_v3_671b import CONFIG as DEEPSEEK_V3_671B
from repro_torch.configs.gemma_2b import CONFIG as GEMMA_2B
from repro_torch.configs.glm4_9b import CONFIG as GLM4_9B
from repro_torch.configs.mamba2_370m import CONFIG as MAMBA2_370M
from repro_torch.configs.pixtral_12b import CONFIG as PIXTRAL_12B
from repro_torch.configs.qwen1_5_4b import CONFIG as QWEN1_5_4B
from repro_torch.configs.qwen3_0_6b import CONFIG as QWEN3_0_6B
from repro_torch.configs.recurrentgemma_2b import CONFIG as RECURRENTGEMMA_2B
from repro_torch.configs.whisper_medium import CONFIG as WHISPER_MEDIUM

# The paper's own dense evaluation backbones (Section 3.1).
LLAMA31_8B = ArchConfig(
    name="llama3.1-8b", family="dense", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, head_dim=128, d_ff=14336,
    vocab_size=128256, activation="silu", rope_theta=5e5,
    tie_embeddings=False, use_stem=True,
)
QWEN3_8B = ArchConfig(
    name="qwen3-8b", family="dense", num_layers=36, d_model=4096,
    num_heads=32, num_kv_heads=8, head_dim=128, d_ff=12288,
    vocab_size=151936, activation="silu", qk_norm=True, rope_theta=1e6,
    tie_embeddings=False, use_stem=True,
)

ASSIGNED = {
    c.name: c
    for c in (
        QWEN3_0_6B, GLM4_9B, GEMMA_2B, QWEN1_5_4B, RECURRENTGEMMA_2B,
        ARCTIC_480B, DEEPSEEK_V3_671B, MAMBA2_370M, WHISPER_MEDIUM,
        PIXTRAL_12B,
    )
}
EXTRA = {c.name: c for c in (LLAMA31_8B, QWEN3_8B)}
ALL = {**ASSIGNED, **EXTRA}


def get_config(name: str) -> ArchConfig:
    if name not in ALL:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ALL)}")
    return ALL[name]


def reduced(cfg: ArchConfig) -> ArchConfig:
    """CPU smoke-test variant of the same family: tiny widths, layers and
    tables, the same code paths (GQA ratio, MoE routing, MLA, the hybrid
    pattern with its leftover layers, MTP, the stubs)."""
    kv_ratio = max(1, cfg.num_heads // max(cfg.num_kv_heads, 1))
    heads = 4
    kw: dict = dict(
        name=cfg.name + "-reduced",
        num_layers=2,
        d_model=64,
        num_heads=heads,
        num_kv_heads=max(1, heads // kv_ratio),
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
    )
    if cfg.family == "hybrid":
        kw["num_layers"] = 4  # one full (rec, rec, attn) group + 1 leftover rec
        kw["rglru"] = RGLRUConfig(lru_width=64, conv_width=4, attn_period=3, window=32)
    if cfg.ssd is not None:
        kw["ssd"] = SSDConfig(state_dim=16, head_dim=16, expand=2, conv_width=4,
                              chunk_size=32)
        kw["num_heads"] = kw["num_kv_heads"] = 8  # d_inner 128 / head_dim 16
    if cfg.moe is not None:
        kw["num_layers"] = 3
        kw["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=8,
            top_k=min(cfg.moe.top_k, 2),
            expert_d_ff=64,
            shared_d_ff=64 if cfg.moe.shared_experts else 0,
            residual_d_ff=64 if cfg.moe.residual_dense else 0,
            first_k_dense=1 if cfg.moe.first_k_dense else 0,
            first_dense_d_ff=128 if cfg.moe.first_k_dense else 0,
        )
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16, rope_head_dim=8,
                              nope_head_dim=16, v_head_dim=16)
        kw["head_dim"] = 24
    if cfg.encdec is not None:
        kw["encdec"] = EncDecConfig(encoder_layers=2, encoder_frames=16)
    return cfg.replace(**kw)
