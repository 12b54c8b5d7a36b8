"""Config registry of the port: ``get_config(arch_id)`` + ``reduced``.

The configurations the port serves: the dense ``qwen3-0.6b``,
``qwen1.5-4b``, ``glm4-9b`` and ``gemma-2b``, the MoE ``arctic-480b`` and
the MLA + MoE ``deepseek-v3-671b``.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.arctic_480b import CONFIG as ARCTIC_480B
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig  # noqa: F401
from repro_torch.configs.deepseek_v3_671b import CONFIG as DEEPSEEK_V3_671B
from repro_torch.configs.gemma_2b import CONFIG as GEMMA_2B
from repro_torch.configs.glm4_9b import CONFIG as GLM4_9B
from repro_torch.configs.qwen1_5_4b import CONFIG as QWEN1_5_4B
from repro_torch.configs.qwen3_0_6b import CONFIG as QWEN3_0_6B

ALL = {c.name: c for c in (QWEN3_0_6B, GLM4_9B, GEMMA_2B, QWEN1_5_4B,
                           ARCTIC_480B, DEEPSEEK_V3_671B)}


def get_config(name: str) -> ArchConfig:
    if name not in ALL:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ALL)}")
    return ALL[name]


def reduced(cfg: ArchConfig) -> ArchConfig:
    """CPU smoke-test variant of a dense, MoE or MLA config: tiny widths
    and tables, the same GQA ratio, MoE routing, MLA, MTP and code paths
    (the reference ``reduced`` restricted to those families)."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"reduced() is ported for the dense and MoE families only, got "
            f"{cfg.family!r}")
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
    return cfg.replace(**kw)
