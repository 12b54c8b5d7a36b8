"""Config registry of the port: ``get_config(arch_id)`` + ``reduced``.

The dense configurations the port serves: ``qwen3-0.6b``, ``qwen1.5-4b``,
``glm4-9b`` and ``gemma-2b``.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.gemma_2b import CONFIG as GEMMA_2B
from repro_torch.configs.glm4_9b import CONFIG as GLM4_9B
from repro_torch.configs.qwen1_5_4b import CONFIG as QWEN1_5_4B
from repro_torch.configs.qwen3_0_6b import CONFIG as QWEN3_0_6B

ALL = {c.name: c for c in (QWEN3_0_6B, GLM4_9B, GEMMA_2B, QWEN1_5_4B)}


def get_config(name: str) -> ArchConfig:
    if name not in ALL:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ALL)}")
    return ALL[name]


def reduced(cfg: ArchConfig) -> ArchConfig:
    """CPU smoke-test variant of a dense config: tiny widths and tables,
    the same GQA ratio and code paths (the reference ``reduced`` restricted
    to the dense family)."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"reduced() is ported for the dense family only, got {cfg.family!r}")
    kv_ratio = max(1, cfg.num_heads // max(cfg.num_kv_heads, 1))
    heads = 4
    return cfg.replace(
        name=cfg.name + "-reduced",
        num_layers=2,
        d_model=64,
        num_heads=heads,
        num_kv_heads=max(1, heads // kv_ratio),
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
    )
