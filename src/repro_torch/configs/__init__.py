"""Config registry of the port: ``get_config(arch_id)`` + ``reduced``.

Only the dense ``qwen3-0.6b`` is served by this slice of the port.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.qwen3_0_6b import CONFIG as QWEN3_0_6B

ALL = {QWEN3_0_6B.name: QWEN3_0_6B}


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
