"""Model bundle of the port (the part of ``repro/models/registry.py`` the
serving engine and the prefill step read): ``cfg``, ``init_params``,
``prefill`` and ``init_caches``."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    init_params: Callable[..., Any]   # (generator, device="cuda") -> params
    prefill: Callable[..., Any]       # (params, batch, **kw) -> (logits, caches)
    init_caches: Callable[..., Any]   # (batch, max_len, device="cuda") -> caches


def build(cfg: ArchConfig) -> ModelBundle:
    transformer.assert_paged_servable(cfg)
    return ModelBundle(
        cfg=cfg,
        init_params=lambda generator, device="cuda": transformer.init_params(
            generator, cfg, device),
        prefill=lambda p, b, **kw: transformer.prefill(p, b, cfg, **kw),
        init_caches=lambda batch, max_len, device="cuda": transformer.init_caches(
            cfg, batch, max_len, device))
