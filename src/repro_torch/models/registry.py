"""Model bundle of the port (the part of ``repro/models/registry.py`` the
serving engine reads): ``cfg`` and ``init_params``."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    init_params: Callable[..., Any]   # (generator, device="cuda") -> params


def build(cfg: ArchConfig) -> ModelBundle:
    transformer.assert_paged_servable(cfg)
    return ModelBundle(
        cfg=cfg,
        init_params=lambda generator, device="cuda": transformer.init_params(
            generator, cfg, device))
