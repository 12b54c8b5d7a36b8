"""Model bundle of the port (``repro/models/registry.py`` for the dense
family): ``cfg``, ``init_params``, ``loss_fn``, ``prefill``,
``decode_step`` and ``init_caches``, with the reference's call shapes."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.configs.base import ArchConfig
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    init_params: Callable[..., Any]   # (generator, device="cuda") -> params
    loss_fn: Callable[..., Any]       # (params, batch, **kw) -> (loss, metrics)
    prefill: Callable[..., Any]       # (params, batch, **kw) -> (logits, caches)
    decode_step: Callable[..., Any]   # (params, tokens, caches, **kw) -> (logits, caches)
    init_caches: Callable[..., Any]   # (batch, max_len, device="cuda") -> caches


def build(cfg: ArchConfig) -> ModelBundle:
    transformer.assert_paged_servable(cfg)
    return ModelBundle(
        cfg=cfg,
        init_params=lambda generator, device="cuda": transformer.init_params(
            generator, cfg, device),
        loss_fn=lambda p, b, **kw: transformer.loss_fn(p, b, cfg, **kw),
        prefill=lambda p, b, **kw: transformer.prefill(p, b, cfg, **kw),
        decode_step=lambda p, t, c, **kw: transformer.decode_step(p, t, c, cfg, **kw),
        init_caches=lambda batch, max_len, device="cuda": transformer.init_caches(
            cfg, batch, max_len, device))
