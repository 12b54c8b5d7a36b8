"""Model bundle of the port (``repro/models/registry.py``): ``cfg``,
``init_params``, ``loss_fn``, ``prefill``, ``decode_step`` and
``init_caches``, with the reference's call shapes, for the decoder-only
families (``models/transformer.py``) and the encoder-decoder
(``models/encdec.py``); and ``param_counts``.  Building a bundle checks
nothing about paged serving: the engine and the paged steps refuse a config
without a page layout themselves, as the reference's do."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, transformer


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    init_params: Callable[..., Any]   # (generator, device="cuda") -> params
    loss_fn: Callable[..., Any]       # (params, batch, **kw) -> (loss, metrics)
    prefill: Callable[..., Any]       # (params, batch, **kw) -> (logits, caches)
    decode_step: Callable[..., Any]   # (params, tokens, caches, **kw) -> (logits, caches)
    init_caches: Callable[..., Any]   # (batch, max_len, device="cuda") -> caches


def build(cfg: ArchConfig) -> ModelBundle:
    if cfg.family == "encdec":
        return ModelBundle(
            cfg=cfg,
            init_params=lambda generator, device="cuda": encdec.init_params(
                generator, cfg, device),
            loss_fn=lambda p, b, **kw: encdec.loss_fn(p, b, cfg, **kw),
            prefill=lambda p, b, **kw: encdec.prefill(p, b, cfg, **kw),
            decode_step=lambda p, t, c: encdec.decode_step(p, t, c, cfg),
            init_caches=lambda batch, max_len, device="cuda": encdec.init_caches(
                cfg, batch, max_len, cfg.encdec.encoder_frames, device))
    return ModelBundle(
        cfg=cfg,
        init_params=lambda generator, device="cuda": transformer.init_params(
            generator, cfg, device),
        loss_fn=lambda p, b, **kw: transformer.loss_fn(p, b, cfg, **kw),
        prefill=lambda p, b, **kw: transformer.prefill(p, b, cfg, **kw),
        decode_step=lambda p, t, c, **kw: transformer.decode_step(p, t, c, cfg, **kw),
        init_caches=lambda batch, max_len, device="cuda": transformer.init_caches(
            cfg, batch, max_len, device))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def param_counts(cfg: ArchConfig) -> tuple[float, float]:
    """(total parameters, active parameters per token), counted from the
    parameter tree built on the meta device (nothing is allocated)."""
    values = build(cfg).init_params(torch.Generator(), device="meta")
    total = sum(math.prod(v.shape) for v in _leaves(values))
    active = total
    if cfg.moe is not None:
        e, k, f, d = (cfg.moe.num_experts, cfg.moe.top_k,
                      cfg.moe.expert_d_ff, cfg.d_model)
        n_moe_layers = cfg.num_layers - cfg.moe.first_k_dense
        active = total - n_moe_layers * e * 3 * d * f + n_moe_layers * k * 3 * d * f
    return float(total), float(active)
