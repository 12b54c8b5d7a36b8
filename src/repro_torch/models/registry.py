"""Model bundle of the port (``repro/models/registry.py``): ``cfg``,
``init_params``, ``abstract_params``, ``loss_fn``, ``prefill``,
``decode_step`` and ``init_caches``, with the reference's call shapes, for
the decoder-only families (``models/transformer.py``) and the
encoder-decoder (``models/encdec.py``); ``input_specs`` and
``abstract_caches`` (tensors on the ``meta`` device standing in for the
reference's ``ShapeDtypeStruct``s); and ``param_counts``.  Building a bundle
checks nothing about paged serving: the engine and the paged steps refuse a
config without a page layout themselves, as the reference's do."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig, RunShape
from repro_torch.models import encdec, transformer


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ArchConfig
    init_params: Callable[..., Any]   # (generator, device="cuda") -> params
    abstract_params: Callable[[], Any]  # () -> (values on "meta", axes tree)
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
            abstract_params=lambda: encdec.abstract_params(cfg),
            loss_fn=lambda p, b, **kw: encdec.loss_fn(p, b, cfg, **kw),
            prefill=lambda p, b, **kw: encdec.prefill(p, b, cfg, **kw),
            decode_step=lambda p, t, c: encdec.decode_step(p, t, c, cfg),
            init_caches=lambda batch, max_len, device="cuda": encdec.init_caches(
                cfg, batch, max_len, cfg.encdec.encoder_frames, device))
    return ModelBundle(
        cfg=cfg,
        init_params=lambda generator, device="cuda": transformer.init_params(
            generator, cfg, device),
        abstract_params=lambda: transformer.abstract_params(cfg),
        loss_fn=lambda p, b, **kw: transformer.loss_fn(p, b, cfg, **kw),
        prefill=lambda p, b, **kw: transformer.prefill(p, b, cfg, **kw),
        decode_step=lambda p, t, c, **kw: transformer.decode_step(p, t, c, cfg, **kw),
        init_caches=lambda batch, max_len, device="cuda": transformer.init_caches(
            cfg, batch, max_len, device))


VLM_PATCH_FRACTION = 4   # 1/4 of the sequence is patch positions


def _tok(b: int, s: int) -> torch.Tensor:
    return torch.empty((b, s), dtype=torch.int32, device="meta")


def input_specs(cfg: ArchConfig, shape: RunShape) -> dict:
    """Stand-ins (``meta`` tensors) for every model input of this cell."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        if cfg.family == "encdec":
            return {"frames": torch.empty((b, cfg.encdec.encoder_frames, cfg.d_model),
                                          dtype=torch.bfloat16, device="meta"),
                    "tokens": _tok(b, s), "labels": _tok(b, s)}
        if cfg.vlm_stub:
            s_img = s // VLM_PATCH_FRACTION
            return {"patch_embeds": torch.empty((b, s_img, cfg.d_model),
                                                dtype=torch.bfloat16, device="meta"),
                    "tokens": _tok(b, s - s_img), "labels": _tok(b, s - s_img)}
        return {"tokens": _tok(b, s), "labels": _tok(b, s)}
    if shape.kind == "prefill":
        spec = input_specs(cfg, dataclasses.replace(shape, kind="train"))
        spec.pop("labels")
        return spec
    if shape.kind == "decode":
        return {"tokens": _tok(b, 1)}
    raise ValueError(shape.kind)


def abstract_caches(cfg: ArchConfig, shape: RunShape):
    """The serve-step caches of a decode cell on the ``meta`` device."""
    return build(cfg).init_caches(shape.global_batch, shape.seq_len, device="meta")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def param_counts(cfg: ArchConfig) -> tuple[float, float]:
    """(total parameters, active parameters per token), counted from the
    parameter tree built on the meta device (nothing is allocated)."""
    values, _ = build(cfg).abstract_params()
    total = sum(math.prod(v.shape) for v in _leaves(values))
    active = total
    if cfg.moe is not None:
        e, k, f, d = (cfg.moe.num_experts, cfg.moe.top_k,
                      cfg.moe.expert_d_ff, cfg.d_model)
        n_moe_layers = cfg.num_layers - cfg.moe.first_k_dense
        active = total - n_moe_layers * e * 3 * d * f + n_moe_layers * k * 3 * d * f
    return float(total), float(active)
