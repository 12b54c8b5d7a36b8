"""Decoder-only LM for paged serving, dense family (port of the paged half
of ``repro/models/transformer.py``).

Parameters keep the reference's tree: ``embed``, ``final_norm`` and
``segment{si}`` whose leaves are stacked along a leading layer axis.  The
reference's ``lax.scan`` over a segment becomes a Python loop over that
axis; page pools are stacked the same way and each layer works on views of
them, so its in-place writes land in the stacked tensors.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import policy as policy_lib
from repro_torch.models import attention, common, mlp
from repro_torch.runtime import paged as paged_lib

PAGED_KINDS = ("dense",)   # attention sub-layers this port serves


def layer_program(cfg: ArchConfig) -> list[tuple[int, tuple[str, ...]]]:
    if cfg.family not in ("dense", "vlm"):
        raise NotImplementedError(
            f"the port serves the dense family only, got {cfg.family!r}")
    return [(cfg.num_layers, ("dense",))]


def assert_paged_servable(cfg: ArchConfig) -> None:
    for _, kinds in layer_program(cfg):
        for k in kinds:
            if k not in PAGED_KINDS:
                raise NotImplementedError(
                    f"paged serving supports {PAGED_KINDS} sub-layers, got "
                    f"{k!r} (arch {cfg.name})")


def _init_sublayer(ini: common.Initializer, cfg: ArchConfig) -> dict:
    return {
        "norm1": ini.zeros((cfg.d_model,)),
        "attn": attention.init(ini, cfg),
        "norm2": ini.zeros((cfg.d_model,)),
        "ffn": mlp.init(ini, cfg.d_model, cfg.d_ff, cfg.activation),
    }


def _stack(trees: list) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def init_params(generator: torch.Generator, cfg: ArchConfig, device="cuda") -> dict:
    """Random parameters with the reference's tree, shapes and scales,
    drawn from ``generator`` on ``device``."""
    ini = common.Initializer(generator, cfg.torch_dtype, device)
    p: dict[str, Any] = {
        "embed": common.embed_init(ini, cfg.padded_vocab, cfg.d_model),
        "final_norm": ini.zeros((cfg.d_model,)),
    }
    for si, (n, kinds) in enumerate(layer_program(cfg)):
        p[f"segment{si}"] = _stack([
            {f"sub{i}": _init_sublayer(ini, cfg) for i, _ in enumerate(kinds)}
            for _ in range(n)])
    return p


def init_page_pools(cfg: ArchConfig, num_pages: int, stem_cfg, device="cuda"):
    """Per-layer page pools stacked like the parameters:
    ``[{"sub0": PagePool with (n_layers, hk, P, ...) leaves}]``."""
    stem_cfg = policy_lib.as_policy(stem_cfg)
    assert_paged_servable(cfg)
    return [{f"sub{i}": paged_lib.init_pool(
                num_pages, cfg.num_kv_heads, stem_cfg.block_size,
                cfg.head_dim, stem_cfg.stride, cfg.torch_dtype, device,
                layers=n)
             for i, _ in enumerate(kinds)}
            for n, kinds in layer_program(cfg)]


def _logits(params, x, cfg: ArchConfig):
    x = common.rms_norm(x, params["final_norm"])
    if not cfg.tie_embeddings:
        raise NotImplementedError("untied LM heads are not ported yet")
    return common.lm_logits(x, params["embed"])


def paged_mixed_step(params, tokens, pools, page_table, cache_lens,
                     cfg: ArchConfig, *, stem_cfg, budget_frac: float = 1.0,
                     chunk=None, chunk_k_max: int = 0):
    """One mixed batch of decode tokens + prefill chunks over the page pool.

    The paged backend of both lanes is ``policy.executor`` of ``stem_cfg``.
    tokens: (slots, 1).  ``chunk`` is None (decode only) or a dict of
    tensors for L chunk lanes: tokens (L, C), page_table (L, max_pages),
    start (L,), true_len (L,), budgets (L, C // block), last (L,).
    Pools are updated in place.  Returns (decode logits (slots, vocab),
    chunk logits (L, vocab) | None, pools)."""
    dtype = cfg.torch_dtype
    x = common.embed_lookup(params["embed"], tokens, dtype)
    xc = None
    if chunk is not None:
        xc = common.embed_lookup(params["embed"], chunk["tokens"], dtype)
    if cfg.embed_scale_flag:
        x = x * (cfg.d_model ** 0.5)
        xc = None if xc is None else xc * (cfg.d_model ** 0.5)
    for si, (n, kinds) in enumerate(layer_program(cfg)):
        seg = params[f"segment{si}"]
        for layer in range(n):
            layer_params = _index(seg, layer)
            for i, _ in enumerate(kinds):
                p = layer_params[f"sub{i}"]
                pl = paged_lib.layer_view(pools[si][f"sub{i}"], layer)
                if chunk is not None:
                    hc = common.rms_norm(xc, p["norm1"])
                    mix_c, pl = attention.apply_chunk_paged(
                        p["attn"], hc, cfg, pl, chunk["page_table"],
                        chunk["start"], chunk["true_len"], chunk["budgets"],
                        stem_cfg, k_max=chunk_k_max)
                    xc = xc + mix_c
                h = common.rms_norm(x, p["norm1"])
                mix, pl = attention.apply_decode_paged(
                    p["attn"], h, cfg, pl, page_table, cache_lens, stem_cfg,
                    budget_frac=budget_frac)
                x = x + mix
                x = x + mlp.apply(p["ffn"], common.rms_norm(x, p["norm2"]),
                                  cfg.activation)
                if chunk is not None:
                    xc = xc + mlp.apply(p["ffn"], common.rms_norm(xc, p["norm2"]),
                                        cfg.activation)
    dec_logits = _logits(params, x, cfg)[:, 0]
    chunk_logits = None
    if chunk is not None:
        last = chunk["last"].long()
        xl = torch.take_along_dim(xc, last[:, None, None], dim=1)
        chunk_logits = _logits(params, xl, cfg)[:, 0]
    return dec_logits, chunk_logits, pools
