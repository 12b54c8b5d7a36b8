"""Decoder-only LM, dense family (port of ``repro/models/transformer.py``):
the evaluation passes (``loss_fn``, ``forward_hiddens``,
``forward_with_stats``), one-shot prefill, contiguous-cache decode
(``decode_step``) and paged serving (``paged_mixed_step``,
``paged_decode_step``), with tied or untied LM heads.

Parameters keep the reference's tree: ``embed``, ``final_norm`` and
``segment{si}`` whose leaves are stacked along a leading layer axis.  The
reference's ``lax.scan`` over a segment becomes a Python loop over that
axis; caches and page pools are stacked the same way, and each layer works
on views of the pools, so its in-place writes land in the stacked tensors.
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
    if isinstance(trees[0], tuple):               # NamedTuple caches
        return type(trees[0])(*(_stack(list(f)) for f in zip(*trees)))
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
    if not cfg.tie_embeddings:
        p["head"] = ini.normal((cfg.d_model, cfg.padded_vocab), scale=0.02,
                               dtype=torch.float32)
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


def num_layer_groups(cfg: ArchConfig) -> int:
    """Number of layer groups — the index space of per-layer ``policies``."""
    return sum(n for n, _ in layer_program(cfg))


def _layer_policies(cfg: ArchConfig, stem_cfg, policies):
    """Per-group effective policy list (length ``num_layer_groups``):
    ``policies`` maps a layer-group index to an override (any policy
    spelling); unlisted groups use ``stem_cfg``."""
    total = num_layer_groups(cfg)
    base = policy_lib.as_policy_opt(stem_cfg)
    if not policies:
        return [base] * total
    bad = sorted(i for i in policies if not (isinstance(i, int) and 0 <= i < total))
    if bad:
        raise ValueError(
            f"policies keys {bad} out of range for {total} layer groups")
    return [policy_lib.as_policy_opt(policies[i]) if i in policies else base
            for i in range(total)]


def _policy_runs(eff_seg):
    """Coalesce consecutive equal policies into (start, length, policy)
    runs (the reference scans each run; here each run is a loop)."""
    runs: list = []
    for i, p in enumerate(eff_seg):
        if runs and runs[-1][2] == p:
            runs[-1] = (runs[-1][0], runs[-1][1] + 1, p)
        else:
            runs.append((i, 1, p))
    return runs


def _embed_inputs(params, batch: dict, cfg: ArchConfig):
    """Token (+ optional stub modality prefix) embeddings -> (b, s, d)."""
    parts = []
    if cfg.vlm_stub and "patch_embeds" in batch:
        parts.append(batch["patch_embeds"].to(cfg.torch_dtype))
    emb = common.embed_lookup(params["embed"], batch["tokens"], cfg.torch_dtype)
    parts.append(emb * (cfg.d_model ** 0.5) if cfg.embed_scale_flag else emb)
    return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]


def _check_kind(kind: str) -> None:
    if kind != "dense":
        raise NotImplementedError(f"sub-layer kind {kind!r} is not ported")


def _sublayer_full(params, x, cfg: ArchConfig, kind: str, *, positions,
                   stem_cfg, return_stats: bool = False):
    """Returns (x, aux_loss) — or (x, aux_loss, StemStats | None) when
    ``return_stats`` (stats exist only when the sparse attention path ran)."""
    _check_kind(kind)
    h = common.rms_norm(x, params["norm1"])
    stats = None
    if return_stats:
        mix, stats = attention.apply_full(params["attn"], h, cfg,
                                          positions=positions,
                                          stem_cfg=stem_cfg, return_stats=True)
    else:
        mix = attention.apply_full(params["attn"], h, cfg, positions=positions,
                                   stem_cfg=stem_cfg)
    x = x + mix
    x = x + mlp.apply(params["ffn"], common.rms_norm(x, params["norm2"]),
                      cfg.activation)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return (x, aux, stats) if return_stats else (x, aux)


def _group_full(params, x, cfg, kinds, *, positions, stem_cfg):
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, k in enumerate(kinds):
        x, a = _sublayer_full(params[f"sub{i}"], x, cfg, k,
                              positions=positions, stem_cfg=stem_cfg)
        aux = aux + a
    return x, aux


def _run_segments(params, x, cfg: ArchConfig, *, positions, stem_cfg,
                  policies=None):
    """Every layer over the full sequence, each under its effective policy
    (``policies`` overrides ``stem_cfg`` per layer group).  Returns
    (x, summed aux loss)."""
    eff = _layer_policies(cfg, stem_cfg, policies)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    off = 0
    for si, (n, kinds) in enumerate(layer_program(cfg)):
        seg = params[f"segment{si}"]
        for layer in range(n):
            x, a = _group_full(_index(seg, layer), x, cfg, kinds,
                               positions=positions, stem_cfg=eff[off + layer])
            aux_total = aux_total + a
        off += n
    return x, aux_total


@torch.no_grad()
def loss_fn(params, batch: dict, cfg: ArchConfig, *, stem_cfg=None,
            remat: bool = True, policies=None):
    """Next-token CE.  batch: tokens (b, s), labels (b, s), optional
    loss_mask (b, s).  Returns (loss, {"ce", "aux", "loss"}).

    A forward-only evaluation pass: the kernels have no backward, so it
    runs under ``torch.no_grad``.  ``remat`` is accepted for the
    reference's signature and has no effect (there are no activations kept
    for a backward pass).  ``stem_cfg`` is any policy spelling;
    ``policies`` optionally overrides it per layer group ({index: policy}).
    The multi-token-prediction head does not apply to the dense family and
    raises."""
    if cfg.mtp:
        raise NotImplementedError("the multi-token-prediction loss is not ported")
    x = _embed_inputs(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = _run_segments(params, x, cfg, positions=positions,
                           stem_cfg=stem_cfg, policies=policies)
    txt_len = batch["tokens"].shape[1]
    logits = _logits(params, x[:, -txt_len:], cfg)
    ce = common.cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
    total = ce + aux
    return total, {"ce": ce, "aux": aux, "loss": total}


@torch.no_grad()
def forward_hiddens(params, batch: dict, cfg: ArchConfig, *, stem_cfg=None):
    """Forward pass that also returns every layer's residual stream — the
    per-layer sparse-vs-dense MSE measurements.  Returns (logits (b, s,
    vocab) fp32, list of (n_layers_i, b, s, d) per segment)."""
    x = _embed_inputs(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    hiddens = []
    for si, (n, kinds) in enumerate(layer_program(cfg)):
        seg = params[f"segment{si}"]
        ys = []
        for layer in range(n):
            x, _ = _group_full(_index(seg, layer), x, cfg, kinds,
                               positions=positions, stem_cfg=stem_cfg)
            ys.append(x)
        hiddens.append(torch.stack(ys))
    return _logits(params, x, cfg), hiddens


@torch.no_grad()
def forward_with_stats(params, batch: dict, cfg: ArchConfig, *,
                       stem_cfg=None, policies=None):
    """Diagnostic forward pass with per-sub-layer sparse-attention stats:
    every attention sub-layer reports the realized ``StemStats`` of its own
    effective policy (realized density per layer).

    Returns (logits (b, s, vocab), records), each record a dict
    ``{"layer": group index, "kind": sub-layer kind, "policy": policy name
    or None, "stats": StemStats | None}`` (None where the sparse path did
    not run)."""
    x = _embed_inputs(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    eff = _layer_policies(cfg, stem_cfg, policies)
    records = []
    li = 0
    for si, (n, kinds) in enumerate(layer_program(cfg)):
        seg = params[f"segment{si}"]
        for j in range(n):
            layer_params = _index(seg, j)
            pol = eff[li]
            for i, kind in enumerate(kinds):
                x, _, st = _sublayer_full(
                    layer_params[f"sub{i}"], x, cfg, kind, positions=positions,
                    stem_cfg=pol, return_stats=True)
                records.append({
                    "layer": li, "kind": kind,
                    "policy": (pol.name or None) if pol is not None else None,
                    "stats": st,
                })
            li += 1
    return _logits(params, x, cfg), records


def _sublayer_cache(cfg: ArchConfig, kind: str, batch: int, max_len: int,
                    dtype, device):
    _check_kind(kind)
    return attention.init_cache(cfg, batch, max_len, dtype=dtype, device=device)


def _sublayer_prefill(params, x, cfg: ArchConfig, kind: str, *, positions,
                      stem_cfg, max_len: int):
    """Returns (x, aux, cache)."""
    _check_kind(kind)
    h = common.rms_norm(x, params["norm1"])
    mix, cache = attention.prefill_into_cache(
        params["attn"], h, cfg, positions=positions, max_len=max_len,
        stem_cfg=stem_cfg)
    x = x + mix
    y = mlp.apply(params["ffn"], common.rms_norm(x, params["norm2"]),
                  cfg.activation)
    return x + y, torch.zeros((), dtype=torch.float32, device=x.device), cache


def init_caches(cfg: ArchConfig, batch: int, max_len: int, device="cuda"):
    """Per-segment caches, leaves stacked ``(n_layers, ...)``."""
    return [{f"sub{i}": _stack([_sublayer_cache(cfg, k, batch, max_len,
                                                cfg.torch_dtype, device)] * n)
             for i, k in enumerate(kinds)}
            for n, kinds in layer_program(cfg)]


def prefill(params, batch: dict, cfg: ArchConfig, *, max_len: int,
            stem_cfg=None, last_pos=None, policies=None):
    """Process the full prompt: the paper's one-shot pre-filling phase.
    Returns (last-position logits (b, vocab), caches).

    ``stem_cfg`` is any policy spelling or None (dense); ``policies``
    optionally overrides it per layer group ({index: policy}).
    ``last_pos`` (scalar or (b,)) picks which position's logits each row
    returns (right-padded prompts); default: the final position."""
    x = _embed_inputs(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    eff = _layer_policies(cfg, stem_cfg, policies)
    caches = []
    off = 0
    for si, (n, kinds) in enumerate(layer_program(cfg)):
        seg = params[f"segment{si}"]
        layer_caches = []
        for start, length, pol in _policy_runs(eff[off:off + n]):
            for layer in range(start, start + length):
                layer_params = _index(seg, layer)
                cache = {}
                for i, k in enumerate(kinds):
                    x, _, cache[f"sub{i}"] = _sublayer_prefill(
                        layer_params[f"sub{i}"], x, cfg, k,
                        positions=positions, stem_cfg=pol, max_len=max_len)
                layer_caches.append(cache)
        off += n
        caches.append(_stack(layer_caches))
    if last_pos is None:
        x_last = x[:, -1:]
    else:
        lp = torch.as_tensor(last_pos, device=x.device).long().expand(x.shape[0])
        x_last = torch.take_along_dim(x, lp[:, None, None], dim=1)
    return _logits(params, x_last, cfg)[:, 0], caches


def prefill_kv_pages(params, tokens: torch.Tensor, true_len, pools,
                     page_row: torch.Tensor, cfg: ArchConfig, stem_cfg):
    """Prefill ONE request and write its pages + summaries into the pools,
    in place.

    tokens: (1, Lp) right-padded to a page multiple; true_len: its length;
    page_row: (max_pages_per_slot,) — every page reserved for the request
    (prompt pages first, then decode-spill pages), trash-padded.  All of
    them are reset to pristine before the prompt's Lp / page_size leading
    pages are written (recycled pages are dirty, and decode increments
    assume fresh pages).  Returns (next-token logits (vocab,), pools)."""
    stem_cfg = policy_lib.as_policy(stem_cfg)
    logits, caches = prefill(params, {"tokens": tokens}, cfg,
                             max_len=tokens.shape[1], stem_cfg=stem_cfg,
                             last_pos=true_len - 1)
    prompt_pages = page_row[:tokens.shape[1] // stem_cfg.block_size]
    for si, (n, kinds) in enumerate(layer_program(cfg)):
        for i, _ in enumerate(kinds):
            cache = caches[si][f"sub{i}"]          # k: (n, 1, hk, Lp, d)
            for layer in range(n):
                pool = paged_lib.reset_pages(
                    paged_lib.layer_view(pools[si][f"sub{i}"], layer), page_row)
                paged_lib.write_prefill_pages(pool, prompt_pages,
                                              cache.k[layer, 0], cache.v[layer, 0],
                                              true_len, stem_cfg)
    return logits[0], pools


def _logits(params, x, cfg: ArchConfig):
    x = common.rms_norm(x, params["final_norm"])
    if cfg.tie_embeddings:
        return common.lm_logits(x, params["embed"])
    return torch.einsum("bsd,dv->bsv", x.float(), params["head"].float())


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


def paged_decode_step(params, tokens, pools, page_table, cache_lens,
                      cfg: ArchConfig, *, stem_cfg, budget_frac: float = 1.0):
    """One token for every engine slot against the paged cache — the
    decode-only view of ``paged_mixed_step``.  Returns (logits (slots,
    vocab), pools)."""
    logits, _, pools = paged_mixed_step(
        params, tokens, pools, page_table, cache_lens, cfg,
        stem_cfg=stem_cfg, budget_frac=budget_frac, chunk=None)
    return logits, pools


def _sublayer_decode(params, x, cfg: ArchConfig, kind: str, cache, *,
                     stem_cfg=None, budget_frac: float = 1.0):
    _check_kind(kind)
    h = common.rms_norm(x, params["norm1"])
    mix, cache = attention.apply_decode(params["attn"], h, cfg, cache,
                                        stem_cfg=stem_cfg,
                                        budget_frac=budget_frac)
    x = x + mix
    y = mlp.apply(params["ffn"], common.rms_norm(x, params["norm2"]),
                  cfg.activation)
    return x + y, cache


def decode_step(params, tokens, caches, cfg: ArchConfig, *, stem_cfg=None,
                budget_frac: float = 1.0):
    """One token for every sequence in the batch.  tokens: (b, 1).
    Returns (logits (b, vocab), caches): each layer writes its token's K/V
    into its view of the stacked caches in place, and every ``pos`` leaf
    advances by one.

    With ``stem_cfg`` the attention sub-layers decode policy-sparse over
    the contiguous cache (summarize + select every step) — the fixed-batch
    reference for the paged engine's sparse decode."""
    if stem_cfg is not None:
        assert_paged_servable(cfg)
    x = common.embed_lookup(params["embed"], tokens, cfg.torch_dtype)
    if cfg.embed_scale_flag:
        x = x * (cfg.d_model ** 0.5)
    new_caches = []
    for si, (n, kinds) in enumerate(layer_program(cfg)):
        seg = params[f"segment{si}"]
        seg_cache = caches[si]
        new_pos = {f"sub{i}": [] for i, _ in enumerate(kinds)}
        for layer in range(n):
            layer_params = _index(seg, layer)
            for i, k in enumerate(kinds):
                c = seg_cache[f"sub{i}"]
                view = attention.KVCache(k=c.k[layer], v=c.v[layer],
                                         pos=c.pos[layer])
                x, view = _sublayer_decode(layer_params[f"sub{i}"], x, cfg, k,
                                           view, stem_cfg=stem_cfg,
                                           budget_frac=budget_frac)
                new_pos[f"sub{i}"].append(view.pos)
        new_caches.append({key: seg_cache[key]._replace(pos=torch.stack(ps))
                           for key, ps in new_pos.items()})
    return _logits(params, x, cfg)[:, 0], new_caches
