"""Decoder-only LM of every decoder family (port of
``repro/models/transformer.py``): the evaluation passes (``loss_fn`` with
the multi-token-prediction head, ``forward_hiddens``,
``forward_with_stats``), one-shot prefill, contiguous-cache decode
(``decode_step``) and paged serving (``paged_mixed_step``,
``paged_decode_step``), with tied or untied LM heads.

Parameters keep the reference's tree: ``embed``, ``final_norm`` and
``segment{si}`` whose leaves are stacked along a leading layer axis.  The
reference's ``lax.scan`` over a segment becomes a Python loop over that
axis; caches, recurrent states and page pools are stacked the same way,
and each layer works on views of them, so its in-place writes land in the
stacked tensors.

Sub-layer kinds: ``dense`` (attention + MLP), ``moe`` (attention + the
MoE FFN of ``models/moe.py``), ``mla_dense`` / ``mla_moe`` (MLA of
``models/mla.py`` + MLP / MoE FFN), ``dense_local`` (windowed attention
over a ring cache + MLP), ``rec`` (the RG-LRU block of ``models/rglru.py``
+ MLP) and ``ssd`` (the Mamba-2 block of ``models/ssd.py``, no FFN).  An
MoE FFN runs per lane: a batch row's capacity counts that row's own tokens
(1 for a decode row, C for a chunk, Lp for a one-shot prompt).  Only
``dense`` and ``moe`` have a page layout: the other kinds serve through
``loss_fn``, ``prefill`` and ``decode_step`` only, and the paged paths
refuse them (``assert_paged_servable``), as the reference's do.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import chunked as chunked_lib
from repro_torch.core import policy as policy_lib
from repro_torch.models import attention, common, mla, mlp, moe, rglru, ssd
from repro_torch.runtime import paged as paged_lib

PAGED_KINDS = ("dense", "moe")   # attention sub-layers the paged engine serves
MLA_KINDS = ("mla_dense", "mla_moe")
MOE_KINDS = ("moe", "mla_moe")
KINDS = PAGED_KINDS + MLA_KINDS + ("dense_local", "rec", "ssd")


def layer_program(cfg: ArchConfig) -> list[tuple[int, tuple[str, ...]]]:
    """Segments ``(num_groups, kinds)``: ``ssd`` layers for the SSM family;
    for the hybrid, groups of ``attn_period - 1`` ``rec`` layers and one
    ``dense_local``, then a group of the leftover ``rec`` layers; for MoE an
    optional ``first_k_dense`` dense segment, then the MoE layers
    (``mla_dense`` / ``mla_moe`` with MLA); one ``("dense",)`` segment for
    the dense / vlm backbones."""
    if cfg.family == "ssm":
        return [(cfg.num_layers, ("ssd",))]
    if cfg.family == "hybrid":
        period = cfg.rglru.attn_period
        full = cfg.num_layers // period
        rem = cfg.num_layers - full * period
        prog = [(full, ("rec",) * (period - 1) + ("dense_local",))]
        if rem:
            prog.append((1, ("rec",) * rem))
        return prog
    if cfg.family == "moe":
        first = cfg.moe.first_k_dense
        dense, kind = ("mla_dense", "mla_moe") if cfg.mla else ("dense", "moe")
        return ([(first, (dense,))] if first else []) + [
            (cfg.num_layers - first, (kind,))]
    if cfg.family not in ("dense", "vlm"):
        raise NotImplementedError(
            f"the decoder-only families are dense, vlm, moe, ssm and hybrid; "
            f"got {cfg.family!r} (registry.build routes encdec)")
    return [(cfg.num_layers, ("dense",))]


def assert_paged_servable(cfg: ArchConfig) -> None:
    for _, kinds in layer_program(cfg):
        for k in kinds:
            if k not in PAGED_KINDS:
                raise NotImplementedError(
                    f"paged serving supports {PAGED_KINDS} sub-layers, got "
                    f"{k!r} (arch {cfg.name})")


def _init_sublayer(ini: common.Initializer, cfg: ArchConfig, kind: str) -> dict:
    if kind not in KINDS:
        raise ValueError(f"unknown sub-layer kind {kind!r}")
    p = {"norm1": ini.zeros((cfg.d_model,))}
    if kind == "rec":
        p["mixer"] = rglru.init(ini, cfg)
    elif kind == "ssd":
        p["mixer"] = ssd.init(ini, cfg)
    else:
        p["attn"] = (mla.init if kind in MLA_KINDS else attention.init)(ini, cfg)
    if kind == "ssd":          # mamba blocks have no separate FFN
        return p
    p["norm2"] = ini.zeros((cfg.d_model,))
    if kind in MOE_KINDS:
        p["ffn"] = moe.init(ini, cfg.d_model, cfg.moe, cfg.activation)
    else:
        d_ff = cfg.d_ff
        if kind == "mla_dense" and cfg.moe and cfg.moe.first_dense_d_ff:
            d_ff = cfg.moe.first_dense_d_ff
        p["ffn"] = mlp.init(ini, cfg.d_model, d_ff, cfg.activation)
    return p


def _ffn(params, h, cfg: ArchConfig, kind: str):
    """The sub-layer's FFN on ``h`` (b, s, d): (y, aux loss fp32 scalar)."""
    if kind in MOE_KINDS:
        return moe.apply(params, h, cfg.moe, cfg.activation)
    return (mlp.apply(params, h, cfg.activation),
            torch.zeros((), dtype=torch.float32, device=h.device))


def _with_ffn(params, x, cfg: ArchConfig, kind: str):
    """x plus the sub-layer's FFN (none for ``ssd``): (x, aux)."""
    if kind == "ssd":
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    y, aux = _ffn(params["ffn"], common.rms_norm(x, params["norm2"]), cfg, kind)
    return x + y, aux


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
    drawn from ``generator`` on ``device`` straight into the stacked
    tensors, layer by layer (the peak is the parameters plus one draw of
    at most ``common.DRAW_BYTES``)."""
    ini = common.Initializer(generator, cfg.torch_dtype, device)
    p: dict[str, Any] = {
        "embed": common.embed_init(ini, cfg.padded_vocab, cfg.d_model),
        "final_norm": ini.zeros((cfg.d_model,)),
    }
    for si, (n, kinds) in enumerate(layer_program(cfg)):
        p[f"segment{si}"] = ini.stacked(n, lambda kinds=kinds: {
            f"sub{i}": _init_sublayer(ini, cfg, k) for i, k in enumerate(kinds)})
    if not cfg.tie_embeddings:
        p["head"] = ini.normal((cfg.d_model, cfg.padded_vocab), scale=0.02,
                               dtype=torch.float32)
    if cfg.mtp:
        p["mtp_proj"] = ini.normal((2 * cfg.d_model, cfg.d_model))
        p["mtp_norm"] = ini.zeros((cfg.d_model,))
        p["mtp_layer"] = ini.stacked(1, lambda: {
            "sub0": _init_sublayer(ini, cfg, "dense")})
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


def _sublayer_full(params, x, cfg: ArchConfig, kind: str, *, positions,
                   stem_cfg, return_stats: bool = False):
    """Returns (x, aux_loss) — or (x, aux_loss, StemStats | None) when
    ``return_stats`` (stats exist only when the sparse attention path ran)."""
    h = common.rms_norm(x, params["norm1"])
    stats = None
    if kind == "rec":
        mix = rglru.apply_full(params["mixer"], h, cfg)
    elif kind == "ssd":
        mix = ssd.apply_full(params["mixer"], h, cfg)
    elif kind == "dense_local":
        mix = attention.apply_full(params["attn"], h, cfg, positions=positions,
                                   window=cfg.rglru.window)
    else:
        mixer = mla if kind in MLA_KINDS else attention
        if return_stats:
            mix, stats = mixer.apply_full(params["attn"], h, cfg,
                                          positions=positions,
                                          stem_cfg=stem_cfg, return_stats=True)
        else:
            mix = mixer.apply_full(params["attn"], h, cfg, positions=positions,
                                   stem_cfg=stem_cfg)
    x, aux = _with_ffn(params, x + mix, cfg, kind)
    return (x, aux, stats) if return_stats else (x, aux)


def _group_full(params, x, cfg, kinds, *, positions, stem_cfg):
    """The layer group's sub-layers in order: (x, summed aux loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, k in enumerate(kinds):
        x, a = _sublayer_full(params[f"sub{i}"], x, cfg, k,
                              positions=positions, stem_cfg=stem_cfg)
        aux = aux + a
    return x, aux


def _remat(body, remat: bool):
    """``body`` recomputed in the backward pass when ``remat`` and gradients
    are on (``torch.utils.checkpoint``, as the reference wraps each scan
    body in ``jax.checkpoint``: only the body's inputs stay alive)."""
    if not (remat and torch.is_grad_enabled()):
        return body
    return lambda *args: torch.utils.checkpoint.checkpoint(body, *args,
                                                           use_reentrant=False)


def _run_segments(params, x, cfg: ArchConfig, *, positions, stem_cfg,
                  policies=None, remat: bool = False):
    """Every layer over the full sequence, each under its effective policy
    (``policies`` overrides ``stem_cfg`` per layer group), each layer group
    under ``_remat``.  Returns (x, summed aux loss)."""
    eff = _layer_policies(cfg, stem_cfg, policies)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    off = 0
    for si, (n, kinds) in enumerate(layer_program(cfg)):
        seg = params[f"segment{si}"]
        for layer in range(n):
            body = _remat(functools.partial(
                _group_full, cfg=cfg, kinds=kinds, positions=positions,
                stem_cfg=eff[off + layer]), remat)
            x, a = body(_index(seg, layer), x)
            aux_total = aux_total + a
        off += n
    return x, aux_total


def loss_fn(params, batch: dict, cfg: ArchConfig, *, stem_cfg=None,
            remat: bool = True, policies=None):
    """Next-token CE.  batch: tokens (b, s), labels (b, s), optional
    loss_mask (b, s).  Returns (loss, {"ce", "aux", "loss"}).

    Differentiable (the training step's forward): the attention kernels'
    backward is hand-written (``kernels.flash_attention.attention``,
    ``kernels.block_sparse_attn.attention``).  ``remat`` recomputes each
    layer group in the backward pass (``_run_segments``); it changes no
    value.  ``stem_cfg`` is any policy spelling;
    ``policies`` optionally overrides it per layer group ({index: policy}).
    With ``cfg.mtp`` the multi-token-prediction head adds ``mtp_weight *
    mtp_ce``: the final hidden state at t (normed) and the embedding of
    label t, projected by ``mtp_proj`` through one dense layer (dense
    attention), predict label t + 1."""
    x = _embed_inputs(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = _run_segments(params, x, cfg, positions=positions,
                           stem_cfg=stem_cfg, policies=policies, remat=remat)
    txt_len = batch["tokens"].shape[1]
    x_txt = x[:, -txt_len:]
    logits = _logits(params, x_txt, cfg)
    ce = common.cross_entropy(logits, batch["labels"], batch.get("loss_mask"))
    del logits
    metrics = {"ce": ce, "aux": aux}
    total = ce + aux
    if cfg.mtp:
        h = common.rms_norm(x_txt[:, :-1], params["mtp_norm"])
        nxt = common.embed_lookup(params["embed"], batch["labels"][:, :-1],
                                  cfg.torch_dtype)
        hm = torch.einsum("bse,ed->bsd", torch.cat([h, nxt], dim=-1),
                          params["mtp_proj"])
        hm, _ = _group_full(_index(params["mtp_layer"], 0), hm, cfg, ("dense",),
                            positions=positions[:-1], stem_cfg=None)
        mtp_ce = common.cross_entropy(_logits(params, hm, cfg),
                                      batch["labels"][:, 1:])
        metrics["mtp_ce"] = mtp_ce
        total = total + cfg.mtp_weight * mtp_ce
    metrics["loss"] = total
    return total, metrics


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
    if kind == "rec":        # the reference's fp32 conv tail
        return rglru.init_state(cfg, batch, device=device)
    if kind == "ssd":
        return ssd.init_state(cfg, batch, dtype, device=device)
    if kind == "dense_local":
        return attention.init_cache(cfg, batch, max_len, window=cfg.rglru.window,
                                    dtype=dtype, device=device)
    mixer = mla if kind in MLA_KINDS else attention
    return mixer.init_cache(cfg, batch, max_len, dtype=dtype, device=device)


def _sublayer_prefill(params, x, cfg: ArchConfig, kind: str, *, positions,
                      stem_cfg, max_len: int):
    """Returns (x, aux, cache)."""
    h = common.rms_norm(x, params["norm1"])
    if kind == "rec":
        mix, cache = rglru.prefill_into_state(params["mixer"], h, cfg)
    elif kind == "ssd":
        mix, cache = ssd.prefill_into_state(params["mixer"], h, cfg)
    elif kind == "dense_local":
        mix, cache = attention.prefill_into_cache(
            params["attn"], h, cfg, positions=positions, max_len=max_len,
            window=cfg.rglru.window)
    else:
        mixer = mla if kind in MLA_KINDS else attention
        mix, cache = mixer.prefill_into_cache(
            params["attn"], h, cfg, positions=positions, max_len=max_len,
            stem_cfg=stem_cfg)
    x, aux = _with_ffn(params, x + mix, cfg, kind)
    return x, aux, cache


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


def prefill_kv_pages_suffix(params, tokens, true_len, start: int, pools,
                            page_row: torch.Tensor, cfg: ArchConfig, stem_cfg):
    """Prefill ONE request's unmatched suffix against already-written prefix
    pages, in place: the prefix cache's admission entry.

    Positions ``[start, Lp)`` run as one chunk lane of ``paged_mixed_step``:
    the chunk's queries attend causally over the whole prompt through the
    page table, so the leading ``start / page_size`` pages of ``page_row``
    may be prefix pages shared with other slots — read, never written.  The
    caller resets the private (suffix + spill) pages beforehand and leaves
    the shared ones alone.

    tokens: (1, Lp) right-padded to a page multiple; true_len: its length
    (> start); start: the block-aligned matched-prefix offset; page_row:
    (max_pages_per_slot,) trash-padded.  The policy's executor is the
    chunk lane's backend.  Returns (next-token logits (vocab,), pools)."""
    stem_cfg = policy_lib.as_policy(stem_cfg)
    bs = stem_cfg.block_size
    lp = tokens.shape[1]
    if start % bs != 0 or not 0 <= start < lp:
        raise ValueError(f"matched-prefix offset {start} must be a block "
                         f"multiple inside the padded prompt (Lp={lp})")
    nc = (lp - start) // bs
    dev = tokens.device
    tl = int(true_len)
    budgets = chunked_lib.chunk_budget_rows(stem_cfg, lp, start, nc)
    chunk = {
        "tokens": tokens[:, start:],
        "page_table": page_row[None].to(torch.int32),
        "start": torch.full((1,), start, dtype=torch.int32, device=dev),
        "true_len": torch.full((1,), tl, dtype=torch.int32, device=dev),
        "budgets": torch.as_tensor(budgets[None], dtype=torch.int32, device=dev),
        "last": torch.full((1,), tl - 1 - start, dtype=torch.int32, device=dev),
    }
    # Idle decode lane: a zero page table sends its write to the trash page.
    maxp = page_row.shape[0]
    _, chunk_logits, pools = paged_mixed_step(
        params, torch.zeros((1, 1), dtype=torch.int32, device=dev), pools,
        torch.zeros((1, maxp), dtype=torch.int32, device=dev),
        torch.zeros((1,), dtype=torch.int32, device=dev), cfg,
        stem_cfg=stem_cfg, chunk=chunk)
    return chunk_logits[0], pools


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
            for i, kind in enumerate(kinds):
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
                # each lane through the FFN on its own: an MoE row's
                # capacity counts that row's tokens only
                x = x + _ffn(p["ffn"], common.rms_norm(x, p["norm2"]), cfg,
                             kind)[0]
                if chunk is not None:
                    xc = xc + _ffn(p["ffn"], common.rms_norm(xc, p["norm2"]),
                                   cfg, kind)[0]
    dec_logits = _logits(params, x, cfg)[:, 0]
    chunk_logits = None
    if chunk is not None:
        last = chunk["last"].long()
        xl = torch.take_along_dim(xc, last[:, None, None], dim=1)
        chunk_logits = _logits(params, xl, cfg)[:, 0]
    return dec_logits, chunk_logits, pools


def paged_sampled_step(params, token_buf, pools, page_table, cache_lens,
                       dec_mask, cfg: ArchConfig, *, stem_cfg, sampler,
                       budget_frac: float = 1.0, chunk=None,
                       chunk_k_max: int = 0):
    """``paged_mixed_step`` with sampling on the device: the async engine's
    step.  The decode lane reads its tokens from ``token_buf`` — the
    device-resident fed-back token buffer, ``(slots + 1,)`` int32 whose last
    entry is a trash entry — and the buffer is advanced in place:

      * decode lanes granted this step (``dec_mask`` (slots,) bool) write
        their sampled id back (the next step's input); the others keep
        their pending token;
      * a chunk lane that completes a prefill (``chunk["emit"]`` (L,) bool)
        writes its sampled first token into the entry of ``chunk["slot"]``;
        the other lanes write into the trash entry (the reference drops
        out-of-range targets; a boolean mask would give a data-dependent
        shape and a host sync).

    Returns (dec_ids (slots,) int32, chunk_ids (L,) int32 | None, token_buf,
    pools)."""
    slots = dec_mask.shape[0]
    dec_logits, chunk_logits, pools = paged_mixed_step(
        params, token_buf[:slots, None], pools, page_table, cache_lens, cfg,
        stem_cfg=stem_cfg, budget_frac=budget_frac, chunk=chunk,
        chunk_k_max=chunk_k_max)
    dec_ids = sampler(dec_logits)
    token_buf[:slots] = torch.where(dec_mask, dec_ids, token_buf[:slots])
    chunk_ids = None
    if chunk is not None:
        chunk_ids = sampler(chunk_logits)
        target = torch.where(chunk["emit"], chunk["slot"].long(), slots)
        token_buf.index_copy_(0, target, chunk_ids)
    return dec_ids, chunk_ids, token_buf, pools


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
    h = common.rms_norm(x, params["norm1"])
    if kind == "rec":
        mix, cache = rglru.apply_decode(params["mixer"], h, cfg, cache)
    elif kind == "ssd":
        mix, cache = ssd.apply_decode(params["mixer"], h, cfg, cache)
    elif kind == "dense_local":
        mix, cache = attention.apply_decode(params["attn"], h, cfg, cache,
                                            window=cfg.rglru.window)
    elif kind in MLA_KINDS:    # dense over the latent cache, as the reference
        mix, cache = mla.apply_decode(params["attn"], h, cfg, cache)
    else:
        mix, cache = attention.apply_decode(params["attn"], h, cfg, cache,
                                            stem_cfg=stem_cfg,
                                            budget_frac=budget_frac)
    return _with_ffn(params, x + mix, cfg, kind)[0], cache


def decode_step(params, tokens, caches, cfg: ArchConfig, *, stem_cfg=None,
                budget_frac: float = 1.0):
    """One token for every sequence in the batch.  tokens: (b, 1).
    Returns (logits (b, vocab), caches): each layer writes its token's K/V
    into its view of the stacked caches in place, and every ``pos`` leaf
    advances by one.

    With ``stem_cfg`` the attention sub-layers decode policy-sparse over
    the contiguous cache (summarize + select every step) — the fixed-batch
    reference for the paged engine's sparse decode.  Only the paged kinds
    decode sparse, so with ``stem_cfg`` any other config (MLA, windowed,
    recurrent) raises, as in the reference."""
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
                c = seg_cache[f"sub{i}"]       # a cache or recurrent state
                view = type(c)(*(leaf[layer] for leaf in c))
                x, view = _sublayer_decode(layer_params[f"sub{i}"], x, cfg, k,
                                           view, stem_cfg=stem_cfg,
                                           budget_frac=budget_frac)
                new_pos[f"sub{i}"].append(view.pos)
        new_caches.append({key: seg_cache[key]._replace(pos=torch.stack(ps))
                           for key, ps in new_pos.items()})
    return _logits(params, x, cfg)[:, 0], new_caches
