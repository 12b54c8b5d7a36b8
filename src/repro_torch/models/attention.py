"""Grouped-query attention with a pluggable sparsity policy (port of
``repro/models/attention.py``): ``apply_full``, ``prefill_into_cache`` and
``apply_decode`` over global or windowed (ring) caches, the paged
``apply_decode_paged`` / ``apply_chunk_paged`` (on one device or over a
slot group's tp shards), and the encoder-decoder
cross attention (``init_cross``, ``cross_kv``, ``apply_cross``).

Full-sequence attention runs the policy-sparse path
(``core/sparse_attention.sparse_attention``) when a policy is given and the
sequence holds at least two whole blocks, and the dense arm
(``dense_attention_auto``) otherwise.  Windowed (local) attention runs as a
chunked band (``local_attention``), so its cost scales with N * window.

Tensor-parallel ``apply_full`` (its heads split over the model axis:
``sharding.arrays.ModelShards``, inside ``sharding.context.
model_parallel``): each model shard projects its block of query heads,
normalizes and rotates them, attends over them on its own device and
applies its row block of ``wo``; the shards' outputs are summed
(``reduce_from_model_shards``).  KV heads split with them when the rules
split ``kv_heads`` too; otherwise K / V are projected once on the lead
shard and each shard is sent the KV heads its query heads read.  Where a
KV group's query heads fall on several shards (``tp > hk``) and the policy
pools its metric over the group (``group_reduce``), each shard computes its
heads' metric, the group's shards exchange them and each pools the whole
group's, so every shard selects as the whole group does.  The
encoder-decoder's cross attention splits the same way (``cross_kv``,
``apply_cross``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import chunked as chunked_lib
from repro_torch.core import decode as decode_lib
from repro_torch.core import policy as policy_lib
from repro_torch.core.decode import DEFAULT_BUDGET_FRAC
from repro_torch.core import metric as metric_lib
from repro_torch.core.sparse_attention import (dense_attention,
                                               dense_attention_auto,
                                               sparse_attention)
from repro_torch.kernels import cost as cost_lib
from repro_torch.models import common
from repro_torch.runtime import paged as paged_lib
from repro_torch.sharding import arrays
from repro_torch.sharding import context as shctx
from repro_torch.sharding import serving as serving_lib


class KVCache(NamedTuple):
    k: torch.Tensor        # (b, hk, L, dh)
    v: torch.Tensor
    pos: torch.Tensor      # int32 next write position: scalar (uniform
                           # batch) or (b,) per sequence (ragged batch)


def init(ini: common.Initializer, cfg: ArchConfig) -> dict:
    d, h, hk, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": ini.normal((d, h, dh), ("embed", "heads", "head_dim")),
        "wk": ini.normal((d, hk, dh), ("embed", "kv_heads", "head_dim")),
        "wv": ini.normal((d, hk, dh), ("embed", "kv_heads", "head_dim")),
        "wo": ini.normal((h, dh, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = ini.zeros((h, dh), ("heads", "head_dim"))
        p["bk"] = ini.zeros((hk, dh), ("kv_heads", "head_dim"))
        p["bv"] = ini.zeros((hk, dh), ("kv_heads", "head_dim"))
    if cfg.qk_norm:
        p["q_norm"] = ini.zeros((dh,), ("head_dim",))
        p["k_norm"] = ini.zeros((dh,), ("head_dim",))
    return p


def _heads(x, w, b, norm, positions, cfg: ArchConfig, use_rope: bool):
    """x (b, s, d) projected by w (d, h, dh), plus the bias b, normed by
    ``norm`` and rotated (each when given): (b, h, s, dh)."""
    y = torch.einsum("bsd,dhk->bhsk", x, w)
    if b is not None:
        y = y + b[None, :, None, :]
    if norm is not None:
        y = common.rms_norm(y, norm)
    return common.apply_rope(y, positions, cfg.rope_theta) if use_rope else y


def _q(params, x, cfg: ArchConfig, positions, use_rope: bool):
    """x (b, s, d) -> q (b, hq, s, dh)."""
    return _heads(x, params["wq"], params["bq"] if cfg.qkv_bias else None,
                  params["q_norm"] if cfg.qk_norm else None, positions, cfg, use_rope)


def _kv(params, x, cfg: ArchConfig, positions, use_rope: bool):
    """x (b, s, d) -> k, v (b, hk, s, dh)."""
    k = _heads(x, params["wk"], params["bk"] if cfg.qkv_bias else None,
               params["k_norm"] if cfg.qk_norm else None, positions, cfg, use_rope)
    v = _heads(x, params["wv"], params["bv"] if cfg.qkv_bias else None, None,
               positions, cfg, False)
    return k, v


def _project(params, x, cfg: ArchConfig, positions, *, use_rope: bool = True):
    """x: (b, s, d) -> q (b, hq, s, dh), k, v (b, hk, s, dh)."""
    return (_q(params, x, cfg, positions, use_rope), *_kv(params, x, cfg, positions, use_rope))


def _out_proj(o, x, params):
    return torch.einsum("bhsk,hkd->bsd", o.to(x.dtype), params["wo"])


def local_attention(q, k, v, window: int):
    """Banded sliding-window attention, chunked so the cost is O(N * 2w).

    q, k, v: (b, h, n, d), k / v already repeated to q's heads.  Each query
    chunk of length w attends to its own and the previous chunk under the
    exact mask j <= i, i - j < w; a length that is not a window multiple is
    padded (padded keys lie in the future of every real query, padded
    queries are dropped)."""
    b, h, n, d = q.shape
    w = window
    if n <= w:
        return _masked_window_dense(q, k, v, w)
    n_orig = n
    if n % w:
        pad = w - n % w
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        n = n + pad
    nc = n // w
    qc = q.reshape(b, h, nc, w, d)
    kc = k.reshape(b, h, nc, w, d)
    vc = v.reshape(b, h, nc, w, d)
    k_prev = torch.cat([torch.zeros_like(kc[:, :, :1]), kc[:, :, :-1]], dim=2)
    v_prev = torch.cat([torch.zeros_like(vc[:, :, :1]), vc[:, :, :-1]], dim=2)
    kk = torch.cat([k_prev, kc], dim=3)                 # (b, h, nc, 2w, d)
    vv = torch.cat([v_prev, vc], dim=3)
    s = torch.einsum("bhcqd,bhckd->bhcqk", qc.float(), kk.float()) * (d ** -0.5)
    dev = q.device
    qi = torch.arange(w, device=dev)[:, None] + w       # position in the 2w band
    kj = torch.arange(2 * w, device=dev)[None, :]
    mask = (kj <= qi) & (kj > qi - w)
    first_chunk = torch.arange(nc, device=dev)[:, None, None] == 0
    valid = torch.where(first_chunk, mask & (kj >= w), mask)
    s = torch.where(valid[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhcqk,bhckd->bhcqd", p, vv.float())
    return o.reshape(b, h, n, d)[:, :, :n_orig].to(q.dtype)


def _masked_window_dense(q, k, v, window: int):
    n = q.shape[2]
    qi = torch.arange(n, device=q.device)[:, None]
    kj = torch.arange(n, device=q.device)[None, :]
    mask = (kj <= qi) & (kj > qi - window)
    b, hq = q.shape[0], q.shape[1]
    return dense_attention(q, k, v, causal=True, mask=mask.expand(b, hq, n, n))


def _local(q, k, v, window: int):
    group = q.shape[1] // k.shape[1]
    return local_attention(q, k.repeat_interleave(group, dim=1),
                           v.repeat_interleave(group, dim=1), window)


def takes_sparse_path(pol, n: int, causal: bool) -> bool:
    """Whether ``sparse_or_dense`` runs the policy-sparse path."""
    return pol is not None and causal and n % pol.block_size == 0 \
        and n // pol.block_size >= 2


def sparse_or_dense(q, k, v, pol, n: int, causal: bool, return_stats: bool,
                    scores=None):
    """The policy-sparse path for causal sequences of >= 2 whole blocks
    (``scores``: the metric to select by, else the policy's own), the dense
    arm otherwise.  Returns (o, StemStats | None)."""
    if takes_sparse_path(pol, n, causal):
        if return_stats:
            return sparse_attention(q, k, v, pol, return_stats=True, scores=scores)
        return sparse_attention(q, k, v, pol, scores=scores), None
    return dense_attention_auto(q, k, v, causal=causal), None


def _group_pooled_scores(qs: list, ks: list, vs: list, pol, group: int, mp) -> list:
    """Each model shard's rows of its KV group's pooled metric, when a
    group's ``group`` query heads fall on several shards of ``mp`` (each
    shard ``hl = group / n`` of them, ``qs[t]`` / ``ks[t]`` / ``vs[t]`` its
    heads and its one KV head): every shard's raw metric, then on each
    shard its group's metrics gathered in head order and reduced by
    ``pol.group_reduce``, as the whole group's would be."""
    hl = qs[0].shape[1]
    per = group // hl                        # shards a group spans
    with torch.no_grad():
        raw = []
        for t in range(mp.tp):
            with mp.on(t):
                raw.append(pol.metric.prefill_scores(qs[t], ks[t], vs[t],
                                                     block_size=pol.block_size))
        out = []
        for t in range(mp.tp):
            with mp.on(t):
                first = t // per * per
                parts = []
                for u in range(first, first + per):
                    if u != t:
                        cost_lib.note_collective("all-gather", raw[u].numel()
                                                 * raw[u].element_size(), mp.coords[t])
                    parts.append(raw[u].to(qs[t].device))
                pooled = metric_lib.group_reduce_metric(torch.cat(parts, dim=1), group,
                                                        pol.group_reduce)
                out.append(pooled[:, (t - first) * hl:(t - first + 1) * hl])
    return out


def _apply_full_tp(params, x, cfg: ArchConfig, mp, *, positions, pol, window,
                   use_rope: bool, causal: bool):
    """``apply_full`` over the model shards of ``mp`` (the module
    docstring)."""
    h, hk = params["wq"].shape[1], params["wk"].shape[1]
    hl, group = h // mp.tp, h // hk
    if hl % group and group % hl:
        raise NotImplementedError(f"{mp.tp} model shards split {h} query heads into "
                                  f"blocks of {hl}, neither a multiple nor a divisor "
                                  f"of the GQA group {group}")
    kv_split = isinstance(params["wk"], arrays.ModelShards)
    shard = lambda t: {k: v.parts[t] if isinstance(v, arrays.ModelShards) else v
                       for k, v in params.items()}
    xs = arrays.to_model_shards(x, mp)
    qs, ks, vs = [], [], []
    if not kv_split:
        # K / V once on the lead shard; each shard gets the KV heads it reads
        k, v = _kv(params, x, cfg, positions, use_rope)
        kv = [(t * hl // group, ((t + 1) * hl - 1) // group + 1) for t in range(mp.tp)]
        ks, vs = arrays.to_model_shards(k, mp, 1, kv), arrays.to_model_shards(v, mp, 1, kv)
    for t in range(mp.tp):
        with mp.on(t):
            qs.append(_q(shard(t), xs[t], cfg, positions, use_rope))
            if kv_split:
                k, v = _kv(shard(t), xs[t], cfg, positions, use_rope)
                ks.append(k)
                vs.append(v)
    n = x.shape[1]
    scores = [None] * mp.tp
    if window is None and takes_sparse_path(pol, n, causal) \
            and pol.group_reduce != "none" and hl < group:
        scores = _group_pooled_scores(qs, ks, vs, pol, group, mp)
    outs = []
    for t in range(mp.tp):
        with mp.on(t):
            if window is not None:
                o = _local(qs[t], ks[t], vs[t], window)
            else:
                o, _ = sparse_or_dense(qs[t], ks[t], vs[t], pol, n, causal, False,
                                       scores[t])
            outs.append(_out_proj(o, x, {"wo": params["wo"].parts[t]}))
    return arrays.reduce_from_model_shards(outs, mp, x.dtype)


def apply_full(params, x, cfg: ArchConfig, *, positions, stem_cfg=None,
               window: Optional[int] = None, use_rope: bool = True,
               causal: bool = True, return_stats: bool = False):
    """Training / prefill attention over the full sequence.  ``stem_cfg``:
    any policy spelling or None (dense).  ``return_stats`` also returns the
    sparse path's ``StemStats`` (None when the dense arm or the windowed
    path ran).  ``window`` runs local attention (no policy).  With its
    heads in ``ModelShards`` it runs tensor-parallel (the module docstring;
    no stats)."""
    pol = policy_lib.as_policy_opt(stem_cfg)
    if isinstance(params["wq"], arrays.ModelShards) and not return_stats:
        return _apply_full_tp(params, x, cfg, shctx.model_parallel_state(),
                              positions=positions, pol=pol, window=window,
                              use_rope=use_rope, causal=causal)
    q, k, v = _project(params, x, cfg, positions, use_rope=use_rope)
    if window is not None:
        o, stats = _local(q, k, v, window), None
    else:
        o, stats = sparse_or_dense(q, k, v, pol, x.shape[1], causal,
                                   return_stats)
    out = _out_proj(o, x, params)
    return (out, stats) if return_stats else out


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               window: Optional[int] = None, dtype=torch.bfloat16,
               device="cuda") -> KVCache:
    """Zeroed cache of ``max_len`` slots, or ``min(max_len, window)`` ring
    slots when windowed."""
    L = min(max_len, window) if window else max_len
    shape = (batch, cfg.num_kv_heads, L, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   pos=torch.zeros((), dtype=torch.int32, device=device))


def prefill_into_cache(params, x, cfg: ArchConfig, *, positions, max_len: int,
                       stem_cfg=None, window: Optional[int] = None,
                       use_rope: bool = True):
    """Prefill attention and the populated cache for decode.  x: (b, n,
    d).  Returns (out, KVCache with k/v padded to max_len).

    Windowed: local attention, and the trailing ``L = min(max_len,
    window)`` keys rolled onto their ring slots (position p at slot p % L).
    As in the reference, a prompt shorter than L leaves a cache of n slots,
    and decode then rings over those n (its window shrinks to n)."""
    pol = policy_lib.as_policy_opt(stem_cfg)
    q, k, v = _project(params, x, cfg, positions, use_rope=use_rope)
    n = x.shape[1]
    if window is not None:
        o = _local(q, k, v, window)
        L = min(max_len, window)
        ck = torch.roll(k[:, :, -L:], shifts=n % L, dims=2)
        cv = torch.roll(v[:, :, -L:], shifts=n % L, dims=2)
    else:
        o, _ = sparse_or_dense(q, k, v, pol, n, True, False)
        pad = max_len - k.shape[2]
        ck, cv = F.pad(k, (0, 0, 0, pad)), F.pad(v, (0, 0, 0, pad))
    cache = KVCache(k=ck, v=cv, pos=torch.tensor(n, dtype=torch.int32,
                                                 device=x.device))
    return _out_proj(o, x, params), cache


def apply_decode(params, x, cfg: ArchConfig, cache: KVCache, *,
                 window: Optional[int] = None, use_rope: bool = True,
                 stem_cfg=None, budget_frac: float = DEFAULT_BUDGET_FRAC):
    """One decode step against the contiguous cache.  x: (b, 1, d).
    Returns (out, KVCache): the new token's K/V are written into
    ``cache.k`` / ``cache.v`` in place, and ``pos`` advances by one.

    ``cache.pos`` may be a scalar (every row at one length) or a ``(b,)``
    vector (ragged batch: each row writes and masks at its own length, and
    rope uses the per-row position).  Without a policy the step is dense
    decode in fp32 over the valid prefix.  With ``stem_cfg`` (any policy
    spelling) the step is policy-sparse: the whole cache is re-summarized
    (O(L) a step: the fixed-batch reference arm of the paged engine, not a
    serving path), then the policy's metric and budget rule select blocks
    and the step attends over them only.  ``window`` treats the cache as a
    ring of ``cache.k.shape[2]`` slots (no policy)."""
    pos = cache.pos
    b = x.shape[0]
    if stem_cfg is not None:
        # Validate before any projection: the summaries need whole blocks.
        if window is not None:
            raise NotImplementedError(
                "policy-sparse decode needs global attention, not windowed")
        pol = policy_lib.as_policy(stem_cfg)
        L0 = cache.k.shape[2]
        if L0 % pol.block_size != 0:
            raise ValueError(
                f"policy-sparse decode needs the cache capacity to be a "
                f"multiple of the policy block size, but cache len {L0} % "
                f"block {pol.block_size} != 0. Allocate the cache padded to "
                f"a block/page multiple — ceil(max_len / {pol.block_size}) "
                f"* {pol.block_size} — as the paged engine does with whole "
                f"pages (per-row valid lengths may still be ragged; only "
                f"the buffer capacity must align).")
    rope_pos = pos[None] if pos.ndim == 0 else pos[:, None]      # (1,)|(b,1)
    q, k_new, v_new = _project(params, x, cfg, rope_pos, use_rope=use_rope)
    L = cache.k.shape[2]
    posv = pos.expand(b)                                         # (b,)
    ar = torch.arange(L, device=x.device)[None, :]
    if window is None:
        ck, cv = common.update_cache(cache.k, cache.v, pos, k_new, v_new)
        valid = ar <= posv[:, None]                              # (b, L)
    else:
        ck, cv = common.update_ring_cache(cache.k, cache.v, pos, k_new, v_new, L)
        slot_age = posv[:, None] - ((posv[:, None] - ar) % L)
        valid = (slot_age >= 0) & (slot_age > posv[:, None] - L)
    new_cache = KVCache(k=ck, v=cv, pos=pos + 1)
    if stem_cfg is not None:
        summary = decode_lib.summarize_cache(ck, cv, pol)
        o = decode_lib.sparse_decode_attention(
            q, ck, cv, summary, posv + 1, pol, budget_frac=budget_frac)
        return _out_proj(o, x, params), new_cache
    h = q.shape[1]
    hk = ck.shape[1]
    group = h // hk
    s = torch.einsum("bhgd,bhkd->bhgk",
                     q[:, :, 0].reshape(b, hk, group, -1).float(),
                     ck.float()) * (cfg.head_dim ** -0.5)
    s = torch.where(valid[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p, cv.float())
    o = o.reshape(b, h, 1, cfg.head_dim)
    return _out_proj(o, x, params), new_cache


def apply_decode_paged(params, x, cfg: ArchConfig, pool, page_table,
                       cache_lens, stem_cfg, *,
                       budget_frac: float = DEFAULT_BUDGET_FRAC,
                       use_rope: bool = True):
    """One decode step against the paged cache: append the new token's K/V
    (+ summary increments, in place), then policy page selection + exact
    attention over the selected pages.  x: (slots, 1, d).
    Returns (out, pool).

    Under the serving mesh ``pool`` is a ``serving.HeadShards`` of the tp
    ranks' layer pools (ref ``src/repro/models/attention.py:255-283``): the
    projections are computed once, each rank appends and attends its head
    block on its own device, and the outputs are gathered in rank order
    before ``wo``."""
    stem_cfg = policy_lib.as_policy(stem_cfg)
    lens = cache_lens.to(torch.int32)
    q, k_new, v_new = _project(params, x, cfg, lens[:, None], use_rope=use_rope)
    if isinstance(pool, serving_lib.HeadShards):
        tp, outs = len(pool), []
        for t, pl in enumerate(pool):
            dev = pl.k.device
            pt, ln = page_table.to(dev), lens.to(dev)
            paged_lib.append_token(
                pl, pt, ln, serving_lib.local_heads(k_new, t, tp).to(dev),
                serving_lib.local_heads(v_new, t, tp).to(dev), stem_cfg)
            outs.append(paged_lib.paged_sparse_decode(
                serving_lib.local_heads(q, t, tp).to(dev), pl, pt, ln + 1,
                stem_cfg, budget_frac=budget_frac))
        return _out_proj(serving_lib.gather_heads(outs, x.device), x, params), pool
    pool = paged_lib.append_token(pool, page_table, lens, k_new, v_new, stem_cfg)
    o = paged_lib.paged_sparse_decode(q, pool, page_table, lens + 1, stem_cfg,
                                      budget_frac=budget_frac)
    return _out_proj(o, x, params), pool


def apply_chunk_paged(params, x, cfg: ArchConfig, pool, page_table,
                      chunk_start, true_len, budgets, stem_cfg, *,
                      k_max: int = 0, use_rope: bool = True):
    """One chunked-prefill step against the paged cache: write the chunk's
    K/V pages + summaries first (in place), then chunked selection + exact
    attention over history and in-chunk pages at absolute positions.
    x: (lanes, C, d).  Returns (out, pool).  Under the serving mesh
    ``pool`` is a ``serving.HeadShards``, as in ``apply_decode_paged`` (ref
    ``src/repro/models/attention.py:286-327``)."""
    stem_cfg = policy_lib.as_policy(stem_cfg)
    c = x.shape[1]
    positions = chunk_start[:, None] + torch.arange(c, device=x.device)[None, :]
    q, k_new, v_new = _project(params, x, cfg, positions, use_rope=use_rope)
    if isinstance(pool, serving_lib.HeadShards):
        tp, outs = len(pool), []
        for t, pl in enumerate(pool):
            dev = pl.k.device
            pt, start = page_table.to(dev), chunk_start.to(dev)
            paged_lib.write_chunk_pages(
                pl, pt, start, serving_lib.local_heads(k_new, t, tp).to(dev),
                serving_lib.local_heads(v_new, t, tp).to(dev),
                true_len.to(dev), stem_cfg)
            outs.append(chunked_lib.chunked_prefill_attention(
                serving_lib.local_heads(q, t, tp).to(dev), pl, pt, start,
                budgets.to(dev), stem_cfg, k_max))
        return _out_proj(serving_lib.gather_heads(outs, x.device), x, params), pool
    pool = paged_lib.write_chunk_pages(pool, page_table, chunk_start, k_new,
                                       v_new, true_len, stem_cfg)
    o = chunked_lib.chunked_prefill_attention(q, pool, page_table,
                                              chunk_start, budgets, stem_cfg,
                                              k_max)
    return _out_proj(o, x, params), pool


# ---------------------------------------------------------------------------
# Cross attention (encoder-decoder)
# ---------------------------------------------------------------------------

def init_cross(ini: common.Initializer, cfg: ArchConfig) -> dict:
    d, h, dh = cfg.d_model, cfg.num_heads, cfg.head_dim
    return {
        "wq": ini.normal((d, h, dh), ("embed", "heads", "head_dim")),
        "wk": ini.normal((d, h, dh), ("embed", "heads", "head_dim")),
        "wv": ini.normal((d, h, dh), ("embed", "heads", "head_dim")),
        "wo": ini.normal((h, dh, d), ("heads", "head_dim", "embed")),
    }


def cross_kv(params, enc_out):
    """Cross-attention K/V of the encoder output (b, F, d): (b, h, F, dh).
    With its heads in ``ModelShards`` (inside ``sharding.context.
    model_parallel``): lists of each model shard's heads' K / V, on its
    device."""
    if isinstance(params["wk"], arrays.ModelShards):
        mp = shctx.model_parallel_state()
        es, ks, vs = arrays.to_model_shards(enc_out, mp), [], []
        for t in range(mp.tp):
            with mp.on(t):
                ks.append(torch.einsum("bsd,dhk->bhsk", es[t], params["wk"].parts[t]))
                vs.append(torch.einsum("bsd,dhk->bhsk", es[t], params["wv"].parts[t]))
        return ks, vs
    k = torch.einsum("bsd,dhk->bhsk", enc_out, params["wk"])
    v = torch.einsum("bsd,dhk->bhsk", enc_out, params["wv"])
    return k, v


def _cross(wq, wo, x, ck, cv, head_dim: int):
    q = torch.einsum("bsd,dhk->bhsk", x, wq)
    o = dense_attention_auto(q, ck, cv, causal=False, scale=head_dim ** -0.5)
    return torch.einsum("bhsk,hkd->bsd", o, wo)


def apply_cross(params, x, ck, cv, head_dim: int):
    """Bidirectional cross attention: the decoder's x attends the encoder's
    K/V (the plain non-causal path of ``dense_attention_auto``).  With its
    heads in ``ModelShards`` (``ck`` / ``cv``: ``cross_kv``'s lists) each
    model shard attends its heads and applies its row block of ``wo``; the
    partial products are summed (``reduce_from_model_shards``)."""
    if isinstance(params["wq"], arrays.ModelShards):
        mp = shctx.model_parallel_state()
        xs, outs = arrays.to_model_shards(x, mp), []
        for t in range(mp.tp):
            with mp.on(t):
                outs.append(_cross(params["wq"].parts[t], params["wo"].parts[t], xs[t],
                                   ck[t], cv[t], head_dim))
        return arrays.reduce_from_model_shards(outs, mp, x.dtype)
    return _cross(params["wq"], params["wo"], x, ck, cv, head_dim)
