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


def _shard(params, t: int) -> dict:
    """Model shard ``t``'s leaves: its block of each ``ModelShards``, the
    rest as given."""
    return {k: v.parts[t] if isinstance(v, arrays.ModelShards) else v
            for k, v in params.items()}


def _tp_project(params, x, cfg: ArchConfig, mp, positions, use_rope: bool):
    """Each model shard's queries (its block of heads) and the K / V its
    query heads read, on its device: (xs, qs, ks, vs, kv).  KV heads split
    with the query heads when the rules split ``kv_heads``; otherwise K / V
    are projected once on the lead shard (``kv``: that whole (k, v), else
    None) and each shard is sent the KV heads its query heads read."""
    h, hk = params["wq"].shape[1], params["wk"].shape[1]
    hl, group = h // mp.tp, h // hk
    if hl % group and group % hl:
        raise NotImplementedError(f"{mp.tp} model shards split {h} query heads into "
                                  f"blocks of {hl}, neither a multiple nor a divisor "
                                  f"of the GQA group {group}")
    kv_split = isinstance(params["wk"], arrays.ModelShards)
    xs = arrays.to_model_shards(x, mp)
    qs, ks, vs, kv = [], [], [], None
    if not kv_split:
        kv = _kv(params, x, cfg, positions, use_rope)
        rng = [(t * hl // group, ((t + 1) * hl - 1) // group + 1) for t in range(mp.tp)]
        ks, vs = (arrays.to_model_shards(t, mp, 1, rng) for t in kv)
    for t in range(mp.tp):
        with mp.on(t):
            qs.append(_q(_shard(params, t), xs[t], cfg, positions, use_rope))
            if kv_split:
                k, v = _kv(_shard(params, t), xs[t], cfg, positions, use_rope)
                ks.append(k)
                vs.append(v)
    return xs, qs, ks, vs, kv


def _tp_attend(qs, ks, vs, pol, mp, n: int, group: int, *, window,
               causal: bool) -> list:
    """Each model shard's attention over its heads (a KV group of ``group``
    query heads split over shards pools its metric across them): the
    outputs, one a shard."""
    hl = qs[0].shape[1]
    scores = [None] * mp.tp
    if window is None and takes_sparse_path(pol, n, causal) \
            and pol.group_reduce != "none" and hl < group:
        scores = _group_pooled_scores(qs, ks, vs, pol, group, mp)
    outs = []
    for t in range(mp.tp):
        with mp.on(t):
            if window is not None:
                outs.append(_local(qs[t], ks[t], vs[t], window))
            else:
                outs.append(sparse_or_dense(qs[t], ks[t], vs[t], pol, n, causal, False,
                                            scores[t])[0])
    return outs


def _apply_full_tp(params, x, cfg: ArchConfig, mp, *, positions, pol, window,
                   use_rope: bool, causal: bool):
    """``apply_full`` over the model shards of ``mp`` (the module
    docstring)."""
    _, qs, ks, vs, _ = _tp_project(params, x, cfg, mp, positions, use_rope)
    group = params["wq"].shape[1] // params["wk"].shape[1]
    os_ = _tp_attend(qs, ks, vs, pol, mp, x.shape[1], group, window=window,
                     causal=causal)
    outs = []
    for t in range(mp.tp):
        with mp.on(t):
            outs.append(_out_proj(os_[t], x, {"wo": params["wo"].parts[t]}))
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


def _cache_of(k, v, n: int, max_len: int, window):
    """The prompt's K / V (b, hk, n, dh) as the cache holds them: padded to
    ``max_len``, or the trailing ``L = min(max_len, window)`` keys rolled
    onto their ring slots (position p at slot p % L)."""
    if window is not None:
        L = min(max_len, window)
        return (torch.roll(k[:, :, -L:], shifts=n % L, dims=2),
                torch.roll(v[:, :, -L:], shifts=n % L, dims=2))
    pad = max_len - k.shape[2]
    return F.pad(k, (0, 0, 0, pad)), F.pad(v, (0, 0, 0, pad))


def prefill_into_cache(params, x, cfg: ArchConfig, *, positions, max_len: int,
                       stem_cfg=None, window: Optional[int] = None,
                       use_rope: bool = True):
    """Prefill attention and the populated cache for decode.  x: (b, n,
    d).  Returns (out, KVCache with k/v padded to max_len).

    Windowed: local attention, and the trailing ``L = min(max_len,
    window)`` keys rolled onto their ring slots (position p at slot p % L).
    As in the reference, a prompt shorter than L leaves a cache of n slots,
    and decode then rings over those n (its window shrinks to n).

    With its heads in ``ModelShards`` (inside ``sharding.context.
    model_parallel``) the attention runs as ``apply_full``'s and the
    cache's ``k`` / ``v`` are ``ModelShards`` in ``rules.cache_shardings``'
    layout: each shard's KV heads where the rules split them, else each
    shard's block of the (ring) slots for every KV head, cut from the K / V
    projected once on the lead shard (whole on every shard where the model
    axis divides neither).  Where the rules leave the query heads whole
    the attention runs on the lead shard and the cache is cut the same
    way."""
    pol = policy_lib.as_policy_opt(stem_cfg)
    n = x.shape[1]
    pos = torch.tensor(n, dtype=torch.int32, device=x.device)
    if isinstance(params["wq"], arrays.ModelShards):
        mp = shctx.model_parallel_state()
        _, qs, ks, vs, kv = _tp_project(params, x, cfg, mp, positions, use_rope)
        group = params["wq"].shape[1] // params["wk"].shape[1]
        os_ = _tp_attend(qs, ks, vs, pol, mp, n, group, window=window, causal=True)
        outs, cks, cvs = [], [], []
        for t in range(mp.tp):
            with mp.on(t):
                outs.append(_out_proj(os_[t], x, {"wo": params["wo"].parts[t]}))
                if kv is None:
                    ck, cv = _cache_of(ks[t], vs[t], n, max_len, window)
                    cks.append(ck)
                    cvs.append(cv)
        if kv is None:
            wk = params["wk"]
            shape = (x.shape[0], wk.shape[1], cks[0].shape[2], wk.shape[2])
            ck = arrays.ModelShards(cks, 1, wk.bounds, shape)
            cv = arrays.ModelShards(cvs, 1, wk.bounds, shape)
        else:
            ck, cv = (arrays.cache_blocks(c, mp, (2,))
                      for c in _cache_of(*kv, n, max_len, window))
        return (arrays.reduce_from_model_shards(outs, mp, x.dtype),
                KVCache(k=ck, v=cv, pos=pos))
    q, k, v = _project(params, x, cfg, positions, use_rope=use_rope)
    if window is not None:
        o = _local(q, k, v, window)
    else:
        o, _ = sparse_or_dense(q, k, v, pol, n, True, False)
    ck, cv = _cache_of(k, v, n, max_len, window)
    mp = shctx.model_parallel_state()
    if mp is not None:      # the rules leave the heads whole: the cache's blocks
        ck, cv = arrays.cache_blocks(ck, mp, (2,)), arrays.cache_blocks(cv, mp, (2,))
    return _out_proj(o, x, params), KVCache(k=ck, v=cv, pos=pos)


def _check_sparse_decode(cache_len: int, window, pol) -> None:
    if window is not None:
        raise NotImplementedError(
            "policy-sparse decode needs global attention, not windowed")
    if cache_len % pol.block_size != 0:
        raise ValueError(
            f"policy-sparse decode needs the cache capacity to be a "
            f"multiple of the policy block size, but cache len {cache_len} % "
            f"block {pol.block_size} != 0. Allocate the cache padded to "
            f"a block/page multiple — ceil(max_len / {pol.block_size}) "
            f"* {pol.block_size} — as the paged engine does with whole "
            f"pages (per-row valid lengths may still be ragged; only "
            f"the buffer capacity must align).")


def _decode_attend(q, k_new, v_new, cache: KVCache, cfg: ArchConfig, *, window,
                   pol, budget_frac: float):
    """Write the step's K / V into ``cache`` (in place) and attend: (o (b,
    hq, 1, dh), the cache with ``pos`` advanced)."""
    pos = cache.pos
    b = q.shape[0]
    L = cache.k.shape[2]
    posv = pos.expand(b)                                         # (b,)
    ar = torch.arange(L, device=q.device)[None, :]
    if window is None:
        ck, cv = common.update_cache(cache.k, cache.v, pos, k_new, v_new)
        valid = ar <= posv[:, None]                              # (b, L)
    else:
        ck, cv = common.update_ring_cache(cache.k, cache.v, pos, k_new, v_new, L)
        slot_age = posv[:, None] - ((posv[:, None] - ar) % L)
        valid = (slot_age >= 0) & (slot_age > posv[:, None] - L)
    new_cache = KVCache(k=ck, v=cv, pos=pos + 1)
    if pol is not None:
        summary = decode_lib.summarize_cache(ck, cv, pol)
        return decode_lib.sparse_decode_attention(
            q, ck, cv, summary, posv + 1, pol, budget_frac=budget_frac), new_cache
    h = q.shape[1]
    hk = ck.shape[1]
    group = h // hk
    s = torch.einsum("bhgd,bhkd->bhgk",
                     q[:, :, 0].reshape(b, hk, group, -1).float(),
                     ck.float()) * (cfg.head_dim ** -0.5)
    s = torch.where(valid[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p, cv.float())
    return o.reshape(b, h, 1, cfg.head_dim), new_cache


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
    ring of ``cache.k.shape[2]`` slots (no policy).

    With its heads and the cache in ``ModelShards`` (a mesh serve step)
    the step runs over the model shards: ``_apply_decode_tp``."""
    pol = policy_lib.as_policy(stem_cfg) if stem_cfg is not None else None
    if pol is not None:
        # validate before any projection: the summaries need whole blocks
        _check_sparse_decode(cache.k.shape[2], window, pol)
    pos = cache.pos
    rope_pos = pos[None] if pos.ndim == 0 else pos[:, None]      # (1,)|(b,1)
    if isinstance(cache.k, arrays.ModelShards):
        return _apply_decode_tp(params, x, cfg, cache, shctx.model_parallel_state(),
                                rope_pos=rope_pos, window=window, use_rope=use_rope,
                                pol=pol, budget_frac=budget_frac)
    q, k_new, v_new = _project(params, x, cfg, rope_pos, use_rope=use_rope)
    o, new_cache = _decode_attend(q, k_new, v_new, cache, cfg, window=window, pol=pol,
                                  budget_frac=budget_frac)
    return _out_proj(o, x, params), new_cache


def _partial_softmax(s, keep, pv):
    """One shard's share of a softmax: the scores ``s`` (..., n) of its
    keys masked by ``keep``, in fp32, and ``pv(p)`` the probabilities'
    product with its values: (row max (..., 1), row sum (..., 1),
    unnormalized output).  A row with no key kept adds zero weight: its max
    is -1e30, its sum and output 0."""
    s = torch.where(keep, s, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), 0.0)
    return m, p.sum(dim=-1, keepdim=True), pv(p)


def combine_partials(parts: list, mp) -> torch.Tensor:
    """The softmax-weighted output of the shards' ``_partial_softmax``
    results ((shard, (m, l, acc)) pairs), combined on the lead shard in
    rank order in fp32 (a row that no shard kept a key of: zeros)."""
    lead = mp.devices[0]
    got = []
    with mp.on(0):
        for t, (m, l, acc) in parts:
            if t:
                cost_lib.note_collective("reduce", (m.numel() + l.numel() + acc.numel()) * 4,
                                         mp.coords[t])
            got.append((m.to(lead), l.to(lead), acc.to(lead)))
        top = got[0][0]
        for m, _, _ in got[1:]:
            top = torch.maximum(top, m)
        total = acc_sum = None
        for m, l, acc in got:
            w = torch.exp(m - top)
            total = l * w if total is None else total + l * w
            acc_sum = acc * w if acc_sum is None else acc_sum + acc * w
        return acc_sum / torch.where(total > 0, total, torch.ones_like(total))


def write_owned(part, lo: int, slot, own, new, dim: int = 2) -> None:
    """Each row's ``new`` (size 1 along ``dim``) written at its slot
    ``slot`` (a scalar or (b,)) of ``part``, whose slots along ``dim`` start
    at ``lo``, where ``own`` (the slot lies in the part) holds; in place.
    ``dim`` is 2 for a KV cache (b, hk, n, dh), 1 for MLA's (b, n, r)."""
    li = torch.clamp(slot - lo, 0, part.shape[dim] - 1).long()
    new = new.to(part.dtype)
    if slot.ndim == 0:
        li = li.reshape(1)
        part.index_copy_(dim, li, torch.where(own, new, part.index_select(dim, li)))
        return
    bidx = torch.arange(part.shape[0], device=part.device)
    if dim == 2:
        part[bidx, :, li] = torch.where(own[:, None, None], new[:, :, 0], part[bidx, :, li])
    else:
        part[bidx, li] = torch.where(own[:, None], new[:, 0], part[bidx, li])


def _apply_decode_tp(params, x, cfg: ArchConfig, cache: KVCache, mp, *, rope_pos,
                     window, use_rope: bool, pol, budget_frac: float):
    """``apply_decode`` over the model shards of ``mp``, the cache in
    ``ModelShards`` (``rules.cache_shardings``' layout):

    * split by KV heads: each shard projects its heads, writes its KV heads'
      new K / V and decodes them as one device does (policy-sparse: it
      summarizes and selects its own heads); ``wo``'s row blocks give
      partial products, summed in rank order;
    * split by sequence (slots), or whole on every shard: each shard
      projects its query heads and they are all-gathered (where the rules
      leave the heads whole, the lead projects them, sends them to every
      shard and applies ``wo`` itself); the new K / V,
      projected once on the lead shard, are written only on the shard
      whose slots hold the row's position (on every shard when whole); each
      shard computes the fp32 partial softmax of its valid slots, and the
      partials are combined on the lead shard in rank order
      (``combine_partials``).  Policy-sparse: each shard summarizes its own
      blocks (kernels 5-6) and scores them, the scores are gathered in
      rank order, one selection is made on the lead shard, and each shard
      attends the selected blocks it holds."""
    ck, cv, pos = cache.k, cache.v, cache.pos
    b = x.shape[0]
    h, hk, dh = params["wq"].shape[1], ck.shape[1], ck.shape[3]
    hl = h // mp.tp
    xs = arrays.to_model_shards(x, mp)
    poss = arrays.to_model_shards(pos, mp)
    new_cache = KVCache(k=ck, v=cv, pos=pos + 1)
    if ck.dim == 1:
        outs = []
        for t in range(mp.tp):
            with mp.on(t):
                p = _shard(params, t)
                q, k_new, v_new = _project(p, xs[t], cfg, rope_pos.to(xs[t].device),
                                           use_rope=use_rope)
                o, _ = _decode_attend(q, k_new, v_new,
                                      KVCache(ck.parts[t], cv.parts[t], poss[t]), cfg,
                                      window=window, pol=pol, budget_frac=budget_frac)
                outs.append(_out_proj(o, xs[t], {"wo": p["wo"]}))
        return arrays.reduce_from_model_shards(outs, mp, x.dtype), new_cache
    heads_split = isinstance(params["wq"], arrays.ModelShards)
    if heads_split:
        qs = []
        for t in range(mp.tp):
            with mp.on(t):
                qs.append(_q(_shard(params, t), xs[t], cfg, rope_pos.to(xs[t].device),
                             use_rope))
        q_all = arrays.take(arrays.ModelShards(qs, 1, arrays.even_bounds(h, mp.tp),
                                               (b, h, 1, dh)), mp, [[(0, h)]] * mp.tp)
    else:                   # the rules leave the heads whole: on the lead shard
        q_all = arrays.to_model_shards(_q(params, x, cfg, rope_pos, use_rope), mp)
    k_new, v_new = _kv(params, x, cfg, rope_pos, use_rope)
    ks, vs = arrays.to_model_shards(k_new, mp), arrays.to_model_shards(v_new, mp)
    L = ck.shape[2]
    bounds = ck.seq_bounds(2)
    owners = range(mp.tp) if ck.dim == 2 else range(1)
    for t in range(mp.tp):
        with mp.on(t):
            lo, hi = bounds[t]
            slot = poss[t] if window is None else poss[t] % L
            own = (slot >= lo) & (slot < hi)
            write_owned(ck.parts[t], lo, slot, own, ks[t])
            write_owned(cv.parts[t], lo, slot, own, vs[t])
    group = h // hk
    if pol is not None:
        parts = _sparse_partials(q_all, ck, cv, poss, bounds, owners, pol, budget_frac, mp)
    else:
        parts = []
        for t in owners:
            with mp.on(t):
                lo, hi = bounds[t]
                posv = poss[t].expand(b)[:, None]
                g = torch.arange(lo, hi, device=posv.device)[None, :]
                if window is None:
                    valid = g <= posv
                else:
                    age = posv - ((posv - g) % L)
                    valid = (age >= 0) & (age > posv - L)
                qg = q_all[t][:, :, 0].reshape(b, hk, group, dh).float()
                s = torch.einsum("bhgd,bhkd->bhgk", qg, ck.parts[t].float()) \
                    * (cfg.head_dim ** -0.5)
                vt = cv.parts[t].float()
                parts.append((t, _partial_softmax(
                    s, valid[:, None, None, :],
                    lambda p: torch.einsum("bhgk,bhkd->bhgd", p, vt))))
    o = combine_partials(parts, mp).reshape(b, h, 1, dh)
    if pol is not None:
        o = o.to(q_all[0].dtype)
    if not heads_split:
        return _out_proj(o, x, params), new_cache
    os_ = arrays.to_model_shards(o, mp, 1, params["wo"].bounds)
    outs = []
    for t in range(mp.tp):
        with mp.on(t):
            outs.append(_out_proj(os_[t], xs[t], {"wo": params["wo"].parts[t]}))
    return arrays.reduce_from_model_shards(outs, mp, x.dtype), new_cache


def _sparse_partials(q_all, ck, cv, poss, bounds, owners, pol, budget_frac: float,
                     mp) -> list:
    """Policy-sparse decode over a cache split by sequence: each owning
    shard's summaries and scores of its blocks, one selection over the
    scores gathered in rank order (on the lead shard), then each shard's
    partial softmax over the selected blocks it holds."""
    b, hk, L, dh = ck.shape
    bs = pol.block_size
    if any(lo % bs or hi % bs for lo, hi in bounds):
        raise NotImplementedError(
            f"policy-sparse decode over a cache split by sequence needs each shard's "
            f"slots {bounds} in whole blocks of {bs}")
    scores = []
    with torch.no_grad():
        for t in owners:
            with mp.on(t):
                summary = decode_lib.summarize_cache(ck.parts[t], cv.parts[t], pol)
                scores.append(pol.decode_scores(q_all[t], summary.k_groups, summary.v_mag))
        with mp.on(0):
            lead = mp.devices[0]
            for t, m in zip(owners, scores):
                if t:
                    cost_lib.note_collective("all-gather", m.numel() * 4, mp.coords[t])
            m = torch.cat([m.to(lead) for m in scores], dim=-1)
            lens = poss[0].expand(b) + 1
            sel = pol.decode_select(m, lens, budget_frac=budget_frac)
    idxs = arrays.to_model_shards(sel.indices, mp)
    lives = arrays.to_model_shards(sel.live, mp)
    parts = []
    for t in owners:
        with mp.on(t):
            lo, hi = bounds[t]
            nb = (hi - lo) // bs
            local = idxs[t].long() - lo // bs                     # (b, hk, g, kmax)
            mine = lives[t] & (local >= 0) & (local < nb)
            at = torch.clamp(local, 0, nb - 1)[..., None, None]
            group = q_all[t].shape[1] // hk
            kb = ck.parts[t].reshape(b, hk, 1, nb, bs, dh)
            vb = cv.parts[t].reshape(b, hk, 1, nb, bs, cv.shape[3])
            gk = torch.take_along_dim(kb, at, dim=3)           # (b, hk, g, kmax, bs, dh)
            gv = torch.take_along_dim(vb, at, dim=3)
            lens = poss[t].expand(b) + 1
            tok = idxs[t].long()[..., None] * bs + torch.arange(bs, device=gk.device)
            keep = (tok < lens[:, None, None, None, None]) & mine[..., None]
            qg = q_all[t].reshape(b, hk, group, 1, dh).float()
            s = torch.einsum("bhgqd,bhgnkd->bhgqnk", qg, gk.float()) * (dh ** -0.5)
            n = s.shape[-2] * bs
            gvf = gv.reshape(b, hk, group, n, gv.shape[-1]).float()
            parts.append((t, _partial_softmax(
                s.reshape(b, hk, group, 1, n), keep.reshape(b, hk, group, 1, n),
                lambda p: torch.einsum("bhgqn,bhgnd->bhgqd", p, gvf))))
    return parts


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
