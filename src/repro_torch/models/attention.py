"""Grouped-query attention with a pluggable sparsity policy (port of
``repro/models/attention.py``: ``init``, ``_project``, the global-attention
branches of ``apply_full``, ``prefill_into_cache`` and ``apply_decode`` with
``KVCache`` / ``init_cache``, and the paged ``apply_decode_paged`` /
``apply_chunk_paged``).

Full-sequence attention runs the policy-sparse path
(``core/sparse_attention.sparse_attention``) when a policy is given and the
sequence holds at least two whole blocks, and the dense arm
(``dense_attention_auto``) otherwise.  Windowed (local) attention is not
ported yet and raises.
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
from repro_torch.core.sparse_attention import (dense_attention_auto,
                                               sparse_attention)
from repro_torch.models import common
from repro_torch.runtime import paged as paged_lib


class KVCache(NamedTuple):
    k: torch.Tensor        # (b, hk, L, dh)
    v: torch.Tensor
    pos: torch.Tensor      # int32 next write position: scalar (uniform
                           # batch) or (b,) per sequence (ragged batch)


def init(ini: common.Initializer, cfg: ArchConfig) -> dict:
    d, h, hk, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": ini.normal((d, h, dh)),
        "wk": ini.normal((d, hk, dh)),
        "wv": ini.normal((d, hk, dh)),
        "wo": ini.normal((h, dh, d)),
    }
    if cfg.qkv_bias:
        p["bq"] = ini.zeros((h, dh))
        p["bk"] = ini.zeros((hk, dh))
        p["bv"] = ini.zeros((hk, dh))
    if cfg.qk_norm:
        p["q_norm"] = ini.zeros((dh,))
        p["k_norm"] = ini.zeros((dh,))
    return p


def _project(params, x, cfg: ArchConfig, positions, *, use_rope: bool = True):
    """x: (b, s, d) -> q (b, hq, s, dh), k, v (b, hk, s, dh)."""
    q = torch.einsum("bsd,dhk->bhsk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bhsk", x, params["wk"])
    v = torch.einsum("bsd,dhk->bhsk", x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"][None, :, None, :]
        k = k + params["bk"][None, :, None, :]
        v = v + params["bv"][None, :, None, :]
    if cfg.qk_norm:
        q = common.rms_norm(q, params["q_norm"])
        k = common.rms_norm(k, params["k_norm"])
    if use_rope:
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(o, x, params):
    return torch.einsum("bhsk,hkd->bsd", o.to(x.dtype), params["wo"])


def _no_window(window) -> None:
    if window is not None:
        raise NotImplementedError("windowed (local) attention is not ported yet")


def _sparse_or_dense(q, k, v, pol, n: int, causal: bool, return_stats: bool):
    """The policy-sparse path for causal sequences of >= 2 whole blocks,
    the dense arm otherwise.  Returns (o, StemStats | None)."""
    if pol is not None and causal and n % pol.block_size == 0 \
            and n // pol.block_size >= 2:
        if return_stats:
            return sparse_attention(q, k, v, pol, return_stats=True)
        return sparse_attention(q, k, v, pol), None
    return dense_attention_auto(q, k, v, causal=causal), None


def apply_full(params, x, cfg: ArchConfig, *, positions, stem_cfg=None,
               window: Optional[int] = None, use_rope: bool = True,
               causal: bool = True, return_stats: bool = False):
    """Training / prefill attention over the full sequence.  ``stem_cfg``:
    any policy spelling or None (dense).  ``return_stats`` also returns the
    sparse path's ``StemStats`` (None when the dense arm ran)."""
    _no_window(window)
    pol = policy_lib.as_policy_opt(stem_cfg)
    q, k, v = _project(params, x, cfg, positions, use_rope=use_rope)
    o, stats = _sparse_or_dense(q, k, v, pol, x.shape[1], causal, return_stats)
    out = _out_proj(o, x, params)
    return (out, stats) if return_stats else out


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               window: Optional[int] = None, dtype=torch.bfloat16,
               device="cuda") -> KVCache:
    _no_window(window)
    shape = (batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   pos=torch.zeros((), dtype=torch.int32, device=device))


def prefill_into_cache(params, x, cfg: ArchConfig, *, positions, max_len: int,
                       stem_cfg=None, window: Optional[int] = None,
                       use_rope: bool = True):
    """Prefill attention and the populated cache for decode.
    x: (b, n, d).  Returns (out, KVCache with k/v padded to max_len)."""
    _no_window(window)
    pol = policy_lib.as_policy_opt(stem_cfg)
    q, k, v = _project(params, x, cfg, positions, use_rope=use_rope)
    o, _ = _sparse_or_dense(q, k, v, pol, x.shape[1], True, False)
    pad = max_len - k.shape[2]
    cache = KVCache(k=F.pad(k, (0, 0, 0, pad)), v=F.pad(v, (0, 0, 0, pad)),
                    pos=torch.tensor(x.shape[1], dtype=torch.int32,
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
    and the step attends over them only."""
    _no_window(window)
    pos = cache.pos
    b = x.shape[0]
    if stem_cfg is not None:
        # Validate before any projection: the summaries need whole blocks.
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
    ck, cv = common.update_cache(cache.k, cache.v, pos, k_new, v_new)
    new_cache = KVCache(k=ck, v=cv, pos=pos + 1)
    if stem_cfg is not None:
        summary = decode_lib.summarize_cache(ck, cv, pol)
        o = decode_lib.sparse_decode_attention(
            q, ck, cv, summary, posv + 1, pol, budget_frac=budget_frac)
        return _out_proj(o, x, params), new_cache
    h = q.shape[1]
    hk = ck.shape[1]
    group = h // hk
    valid = torch.arange(L, device=x.device)[None, :] <= posv[:, None]   # (b, L)
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
    Returns (out, pool)."""
    stem_cfg = policy_lib.as_policy(stem_cfg)
    lens = cache_lens.to(torch.int32)
    q, k_new, v_new = _project(params, x, cfg, lens[:, None], use_rope=use_rope)
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
    x: (lanes, C, d).  Returns (out, pool)."""
    stem_cfg = policy_lib.as_policy(stem_cfg)
    c = x.shape[1]
    positions = chunk_start[:, None] + torch.arange(c, device=x.device)[None, :]
    q, k_new, v_new = _project(params, x, cfg, positions, use_rope=use_rope)
    pool = paged_lib.write_chunk_pages(pool, page_table, chunk_start, k_new,
                                       v_new, true_len, stem_cfg)
    o = chunked_lib.chunked_prefill_attention(q, pool, page_table,
                                              chunk_start, budgets, stem_cfg,
                                              k_max)
    return _out_proj(o, x, params), pool
