"""Multi-head Latent Attention (DeepSeek-V3) with Stem (port of
``repro/models/mla.py``).

MLA compresses K/V into a small latent ``c_kv`` (512) plus a shared 64-dim
rotary key.  The decode cache stores only (c_kv, k_rope), in bf16 whatever
the model dtype, and queries use a low-rank down / up projection.

Stem (the paper's DSA + Stem experiment): full-sequence attention expands
the latents to per-head keys (nope 128 + rope 64 = 192) and values (128)
and runs the policy-sparse path over them when the sequence holds at least
two whole blocks, the dense arm otherwise.  The OAM value term reads the
expanded values handed to ``sparse_attention``.  Decode attends densely
over the latent cache with the up-projections absorbed into the query and
the output (fp32 scores and probabilities).

Tensor-parallel ``_full`` (``w_uq`` / ``w_uk`` / ``w_uv`` / ``wo`` split by
heads: ``sharding.arrays.ModelShards``, inside
``sharding.context.model_parallel``): the down projections ``w_dq``,
``w_dkv``, ``w_kr`` and the latent norms run once on the lead shard, whose
normed query latent, KV latent and rope key are copied to every shard;
each shard expands its heads, attends over them and applies its rows of
``wo``; the outputs are summed.  In a mesh serve step the latent cache is
split by sequence (``rules.cache_shardings``): the prefill cuts each
shard's slots from the lead's latents, and the decode computes the
absorbed queries by heads, all-gathers them, and combines the shards'
partial softmaxes over their slots (``attention.combine_partials``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core import policy as policy_lib
from repro_torch.models import attention, common
from repro_torch.sharding import arrays
from repro_torch.sharding import context as shctx


class MLACache(NamedTuple):
    c_kv: torch.Tensor     # (b, L, kv_rank) compressed latents
    k_rope: torch.Tensor   # (b, L, rope_dim) shared rotary key
    pos: torch.Tensor      # int32 next write position: scalar or (b,)


def init(ini: common.Initializer, cfg: ArchConfig) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    dh_q = m.nope_head_dim + m.rope_head_dim
    return {
        "w_dq": ini.normal((d, m.q_lora_rank), ("embed", "q_lora")),
        "q_norm": ini.zeros((m.q_lora_rank,), ("q_lora",)),
        "w_uq": ini.normal((m.q_lora_rank, h, dh_q), ("q_lora", "heads", "head_dim")),
        "w_dkv": ini.normal((d, m.kv_lora_rank), ("embed", "kv_lora")),
        "kv_norm": ini.zeros((m.kv_lora_rank,), ("kv_lora",)),
        "w_uk": ini.normal((m.kv_lora_rank, h, m.nope_head_dim),
                           ("kv_lora", "heads", "head_dim")),
        "w_uv": ini.normal((m.kv_lora_rank, h, m.v_head_dim),
                           ("kv_lora", "heads", "head_dim")),
        "w_kr": ini.normal((d, m.rope_head_dim), ("embed", "head_dim")),
        "wo": ini.normal((h, m.v_head_dim, d), ("heads", "head_dim", "embed")),
    }


def _queries(params, x, cfg: ArchConfig, positions):
    """x (b, s, d) -> q_nope (b, h, s, nope), q_rope (b, h, s, rope)."""
    return _query_heads(_query_latent(params, x), params["w_uq"], cfg, positions)


def _query_latent(params, x):
    """x (b, s, d) -> the normed query latent (b, s, q_rank)."""
    return common.rms_norm(torch.einsum("bsd,dr->bsr", x, params["w_dq"]), params["q_norm"])


def _query_heads(cq, w_uq, cfg: ArchConfig, positions):
    """The query latent up-projected by ``w_uq``'s heads: (q_nope, q_rope)."""
    m = cfg.mla
    q = torch.einsum("bsr,rhk->bhsk", cq, w_uq)
    q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    return q_nope, common.apply_rope(q_rope, positions, cfg.rope_theta)


def _latents(params, x, cfg: ArchConfig, positions):
    """x (b, s, d) -> c (b, s, kv_rank), kr (b, s, rope)."""
    c = common.rms_norm(torch.einsum("bsd,dr->bsr", x, params["w_dkv"]),
                        params["kv_norm"])
    kr = torch.einsum("bsd,dk->bsk", x, params["w_kr"])
    kr = common.apply_rope(kr[:, None], positions, cfg.rope_theta)[:, 0]
    return c, kr


def _expand(params, c, kr, cfg: ArchConfig):
    """Latents to per-head keys (b, h, s, nope + rope) — the shared rope key
    concatenated to every head — and values (b, h, s, v)."""
    k_nope = torch.einsum("bsr,rhk->bhsk", c, params["w_uk"])
    v = torch.einsum("bsr,rhk->bhsk", c, params["w_uv"])
    kr_h = kr[:, None].expand(kr.shape[0], k_nope.shape[1], *kr.shape[1:])
    return torch.cat([k_nope, kr_h], dim=-1), v


def _full(params, x, cfg: ArchConfig, positions, stem_cfg, return_stats: bool):
    """Full-sequence attention: (out (b, s, d), StemStats | None, the
    latents c and kr)."""
    if isinstance(params["w_uq"], arrays.ModelShards) and not return_stats:
        return _full_tp(params, x, cfg, positions, stem_cfg, shctx.model_parallel_state())
    q_nope, q_rope = _queries(params, x, cfg, positions)
    c, kr = _latents(params, x, cfg, positions)
    k, v = _expand(params, c, kr, cfg)
    # q/k's head dim is nope + rope, so the default scale is MLA's
    o, stats = attention.sparse_or_dense(
        torch.cat([q_nope, q_rope], dim=-1), k, v,
        policy_lib.as_policy_opt(stem_cfg), x.shape[1], True, return_stats)
    return torch.einsum("bhsk,hkd->bsd", o, params["wo"]), stats, c, kr


def _full_tp(params, x, cfg: ArchConfig, positions, stem_cfg, mp):
    """``_full`` over the model shards of ``mp`` (the module docstring)."""
    c, kr = _latents(params, x, cfg, positions)
    cqs, cs, krs = (arrays.to_model_shards(t, mp) for t in (_query_latent(params, x), c, kr))
    pol = policy_lib.as_policy_opt(stem_cfg)
    outs = []
    for t in range(mp.tp):
        with mp.on(t):
            q_nope, q_rope = _query_heads(cqs[t], params["w_uq"].parts[t], cfg, positions)
            k, v = _expand({"w_uk": params["w_uk"].parts[t], "w_uv": params["w_uv"].parts[t]},
                           cs[t], krs[t], cfg)
            o, _ = attention.sparse_or_dense(torch.cat([q_nope, q_rope], dim=-1), k, v, pol,
                                             x.shape[1], True, False)
            outs.append(torch.einsum("bhsk,hkd->bsd", o, params["wo"].parts[t]))
    return arrays.reduce_from_model_shards(outs, mp, x.dtype), None, c, kr


def apply_full(params, x, cfg: ArchConfig, *, positions, stem_cfg=None,
               return_stats: bool = False):
    """Training / prefill attention over the full sequence.  ``stem_cfg``:
    any policy spelling or None (dense).  ``return_stats`` also returns the
    sparse path's ``StemStats`` (None when the dense arm ran)."""
    out, stats, _, _ = _full(params, x, cfg, positions, stem_cfg, return_stats)
    return (out, stats) if return_stats else out


def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> MLACache:
    m = cfg.mla
    return MLACache(
        c_kv=torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype, device=device),
        k_rope=torch.zeros((batch, max_len, m.rope_head_dim), dtype=dtype,
                           device=device),
        pos=torch.zeros((), dtype=torch.int32, device=device))


def prefill_into_cache(params, x, cfg: ArchConfig, *, positions, max_len: int,
                       stem_cfg=None):
    """Prefill attention and the latent cache for decode: (out, MLACache
    with c_kv / k_rope padded to max_len and stored in bf16).  With its
    heads in ``ModelShards`` the latents are ``ModelShards`` of each model
    shard's slots (whole on every shard where the model axis does not
    divide ``max_len``)."""
    out, _, c, kr = _full(params, x, cfg, positions, stem_cfg, False)
    pad = max_len - x.shape[1]
    c_kv = F.pad(c, (0, 0, 0, pad)).to(torch.bfloat16)
    k_rope = F.pad(kr, (0, 0, 0, pad)).to(torch.bfloat16)
    mp = shctx.model_parallel_state()
    if mp is not None:
        c_kv, k_rope = arrays.cache_blocks(c_kv, mp, (1,)), arrays.cache_blocks(k_rope, mp, (1,))
    cache = MLACache(c_kv=c_kv, k_rope=k_rope,
                     pos=torch.tensor(x.shape[1], dtype=torch.int32, device=x.device))
    return out, cache


def apply_decode(params, x, cfg: ArchConfig, cache: MLACache):
    """One decode step over the latent cache.  x: (b, 1, d).  Returns (out,
    MLACache): the token's latents are written into ``cache.c_kv`` /
    ``cache.k_rope`` in place (in the cache's dtype), and ``pos`` advances
    by one.  ``cache.pos`` is a scalar or a ``(b,)`` vector (ragged batch:
    each row writes and masks at its own length).

    Absorbed attention: score = (q_nope W_UK) . c + q_rope . k_rope, the
    latent output p . c then W_UV and wo; scores, probabilities and the
    latent output in fp32.  With the cache in ``ModelShards``:
    ``_apply_decode_tp``."""
    m = cfg.mla
    pos = cache.pos
    b = x.shape[0]
    rope_pos = pos[None] if pos.ndim == 0 else pos[:, None]
    if isinstance(cache.c_kv, arrays.ModelShards):
        return _apply_decode_tp(params, x, cfg, cache, shctx.model_parallel_state(), rope_pos)
    q_nope, q_rope = _queries(params, x, cfg, rope_pos)
    c_new, kr_new = _latents(params, x, cfg, rope_pos)
    ck, ckr = cache.c_kv, cache.k_rope
    if pos.ndim == 0:
        idx = pos.reshape(1).long()
        ck.index_copy_(1, idx, c_new.to(ck.dtype))
        ckr.index_copy_(1, idx, kr_new.to(ckr.dtype))
    else:
        bidx = torch.arange(b, device=x.device)
        ck[bidx, pos.long()] = c_new[:, 0].to(ck.dtype)
        ckr[bidx, pos.long()] = kr_new[:, 0].to(ckr.dtype)
    L = ck.shape[1]
    valid = torch.arange(L, device=x.device)[None, :] <= pos.expand(b)[:, None]
    ckf = ck.float()
    q_abs = torch.einsum("bhsk,rhk->bhsr", q_nope, params["w_uk"])
    s = torch.einsum("bhsr,blr->bhsl", q_abs.float(), ckf)
    s = s + torch.einsum("bhsk,blk->bhsl", q_rope.float(), ckr.float())
    s = s * (m.nope_head_dim + m.rope_head_dim) ** -0.5
    s = torch.where(valid[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhsl,blr->bhsr", p, ckf)
    o = torch.einsum("bhsr,rhk->bhsk", o_lat.to(x.dtype), params["w_uv"])
    out = torch.einsum("bhsk,hkd->bsd", o, params["wo"])
    return out, MLACache(c_kv=ck, k_rope=ckr, pos=pos + 1)


def _apply_decode_tp(params, x, cfg: ArchConfig, cache: MLACache, mp, rope_pos):
    """``apply_decode`` over the model shards of ``mp``, the latents split
    by sequence (or whole on every shard): the query latent and the new
    latents once on the lead shard; each shard's absorbed queries (its
    heads of ``w_uq`` / ``w_uk``; the lead's, all heads, where the rules
    leave them whole), all-gathered; each row's latents
    written on the shard holding its position; each shard's fp32 partial
    softmax over its valid slots, combined on the lead shard in rank
    order; ``w_uv`` and ``wo`` by heads, the partial products summed."""
    m = cfg.mla
    ck, ckr, pos = cache.c_kv, cache.k_rope, cache.pos
    b, h = x.shape[0], params["w_uq"].shape[1]
    c_new, kr_new = _latents(params, x, cfg, rope_pos)
    heads_split = isinstance(params["w_uq"], arrays.ModelShards)
    if heads_split:
        cqs = arrays.to_model_shards(_query_latent(params, x), mp)
        qa, qr = [], []
        for t in range(mp.tp):
            with mp.on(t):
                q_nope, q_rope = _query_heads(cqs[t], params["w_uq"].parts[t], cfg,
                                              rope_pos.to(cqs[t].device))
                qa.append(torch.einsum("bhsk,rhk->bhsr", q_nope, params["w_uk"].parts[t]))
                qr.append(q_rope)
        bounds = params["w_uq"].bounds
        every = [[(0, h)]] * mp.tp
        q_abs = arrays.take(arrays.ModelShards(qa, 1, bounds, (b, h, 1, qa[0].shape[-1])),
                            mp, every)
        q_rope = arrays.take(arrays.ModelShards(qr, 1, bounds, (b, h, 1, qr[0].shape[-1])),
                             mp, every)
    else:                   # the rules leave the heads whole: on the lead shard
        q_nope, q_rope = _queries(params, x, cfg, rope_pos)
        q_abs = arrays.to_model_shards(torch.einsum("bhsk,rhk->bhsr", q_nope,
                                                    params["w_uk"]), mp)
        q_rope = arrays.to_model_shards(q_rope, mp)
    cs, krs, poss = (arrays.to_model_shards(t, mp) for t in (c_new, kr_new, pos))
    slots = ck.seq_bounds(1)
    parts = []
    for t in range(mp.tp):
        with mp.on(t):
            lo, hi = slots[t]
            own = (poss[t] >= lo) & (poss[t] < hi)
            attention.write_owned(ck.parts[t], lo, poss[t], own, cs[t], dim=1)
            attention.write_owned(ckr.parts[t], lo, poss[t], own, krs[t], dim=1)
            if t and ck.dim is None:
                continue                    # whole on every shard: the lead attends
            cf = ck.parts[t].float()
            s = torch.einsum("bhsr,blr->bhsl", q_abs[t].float(), cf)
            s = s + torch.einsum("bhsk,blk->bhsl", q_rope[t].float(), ckr.parts[t].float())
            s = s * (m.nope_head_dim + m.rope_head_dim) ** -0.5
            g = torch.arange(lo, hi, device=cf.device)[None, :]
            valid = g <= poss[t].expand(b)[:, None]
            parts.append((t, attention._partial_softmax(
                s, valid[:, None, None, :], lambda p: torch.einsum("bhsl,blr->bhsr", p, cf))))
    o_lat = attention.combine_partials(parts, mp)
    new_cache = MLACache(c_kv=ck, k_rope=ckr, pos=pos + 1)
    if not heads_split:
        o = torch.einsum("bhsr,rhk->bhsk", o_lat.to(x.dtype), params["w_uv"])
        return torch.einsum("bhsk,hkd->bsd", o, params["wo"]), new_cache
    os_ = arrays.to_model_shards(o_lat.to(x.dtype), mp, 1, params["w_uv"].bounds)
    outs = []
    for t in range(mp.tp):
        with mp.on(t):
            o = torch.einsum("bhsr,rhk->bhsk", os_[t], params["w_uv"].parts[t])
            outs.append(torch.einsum("bhsk,hkd->bsd", o, params["wo"].parts[t]))
    return arrays.reduce_from_model_shards(outs, mp, x.dtype), new_cache
