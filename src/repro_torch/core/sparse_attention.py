"""Sparse attention execution: policy orchestration (port of
``repro/core/sparse_attention.py``).

Pipeline per (batch, head), for any ``SparsityPolicy`` (core/policy.py):
  1. the policy's metric scores key blocks (metric.py),
  2. its schedule fixes per-row block budgets (schedule.py),
  3. its selector turns scores + budgets into a BlockSelection
     (selection.py),
  4. an executor runs exact attention over the selected blocks only.

Executors (``policy.register_executor``):
  * "fused"  — the block-sparse CUDA kernel (kernels/block_sparse_attn.py),
               the counterpart of the reference's "pallas", with its
               hand-written backward;
  * "gather" — the plain PyTorch flash-style gather executor (padded or
               budget-sorted ragged schedule, GQA dedup), the counterpart of
               "xla";
  * "dense"  — the O(N^2) masked oracle.

The dense arm (``dense_attention_auto``) sends causal self-attention without
a mask to the flash kernel on a CUDA tensor (forward and its hand-written
backward); ``dense_attention`` and ``dense_attention_chunked`` are its plain
versions on the CPU, and the path of non-causal and masked attention on
every device.  "gather" and "dense" differentiate by autograd: they are the
CPU oracle and the card's fp32 cross-check of the training path.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import policy as policy_lib
from repro_torch.core import selection as selection_lib
from repro_torch.kernels import block_sparse_attn as bsa_kernels
from repro_torch.kernels import flash_attention as flash_kernels

NEG_INF = -1e30


class StemStats(NamedTuple):
    density: torch.Tensor          # realized fraction of admissible blocks
    avg_budget_blocks: torch.Tensor
    k_max: int


def dense_attention(q, k, v, *, causal: bool = True, scale=None, mask=None):
    """Reference dense attention with GQA: q (b, hq, sq, d); k (b, hk, sk, d);
    v (b, hk, sk, dv); ``mask`` an optional (b, hq, sq, sk) keep-mask.
    O(N^2) — baseline and oracle."""
    b, hq, sq, d = q.shape
    hk, sk, dv = k.shape[1], k.shape[2], v.shape[-1]
    group = hq // hk
    scale = d ** -0.5 if scale is None else scale
    qg = q.reshape(b, hk, group, sq, d).float()
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None]
        kj = torch.arange(sk, device=q.device)[None, :]
        scores = torch.where(kj <= qi + (sk - sq), scores, NEG_INF)
    if mask is not None:
        scores = torch.where(mask.reshape(b, hk, group, sq, sk), scores, NEG_INF)
    # Fully-masked rows (pathological configs only) softmax over zeros.
    row_max = scores.amax(dim=-1, keepdim=True)
    probs = torch.softmax(torch.where(row_max > NEG_INF / 2, scores, 0.0), dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.float())
    return out.reshape(b, hq, sq, dv).to(q.dtype)


def dense_attention_chunked(q, k, v, *, causal: bool = True, scale=None,
                            q_chunk: int = 1024, kv_chunk: int = 1024):
    """Flash-style dense attention in plain PyTorch: streams KV chunks with
    an online-softmax accumulator (O(N * chunk) memory).  Causality is
    applied by masking, not by skipping chunks."""
    b, hq, sq, d = q.shape
    hk, sk, dv = k.shape[1], k.shape[2], v.shape[-1]
    group = hq // hk
    scale = d ** -0.5 if scale is None else scale
    qc, kc = min(q_chunk, sq), min(kv_chunk, sk)
    if sq % qc or sk % kc:
        return dense_attention(q, k, v, causal=causal, scale=scale)
    nq, nk = sq // qc, sk // kc
    dev = q.device
    qb = q.reshape(b, hk, group, nq, qc, d).float() * scale
    kb = k.reshape(b, hk, nk, kc, d)
    vb = v.reshape(b, hk, nk, kc, dv)
    q_pos = torch.arange(sq, device=dev).reshape(nq, qc)
    acc = torch.zeros((b, hk, group, nq, qc, dv), dtype=torch.float32, device=dev)
    m = torch.full((b, hk, group, nq, qc), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hk, group, nq, qc), dtype=torch.float32, device=dev)
    for j in range(nk):
        s = torch.einsum("bhgnqd,bhkd->bhgnqk", qb, kb[:, :, j].float())
        if causal:
            k_pos = j * kc + torch.arange(kc, device=dev)
            keep = k_pos[None, None] <= (sk - sq) + q_pos[:, :, None]
            s = torch.where(keep, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        if causal:
            p = torch.where(keep, p, 0.0)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgnqk,bhkd->bhgnqd", p, vb[:, :, j].float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.reshape(b, hq, sq, dv).to(q.dtype)


def dense_attention_auto(q, k, v, *, causal: bool = True, scale=None,
                         mask=None, threshold: int = 2048):
    """Dense attention dispatch, by the form of the call.  On a CUDA
    tensor, causal self-attention without a mask (sq == sk; v's head dim
    may differ from q/k's, as MLA's does) runs the flash kernel (on
    ``meta`` tensors, the dry run's, its shape-only path).  Every
    other form (non-causal: an encoder, cross-attention; or masked) runs
    the plain path on any device, as the reference computes these forms
    outside its kernels: the chunked online softmax for long sequences
    without a mask, the direct masked softmax otherwise."""
    if q.device.type in ("cuda", "meta") and mask is None and causal \
            and q.shape[2] == k.shape[2]:
        return flash_kernels.attention(
            q.contiguous(), k.contiguous(), v.contiguous(), scale=scale)
    if mask is None and q.shape[2] >= threshold and k.shape[2] >= threshold:
        return dense_attention_chunked(q, k, v, causal=causal, scale=scale)
    return dense_attention(q, k, v, causal=causal, scale=scale, mask=mask)


def _gather_executor(q, k, v, indices, slot_mask, *, block_size: int,
                     scale: float, slot_chunk: int,
                     budgets: Optional[np.ndarray] = None,
                     group_dedup: bool = False):
    """Flash-style sparse executor: per query-block row, stream the selected
    key/value blocks in chunks of ``slot_chunk`` slots with an online-softmax
    accumulator.

    Rows fold (head-in-group, query block) pairs per KV head: with
    ``group_dedup`` the selection is per KV head (b, hk, nq, k_max) and a row
    is a fused (group * block, d) query tile; without it the selection is
    per query head and a row is one (block, d) tile.  ``budgets`` (static
    numpy per query-block row) runs the ragged schedule — budget-sorted
    segments, each streaming only the slot chunks its rows use; None runs
    the padded schedule.  q: (b, hq, sq, d); k: (b, hk, sk, d); v: (b, hk,
    sk, dv)."""
    b, hq, sq, d = q.shape
    hk, sk, dv = k.shape[1], k.shape[2], v.shape[-1]
    group = hq // hk
    bs = block_size
    nq, nk = sq // bs, sk // bs
    k_max = indices.shape[-1]
    chunk = max(1, min(slot_chunk, k_max))
    pad = (-k_max) % chunk
    if pad:
        indices = F.pad(indices, (0, pad))
        slot_mask = F.pad(slot_mask, (0, pad))
    n_chunks = (k_max + pad) // chunk
    dev = q.device
    kb = k.reshape(b, hk, nk, bs, d)
    vb = v.reshape(b, hk, nk, bs, dv)
    q_pos = (sk - sq) + np.arange(sq).reshape(nq, bs)      # global query positions

    qg = q.reshape(b, hk, group, nq, bs, d)
    if group_dedup:
        qrows = qg.permute(0, 1, 3, 2, 4, 5).reshape(b, hk, nq, group * bs, d)
        idx, msk = indices, slot_mask
        q_pos_rows = np.tile(q_pos, (1, group))            # (nq, group*bs)
        row_budgets = budgets
    else:
        qrows = qg.reshape(b, hk, group * nq, bs, d)
        idx = indices.reshape(b, hk, group * nq, -1)
        msk = slot_mask.reshape(b, hk, group * nq, -1)
        q_pos_rows = np.tile(q_pos, (group, 1))            # (group*nq, bs)
        row_budgets = None if budgets is None else np.tile(budgets, group)
    qrows = qrows.float() * scale
    q_pos_rows = torch.as_tensor(q_pos_rows, device=dev)
    bi = torch.arange(b, device=dev)[:, None, None, None]
    hi = torch.arange(hk, device=dev)[None, :, None, None]

    def run_rows(q_r, pos_r, idx_r, msk_r, seg_chunks):
        """Online softmax over ``seg_chunks`` slot chunks for one row set:
        q_r (b, hk, R, Bq, d); idx_r/msk_r (b, hk, R, seg_chunks*chunk)."""
        R, Bq = q_r.shape[2], q_r.shape[3]
        idx_s = idx_r.reshape(b, hk, R, seg_chunks, chunk)
        msk_s = msk_r.reshape(b, hk, R, seg_chunks, chunk)
        acc = torch.zeros((b, hk, R, Bq, dv), dtype=torch.float32, device=dev)
        m = torch.full((b, hk, R, Bq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, hk, R, Bq), dtype=torch.float32, device=dev)
        for c in range(seg_chunks):
            idx_c = idx_s[:, :, :, c].long()                    # (b, hk, R, chunk)
            k_c = kb[bi, hi, idx_c].float()                     # (b,hk,R,chunk,bs,d)
            v_c = vb[bi, hi, idx_c].float()
            s = torch.einsum("bhrqd,bhrckd->bhrqck", q_r, k_c)
            k_pos = idx_c[..., None] * bs + torch.arange(bs, device=dev)
            keep = k_pos[:, :, :, None] <= pos_r[None, None, :, :, None, None]
            keep = keep & msk_s[:, :, :, c][:, :, :, None, :, None]
            s = torch.where(keep, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=(-1, -2)))
            corr = torch.exp(m - m_new)
            p = torch.where(keep, torch.exp(s - m_new[..., None, None]), 0.0)
            l = l * corr + p.sum(dim=(-1, -2))
            acc = acc * corr[..., None] + torch.einsum("bhrqck,bhrckd->bhrqd", p, v_c)
            m = m_new
        return acc / torch.clamp(l, min=1e-20)[..., None]

    if row_budgets is None:
        out_rows = run_rows(qrows, q_pos_rows, idx, msk, n_chunks)
    else:
        segments = selection_lib.budget_sorted_segments(row_budgets, chunk)
        outs = []
        for seg in segments:
            rows = torch.as_tensor(seg.rows, device=dev)
            seg_chunks = min(seg.n_chunks, n_chunks)
            n_slots = seg_chunks * chunk
            outs.append(run_rows(qrows[:, :, rows], q_pos_rows[rows],
                                 idx[:, :, rows, :n_slots],
                                 msk[:, :, rows, :n_slots], seg_chunks))
        inv = np.argsort(np.concatenate([np.asarray(s.rows) for s in segments]))
        out_rows = torch.cat(outs, dim=2)[:, :, torch.as_tensor(inv, device=dev)]

    if group_dedup:
        out = out_rows.reshape(b, hk, nq, group, bs, dv).permute(0, 1, 3, 2, 4, 5)
    else:
        out = out_rows.reshape(b, hk, group, nq, bs, dv)
    return out.reshape(b, hq, sq, dv).to(q.dtype)


def select_for(q, k, v, cfg, *, with_block_mask: bool = True):
    """Phase 1: metric + schedule + selection.  ``cfg``: StemConfig,
    SparsityPolicy or registered policy name.  Returns (sel, k_max)."""
    return policy_lib.as_policy(cfg).prefill_select(
        q, k, v, with_block_mask=with_block_mask)


# ---------------------------------------------------------------------------
# Executors (registered under policy.register_executor; resolved by name)
# ---------------------------------------------------------------------------

def _dense_oracle_executor(q, k, v, sel, *, policy, scale, **_):
    """O(N^2) masked softmax over the selection's dense block mask."""
    token_mask = selection_lib.block_mask_to_token_mask(
        sel.block_mask, policy.block_size, policy.block_size,
        q.shape[2], k.shape[2])
    return dense_attention(q, k, v, causal=True, scale=scale, mask=token_mask)


def _gather_exec(q, k, v, sel, *, policy, scale, indices, slot_mask, dedup,
                 budgets, **_):
    return _gather_executor(
        q, k, v, indices, slot_mask, block_size=policy.block_size,
        scale=scale, slot_chunk=policy.slot_chunk, budgets=budgets,
        group_dedup=dedup)


def _fused_executor(q, k, v, sel, *, policy, scale, indices, slot_mask,
                    live_counts, dedup, **_):
    # on meta tensors (the dry run) the kernel counts the pairs the budgets
    # fix, where they fix them
    known = (policy.prefill_live_counts(q.shape[2], k.shape[2])
             if q.device.type == "meta" else None)
    return bsa_kernels.attention(
        q.contiguous(), k.contiguous(), v.contiguous(), indices.contiguous(),
        live_counts.contiguous(), block_size=policy.block_size, scale=scale,
        group_dedup=dedup, known_counts=known)


policy_lib.register_executor("dense", _dense_oracle_executor,
                             needs_block_mask=True)
policy_lib.register_executor("gather", _gather_exec)
policy_lib.register_executor("fused", _fused_executor)


def sparse_attention(q, k, v, policy, executor: Optional[str] = None,
                     return_stats: bool = False, scores=None):
    """Block-sparse causal attention under a ``SparsityPolicy``.

    q: (b, hq, seq, d); k: (b, hk, seq, d); v: (b, hk, seq, dv) (MLA's
    dv differs from d); policy: SparsityPolicy | registered name |
    StemConfig; executor: "fused" | "gather" | "dense" (None uses
    ``policy.executor``); ``scores`` optionally the (group-reduced) metric
    to select by (``policy.prefill_select``).  Returns (b, hq, seq, dv)
    [, StemStats]."""
    policy = policy_lib.as_policy(policy)
    spec = policy_lib.get_executor(executor or policy.executor)
    hq, d, sq = q.shape[1], q.shape[3], q.shape[2]
    sk = k.shape[2]
    scale = d ** -0.5
    sel, k_max = policy.prefill_select(
        q, k, v, with_block_mask=spec.needs_block_mask, scores=scores)

    # GQA block dedup: with group-shared selection every query head of a KV
    # group picks identical blocks, so the executors take one head per group.
    group = hq // k.shape[1]
    dedup = policy.ragged and policy.group_reduce != "none" and group > 1
    idx, msk, cnt = sel.indices, sel.slot_mask, sel.live_counts
    if dedup:
        idx, msk, cnt = idx[:, ::group], msk[:, ::group], cnt[:, ::group]

    # Static budgets drive the ragged schedule; threshold selectors have
    # data-dependent budgets and run the padded one.
    budgets_np = None
    if policy.ragged and policy.selector.budget_driven:
        budgets_np = policy.prefill_budgets(sq, sk)

    out = spec.fn(q, k, v, sel, policy=policy, scale=scale, indices=idx,
                  slot_mask=msk, live_counts=cnt, dedup=dedup,
                  budgets=budgets_np)
    if return_stats:
        nk = sk // policy.block_size
        return out, StemStats(
            density=selection_lib.selection_density(sel, nk),
            avg_budget_blocks=sel.budgets.float().mean(), k_max=k_max)
    return out


def stem_attention(q, k, v, cfg, return_stats: bool = False):
    """Stem sparse causal attention (Algorithm 1) — the ``StemConfig`` shim
    over :func:`sparse_attention` (executor from ``cfg.backend``)."""
    return sparse_attention(q, k, v, cfg, return_stats=return_stats)
