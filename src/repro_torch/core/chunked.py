"""Chunked sparse prefill over the paged Stem KV cache (port of
``repro/core/chunked.py``).

A prompt is processed in fixed-size chunks that ride in the same step as
decode tokens.  Each chunk's queries are scored against every visible
page's stored summaries (the chunk's own pages are written first), per-row
TPD budgets are evaluated at absolute query-block rows of the full prompt,
top-k keeps forced sink/local floors at the absolute diagonal, and only the
selected pages are attended, token-causal at absolute positions.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import policy as policy_lib
from repro_torch.core.selection import FORCE_BONUS, NEG_INF, stable_topk


class ChunkSelection(NamedTuple):
    """indices: (b, hq, nc, k_max) int32 logical block ids (dead slots point
    at block 0); live: (b, hq, nc, k_max) bool."""

    indices: torch.Tensor
    live: torch.Tensor


def validate_chunked_policy(policy) -> None:
    """Fail fast for policies chunked prefill cannot serve."""
    policy = policy_lib.as_policy(policy)
    if not getattr(policy.selector, "budget_driven", False):
        raise NotImplementedError(
            f"chunked prefill needs a budget-driven selector; "
            f"{type(policy.selector).__name__} is threshold-based — run the "
            "engine with monolithic_prefill=True for this policy")
    if getattr(policy.metric, "chunk_scores", None) is None:
        raise NotImplementedError(
            f"metric {type(policy.metric).__name__} lacks chunk_scores — "
            "required for chunked prefill")


def chunk_budget_rows(policy, padded_len: int, chunk_start: int,
                      n_rows: int) -> np.ndarray:
    """The one-shot ``prefill_budgets(padded_len)`` vector sliced at the
    chunk's absolute query-block rows, zero past the prompt.  int32 (n_rows,)."""
    policy = policy_lib.as_policy(policy)
    full = policy.prefill_budgets(padded_len)
    j0 = chunk_start // policy.block_size
    out = np.zeros((n_rows,), np.int32)
    rows = full[j0:j0 + n_rows]
    out[:len(rows)] = rows
    return out


def chunk_budget_bound(policy, max_pages: int) -> int:
    """Static upper bound on any chunk row's block budget (the top-k width):
    the max over every admissible padded prompt length."""
    policy = policy_lib.as_policy(policy)
    if max_pages > 4096:
        return max_pages
    bound = 1
    for n in range(1, max_pages + 1):
        bound = max(bound, int(policy.prefill_budgets(
            n * policy.block_size).max()))
    return max(1, min(bound, max_pages))


def select_chunk_blocks(m: torch.Tensor, block_rows: torch.Tensor,
                        budgets: torch.Tensor, policy,
                        k_max: int = 0) -> ChunkSelection:
    """Top-k + forced sink/local floors + causal validity, at absolute rows.

    m: (b, hq, nc, P); block_rows: (b, nc); budgets: (b, nc) int32;
    k_max: static selection width (0 = all P candidates)."""
    policy = policy_lib.as_policy(policy)
    b, hq, nc, maxp = m.shape
    dev = m.device
    k_max = maxp if k_max <= 0 else min(k_max, maxp)
    blk = torch.arange(maxp, device=dev)
    causal = blk[None, None, :] <= block_rows[:, :, None]            # (b, nc, P)
    is_sink = (blk < policy.sink_blocks)[None, None, :]
    is_local = blk[None, None, :] > block_rows[:, :, None] - policy.local_blocks
    forced = (is_sink | is_local) & causal

    biased = torch.where(forced[:, None], m + FORCE_BONUS, m)
    biased = torch.where(causal[:, None], biased, NEG_INF)
    vals, idx = stable_topk(biased, k_max)                # (b, hq, nc, k_max)
    live = (vals > NEG_INF / 2) & (
        torch.arange(k_max, device=dev)[None, None, None, :]
        < budgets[:, None, :, None])
    return ChunkSelection(
        indices=torch.where(live, idx, 0).to(torch.int32), live=live)


def attend_chunk(
    q: torch.Tensor,            # (b, hq, C, d) chunk queries
    gk: torch.Tensor,           # (b, hk, g, nc, k_max, bs, d) gathered pages
    gv: torch.Tensor,           # (b, hk, g, nc, k_max, bs, dv)
    sel: ChunkSelection,
    chunk_start: torch.Tensor,  # (b,) absolute first query position
    block_size: int,
) -> torch.Tensor:
    """Masked softmax over the selected pages only, token-causal at absolute
    positions.  Returns (b, hq, C, dv)."""
    b, hq, c, d = q.shape
    hk = gk.shape[1]
    group = hq // hk
    bs = block_size
    nc = c // bs
    k_max = gk.shape[4]
    dv = gv.shape[-1]
    dev = q.device
    qg = q.reshape(b, hk, group, nc, bs, d).float()
    s = torch.einsum("bhgnqd,bhgnkcd->bhgnqkc", qg, gk.float())
    s = s * (d ** -0.5)                         # (b, hk, g, nc, bs_q, kmax, bs_k)
    live = sel.live.reshape(b, hk, group, nc, k_max)
    tok_pos = (sel.indices.reshape(b, hk, group, nc, k_max)[..., None] * bs
               + torch.arange(bs, device=dev))  # (b, hk, g, nc, kmax, bs_k)
    q_pos = (chunk_start[:, None, None] + (torch.arange(nc, device=dev) * bs)[None, :, None]
             + torch.arange(bs, device=dev)[None, None, :])  # (b, nc, bs_q)
    keep = tok_pos[:, :, :, :, None] <= q_pos[:, None, None, :, :, None, None]
    keep = keep & live[:, :, :, :, None, :, None]
    s = torch.where(keep, s, NEG_INF)
    p = torch.softmax(s.reshape(b, hk, group, nc, bs, -1), dim=-1)
    p = torch.where(keep, p.reshape(s.shape), 0.0)
    o = torch.einsum("bhgnqkc,bhgnkcd->bhgnqd", p, gv.float())
    return o.reshape(b, hq, c, dv).to(q.dtype)


def chunked_prefill_attention(q, pool, page_table, chunk_start, budgets,
                              policy, k_max: int = 0):
    """Policy-sparse prefill attention for one chunk, straight off the page
    pool (chunk pages already written), through the paged backend
    ``policy.executor`` ("fused" | "gather").  Returns (b, hq, C, dv)."""
    policy = policy_lib.as_policy(policy)
    spec = policy_lib.get_paged_executor(policy.executor)
    return spec.chunk_fn(q, pool, page_table, chunk_start, budgets, policy,
                         k_max)


def _chunked_prefill_gather(q, pool, page_table, chunk_start, budgets,
                            policy, k_max: int = 0):
    """The gather backend (the fused kernels' differential oracle): summary
    gather -> chunk metric -> selection -> page gather -> masked attend."""
    policy = policy_lib.as_policy(policy)
    b, hq, c, d = q.shape
    hk = pool.k.shape[0]
    group = hq // hk
    bs = policy.block_size
    nc = c // bs
    maxp = page_table.shape[1]
    pt = page_table.long()

    kg_rows = pool.kg[:, pt].transpose(0, 1)               # (b, hk, P, s, d)
    vm_rows = pool.vm[:, pt].transpose(0, 1)               # (b, hk, P)

    m = policy.chunk_scores(q, kg_rows, vm_rows)           # (b, hq, nc, P)
    rows = (torch.div(chunk_start, bs, rounding_mode="floor")[:, None]
            + torch.arange(nc, device=q.device)[None, :])
    sel = select_chunk_blocks(m, rows, budgets, policy, k_max)
    kk = sel.indices.shape[-1]

    idx = sel.indices.reshape(b, hk, group, nc, kk).long()
    gp = torch.take_along_dim(
        pt[:, None, None, None, :].expand(b, hk, group, nc, maxp), idx, dim=-1)
    heads = torch.arange(hk, device=q.device)[None, :, None, None, None]
    gk = pool.k[heads, gp]                         # (b, hk, g, nc, kmax, bs, d)
    gv = pool.v[heads, gp]
    return attend_chunk(q, gk, gv, sel, chunk_start, bs)
