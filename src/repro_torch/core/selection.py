"""Block selection: Top-k(i) over the coarse metric with stability floors
(port of ``repro/core/selection.py``).

The one-shot prefill half gives, per query block row, padded index lists
``(b, h, nq, k_max)`` with a live-slot mask (live slots form a prefix of
each row, so ``live_counts`` describes validity), optionally the dense
``(b, h, nq, nk)`` block mask (oracle and tests only), and the
budget-sorted segment schedule of the ragged gather executor.  The decode
and chunk lanes share ``stable_topk`` and ``revisit_indices``.

``stable_topk`` carries the reference's tie rule: ``jax.lax.top_k`` puts the
lower index first among equal values, while ``torch.topk`` promises no
order.  Ties are exact in normal use — every forced sink/local block scores
``metric + FORCE_BONUS`` (= 1e30 in float32) and the streaming metric scores
every block 0 — and the live prefix of the top-k output then decides which
tied blocks survive, so the port sorts stably on descending value instead.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

NEG_INF = -1e30
FORCE_BONUS = 1e30


class BlockSelection(NamedTuple):
    """Selected key blocks per query block row.

    indices: (b, h, nq, k_max) int32 key-block ids (dead slots point at
      block 0); slot_mask: (b, h, nq, k_max) bool, live slots a prefix;
    block_mask: (b, h, nq, nk) bool dense equivalent or None; budgets: (nq,)
      int32 per-row budgets applied; live_counts: (b, h, nq) int32."""

    indices: torch.Tensor
    slot_mask: torch.Tensor
    block_mask: Optional[torch.Tensor]
    budgets: torch.Tensor
    live_counts: Optional[torch.Tensor] = None


class RaggedSegment(NamedTuple):
    """One segment of the budget-sorted ragged schedule: query-block rows
    (budget-descending) that all need ``n_chunks`` slot chunks."""

    rows: tuple
    n_chunks: int


class DecodeSelection(NamedTuple):
    """Per-row cache-block selection for one decode step.

    indices: (b, hk, g, k_max) int32 logical block ids (dead slots masked by
      ``live``); live: (b, hk, g, k_max) bool; budgets: (b,) int32 per-row
      budget applied; n_valid: (b,) int32 ceil(cache_len / block_size).
    """

    indices: torch.Tensor
    live: torch.Tensor
    budgets: torch.Tensor
    n_valid: torch.Tensor


def stable_topk(x: torch.Tensor, k: int):
    """Top-``k`` along the last axis with ``jax.lax.top_k``'s ordering:
    descending values, lower index first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def revisit_indices(indices: torch.Tensor, slot_mask: torch.Tensor) -> torch.Tensor:
    """Re-point dead slots at the row's last live block.  Live slots form a
    prefix, so every dead slot repeats slot ``live_count - 1``; rows with no
    live slot keep slot 0.  (..., k_max) -> (..., k_max) int32."""
    k_max = indices.shape[-1]
    cnt = slot_mask.sum(dim=-1, dtype=torch.int32)
    slot = torch.minimum(
        torch.arange(k_max, dtype=torch.int32, device=indices.device),
        torch.clamp(cnt[..., None] - 1, min=0))
    return torch.take_along_dim(indices, slot.long(), dim=-1).to(torch.int32)


def causal_block_mask(nq: int, nk: int, device=None) -> torch.Tensor:
    """Query block i may see key block j iff j <= i + (nk - nq)."""
    i = torch.arange(nq, device=device)[:, None]
    j = torch.arange(nk, device=device)[None, :]
    return j <= i + (nk - nq)


def forced_block_mask(nq: int, nk: int, sink: int, local: int,
                      device=None) -> torch.Tensor:
    """The first ``sink`` key blocks and the ``local`` blocks ending at the
    diagonal, within causal admissibility."""
    diag = torch.arange(nq, device=device)[:, None] + (nk - nq)
    j = torch.arange(nk, device=device)[None, :]
    forced = (j < sink) | ((j > diag - local) & (j <= diag))
    return forced & causal_block_mask(nq, nk, device)


def select_blocks(metric: torch.Tensor, budgets: torch.Tensor, k_max: int, *,
                  sink_blocks: int, local_blocks: int,
                  with_block_mask: bool = True) -> BlockSelection:
    """Top-k(i) selection (Algorithm 1, lines 14-17) with forced floors.

    metric: (b, h, nq, nk); budgets: (nq,) int32 (causally clamped);
    k_max: static max(budgets), the padded slot count."""
    b, h, nq, nk = metric.shape
    dev = metric.device
    budgets = torch.as_tensor(budgets, dtype=torch.int32, device=dev)
    causal = causal_block_mask(nq, nk, dev)
    forced = forced_block_mask(nq, nk, sink_blocks, local_blocks, dev)
    biased = torch.where(forced, metric + FORCE_BONUS, metric)
    biased = torch.where(causal, biased, NEG_INF)
    k_max = int(min(k_max, nk))
    values, indices = stable_topk(biased, k_max)
    within = torch.arange(k_max, device=dev)[None, :] < budgets[:, None]
    slot_mask = (values > NEG_INF / 2) & within
    indices = torch.where(slot_mask, indices, 0).to(torch.int32)
    block_mask = None
    if with_block_mask:
        hits = torch.zeros((b, h, nq, nk), dtype=torch.int32, device=dev)
        hits.scatter_add_(-1, indices.long(), slot_mask.to(torch.int32))
        block_mask = hits > 0
    return BlockSelection(indices=indices, slot_mask=slot_mask,
                          block_mask=block_mask, budgets=budgets,
                          live_counts=slot_mask.sum(dim=-1, dtype=torch.int32))


def budget_sorted_segments(budgets: np.ndarray, slot_chunk: int) -> tuple:
    """Static ragged schedule: rows sorted by budget (descending, stable),
    coalesced into segments whose rows need the same number of
    ``slot_chunk``-wide chunks.  Pure numpy.  Returns RaggedSegments."""
    budgets = np.asarray(budgets)
    chunk = max(1, int(slot_chunk))
    segments: list = []
    for r in np.argsort(-budgets, kind="stable"):
        c = max(1, -(-int(budgets[r]) // chunk))
        if segments and segments[-1][1] == c:
            segments[-1][0].append(int(r))
        else:
            segments.append(([int(r)], c))
    return tuple(RaggedSegment(tuple(rows), c) for rows, c in segments)


def block_mask_to_token_mask(block_mask: torch.Tensor, block_q: int,
                             block_k: int, seq_q: int, seq_k: int) -> torch.Tensor:
    """(b, h, nq, nk) -> (b, h, seq_q, seq_k) with exact causal masking
    inside diagonal blocks.  Oracle/test path only: O(N^2) memory."""
    m = block_mask.repeat_interleave(block_q, dim=-2).repeat_interleave(
        block_k, dim=-1)[..., :seq_q, :seq_k]
    qi = torch.arange(seq_q, device=m.device)[:, None]
    kj = torch.arange(seq_k, device=m.device)[None, :]
    return m & (kj <= qi + (seq_k - seq_q))


def selection_density(sel: BlockSelection, nk: int) -> torch.Tensor:
    """Realized budget: mean fraction of admissible key blocks attended,
    from ``slot_mask`` (selected slots are distinct blocks)."""
    nq = sel.slot_mask.shape[-2]
    admissible = causal_block_mask(nq, nk, sel.slot_mask.device).sum()
    kept = sel.slot_mask.sum(dim=(-1, -2)).float().mean()
    return kept / admissible
