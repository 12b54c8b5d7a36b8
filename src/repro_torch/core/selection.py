"""Block-selection helpers shared by the decode and chunk lanes (port of
``repro/core/selection.py``).

``stable_topk`` carries the reference's tie rule: ``jax.lax.top_k`` puts the
lower index first among equal values, while ``torch.topk`` promises no
order.  Ties are exact in normal use — every forced sink/local block scores
``metric + FORCE_BONUS`` (= 1e30 in float32) and the streaming metric scores
every block 0 — and the live prefix of the top-k output then decides which
tied blocks survive, so the port sorts stably on descending value instead.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = -1e30
FORCE_BONUS = 1e30


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
