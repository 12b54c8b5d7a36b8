"""Policy-driven sparse decode (port of ``repro/core/decode.py``).

Each decode step scores cache blocks against the single query with the
policy's block metric, applies the policy's budget + selection rule, and
attends exactly over the selected blocks.  The pipeline is factored into
stages shared with the paged executors (``runtime/paged.py``):

  ``summarize_cache``      — anti-diagonal K group means + block max log||V||
                             of a contiguous cache (the pool and vmag kernels);
  ``decode_block_metric``  — policy metric of the query vs every cache block;
  ``select_decode_blocks`` — policy budget + validity + forced floors;
  ``attend_selected``      — exact masked attention over gathered blocks.

``sparse_decode_attention`` composes them over a contiguous cache (the
fixed-batch decode of ``models/attention.apply_decode``).  ``cache_lens``
may be a scalar or a ``(b,)`` vector: every row masks at its own valid
prefix, which need not be a block multiple.
"""
from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import metric as metric_lib
from repro_torch.core import policy as policy_lib
from repro_torch.core.selection import NEG_INF, DecodeSelection

# Default decode sparsity of every decode entry point: dense (1.0).  Sparse
# serving passes its fraction explicitly (``EngineConfig.budget_frac``).
DEFAULT_BUDGET_FRAC = 1.0
# The v_mag of an all-zero block (log of the norm floor); fresh pages start
# at it so incremental appends reproduce the batch summary exactly.
V_MAG_FLOOR = float(np.log(1e-20))


class BlockSummary(NamedTuple):
    """Pooled per-block cache summaries."""
    k_groups: torch.Tensor   # (b, hk, nblocks, stride, d) anti-diag group means
    v_mag: torch.Tensor      # (b, hk, nblocks) max-pooled log ||V||


def summarize_cache(k: torch.Tensor, v: torch.Tensor, cfg) -> BlockSummary:
    """k, v: (b, hk, L, d) with L % block_size == 0.  ``cfg``: any policy
    spelling (block_size / stride are read off it)."""
    p = policy_lib.as_policy(cfg)
    return BlockSummary(
        k_groups=metric_lib.antidiag_pool(k, p.block_size, p.stride),
        v_mag=metric_lib.value_block_magnitude(v, p.block_size))


def decode_block_metric(q: torch.Tensor, k_groups: torch.Tensor,
                        v_mag: torch.Tensor, cfg) -> torch.Tensor:
    """q: (b, hq, 1, d); k_groups: (b, hk, n, stride, d); v_mag: (b, hk, n).
    Returns (b, hk, group, n) float32."""
    return policy_lib.as_policy(cfg).decode_scores(q, k_groups, v_mag)


def decode_budget_bound(nblk: int, cfg, budget_frac: float) -> int:
    """Static top-k width of the policy's decode selection — the gather
    width the executors allocate."""
    return policy_lib.as_policy(cfg).decode_budget_bound(nblk, budget_frac)


def select_decode_blocks(m: torch.Tensor, cache_lens: torch.Tensor, cfg,
                         budget_frac: float = DEFAULT_BUDGET_FRAC) -> DecodeSelection:
    """Policy budget + forced floors + validity, vectorized per row."""
    return policy_lib.as_policy(cfg).decode_select(
        m, cache_lens, budget_frac=budget_frac)


def debug_assert_live_rows(sel: DecodeSelection,
                           context: str = "decode selection") -> None:
    """Opt-in invariant check (``REPRO_DEBUG_DECODE=1``): every row with a
    non-empty cache keeps at least one live selected block per head, or its
    attention output would be a silent zero vector.  The check reads the
    selection on the host, so it is gated behind the variable."""
    if not os.environ.get("REPRO_DEBUG_DECODE"):
        return
    has_live = sel.live.any(dim=-1).cpu().numpy()            # (b, hk, g)
    nonempty = (sel.n_valid > 0).cpu().numpy()               # (b,)
    bad = nonempty[:, None, None] & ~has_live
    if bad.any():
        raise AssertionError(
            f"{context}: rows with a non-empty cache selected zero live "
            f"blocks at (row, kv_head, group) = {np.argwhere(bad).tolist()}; "
            "their attention output will be a silent zero vector "
            "(schedule/selector produced a zero budget with no forced "
            "sink/local floor)")


def attend_selected(
    q: torch.Tensor,            # (b, hq, 1, d)
    gk: torch.Tensor,           # (b, hk, g, k_max, bs, d) gathered key blocks
    gv: torch.Tensor,           # (b, hk, g, k_max, bs, dv)
    sel: DecodeSelection,
    cache_lens: torch.Tensor,   # scalar or (b,)
    block_size: int,
) -> torch.Tensor:
    """Masked softmax over the selected blocks only.  Returns (b, hq, 1, dv).

    Zero-live-row contract: a row with no live slot (``cache_lens == 0``
    trash slots) softmaxes an all-NEG_INF row, whose uniform probabilities
    the ``keep`` mask then zeroes — the row returns an exact zero vector.
    The fused kernel honours the same contract; ``REPRO_DEBUG_DECODE=1``
    asserts that every non-empty row keeps a live slot."""
    debug_assert_live_rows(sel, context="attend_selected")
    b, hq, _, d = q.shape
    hk = gk.shape[1]
    group = hq // hk
    bs = block_size
    lens = torch.as_tensor(cache_lens, dtype=torch.int32,
                           device=q.device).expand(b)
    qg = q.reshape(b, hk, group, 1, d).float()
    s = torch.einsum("bhgqd,bhgnkd->bhgqnk", qg, gk.float())
    s = s * (d ** -0.5)                                    # (b,hk,g,1,kmax,bs)
    tok_pos = sel.indices[..., None] * bs + torch.arange(bs, device=q.device)
    keep = (tok_pos < lens[:, None, None, None, None]) & sel.live[..., None]
    s = torch.where(keep[:, :, :, None], s, NEG_INF)
    p = torch.softmax(s.reshape(b, hk, group, 1, -1), dim=-1).reshape(s.shape)
    p = torch.where(keep[:, :, :, None], p, 0.0)
    o = torch.einsum("bhgqnk,bhgnkd->bhgqd", p, gv.float())
    return o.reshape(b, hq, 1, gv.shape[-1]).to(q.dtype)


def sparse_decode_attention(
    q: torch.Tensor,            # (b, hq, 1, d) — one new query token
    cache_k: torch.Tensor,      # (b, hk, L, d)
    cache_v: torch.Tensor,
    summary: BlockSummary,
    cache_lens,                 # scalar or (b,) valid prefixes
    cfg,
    budget_frac: float = DEFAULT_BUDGET_FRAC,
) -> torch.Tensor:
    """Policy block selection + exact attention over the selected cache
    blocks.  At ``budget_frac=1.0`` every valid block is selected, so the
    result equals dense decode over each row's prefix."""
    policy = policy_lib.as_policy(cfg)
    b, hq, _, d = q.shape
    hk = cache_k.shape[1]
    bs = policy.block_size
    nblk = cache_k.shape[2] // bs
    lens = torch.as_tensor(cache_lens, dtype=torch.int32,
                           device=q.device).expand(b)

    m = policy.decode_scores(q, summary.k_groups, summary.v_mag)
    sel = policy.decode_select(m, lens, budget_frac=budget_frac)

    dv = cache_v.shape[-1]
    kb = cache_k.reshape(b, hk, 1, nblk, bs, d)
    vb = cache_v.reshape(b, hk, 1, nblk, bs, dv)
    # gather along the block axis (3, after the g broadcast axis)
    idx = sel.indices.long()[..., None, None]              # (b,hk,g,kmax,1,1)
    gk = torch.take_along_dim(kb, idx, dim=3)
    gv = torch.take_along_dim(vb, idx, dim=3)
    return attend_selected(q, gk, gv, sel, lens, bs)
