"""Token Position-Decay (TPD) and baseline block budgets (port of
``repro/core/schedule.py``).

Budgets are static int32 numpy per (policy, shape); the engine slices them
on the host and hands them to the step as data, so this module is plain
numpy and matches the reference exactly.
"""
from __future__ import annotations

import numpy as np


def tpd_budget_blocks(
    n_query_blocks: int,
    n_key_blocks: int,
    k_start_blocks: int,
    mu: float,
    *,
    min_budget_blocks: int = 0,
) -> np.ndarray:
    """Block-level TPD schedule (Algorithm 1 line 15): row i's budget decays
    linearly from ``k_start_blocks`` to ``mu * k_start_blocks``, floored at
    ``min_budget_blocks`` and clamped to the causally admissible count.
    Returns int32 numpy (n_query_blocks,)."""
    if n_query_blocks <= 0:
        raise ValueError("n_query_blocks must be positive")
    i = np.arange(n_query_blocks, dtype=np.float64)
    denom = max(n_query_blocks, 1)
    raw = np.floor(k_start_blocks - (k_start_blocks * (1.0 - mu) / denom) * i)
    raw = np.maximum(raw, 1.0)
    raw = np.maximum(raw, float(min_budget_blocks))
    offset = n_key_blocks - n_query_blocks
    admissible = np.minimum(i + 1 + offset, n_key_blocks)
    return np.minimum(raw, admissible).astype(np.int32)


def uniform_budget_blocks(nq: int, nk: int, k_uni: int) -> np.ndarray:
    """Constant per-row budget, causally clamped."""
    offset = nk - nq
    admissible = np.minimum(np.arange(nq, dtype=np.int64) + 1 + offset, nk)
    return np.minimum(np.full((nq,), k_uni, np.int64), admissible).astype(np.int32)


def dense_budget_blocks(nq: int, nk: int) -> np.ndarray:
    """Every causally admissible block: budgets[i] = min(i+1+offset, nk)."""
    offset = nk - nq
    return np.minimum(np.arange(nq, dtype=np.int64) + 1 + offset, nk).astype(np.int32)


def sink_local_budget_blocks(nq: int, nk: int, sink: int, local: int) -> np.ndarray:
    """StreamingLLM budget: per-row count of the forced sink + local blocks
    within causal admissibility."""
    offset = nk - nq
    i = np.arange(nq, dtype=np.int64)[:, None]
    j = np.arange(nk, dtype=np.int64)[None, :]
    diag = i + offset
    forced = ((j < sink) | ((j > diag - local) & (j <= diag))) & (j <= diag)
    return forced.sum(axis=-1).astype(np.int32)


def apply_sparse_segment(budgets: np.ndarray, nq: int, nk: int,
                         sparse_segment) -> np.ndarray:
    """Fig. 3 analysis overlay: sparsify only rows in [lo*nq, hi*nq); all
    other rows keep their full causal budgets.  None is a no-op."""
    if sparse_segment is None:
        return budgets
    lo, hi = sparse_segment
    full = dense_budget_blocks(nq, nk)
    sel = np.zeros(nq, bool)
    sel[int(lo * nq): int(hi * nq)] = True
    return np.where(sel, budgets, full).astype(np.int32)
