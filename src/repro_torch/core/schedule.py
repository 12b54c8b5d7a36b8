"""Token Position-Decay (TPD) and baseline block budgets, and the cost
model of Eqs. (2)-(4) (port of ``repro/core/schedule.py``).

Budgets are static int32 numpy per (policy, shape); the engine slices them
on the host and hands them to the step as data, so this module is plain
numpy and matches the reference exactly: Eq. (3)'s token-level budgets,
the block-level schedules, and the analytic and measured costs.
``budgets_as_tensor`` hands budgets to a device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.config import StemConfig


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


def tpd_budget_tokens(seq_len: int, k_start: int, mu: float) -> np.ndarray:
    """Eq. (3): k(i) = floor(k_start - (k_start (1-mu) / N) * i), i in [0, N),
    floored at 1, before causal clamping.  Returns int32 numpy (seq_len,)."""
    i = np.arange(seq_len, dtype=np.float64)
    k = np.floor(k_start - (k_start * (1.0 - mu) / seq_len) * i)
    return np.maximum(k, 1.0).astype(np.int32)


def schedule_for(cfg: StemConfig, seq_len: int, kv_len: int | None = None) -> np.ndarray:
    """Block-level TPD schedule of a ``StemConfig`` at a sequence length
    (``kv_len`` for a longer key grid), ``sparse_segment`` applied."""
    kv_len = seq_len if kv_len is None else kv_len
    nq = -(-seq_len // cfg.block_size)
    nk = -(-kv_len // cfg.block_size)
    budgets = tpd_budget_blocks(nq, nk, cfg.k_start_blocks(kv_len), cfg.mu,
                                min_budget_blocks=cfg.min_budget_blocks)
    return apply_sparse_segment(budgets, nq, nk, cfg.sparse_segment)


def max_budget_blocks(cfg: StemConfig, seq_len: int, kv_len: int | None = None) -> int:
    """Static upper bound on the per-row block budget (the kernel's K_max)."""
    return int(schedule_for(cfg, seq_len, kv_len).max())


# ---------------------------------------------------------------------------
# Analytic cost model (Eq. 2 / Eq. 4) and measured cost.
# ---------------------------------------------------------------------------

def cost_uniform(seq_len: int, k_uni: int) -> float:
    """Eq. (2): C_uni ~= N * k_uni - k_uni^2 / 2 (token pairs computed)."""
    return seq_len * k_uni - 0.5 * k_uni * k_uni


def cost_decay(seq_len: int, k_start: int, mu: float) -> float:
    """Eq. (4): the uniform cost at k_start minus the decay's savings."""
    uniform = seq_len * k_start - 0.5 * k_start * k_start
    savings = 0.5 * k_start * (1.0 - mu) * (seq_len - k_start)
    return uniform - savings


def measured_cost_tokens(seq_len: int, k_start: int, mu: float) -> int:
    """Exact computed-pair count of the token-level schedule, causally
    clamped: sum_i min(k(i), i+1).  Validates Eq. (4)."""
    k = tpd_budget_tokens(seq_len, k_start, mu).astype(np.int64)
    avail = np.arange(1, seq_len + 1, dtype=np.int64)
    return int(np.minimum(k, avail).sum())


def measured_cost_blocks(budgets: np.ndarray, block_size: int) -> int:
    """Computed token pairs implied by a block-level schedule."""
    return int(budgets.astype(np.int64).sum()) * block_size * block_size


def average_budget(budgets: np.ndarray) -> float:
    """k_avg of Eq. (8) in block units."""
    return float(np.mean(budgets))


def budgets_as_tensor(budgets: np.ndarray, device=None) -> torch.Tensor:
    """Budgets as an int32 tensor on ``device`` (the CPU by default)."""
    return torch.as_tensor(np.asarray(budgets), dtype=torch.int32, device=device)
