"""Training-free sparse-attention baselines the paper compares against
(port of ``repro/core/baselines.py``).

Every baseline is a registered ``SparsityPolicy`` (core/policy.py), so all
of them share Stem's executors and budget accounting:

  * ``"uniform-sam"`` — uniform top-k over routing-only scores, the
    paper's ablation baseline (Table 5, row "Uniform"); with k_uni =
    k_start (1 + mu) / 2 it is budget-matched to TPD.
  * ``"streaming"``   — StreamingLLM-style static sink + local window.
  * ``"xattention"``  — anti-diagonal block scores, per-row softmax and a
    cumulative-mass threshold tau.

The ``*_selection`` functions are thin wrappers that build the policy
equivalent of a ``StemConfig`` and keyword arguments and return its
``BlockSelection``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import policy as policy_lib
from repro_torch.core import schedule as schedule_lib
from repro_torch.core import selection as selection_lib
from repro_torch.core.config import StemConfig
from repro_torch.core.sparse_attention import sparse_attention


def uniform_budgets(nq: int, nk: int, k_uni: int, device="cuda") -> torch.Tensor:
    """Constant budget, causally clamped (int32 tensor of the uniform
    schedule)."""
    return torch.as_tensor(schedule_lib.uniform_budget_blocks(nq, nk, k_uni),
                           dtype=torch.int32, device=device)


def uniform_sam_policy(cfg: StemConfig,
                       k_uni: Optional[int] = None) -> policy_lib.SparsityPolicy:
    """The ``"uniform-sam"`` baseline at a ``StemConfig``'s geometry.
    ``k_uni=None`` keeps the budget-matched default (Table 5): k_uni =
    k_start (1 + mu) / 2 from the config's k_start rule."""
    sam = dataclasses.replace(cfg, metric="sam", mu=1.0)
    return policy_lib.as_policy(sam).with_updates(
        schedule=policy_lib.UniformSchedule(
            k_blocks=k_uni, k_start_frac=cfg.k_start_frac, mu=cfg.mu,
            min_budget_blocks=cfg.min_budget_blocks))


def uniform_sam_selection(q, k, v, cfg: StemConfig,
                          k_uni: Optional[int] = None) -> selection_lib.BlockSelection:
    """Uniform top-k with the Score-Aware Metric (routing only)."""
    return uniform_sam_policy(cfg, k_uni).prefill_select(q, k, v)[0]


def streaming_policy(sink_blocks: int, local_blocks: int,
                     block_size: int = 128) -> policy_lib.SparsityPolicy:
    """StreamingLLM at a given window geometry."""
    return policy_lib.get_policy("streaming").with_updates(
        block_size=block_size, sink_blocks=sink_blocks,
        local_blocks=local_blocks)


def streaming_selection(nq: int, nk: int, batch: int, heads: int,
                        sink_blocks: int, local_blocks: int,
                        device="cuda") -> selection_lib.BlockSelection:
    """StreamingLLM: static sink + sliding window at block granularity.
    Shape-only (the metric is content-free): the ``"streaming"`` policy's
    selector over a zero metric."""
    pol = streaming_policy(sink_blocks, local_blocks)
    metric = torch.zeros((batch, heads, nq, nk), dtype=torch.float32, device=device)
    budgets = pol.schedule.prefill_budgets(nq, nk, block_size=1, kv_len=nk)
    return pol.selector.select(
        metric, torch.as_tensor(budgets, dtype=torch.int32, device=device),
        int(min(sink_blocks + local_blocks, nk)), with_block_mask=True)


def xattention_policy(cfg: StemConfig, tau: float = 0.9) -> policy_lib.SparsityPolicy:
    """The ``"xattention"`` baseline at a ``StemConfig``'s geometry, with
    per-head thresholding (no group reduction), as in the original."""
    return policy_lib.get_policy("xattention").with_updates(
        block_size=cfg.block_size, stride=cfg.stride, tau=tau,
        sink_blocks=cfg.sink_blocks, local_blocks=cfg.local_blocks,
        pooling=cfg.pooling, group_reduce="none")


def xattention_like_selection(q, k, v, cfg: StemConfig,
                              tau: float = 0.9) -> selection_lib.BlockSelection:
    """XAttention-style: softmax the pooled anti-diagonal scores per row and
    keep the smallest prefix of blocks whose cumulative mass reaches tau."""
    return xattention_policy(cfg, tau).prefill_select(q, k, v)[0]


def baseline_policy(cfg: StemConfig, method: str,
                    k_uni: Optional[int] = None) -> policy_lib.SparsityPolicy:
    """A baseline's name ("uniform_sam" | "streaming" | "xattention") ->
    its policy at ``cfg``'s geometry."""
    if method == "uniform_sam":
        return uniform_sam_policy(cfg, k_uni)
    if method == "streaming":
        return streaming_policy(cfg.sink_blocks, cfg.local_blocks, cfg.block_size)
    if method == "xattention":
        return xattention_policy(cfg)
    raise ValueError(f"unknown baseline {method!r}")


def baseline_attention(q, k, v, cfg: StemConfig, method: str = "uniform_sam",
                       k_uni: Optional[int] = None):
    """A baseline policy through the dense-oracle executor.  Returns
    (output, realized density)."""
    out, stats = sparse_attention(q, k, v, baseline_policy(cfg, method, k_uni),
                                  executor="dense", return_stats=True)
    return out, stats.density
