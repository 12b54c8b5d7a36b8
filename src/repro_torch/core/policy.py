"""Composable sparsity policies: metric x schedule x selector (+ executor).

Port of ``repro/core/policy.py``, the paged executors' mesh-sharding
contract included: the ``BlockMetric`` / ``BudgetSchedule`` / ``Selector``
protocols (``runtime_checkable``; every built-in satisfies its own), the
OAM / routing-only (SAM, XAttention) / streaming metrics, the four budget
schedules, the top-k selector with forced sink/local floors and the
cumulative-mass (XAttention) selector, the frozen ``SparsityPolicy``, the
metric/schedule/selector/policy registries (``as_policy``,
``policy_from_config``), the prefill and paged executor registries and the
built-in policies ``stem``, ``stem-sam``, ``uniform-sam``, ``uniform-oam``,
``streaming``, ``xattention`` and ``dense``.

One ``executor`` field names the backend of both registries: "fused" (the
CUDA kernels, the default) and "gather" (the plain PyTorch gather
executors) exist for the one-shot prefill and the paged lanes; "dense" (the
O(N^2) masked oracle) for the prefill only.  Unlike the reference, an
unknown paged executor name — "dense" included — raises instead of falling
back to the gather oracle.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional, Protocol, Union, runtime_checkable

import numpy as np
import torch

from repro_torch.core import metric as metric_lib
from repro_torch.core import schedule as schedule_lib
from repro_torch.core import selection as selection_lib
from repro_torch.core.config import (StemConfig, k_start_blocks_for,
                                     uniform_equivalent_budget,
                                     validate_sparse_segment)

NEG_INF = selection_lib.NEG_INF


# ---------------------------------------------------------------------------
# Protocols (the structural contracts a user's own metric, schedule or
# selector is written to)
# ---------------------------------------------------------------------------

@runtime_checkable
class BlockMetric(Protocol):
    """Scores key blocks per query row; higher = more important."""

    def prefill_scores(self, q, k, v, *, block_size: int) -> torch.Tensor:
        """(b, hq, sq, d) x (b, hk, sk, d) -> (b, hq, nq, nk)."""
        ...

    def decode_scores(self, q, k_groups, v_mag) -> torch.Tensor:
        """One decode query vs pooled cache-block summaries.

        q: (b, hq, 1, d); k_groups: (b, hk, n, stride, d); v_mag: (b, hk, n).
        Returns (b, hk, group, n) float32.
        """
        ...

    def chunk_scores(self, q, k_groups, v_mag, *, block_size: int) -> torch.Tensor:
        """A chunk of queries vs pooled cache-block summaries (chunked
        prefill, ``core/chunked.py``).  Must reproduce ``prefill_scores`` on
        full key blocks so chunked selection matches one-shot prefill.

        q: (b, hq, C, d) with C % block_size == 0; k_groups / v_mag as in
        ``decode_scores``.  Returns (b, hq, nc, n).
        """
        ...


@runtime_checkable
class BudgetSchedule(Protocol):
    """Per-query-row block budgets (static for prefill, per-row for decode)."""

    def prefill_budgets(self, nq: int, nk: int, *, block_size: int,
                        kv_len: int) -> np.ndarray:
        """Static int32 numpy budgets of shape (nq,), causally clamped."""
        ...

    def decode_budgets(self, n_valid, n_forced, budget_frac: float):
        """(b,) int32 budgets for one decode step (n_valid/n_forced: (b,))."""
        ...

    def decode_budget_bound(self, nblk: int, forced_bound: int,
                            budget_frac: float) -> int:
        """Static top-k width: upper bound on any row's decode budget."""
        ...


@runtime_checkable
class Selector(Protocol):
    """Turns (metric, budgets) into a concrete block selection."""

    budget_driven: bool  # True: k_max = max budget; False: threshold, k_max = nk

    def select(self, metric, budgets, k_max: int, *,
               with_block_mask: bool) -> selection_lib.BlockSelection:
        ...

    def select_decode(self, metric, cache_lens, *, block_size: int,
                      schedule: BudgetSchedule,
                      budget_frac: float) -> selection_lib.DecodeSelection:
        ...


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class OutputAwareMetric:
    """Eq. (7): pooled routing scores + beta * max(0, maxpool log ||V||)."""

    beta: float = 0.2
    pooling: str = "antidiag"
    stride: int = 16

    def prefill_scores(self, q, k, v, *, block_size: int) -> torch.Tensor:
        """(b, hq, sq, d) x (b, hk, sk, d) -> (b, hq, nq, nk)."""
        return metric_lib.oam_scores(
            q, k, v, block_size=block_size, stride=self.stride,
            pooling=self.pooling, beta=self.beta)

    def decode_scores(self, q, k_groups, v_mag) -> torch.Tensor:
        route = metric_lib.decode_routing_scores(q, k_groups)
        if self.beta == 0.0:
            return route
        return route + self.beta * torch.clamp(v_mag, min=0.0)[:, :, None, :]

    def chunk_scores(self, q, k_groups, v_mag, *, block_size: int) -> torch.Tensor:
        route = metric_lib.chunk_routing_scores(
            q, k_groups, block_size=block_size, pooling=self.pooling)
        if self.beta == 0.0:
            return route
        group = q.shape[1] // k_groups.shape[1]
        mv = torch.repeat_interleave(v_mag, group, dim=1)      # (b, hq, n)
        return route + self.beta * torch.clamp(mv, min=0.0).to(
            route.dtype)[..., None, :]


@dataclasses.dataclass(frozen=True)
class RoutingMetric:
    """Routing-only scores (the paper's SAM ablation; also XAttention's
    anti-diagonal block scores) — no value term."""

    pooling: str = "antidiag"
    stride: int = 16

    def prefill_scores(self, q, k, v, *, block_size: int) -> torch.Tensor:
        return metric_lib.blockwise_routing_scores(
            q, k, block_size=block_size, stride=self.stride,
            pooling=self.pooling)

    def decode_scores(self, q, k_groups, v_mag) -> torch.Tensor:
        return metric_lib.decode_routing_scores(q, k_groups)

    def chunk_scores(self, q, k_groups, v_mag, *, block_size: int) -> torch.Tensor:
        return metric_lib.chunk_routing_scores(
            q, k_groups, block_size=block_size, pooling=self.pooling)


@dataclasses.dataclass(frozen=True)
class StreamingMetric:
    """Content-free zero metric: selection is driven entirely by the forced
    sink/local floors and the budget schedule (StreamingLLM)."""

    def prefill_scores(self, q, k, v, *, block_size: int) -> torch.Tensor:
        b, hq, sq, _ = q.shape
        return torch.zeros((b, hq, sq // block_size, k.shape[2] // block_size),
                           dtype=torch.float32, device=q.device)

    def decode_scores(self, q, k_groups, v_mag) -> torch.Tensor:
        b, hq = q.shape[0], q.shape[1]
        hk, n = k_groups.shape[1], k_groups.shape[2]
        return torch.zeros((b, hk, hq // hk, n), dtype=torch.float32,
                           device=q.device)

    def chunk_scores(self, q, k_groups, v_mag, *, block_size: int) -> torch.Tensor:
        b, hq, c, _ = q.shape
        n = k_groups.shape[2]
        return torch.zeros((b, hq, c // block_size, n), dtype=torch.float32,
                           device=q.device)


# ---------------------------------------------------------------------------
# Budget schedules
# ---------------------------------------------------------------------------

def _validate_fractional(mu: float, min_budget_blocks: int) -> None:
    if not (0.0 < mu <= 1.0):
        raise ValueError(f"mu must be in (0, 1], got {mu}")
    if min_budget_blocks < 0:
        raise ValueError(f"min_budget_blocks must be >= 0, got {min_budget_blocks}")


def _validate_sink_local(sink_blocks: int, local_blocks: int) -> None:
    if sink_blocks < 0 or local_blocks < 0:
        raise ValueError(
            f"sink/local blocks must be >= 0, got ({sink_blocks}, {local_blocks})")


def _fractional_decode_budgets(min_budget_blocks: int, n_valid, n_forced,
                               budget_frac: float):
    """A fixed fraction of the valid cache blocks, floored at min_budget and
    at the forced sink/local count.  n_valid/n_forced: (b,) int32."""
    frac = (n_valid.to(torch.float32) * budget_frac).to(torch.int32)
    return torch.maximum(torch.clamp(n_forced, min=min_budget_blocks), frac)


def _fractional_decode_bound(min_budget_blocks: int, nblk: int,
                             forced_bound: int, budget_frac: float) -> int:
    """Static upper bound on _fractional_decode_budgets — the decode top-k
    width the executors allocate."""
    k_max = min(nblk, int(np.ceil(nblk * budget_frac))
                + min_budget_blocks + forced_bound)
    return max(k_max, 1)


@dataclasses.dataclass(frozen=True)
class TPDSchedule:
    """Token Position-Decay (Eq. 3): linear decay k_start -> mu * k_start."""

    k_start_frac: Optional[float] = None
    mu: float = 0.7
    min_budget_blocks: int = 54
    sparse_segment: Optional[tuple] = None

    def __post_init__(self) -> None:
        _validate_fractional(self.mu, self.min_budget_blocks)
        validate_sparse_segment(self.sparse_segment)

    def prefill_budgets(self, nq: int, nk: int, *, block_size: int,
                        kv_len: int) -> np.ndarray:
        budgets = schedule_lib.tpd_budget_blocks(
            nq, nk, k_start_blocks_for(self.k_start_frac, kv_len, block_size),
            self.mu, min_budget_blocks=self.min_budget_blocks)
        return schedule_lib.apply_sparse_segment(budgets, nq, nk,
                                                 self.sparse_segment)

    def decode_budgets(self, n_valid, n_forced, budget_frac: float):
        return _fractional_decode_budgets(self.min_budget_blocks, n_valid,
                                          n_forced, budget_frac)

    def decode_budget_bound(self, nblk: int, forced_bound: int,
                            budget_frac: float) -> int:
        return _fractional_decode_bound(self.min_budget_blocks, nblk,
                                        forced_bound, budget_frac)


@dataclasses.dataclass(frozen=True)
class UniformSchedule:
    """Constant per-row budget, causally clamped; ``k_blocks=None`` is the
    budget-matched uniform equivalent of TPD (paper Table 5)."""

    k_blocks: Optional[int] = None
    k_start_frac: Optional[float] = None
    mu: float = 0.7
    min_budget_blocks: int = 54

    def __post_init__(self) -> None:
        _validate_fractional(self.mu, self.min_budget_blocks)
        if self.k_blocks is not None and self.k_blocks < 1:
            raise ValueError(f"k_blocks must be >= 1, got {self.k_blocks}")

    def _k_uni(self, nk: int, block_size: int, kv_len: int) -> int:
        if self.k_blocks is not None:
            return self.k_blocks
        k_start = k_start_blocks_for(self.k_start_frac, kv_len, block_size)
        k_uni = uniform_equivalent_budget(k_start, self.mu)
        return max(k_uni, min(self.min_budget_blocks, nk))

    def prefill_budgets(self, nq: int, nk: int, *, block_size: int,
                        kv_len: int) -> np.ndarray:
        return schedule_lib.uniform_budget_blocks(
            nq, nk, self._k_uni(nk, block_size, kv_len))

    def decode_budgets(self, n_valid, n_forced, budget_frac: float):
        return _fractional_decode_budgets(self.min_budget_blocks, n_valid,
                                          n_forced, budget_frac)

    def decode_budget_bound(self, nblk: int, forced_bound: int,
                            budget_frac: float) -> int:
        return _fractional_decode_bound(self.min_budget_blocks, nblk,
                                        forced_bound, budget_frac)


@dataclasses.dataclass(frozen=True)
class DenseSchedule:
    """Every causally admissible block."""

    def prefill_budgets(self, nq: int, nk: int, *, block_size: int,
                        kv_len: int) -> np.ndarray:
        return schedule_lib.dense_budget_blocks(nq, nk)

    def decode_budgets(self, n_valid, n_forced, budget_frac: float):
        return n_valid.to(torch.int32)

    def decode_budget_bound(self, nblk: int, forced_bound: int,
                            budget_frac: float) -> int:
        return max(nblk, 1)


@dataclasses.dataclass(frozen=True)
class SinkLocalSchedule:
    """StreamingLLM budget: exactly the forced sink + local blocks per row."""

    sink_blocks: int = 4
    local_blocks: int = 4

    def __post_init__(self) -> None:
        _validate_sink_local(self.sink_blocks, self.local_blocks)
        if self.sink_blocks + self.local_blocks < 1:
            raise ValueError("sink-local schedule needs sink + local >= 1")

    def prefill_budgets(self, nq: int, nk: int, *, block_size: int,
                        kv_len: int) -> np.ndarray:
        return schedule_lib.sink_local_budget_blocks(
            nq, nk, self.sink_blocks, self.local_blocks)

    def decode_budgets(self, n_valid, n_forced, budget_frac: float):
        return n_forced.to(torch.int32)

    def decode_budget_bound(self, nblk: int, forced_bound: int,
                            budget_frac: float) -> int:
        return max(1, min(nblk, forced_bound))


# ---------------------------------------------------------------------------
# Selector
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TopKSelector:
    """Top-k(i) over the metric with forced sink/local floors
    (``selection.select_blocks``); the decode path is the vectorized per-row
    variant of the paged cache."""

    sink_blocks: int = 4
    local_blocks: int = 4
    budget_driven = True

    def __post_init__(self) -> None:
        _validate_sink_local(self.sink_blocks, self.local_blocks)

    def select(self, metric, budgets, k_max: int, *,
               with_block_mask: bool) -> selection_lib.BlockSelection:
        return selection_lib.select_blocks(
            metric, budgets, k_max, sink_blocks=self.sink_blocks,
            local_blocks=self.local_blocks, with_block_mask=with_block_mask)

    def select_decode(self, m, cache_lens, *, block_size: int, schedule,
                      budget_frac: float) -> selection_lib.DecodeSelection:
        """Per-row budget + validity + forced floors, static-width top-k.

        m: (b, hk, g, nblk) coarse metric; cache_lens: (b,) int32."""
        b, _, _, nblk = m.shape
        bs = block_size
        dev = m.device
        cache_lens = torch.as_tensor(cache_lens, dtype=torch.int32,
                                     device=dev).expand(b)
        n_valid = torch.div(cache_lens + bs - 1, bs, rounding_mode="floor")
        n_forced = torch.clamp(n_valid, max=self.sink_blocks + self.local_blocks)
        k_budget = schedule.decode_budgets(n_valid, n_forced, budget_frac)
        blk = torch.arange(nblk, device=dev)
        is_valid = blk[None, :] < n_valid[:, None]                  # (b, n)
        is_sink = blk < self.sink_blocks                            # (n,)
        is_local = (blk[None, :] >= n_valid[:, None] - self.local_blocks) & is_valid
        forced = (is_sink[None, :] | is_local)[:, None, None, :]    # (b,1,1,n)
        biased = torch.where(forced, m + selection_lib.FORCE_BONUS, m)
        biased = torch.where(is_valid[:, None, None, :], biased,
                             torch.full_like(biased, NEG_INF))

        k_max = schedule.decode_budget_bound(
            nblk, self.sink_blocks + self.local_blocks, budget_frac)
        vals, idx = selection_lib.stable_topk(biased, k_max)
        live = (vals > NEG_INF / 2) & (
            torch.arange(k_max, device=dev)[None, None, None, :]
            < k_budget[:, None, None, None])
        return selection_lib.DecodeSelection(
            indices=idx.to(torch.int32), live=live,
            budgets=k_budget, n_valid=n_valid)


def _cumulative_mass_keep(probs: torch.Tensor, tau: float) -> torch.Tensor:
    """Keep mask over the last axis: a block is kept iff the cumulative
    (descending-sorted) probability mass before it is < tau.  The sort is
    stable, as ``jnp.argsort`` is, so tied blocks keep index order."""
    order = torch.argsort(-probs, dim=-1, stable=True)
    sorted_p = torch.take_along_dim(probs, order, dim=-1)
    keep_sorted = (torch.cumsum(sorted_p, dim=-1) - sorted_p) < tau
    return torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)


@dataclasses.dataclass(frozen=True)
class CumulativeMassSelector:
    """XAttention-style: per-row softmax over the (causal) metric, keep the
    smallest prefix of blocks whose cumulative mass reaches ``tau``;
    sink/local blocks are forced.  Budget-free — pair it with
    ``DenseSchedule``."""

    tau: float = 0.9
    sink_blocks: int = 4
    local_blocks: int = 4
    budget_driven = False

    def __post_init__(self) -> None:
        _validate_sink_local(self.sink_blocks, self.local_blocks)
        if not (0.0 < self.tau <= 1.0):
            raise ValueError(f"tau must be in (0, 1], got {self.tau}")

    def select(self, metric, budgets, k_max: int, *,
               with_block_mask: bool) -> selection_lib.BlockSelection:
        nq, nk = metric.shape[-2], metric.shape[-1]
        dev = metric.device
        causal = selection_lib.causal_block_mask(nq, nk, dev)
        probs = torch.softmax(torch.where(causal, metric, NEG_INF), dim=-1)
        block_mask = _cumulative_mass_keep(probs, self.tau) & causal
        forced = selection_lib.forced_block_mask(
            nq, nk, self.sink_blocks, self.local_blocks, dev)
        block_mask = block_mask | (forced & causal)
        score = torch.where(block_mask, probs + 1.0, NEG_INF)
        vals, idx = selection_lib.stable_topk(score, nk)
        slot_mask = vals > NEG_INF / 2
        return selection_lib.BlockSelection(
            indices=torch.where(slot_mask, idx, 0).to(torch.int32),
            slot_mask=slot_mask,
            block_mask=block_mask if with_block_mask else None,
            budgets=block_mask.sum(dim=-1).amax(dim=(0, 1)).to(torch.int32),
            live_counts=slot_mask.sum(dim=-1, dtype=torch.int32))

    def select_decode(self, m, cache_lens, *, block_size: int, schedule,
                      budget_frac: float) -> selection_lib.DecodeSelection:
        """Threshold selection over cache blocks (k_max = nblk)."""
        b, _, _, nblk = m.shape
        bs = block_size
        dev = m.device
        cache_lens = torch.as_tensor(cache_lens, dtype=torch.int32,
                                     device=dev).expand(b)
        n_valid = torch.div(cache_lens + bs - 1, bs, rounding_mode="floor")
        blk = torch.arange(nblk, device=dev)
        is_valid = blk[None, :] < n_valid[:, None]
        is_sink = blk < self.sink_blocks
        is_local = (blk[None, :] >= n_valid[:, None] - self.local_blocks) & is_valid
        forced = (is_sink[None, :] | is_local)[:, None, None, :]
        valid = is_valid[:, None, None, :]
        probs = torch.softmax(torch.where(valid, m, NEG_INF), dim=-1)
        keep = (_cumulative_mass_keep(probs, self.tau) | forced) & valid
        score = torch.where(keep, probs + 1.0, NEG_INF)
        vals, idx = selection_lib.stable_topk(score, nblk)
        return selection_lib.DecodeSelection(
            indices=idx.to(torch.int32), live=vals > NEG_INF / 2,
            budgets=keep.sum(dim=-1).amax(dim=(1, 2)).to(torch.int32),
            n_valid=n_valid)


# ---------------------------------------------------------------------------
# The composed policy
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SparsityPolicy:
    """Metric x schedule x selector + execution knobs (frozen, hashable).
    ``executor`` names the backend of the one-shot prefill and the paged
    lanes: "fused" (the CUDA kernels, the default), "gather" (the plain
    PyTorch executors) or, for the prefill only, "dense" (the masked
    oracle).  ``slot_chunk`` / ``ragged`` shape the gather executor's
    schedule."""

    metric: Any
    schedule: Any
    selector: Any
    block_size: int = 128
    group_reduce: str = "none"     # "none" | "mean" | "max" (GQA sharing)
    executor: str = "fused"
    slot_chunk: int = 8
    ragged: bool = True
    name: str = ""

    def __post_init__(self) -> None:
        if self.block_size <= 0 or self.block_size % 8 != 0:
            raise ValueError(
                f"block_size must be a positive multiple of 8, got {self.block_size}")
        stride = self.stride
        if stride <= 0 or self.block_size % stride != 0:
            raise ValueError(
                f"metric stride {stride} must divide block_size {self.block_size}")
        if self.group_reduce not in ("none", "mean", "max"):
            raise ValueError(f"unknown group_reduce {self.group_reduce!r}")
        if self.slot_chunk < 1:
            raise ValueError(f"slot_chunk must be >= 1, got {self.slot_chunk}")

    @property
    def stride(self) -> int:
        """Anti-diagonal pooling stride of the metric (1 for content-free
        metrics) — sizes the per-page K group-mean summaries."""
        return getattr(self.metric, "stride", 1)

    @property
    def sink_blocks(self) -> int:
        return getattr(self.selector, "sink_blocks", 0)

    @property
    def local_blocks(self) -> int:
        return getattr(self.selector, "local_blocks", 0)

    def prefill_budgets(self, seq_len: int, kv_len: Optional[int] = None) -> np.ndarray:
        """Static numpy (nq,) budgets."""
        kv_len = seq_len if kv_len is None else kv_len
        nq = -(-seq_len // self.block_size)
        nk = -(-kv_len // self.block_size)
        return self.schedule.prefill_budgets(
            nq, nk, block_size=self.block_size, kv_len=kv_len)

    def prefill_live_counts(self, seq_len: int, kv_len: Optional[int] = None):
        """The live count of each query-block row of the prefill's selection
        where the lengths alone fix it, else None.  A budget-driven
        selector keeps min(budget, causal blocks) of every row; when every
        row's budget also holds its forced sink and local blocks (which
        outrank the rest), and local blocks are forced, the diagonal block
        is always among them.  A threshold selector's counts depend on the
        data: None."""
        if not self.selector.budget_driven or self.local_blocks < 1:
            return None
        kv_len = seq_len if kv_len is None else kv_len
        budgets = np.asarray(self.prefill_budgets(seq_len, kv_len), dtype=np.int64)
        nk = -(-kv_len // self.block_size)
        diag = np.arange(len(budgets)) + (nk - len(budgets))
        sink = np.minimum(self.sink_blocks, diag + 1)
        local = np.minimum(self.local_blocks, diag + 1)
        both = np.maximum(0, sink - np.maximum(0, diag - self.local_blocks + 1))
        if np.any(budgets < sink + local - both):
            return None
        return np.minimum(budgets, diag + 1)

    def prefill_scores(self, q, k, v) -> torch.Tensor:
        m = self.metric.prefill_scores(q, k, v, block_size=self.block_size)
        group = q.shape[1] // k.shape[1]
        return metric_lib.group_reduce_metric(m, group, self.group_reduce)

    def prefill_select(self, q, k, v, *, with_block_mask: bool = True, scores=None):
        """Phase 1 of Algorithm 1: metric + schedule + selection.
        ``scores`` (b, hq, nq, nk) replaces ``prefill_scores`` (a tensor-
        parallel shard's share of its KV group's pooled metric).
        Returns (BlockSelection, k_max)."""
        sq, sk = q.shape[2], k.shape[2]
        m = self.prefill_scores(q, k, v) if scores is None else scores
        budgets = self.prefill_budgets(sq, sk)
        nk = sk // self.block_size
        k_max = int(budgets.max()) if self.selector.budget_driven else int(nk)
        sel = self.selector.select(
            m, torch.as_tensor(budgets, dtype=torch.int32, device=q.device),
            k_max, with_block_mask=with_block_mask)
        return sel, k_max

    def chunk_scores(self, q, k_groups, v_mag) -> torch.Tensor:
        """Chunk metric against pooled page summaries with the policy's GQA
        group reduction applied.  Returns (b, hq, nc, n)."""
        m = self.metric.chunk_scores(q, k_groups, v_mag,
                                     block_size=self.block_size)
        group = q.shape[1] // k_groups.shape[1]
        return metric_lib.group_reduce_metric(m, group, self.group_reduce)

    def decode_scores(self, q, k_groups, v_mag) -> torch.Tensor:
        return self.metric.decode_scores(q, k_groups, v_mag)

    def decode_select(self, m, cache_lens, *,
                      budget_frac: float = 0.25) -> selection_lib.DecodeSelection:
        return self.selector.select_decode(
            m, cache_lens, block_size=self.block_size,
            schedule=self.schedule, budget_frac=budget_frac)

    def decode_budget_bound(self, nblk: int, budget_frac: float) -> int:
        if not self.selector.budget_driven:
            return max(nblk, 1)
        return self.schedule.decode_budget_bound(
            nblk, self.sink_blocks + self.local_blocks, budget_frac)

    def with_updates(self, *, ignore_missing: bool = False,
                     **kw) -> "SparsityPolicy":
        """Copy with knobs rewritten, routing each key to every component
        (policy / metric / schedule / selector) that defines a field of that
        name.  Unknown keys raise unless ``ignore_missing``."""
        top_fields = {f.name for f in dataclasses.fields(self)}
        top = {k: v for k, v in kw.items() if k in top_fields}
        known = set(top)
        final = dict(top)
        for comp_name in ("metric", "schedule", "selector"):
            comp = top.get(comp_name, getattr(self, comp_name))
            fields = {f.name for f in dataclasses.fields(comp)}
            known |= fields
            sub = {k: v for k, v in kw.items() if k in fields}
            if sub:
                final[comp_name] = dataclasses.replace(comp, **sub)
        if not ignore_missing:
            unknown = set(kw) - known
            if unknown:
                raise ValueError(
                    f"with_updates: no component defines {sorted(unknown)}")
        return dataclasses.replace(self, **final) if final else self


# ---------------------------------------------------------------------------
# Registries
# ---------------------------------------------------------------------------

_METRICS: dict = {}
_SCHEDULES: dict = {}
_SELECTORS: dict = {}
_POLICIES: dict = {}


def _register(table: dict, kind: str, name: str, obj, overwrite: bool):
    if not overwrite and name in table:
        raise ValueError(f"{kind} {name!r} already registered")
    table[name] = obj
    return obj


def _lookup(table: dict, kind: str, name: str):
    try:
        return table[name]
    except KeyError:
        raise KeyError(
            f"unknown {kind} {name!r}; registered: {sorted(table)}") from None


def register_metric(name: str, m, *, overwrite: bool = False):
    return _register(_METRICS, "metric", name, m, overwrite)


def get_metric(name: str):
    return _lookup(_METRICS, "metric", name)


def register_schedule(name: str, s, *, overwrite: bool = False):
    return _register(_SCHEDULES, "schedule", name, s, overwrite)


def get_schedule(name: str):
    return _lookup(_SCHEDULES, "schedule", name)


def register_selector(name: str, s, *, overwrite: bool = False):
    return _register(_SELECTORS, "selector", name, s, overwrite)


def get_selector(name: str):
    return _lookup(_SELECTORS, "selector", name)


def register_policy(name: str, policy: SparsityPolicy, *,
                    overwrite: bool = False) -> SparsityPolicy:
    if not policy.name:
        policy = dataclasses.replace(policy, name=name)
    return _register(_POLICIES, "policy", name, policy, overwrite)


def get_policy(name: str) -> SparsityPolicy:
    return _lookup(_POLICIES, "policy", name)


def available_policies() -> tuple:
    return tuple(sorted(_POLICIES))


@functools.lru_cache(maxsize=None)
def policy_from_config(cfg: StemConfig) -> SparsityPolicy:
    """Equivalent policy of a flag record (the ``cfg.policy()`` shim)."""
    if cfg.metric == "oam":
        m: Any = OutputAwareMetric(beta=cfg.beta, pooling=cfg.pooling,
                                   stride=cfg.stride)
    else:
        m = RoutingMetric(pooling=cfg.pooling, stride=cfg.stride)
    return SparsityPolicy(
        metric=m,
        schedule=TPDSchedule(
            k_start_frac=cfg.k_start_frac, mu=cfg.mu,
            min_budget_blocks=cfg.min_budget_blocks,
            sparse_segment=cfg.sparse_segment),
        selector=TopKSelector(sink_blocks=cfg.sink_blocks,
                              local_blocks=cfg.local_blocks),
        block_size=cfg.block_size, group_reduce=cfg.group_reduce,
        executor=cfg.backend, slot_chunk=cfg.slot_chunk, ragged=cfg.ragged,
        name="stem" if cfg.metric == "oam" else "stem-sam")


PolicyLike = Union[SparsityPolicy, StemConfig, str]


def as_policy(obj: PolicyLike) -> SparsityPolicy:
    """Normalize a policy spelling: instance | registered name | StemConfig."""
    if isinstance(obj, SparsityPolicy):
        return obj
    if isinstance(obj, StemConfig):
        return policy_from_config(obj)
    if isinstance(obj, str):
        return get_policy(obj)
    raise TypeError(f"cannot interpret {type(obj).__name__} as a SparsityPolicy")


def as_policy_opt(obj: Optional[PolicyLike]) -> Optional[SparsityPolicy]:
    return None if obj is None else as_policy(obj)


# ---------------------------------------------------------------------------
# Prefill executor registry (one-shot prefill; "fused", "gather" and "dense"
# registered by core/sparse_attention.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ExecutorSpec:
    """One execution backend for a block selection.

    ``fn(q, k, v, sel, *, policy, scale, indices, slot_mask, live_counts,
    dedup, budgets)`` — ``indices``/``slot_mask``/``live_counts`` are the
    (possibly GQA-deduplicated) views of ``sel``; ``budgets`` is the static
    numpy schedule (None = padded execution / threshold selection)."""

    fn: Callable
    needs_block_mask: bool = False


_EXECUTORS: dict = {}


def register_executor(name: str, fn: Callable, *,
                      needs_block_mask: bool = False,
                      overwrite: bool = False) -> ExecutorSpec:
    return _register(_EXECUTORS, "executor", name,
                     ExecutorSpec(fn=fn, needs_block_mask=needs_block_mask),
                     overwrite)


def get_executor(name: str) -> ExecutorSpec:
    """Resolve a prefill backend, importing the module that registers the
    built-in ones."""
    if name not in _EXECUTORS:
        import repro_torch.core.sparse_attention  # noqa: F401 (registers)
    return _lookup(_EXECUTORS, "executor", name)


def available_executors() -> tuple:
    return tuple(sorted(_EXECUTORS))


# ---------------------------------------------------------------------------
# Paged executor registry (serving decode + chunk lanes; "gather" registered
# by runtime/paged.py, "fused" by kernels/paged_attn.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PagedExecutorSpec:
    """One execution backend for the paged serving attention lanes.

    ``decode_fn(q, pool, page_table, cache_lens, policy, budget_frac)`` and
    ``chunk_fn(q, pool, page_table, chunk_start, budgets, policy, k_max)``
    return the attention output and must be selection-identical to the
    "gather" oracle.

    ``sharding`` declares the backend's tensor-parallel contract for mesh
    serving (``sharding/serving.py``; ref ``src/repro/core/policy.py:
    799-834``): "kv-head" means both lanes are independent per KV head —
    they read the head count from the pool and never reduce across heads —
    so a shard's pool slice with its sliced q / k / v gives the full run
    restricted to those heads.  "replicated" marks a backend that must see
    every head; tp > 1 refuses it when the engine is built."""

    decode_fn: Callable
    chunk_fn: Callable
    sharding: str = "kv-head"


_PAGED_EXECUTORS: dict = {}


def register_paged_executor(name: str, *, decode_fn: Callable,
                            chunk_fn: Callable, sharding: str = "kv-head",
                            overwrite: bool = False) -> PagedExecutorSpec:
    if sharding not in ("kv-head", "replicated"):
        raise ValueError(f"sharding must be 'kv-head' or 'replicated', "
                         f"got {sharding!r}")
    return _register(_PAGED_EXECUTORS, "paged executor", name,
                     PagedExecutorSpec(decode_fn=decode_fn, chunk_fn=chunk_fn,
                                       sharding=sharding),
                     overwrite)


def get_paged_executor(name: str) -> PagedExecutorSpec:
    """Resolve a paged backend, importing the module that registers it."""
    if name not in _PAGED_EXECUTORS:
        if name == "fused":
            from repro_torch.kernels import paged_attn  # noqa: F401 (registers)
        elif name == "gather":
            from repro_torch.runtime import paged  # noqa: F401 (registers)
    return _lookup(_PAGED_EXECUTORS, "paged executor", name)


def available_paged_executors() -> tuple:
    return tuple(sorted(_PAGED_EXECUTORS))


# ---------------------------------------------------------------------------
# Built-in registrations (paper defaults: B=128, mu=0.7, beta=0.2, 4+4
# sink/local, floor 54 — rescale with .with_updates for small shapes)
# ---------------------------------------------------------------------------

register_metric("oam", OutputAwareMetric())
register_metric("sam", RoutingMetric())
register_metric("xattention", RoutingMetric())   # alias: antidiag routing
register_metric("streaming", StreamingMetric())

register_schedule("tpd", TPDSchedule())
register_schedule("uniform", UniformSchedule())
register_schedule("dense", DenseSchedule())
register_schedule("sink-local", SinkLocalSchedule())

register_selector("topk", TopKSelector())
register_selector("cumulative-mass", CumulativeMassSelector())

register_policy("stem", SparsityPolicy(
    metric=OutputAwareMetric(), schedule=TPDSchedule(),
    selector=TopKSelector()))
register_policy("stem-sam", SparsityPolicy(
    metric=RoutingMetric(), schedule=TPDSchedule(),
    selector=TopKSelector()))
register_policy("uniform-sam", SparsityPolicy(
    metric=RoutingMetric(), schedule=UniformSchedule(),
    selector=TopKSelector()))
register_policy("uniform-oam", SparsityPolicy(
    metric=OutputAwareMetric(), schedule=UniformSchedule(),
    selector=TopKSelector()))
register_policy("streaming", SparsityPolicy(
    metric=StreamingMetric(), schedule=SinkLocalSchedule(),
    selector=TopKSelector()))
register_policy("xattention", SparsityPolicy(
    metric=RoutingMetric(), schedule=DenseSchedule(),
    selector=CumulativeMassSelector()))
register_policy("dense", SparsityPolicy(
    metric=StreamingMetric(), schedule=DenseSchedule(),
    selector=TopKSelector(sink_blocks=0, local_blocks=0)))
