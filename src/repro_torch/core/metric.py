"""Output-Aware Metric pieces used by paged serving (port of
``repro/core/metric.py``).

Anti-diagonal group-mean pooling, block max-pooled value magnitude, and the
chunk / decode routing scores read off pooled page summaries.  Shapes use
the (batch, heads, seq, head_dim) convention.
"""
from __future__ import annotations

import torch


def _check_divisible(seq_len: int, block_size: int) -> int:
    if seq_len % block_size != 0:
        raise ValueError(f"seq_len {seq_len} must be a multiple of block_size {block_size}")
    return seq_len // block_size


def _f32_scale(x: torch.Tensor, s: int, head_dim: int) -> torch.Tensor:
    """``s * sqrt(head_dim)`` computed in float32, as the reference does."""
    return s * torch.sqrt(torch.tensor(float(head_dim), dtype=torch.float32,
                                       device=x.device))


def antidiag_pool(x: torch.Tensor, block_size: int, stride: int) -> torch.Tensor:
    """(..., seq, dim) -> (..., n_blocks, stride, dim): group u holds the mean
    of the rows whose within-block position is congruent to u (mod s)."""
    *lead, seq, dim = x.shape
    n_blocks = _check_divisible(seq, block_size)
    per_group = block_size // stride
    xb = x.reshape(*lead, n_blocks, per_group, stride, dim)
    return xb.mean(dim=-3)


def mean_pool(x: torch.Tensor, block_size: int) -> torch.Tensor:
    """Plain block mean pooling: (..., seq, dim) -> (..., n_blocks, dim)."""
    *lead, seq, dim = x.shape
    n_blocks = _check_divisible(seq, block_size)
    return x.reshape(*lead, n_blocks, block_size, dim).mean(dim=-2)


def antidiag_routing_scores(q_pooled: torch.Tensor, k_pooled: torch.Tensor,
                            head_dim: int) -> torch.Tensor:
    """(..., nq, s, d) x (..., nk, s, d) -> (..., nq, nk): group u of Q is
    paired with group (s - u) mod s of K."""
    s = q_pooled.shape[-2]
    pair = (s - torch.arange(s, device=k_pooled.device)) % s
    k_matched = k_pooled.index_select(-2, pair)
    scores = torch.einsum("...iud,...jud->...ij", q_pooled, k_matched)
    return scores / _f32_scale(scores, s, head_dim).to(scores.dtype)


def mean_routing_scores(q_pooled: torch.Tensor, k_pooled: torch.Tensor,
                        head_dim: int) -> torch.Tensor:
    """Blockwise routing from plain mean pooling: (..., nq, nk)."""
    scores = torch.einsum("...id,...jd->...ij", q_pooled, k_pooled)
    return scores / _f32_scale(scores, 1, head_dim).to(scores.dtype)


def value_block_magnitude(v: torch.Tensor, block_size: int) -> torch.Tensor:
    """M_V: block max-pool of log ||V_j||_2: (..., seq, dim) -> (..., n_blocks)
    float32."""
    *lead, seq, dim = v.shape
    n_blocks = _check_divisible(seq, block_size)
    norms = torch.linalg.vector_norm(v.float(), dim=-1)
    log_norms = torch.log(torch.clamp(norms, min=1e-20))
    return log_norms.reshape(*lead, n_blocks, block_size).amax(dim=-1)


def chunk_routing_scores(q: torch.Tensor, k_groups: torch.Tensor, *,
                         block_size: int, pooling: str = "antidiag") -> torch.Tensor:
    """Routing scores of a chunk of queries against pooled key summaries.

    q: (b, hq, C, d) with C % block_size == 0; k_groups: (b, hk, n, s, d).
    Returns (b, hq, nc, n)."""
    b, hq, c, d = q.shape
    hk = k_groups.shape[1]
    if hq % hk != 0:
        raise ValueError(f"q_heads {hq} not a multiple of kv_heads {hk}")
    group = hq // hk
    stride = k_groups.shape[-2]
    qp = antidiag_pool(q, block_size, stride)               # (b, hq, nc, s, d)
    kp = torch.repeat_interleave(k_groups, group, dim=1)    # (b, hq, n, s, d)
    if pooling == "antidiag":
        return antidiag_routing_scores(qp, kp, d)
    return mean_routing_scores(qp.mean(dim=-2), kp.mean(dim=-2), d)


def decode_routing_scores(q: torch.Tensor, k_groups: torch.Tensor) -> torch.Tensor:
    """One decode query per sequence vs anti-diag group means.

    q: (b, hq, 1, d); k_groups: (b, hk, n, s, d).  Returns (b, hk, g, n) f32."""
    b, hq, _, d = q.shape
    hk = k_groups.shape[1]
    group = hq // hk
    qg = q.reshape(b, hk, group, 1, d).float()
    kg = k_groups.float()
    route = torch.einsum("bhgqd,bhnsd->bhgqn", qg, kg) / _f32_scale(
        kg, kg.shape[-2], d)
    return route[:, :, :, 0]


def group_reduce_metric(metric: torch.Tensor, group: int, mode: str) -> torch.Tensor:
    """Optionally share the metric across the query heads of a KV group.
    metric: (b, hq, nq, nk); mode "none" | "mean" | "max"."""
    if mode == "none" or group == 1:
        return metric
    b, hq, nq, nk = metric.shape
    g = metric.reshape(b, hq // group, group, nq, nk)
    red = g.mean(dim=2) if mode == "mean" else g.amax(dim=2)
    return torch.repeat_interleave(red, group, dim=1)
