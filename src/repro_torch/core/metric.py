"""Output-Aware Metric (OAM) and block-wise metric downsampling (port of
``repro/core/metric.py``).

Anti-diagonal group-mean pooling, block max-pooled value magnitude, the
one-shot prefill's blockwise routing scores and OAM metric (Eq. 7), and the
chunk / decode routing scores read off pooled page summaries.  Shapes use
the (batch, heads, seq, head_dim) convention.

``antidiag_pool`` and ``value_block_magnitude`` run through the metric
kernels of ``kernels/stem_metric.py`` (CUDA on a CUDA tensor, their plain
versions on the CPU), and every pooling of the port goes through them: the
one-shot prefill metric (``blockwise_routing_scores``, ``oam_scores``), the
page summaries of both serving lanes' pool writes, and the chunk scorer's
query pooling (``kernels/paged_attn.chunk_page_scores``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import stem_metric as metric_kernels


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
    of the rows whose within-block position is congruent to u (mod s),
    summed in fp32 and rounded to x's dtype as the reference's mean keeps it
    (the pool kernel)."""
    _check_divisible(x.shape[-2], block_size)
    return metric_kernels.antidiag_pool(x.contiguous(), block_size=block_size,
                                        stride=stride, out_dtype=x.dtype)


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
    dt = torch.promote_types(q_pooled.dtype, k_pooled.dtype)
    scores = torch.einsum("...iud,...jud->...ij", q_pooled.to(dt), k_matched.to(dt))
    return scores / _f32_scale(scores, s, head_dim).to(scores.dtype)


def mean_routing_scores(q_pooled: torch.Tensor, k_pooled: torch.Tensor,
                        head_dim: int) -> torch.Tensor:
    """Blockwise routing from plain mean pooling: (..., nq, nk)."""
    dt = torch.promote_types(q_pooled.dtype, k_pooled.dtype)
    scores = torch.einsum("...id,...jd->...ij", q_pooled.to(dt), k_pooled.to(dt))
    return scores / _f32_scale(scores, 1, head_dim).to(scores.dtype)


def value_block_magnitude(v: torch.Tensor, block_size: int) -> torch.Tensor:
    """M_V: block max-pool of log ||V_j||_2: (..., seq, dim) -> (..., n_blocks)
    float32 (the value-magnitude kernel)."""
    _check_divisible(v.shape[-2], block_size)
    return metric_kernels.value_magnitude(v.contiguous(), block_size=block_size)


def blockwise_routing_scores(q: torch.Tensor, k: torch.Tensor, *,
                             block_size: int, stride: int,
                             pooling: str = "antidiag") -> torch.Tensor:
    """Downsampled routing scores between all (query block, key block)
    pairs.  q: (b, hq, sq, d); k: (b, hk, sk, d).  Returns (b, hq, nq, nk)."""
    d = q.shape[-1]
    hq, hk = q.shape[1], k.shape[1]
    if hq % hk != 0:
        raise ValueError(f"q_heads {hq} not a multiple of kv_heads {hk}")
    group = hq // hk
    if pooling == "antidiag":
        qp = antidiag_pool(q, block_size, stride)             # (b, hq, nq, s, d)
        kp = torch.repeat_interleave(antidiag_pool(k, block_size, stride),
                                     group, dim=1)
        return antidiag_routing_scores(qp, kp, d)
    qp = mean_pool(q, block_size)
    kp = torch.repeat_interleave(mean_pool(k, block_size), group, dim=1)
    return mean_routing_scores(qp, kp, d)


def routing_scores(q: torch.Tensor, k: torch.Tensor, cfg) -> torch.Tensor:
    """Flag-record (``StemConfig``) wrapper over ``blockwise_routing_scores``."""
    return blockwise_routing_scores(q, k, block_size=cfg.block_size,
                                    stride=cfg.stride, pooling=cfg.pooling)


def oam_scores(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               block_size: int, stride: int, pooling: str = "antidiag",
               beta: float = 0.2) -> torch.Tensor:
    """Coarse metric of Eq. (7): routing scores + beta * max(0, M_V).
    ``beta = 0`` is the routing-only SAM.  Returns (b, hq, nq, nk)."""
    route = blockwise_routing_scores(q, k, block_size=block_size,
                                     stride=stride, pooling=pooling)
    if beta == 0.0:
        return route
    group = q.shape[1] // k.shape[1]
    mv = torch.repeat_interleave(value_block_magnitude(v, block_size),
                                 group, dim=1)                # (b, hq, nk)
    mag = torch.clamp(mv, min=0.0).to(route.dtype)
    return route + beta * mag[..., None, :]


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
