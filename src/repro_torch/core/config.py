"""Configuration for the Stem sparse-attention module (port of
``repro/core/config.py``).

Defaults follow the paper (Section 3.1): block size B = 128, decay ratio
mu = 0.7, metric coefficient beta = 0.2, 4 sink + 4 local blocks, minimum
per-row budget of 54 blocks, and k_start = 0.2 * N_blk up to 16k tokens /
0.1 * N_blk above.

The one difference from the reference is the executor vocabulary of
``backend``: the port's paged executors are "fused" (the CUDA kernels of
``kernels/paged_attn.py``, the default) and "gather" (the plain PyTorch
gather oracle).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


def default_k_start_fraction(seq_len: int) -> float:
    """Paper §3.1 length-dependent rule: 0.2 up to 16k keys, 0.1 above."""
    return 0.2 if seq_len <= 16384 else 0.1


def k_start_blocks_for(k_start_frac: Optional[float], kv_len: int,
                       block_size: int) -> int:
    """Initial TPD budget in blocks."""
    frac = (default_k_start_fraction(kv_len) if k_start_frac is None
            else k_start_frac)
    n_blocks = -(-kv_len // block_size)
    return max(1, int(frac * n_blocks))


def validate_sparse_segment(seg) -> None:
    """Raise ValueError unless ``seg`` is None or a (lo, hi) number pair
    with 0 <= lo < hi <= 1."""
    if seg is None:
        return
    if not (isinstance(seg, tuple) and len(seg) == 2):
        raise ValueError(f"sparse_segment must be a (lo, hi) 2-tuple, got {seg!r}")
    lo, hi = seg
    try:
        lo, hi = float(lo), float(hi)
    except (TypeError, ValueError):
        raise ValueError(f"sparse_segment entries must be numbers, got {seg!r}")
    if not (0.0 <= lo < hi <= 1.0):
        raise ValueError(f"sparse_segment needs 0 <= lo < hi <= 1, got {seg!r}")


@dataclasses.dataclass(frozen=True)
class StemConfig:
    """Hyper-parameters of Stem (Token Position-Decay + Output-Aware Metric).

    The frozen flag record; ``cfg.policy()`` converts it into the equivalent
    :class:`repro_torch.core.policy.SparsityPolicy` (OAM/SAM metric x TPD
    schedule x top-k selector).  Field meanings are those of the reference
    ``StemConfig``; ``backend`` names a paged executor ("fused" | "gather").
    """

    block_size: int = 128
    k_start_frac: Optional[float] = None
    mu: float = 0.7
    beta: float = 0.2
    stride: int = 16
    sink_blocks: int = 4
    local_blocks: int = 4
    min_budget_blocks: int = 54
    pooling: str = "antidiag"
    metric: str = "oam"
    group_reduce: str = "none"
    backend: str = "fused"
    slot_chunk: int = 8
    ragged: bool = True
    sparse_segment: Optional[tuple] = None

    def __post_init__(self) -> None:
        if not (0.0 < self.mu <= 1.0):
            raise ValueError(f"mu must be in (0, 1], got {self.mu}")
        if self.beta < 0.0:
            raise ValueError(f"beta must be >= 0, got {self.beta}")
        if self.block_size <= 0 or self.block_size % 8 != 0:
            raise ValueError(f"block_size must be a positive multiple of 8, got {self.block_size}")
        if self.stride <= 0 or self.block_size % self.stride != 0:
            raise ValueError("stride must divide block_size")
        if self.pooling not in ("antidiag", "mean"):
            raise ValueError(f"unknown pooling {self.pooling!r}")
        if self.metric not in ("oam", "sam"):
            raise ValueError(f"unknown metric {self.metric!r}")
        if self.group_reduce not in ("none", "mean", "max"):
            raise ValueError(f"unknown group_reduce {self.group_reduce!r}")
        if self.backend not in ("fused", "gather"):
            raise ValueError(f"unknown backend {self.backend!r}")
        validate_sparse_segment(self.sparse_segment)

    def policy(self):
        """The equivalent :class:`repro_torch.core.policy.SparsityPolicy`."""
        from repro_torch.core import policy as policy_lib  # deferred: avoid cycle

        return policy_lib.policy_from_config(self)

    def k_start_fraction(self, seq_len: int) -> float:
        if self.k_start_frac is not None:
            return self.k_start_frac
        return default_k_start_fraction(seq_len)

    def k_start_blocks(self, seq_len: int) -> int:
        return k_start_blocks_for(self.k_start_frac, seq_len, self.block_size)


def uniform_equivalent_budget(k_start: int, mu: float) -> int:
    """Budget-matched uniform equivalent (paper Table 5):
    k_uni ~= k_start * (1 + mu) / 2."""
    return max(1, int(round(k_start * (1.0 + mu) / 2.0)))
