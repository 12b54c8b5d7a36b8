"""Plain PyTorch versions of the one-shot prefill kernels under the
reference's names (port of ``repro/kernels/ref.py``).  Each is the plain
version that sits beside its kernel; the kernels are tested against them."""
from __future__ import annotations

import torch

from repro_torch.kernels import block_sparse_attn as _bsa
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import stem_metric as _sm


def flash_attention_ref(q, k, v, scale=None):
    """Dense causal attention (GQA).  q: (b, hq, n, d), k/v: (b, hk, n, d)."""
    return _fa.flash_attention_plain(q, k, v, scale=scale)


def block_sparse_attention_ref(q, k, v, indices, slot_mask, *, block_size: int,
                               scale=None):
    """Attention over the selection's blocks; indices/slot_mask per query
    head (b, hq, nq, k_max) with live slots a prefix of each row."""
    return _bsa.block_sparse_attention_plain(
        q, k, v, indices, slot_mask.sum(dim=-1, dtype=torch.int32),
        block_size=block_size, scale=scale)


def antidiag_pool_ref(x, block_size: int, stride: int):
    """(..., n, d) -> (..., nb, stride, d) float32 group means."""
    return _sm.antidiag_pool_plain(x, block_size=block_size, stride=stride)


def value_magnitude_ref(v, block_size: int):
    """(..., n, d) -> (..., nb) block max of log ||V||_2."""
    return _sm.value_magnitude_plain(v, block_size=block_size)
