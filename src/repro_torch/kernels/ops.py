"""Public wrappers of the one-shot prefill kernels (port of
``repro/kernels/ops.py``): a thin dispatch to the kernel modules, whose
wrappers launch the CUDA kernel for a CUDA tensor and take the plain
PyTorch version for a CPU tensor."""
from __future__ import annotations

import torch

from repro_torch.kernels import block_sparse_attn as _bsa
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import stem_metric as _sm


def flash_attention(q, k, v, *, scale=None):
    return _fa.flash_attention(q, k, v, scale=scale)


def block_sparse_attention(q, k, v, indices, slot_mask, *, block_size=128,
                           scale=None, group_dedup=False, live_counts=None):
    return _bsa.block_sparse_attention(
        q, k, v, indices, slot_mask, block_size=block_size, scale=scale,
        group_dedup=group_dedup, live_counts=live_counts)


def antidiag_pool(x, *, block_size=128, stride=16, out_dtype=torch.float32):
    return _sm.antidiag_pool(x, block_size=block_size, stride=stride,
                             out_dtype=out_dtype)


def value_magnitude(v, *, block_size=128):
    return _sm.value_magnitude(v, block_size=block_size)
