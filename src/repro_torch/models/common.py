"""Shared model building blocks (port of ``repro/models/common.py``: the
initializer, norm, rope, embedding and tied head, cross entropy and the
contiguous KV-cache write; the ring cache of windowed attention is not
ported yet).

Parameters are nested dicts of tensors with the reference's tree layout.
``Initializer`` draws them from an explicit ``torch.Generator`` with the
reference's shapes and scales (normal / sqrt(fan_in), fan_in = the product
of all but the last dimension); JAX and PyTorch give different numbers from
one seed, so tests carry the JAX weights across with ``weights.py``.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch


class Initializer:
    """Draws parameters from one generator on one device."""

    def __init__(self, generator: torch.Generator, dtype: torch.dtype,
                 device):
        self.generator = generator
        self.dtype = dtype
        self.device = torch.device(device)

    def normal(self, shape: Sequence[int], scale: float | None = None,
               dtype=None) -> torch.Tensor:
        fan_in = max(int(math.prod(shape[:-1])) or shape[-1], 1)
        scale = (1.0 / math.sqrt(fan_in)) if scale is None else scale
        v = torch.randn(tuple(shape), generator=self.generator,
                        dtype=torch.float32, device=self.device) * scale
        return v.to(dtype or self.dtype)

    def zeros(self, shape: Sequence[int], dtype=None) -> torch.Tensor:
        return torch.zeros(tuple(shape), dtype=dtype or self.dtype,
                           device=self.device)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32 with scale ``1 + w`` (``w`` initialised to zero)."""
    dtype = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + weight.float())).to(dtype)


def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Interleaved rotary embedding (pairs ``0::2`` / ``1::2``).

    x: (..., seq, head_dim); positions: (seq,) or (batch, seq)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    angles = positions[..., :, None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    while cos.ndim < x.ndim:
        cos, sin = cos[..., None, :, :], sin[..., None, :, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    out = torch.stack([y1, y2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


def embed_init(ini: Initializer, vocab: int, d_model: int) -> torch.Tensor:
    return ini.normal((vocab, d_model), scale=0.02, dtype=torch.float32)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 dtype=torch.bfloat16) -> torch.Tensor:
    return table[tokens.long()].to(dtype)


def lm_logits(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Tied LM head in float32: (b, s, d) @ (vocab, d)^T -> (b, s, vocab)."""
    return torch.einsum("bsd,vd->bsv", x.float(), table.float())


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token CE over unmasked positions, fp32 logsumexp."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.take_along_dim(logits, labels.long()[..., None], dim=-1)[..., 0]
    nll = lse - tgt
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def update_cache(cache_k: torch.Tensor, cache_v: torch.Tensor,
                 pos: torch.Tensor, new_k: torch.Tensor, new_v: torch.Tensor):
    """Write one step at position ``pos`` into the cache, in place, and
    return it.  cache: (b, hk, L, d) (a view of the stacked caches);
    new: (b, hk, 1, d).  ``pos`` is a scalar (uniform batch) or a ``(b,)``
    vector (ragged batch — every row writes at its own length)."""
    if pos.ndim == 0:
        idx = pos.reshape(1).long()
        cache_k.index_copy_(2, idx, new_k.to(cache_k.dtype))
        cache_v.index_copy_(2, idx, new_v.to(cache_v.dtype))
        return cache_k, cache_v
    bidx = torch.arange(cache_k.shape[0], device=cache_k.device)
    cache_k[bidx, :, pos.long()] = new_k[:, :, 0].to(cache_k.dtype)
    cache_v[bidx, :, pos.long()] = new_v[:, :, 0].to(cache_v.dtype)
    return cache_k, cache_v
