"""Shared model building blocks (port of ``repro/models/common.py``: the
initializer, the RMS and layer norms, rope and sinusoidal positions, the
embedding and tied head, cross entropy, and the contiguous and ring
KV-cache writes).

Parameters are nested dicts of tensors with the reference's tree layout.
``Initializer`` draws them from an explicit ``torch.Generator`` with the
reference's shapes and scales (normal / sqrt(fan_in), fan_in = the product
of all but the last dimension); JAX and PyTorch give different numbers from
one seed, so tests carry the JAX weights across with ``weights.py``.

Vocab-parallel embedding, logits and CE: inside
``sharding.context.model_parallel``, a table whose vocab dim is split over
the model axis (``sharding.arrays.ModelShards``) is read by each model
shard for the ids in its range, zero elsewhere, and summed; the logits stay
in per-shard vocab blocks (``VocabShards``: no device holds the ``(b, s,
vocab)`` logits), and ``cross_entropy`` reduces each row's max, sum of
exponentials and target logit across the shards in fp32, in rank order.

Every
leaf is drawn with the reference's tuple of *logical* axis names
(``sharding/rules.py`` maps them to mesh axes); the initializer keeps each
leaf's axes beside it, so ``axes_tree`` gives the reference's axes tree
while the parameter tree itself stays plain tensors.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

from repro_torch.kernels import cost as cost_lib
from repro_torch.sharding import arrays
from repro_torch.sharding import context as shctx


# The largest fp32 temporary one draw allocates; a larger leaf is drawn in
# slices along its leading axis (an arctic-480b expert table is 17.8 GB in
# fp32).
DRAW_BYTES = 1 << 30


class Initializer:
    """Draws parameters from one generator on one device.

    Inside ``stacked(n, build)`` every leaf gains a leading layer axis: the
    first of ``n`` calls of ``build`` allocates each leaf at its stacked
    shape and fills layer 0, and the later calls fill layers 1.. of the
    same tensors in the same order, so no per-layer copy of a tree is ever
    alive beside the stacked one."""

    def __init__(self, generator: torch.Generator, dtype: torch.dtype,
                 device):
        self.generator = generator
        self.dtype = dtype
        self.device = torch.device(device)
        self._layers = 0            # n inside stacked(), else 0
        self._empty = False         # stacked(0): leaves of no layer
        self._layer = 0
        self._leaves: list = []
        self._slot = 0
        self._axes: dict = {}       # id(leaf) -> its logical axes

    def stacked(self, n: int, build):
        """``build()``'s tree with every leaf stacked ``(n, ...)``, drawn
        layer by layer.  At n = 0 (a MoE config cut to its first_k_dense
        layers) every leaf is an empty ``(0, ...)`` stack, as the
        reference's."""
        self._layers, self._leaves = max(n, 1), []
        self._empty = n == 0
        try:
            for layer in range(max(n, 1)):
                self._layer, self._slot = layer, 0
                tree = build()
        finally:
            self._layers, self._leaves, self._empty = 0, [], False
        return tree

    def axes_tree(self, tree):
        """The logical axes of every leaf of ``tree`` (drawn by this
        initializer): a stacked leaf's start with ``"layers"``."""
        if isinstance(tree, dict):
            return {k: self.axes_tree(v) for k, v in tree.items()}
        return self._axes[id(tree)]

    def _leaf(self, shape, axes, dtype, fill) -> torch.Tensor:
        """The tensor of the next leaf and the part this call fills."""
        axes = tuple(axes)
        if len(axes) != len(shape):
            raise ValueError(f"axes {axes} do not name the dims of {tuple(shape)}")
        if not self._layers:
            out = torch.empty(tuple(shape), dtype=dtype, device=self.device)
            fill(out)
            self._axes[id(out)] = axes
            return out
        if self._layer == 0:
            self._leaves.append(torch.empty((0 if self._empty else self._layers, *shape),
                                            dtype=dtype, device=self.device))
            self._axes[id(self._leaves[-1])] = ("layers",) + axes
        out = self._leaves[self._slot]
        self._slot += 1
        if not self._empty:
            fill(out[self._layer])
        return out

    def _fill_normal(self, dst: torch.Tensor, scale: float) -> None:
        """normal * scale in fp32, cast into ``dst``: one draw of the whole
        shape when its fp32 temporary fits ``DRAW_BYTES``, else slices of
        the leading axis."""
        step = dst.shape[0]
        if dst.numel() * 4 > DRAW_BYTES and dst.ndim > 1:
            step = max(1, DRAW_BYTES // (4 * dst[0].numel()))
        for i in range(0, dst.shape[0], step):
            part = dst[i:i + step]
            part.copy_(torch.randn(part.shape, generator=self.generator,
                                   dtype=torch.float32,
                                   device=self.device).mul_(scale))

    def normal(self, shape: Sequence[int], axes, scale: float | None = None,
               dtype=None) -> torch.Tensor:
        """normal / sqrt(fan_in), fan_in = the product of all but the last
        dimension of ``shape`` (the whole per-layer shape, whatever the
        slices a large leaf is drawn in)."""
        fan_in = max(int(math.prod(shape[:-1])) or shape[-1], 1)
        scale = (1.0 / math.sqrt(fan_in)) if scale is None else scale
        return self._leaf(shape, axes, dtype or self.dtype,
                          lambda dst: self._fill_normal(dst, scale))

    def zeros(self, shape: Sequence[int], axes, dtype=None) -> torch.Tensor:
        return self._leaf(shape, axes, dtype or self.dtype, lambda dst: dst.zero_())

    def ones(self, shape: Sequence[int], axes, dtype=None) -> torch.Tensor:
        return self._leaf(shape, axes, dtype or self.dtype, lambda dst: dst.fill_(1))

    def value(self, v: torch.Tensor, axes) -> torch.Tensor:
        """A leaf holding ``v`` (its shape and dtype; every layer alike)."""
        return self._leaf(v.shape, axes, v.dtype, lambda dst: dst.copy_(v))


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in float32 with scale ``1 + w`` (``w`` initialised to zero)."""
    dtype = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + weight.float())).to(dtype)


def layer_norm_simple(x: torch.Tensor, weight: torch.Tensor,
                      eps: float = 1e-5) -> torch.Tensor:
    """Bias-free LayerNorm in float32 with scale ``1 + w`` (whisper's
    layers)."""
    dtype = x.dtype
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * (1.0 + weight.float())).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(dtype)


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


def sinusoidal_positions(length: int, dim: int, device="cuda") -> torch.Tensor:
    """(length, dim) fp32: sines of the first dim / 2 frequencies, then
    their cosines."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    inv = torch.exp(-torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * (math.log(10000.0) / dim))
    ang = pos * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def embed_init(ini: Initializer, vocab: int, d_model: int) -> torch.Tensor:
    return ini.normal((vocab, d_model), ("vocab", "embed"), scale=0.02,
                      dtype=torch.float32)


class VocabShards:
    """Logits in vocab blocks: ``parts[t]`` (b, s, hi - lo) fp32 on model
    shard ``t``'s device, ``bounds[t]`` = (lo, hi), over ``mp``'s shards."""

    def __init__(self, parts: list, bounds: list, mp):
        self.parts, self.bounds, self.mp = parts, bounds, mp


def embed_lookup(table, tokens: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    if isinstance(table, arrays.ModelShards):
        mp = shctx.model_parallel_state()
        ids = arrays.to_model_shards(tokens, mp)
        parts = []
        for t, (lo, hi) in enumerate(table.bounds):
            with mp.on(t):
                local = ids[t].long() - lo
                hit = (local >= 0) & (local < hi - lo)
                rows = table.parts[t][torch.where(hit, local, 0)]
                parts.append(torch.where(hit[..., None], rows, 0.0))
        return arrays.reduce_from_model_shards(parts, mp, torch.float32).to(dtype)
    return table[tokens.long()].to(dtype)


def head_logits(x: torch.Tensor, head, equation: str):
    """fp32 ``einsum(equation, x, head)`` over the vocab dim of ``head``: a
    tensor, or its ``ModelShards`` (then ``VocabShards``)."""
    if not isinstance(head, arrays.ModelShards):
        return torch.einsum(equation, x.float(), head.float())
    mp = shctx.model_parallel_state()
    xs = arrays.to_model_shards(x, mp)
    parts = []
    for t in range(mp.tp):
        with mp.on(t):
            parts.append(torch.einsum(equation, xs[t].float(), head.parts[t].float()))
    return VocabShards(parts, head.bounds, mp)


def lm_logits(x: torch.Tensor, table):
    """Tied LM head in float32: (b, s, d) @ (vocab, d)^T -> (b, s, vocab)."""
    return head_logits(x, table, "bsd,vd->bsv")


def _vocab_parallel_nll(logits: VocabShards, labels: torch.Tensor) -> torch.Tensor:
    """Each row's lse - target logit, its max, sum of exponentials and
    target reduced across the vocab blocks in rank order in fp32, on the
    lead shard."""
    mp = logits.mp
    lead = mp.devices[0]
    ids = arrays.to_model_shards(labels, mp)
    maxes = []
    for t, part in enumerate(logits.parts):
        with mp.on(t):
            maxes.append(part.detach().amax(dim=-1))
    with mp.on(0):
        row_max = maxes[0]
        for t, m in enumerate(maxes):
            cost_lib.note_collective("reduce", m.numel() * 4, mp.coords[t])
            row_max = row_max if t == 0 else torch.maximum(row_max, m.to(lead))
    row_maxes = arrays.to_model_shards(row_max, mp)
    sums, tgts = [], []
    for t, (part, (lo, hi)) in enumerate(zip(logits.parts, logits.bounds)):
        with mp.on(t):
            sums.append(torch.exp(part - row_maxes[t][..., None]).sum(dim=-1))
            local = ids[t].long() - lo
            hit = (local >= 0) & (local < hi - lo)
            got = torch.take_along_dim(part, torch.where(hit, local, 0)[..., None],
                                       dim=-1)[..., 0]
            tgts.append(torch.where(hit, got, 0.0))
    total = arrays.reduce_from_model_shards(sums, mp, torch.float32)
    tgt = arrays.reduce_from_model_shards(tgts, mp, torch.float32)
    return torch.log(total) + row_max - tgt


def cross_entropy(logits, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token CE over unmasked positions, fp32 logsumexp (of
    ``VocabShards`` logits: vocab-parallel).  Inside
    ``sharding.context.data_parallel`` over several shards the mean is the
    global batch's: this shard's sum over the global count."""
    if isinstance(logits, VocabShards) and len(logits.parts) > 1:
        nll = _vocab_parallel_nll(logits, labels)
    else:
        if isinstance(logits, VocabShards):       # one shard holds every row
            logits = logits.parts[0]
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        tgt = torch.take_along_dim(logits, labels.long()[..., None], dim=-1)[..., 0]
        nll = lse - tgt
    dp = shctx.data_parallel_state()
    if dp is not None and dp.n_shards > 1:
        if mask is None:
            return nll.sum() / (nll.numel() * dp.n_shards)
        total = torch.as_tensor(dp.mask_total, dtype=torch.float32, device=nll.device)
        return (nll * mask.float()).sum() / torch.clamp(total, min=1.0)
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


def update_ring_cache(cache_k: torch.Tensor, cache_v: torch.Tensor,
                      pos: torch.Tensor, new_k: torch.Tensor,
                      new_v: torch.Tensor, window: int):
    """Ring-buffer write of windowed attention, in place: position ``pos``
    lands in slot ``pos % window`` (O(window) memory at any length).
    ``pos`` scalar or (b,), as in ``update_cache``."""
    return update_cache(cache_k, cache_v, pos % window, new_k, new_v)
