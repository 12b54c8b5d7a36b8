"""The attention kernels' work, counted: the formulas ``PERF.md``'s kernel
table bounds each kernel with (``chip_smoke.py`` imports them), and the
hook through which a kernel's shape-only path on ``meta`` tensors and the
training mesh's collectives report to a counter (``launch/cost_analysis.py``).

Bytes count each input read once and each output written once; flops are
2 a multiply-add.  The rates are the H100 SXM data sheet's, not
measurements.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

HBM_BYTES_S = 3.35e12        # H100 SXM data sheet
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}


def bound(nbytes: float, flops: float, dtype) -> tuple:
    """(ms, "bytes" | "operations"): the larger of the bytes over the
    memory rate and the flops over ``dtype``'s peak."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def causal_pairs(idx, cnt, bs) -> float:
    """(query, key) pairs the live selected blocks hold under the causal
    mask: B*B below the diagonal, B*(B+1)/2 on it."""
    live = torch.arange(idx.shape[-1], device=idx.device) < cnt[..., None].long()
    rows = torch.arange(idx.shape[2], device=idx.device)[None, None, :, None]
    diag = (idx.long() == rows) & live
    below = (idx.long() < rows) & live
    return float(below.sum()) * bs * bs + float(diag.sum()) * bs * (bs + 1) / 2


def bsa_bytes_flops(q, k, idx, cnt, group, dedup, bs, dv=None):
    """Bytes (q read, the output written at v's head dim dv, each selected
    K / V block read once, the selection) and flops (2 * (d + dv) a causal
    pair) of one block-sparse call; dv defaults to q's head dim."""
    d, es = q.shape[-1], q.element_size()
    dv = d if dv is None else dv
    hsel = idx.shape[1]
    live = torch.arange(idx.shape[-1], device=idx.device) < cnt[..., None].long()
    kvh = (torch.arange(hsel, device=idx.device) // (1 if dedup else group))
    key = (kvh[None, :, None, None].expand_as(idx).long() << 32) | idx.long()
    blocks = int(torch.unique(key[live]).numel())
    nbytes = (q.numel() * (d + dv) // d * es + blocks * bs * (d + dv) * es
              + (idx.numel() + cnt.numel()) * 4)
    heads = group if dedup else 1
    return nbytes, 2.0 * (d + dv) * causal_pairs(idx, cnt, bs) * heads


def flash_bytes_flops(q, k, v) -> tuple:
    """One causal flash call: q, k, v read and the output written once;
    2 * (d + dv) flops a causal pair, b * hq * n (n + 1) / 2 pairs."""
    b, hq, n, d = q.shape
    dv, es = v.shape[-1], q.element_size()
    nbytes = (q.numel() + q.numel() * dv // d + k.numel() + v.numel()) * es
    return nbytes, 2.0 * (d + dv) * b * hq * n * (n + 1) / 2


def bwd_bytes_flops(q, k, v, pairs: float, extra_bytes: float = 0.0, part: str = "both"):
    """Bytes and flops of one attention backward, or of one of its two
    kernels.  Both: q, k, v, o, do and the lse read once, dq, dk, dv
    written once; S, dP, dV, dK, dQ, 2 * (3 d + 2 dv) flops a causal pair.
    "dq": q, k, v, o, do, lse read, dq and delta written; S, dP, dQ (2 *
    (2 d + dv)).  "dkdv": q, k, v, do, lse, delta read, dk and dv written;
    S, dP, dV, dK (2 * (2 d + 2 dv))."""
    es, d, dv = q.element_size(), q.shape[-1], v.shape[-1]
    rows = q.numel() // d * 4                      # one fp32 a query row
    qo = q.numel() * dv // d * es                  # o or do
    kv = (k.numel() + v.numel()) * es
    if part == "dq":
        return 2 * q.numel() * es + kv + 2 * qo + 2 * rows + extra_bytes, \
            2.0 * (2 * d + dv) * pairs
    if part == "dkdv":
        return q.numel() * es + 2 * kv + qo + 2 * rows + extra_bytes, \
            2.0 * (2 * d + 2 * dv) * pairs
    return 2 * (q.numel() * es + kv + qo) + rows + extra_bytes, 2.0 * (3 * d + 2 * dv) * pairs


def pool_bytes_flops(x, out) -> tuple:
    """Anti-diagonal pooling: x read, the means written; one add an input
    element."""
    return x.numel() * x.element_size() + out.numel() * out.element_size(), float(x.numel())


def vmag_bytes_flops(v, out) -> tuple:
    """Value magnitude: v read, the fp32 block maxima written; a multiply
    and an add an input element."""
    return v.numel() * v.element_size() + out.numel() * 4, 2.0 * v.numel()


def budget_pairs(counts, bs: int, rows: int) -> float:
    """The causal pairs of ``rows`` selection rows (batch x heads) whose
    query-block rows keep ``counts`` (numpy) live blocks, the diagonal one
    among them: (count - 1) B^2 + B (B + 1) / 2 a row of a live block."""
    c = np.asarray(counts, dtype=np.float64)
    c = c[c > 0]
    return float(rows * ((c - 1) * bs * bs + bs * (bs + 1) / 2).sum())


def selected_pairs_bound(idx, bs: int) -> float:
    """The causal pairs a block-sparse call's selection can hold at most,
    from its shape alone: every slot live and below the diagonal (a
    selection's data is not known on ``meta`` tensors)."""
    return float(idx.numel()) * bs * bs


# ---------------------------------------------------------------------------
# The counter hook
# ---------------------------------------------------------------------------

_TALLY = [None]


def tally():
    """The active counter (``launch/cost_analysis.CostMode``), or None."""
    return _TALLY[0]


@contextlib.contextmanager
def counting(counter):
    """Report kernel calls and collectives to ``counter`` while the block
    runs: ``counter.kernel(name, flops, nbytes, heads, like)`` and
    ``counter.collective(kind, nbytes, coord)``."""
    prev = _TALLY[0]
    _TALLY[0] = counter
    try:
        yield counter
    finally:
        _TALLY[0] = prev


def note_kernel(name: str, nbytes: float, flops: float, like: torch.Tensor,
                pairs=None) -> None:
    """A kernel's shape-only call on ``meta`` tensors: its work and the
    query heads it was given (``like``: its first input, whose
    coordinate the counter knows); ``pairs`` (rule, count): the causal
    pairs of a block-sparse call and the rule that counted them, "budgets"
    or "bound", for a counter with a ``kernel_pairs`` method."""
    if _TALLY[0] is not None:
        heads = like.shape[1] if like.dim() == 4 else None
        _TALLY[0].kernel(name, float(flops), float(nbytes), heads, like)
        if pairs is not None and hasattr(_TALLY[0], "kernel_pairs"):
            _TALLY[0].kernel_pairs(pairs[0], float(pairs[1]), like)


def note_collective(kind: str, nbytes: float, coord) -> None:
    """``nbytes`` moved by mesh coordinate ``coord`` in a collective of
    ``kind``."""
    if _TALLY[0] is not None:
        _TALLY[0].collective(kind, float(nbytes), coord)
