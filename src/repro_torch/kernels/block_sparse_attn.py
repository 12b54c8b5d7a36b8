"""Stem block-sparse causal attention: the executor of the one-shot Stem
prefill (port of ``repro/kernels/block_sparse_attn.py``).

``block_sparse_attention`` launches a hand-written CUDA kernel for
``sm_90a`` (``csrc/block_sparse_attn.cu``) that replaces the Pallas TPU
kernel ``_sparse_kernel`` (``src/repro/kernels/block_sparse_attn.py:52``):
causal flash attention of each (batch, selection head, query block) over
that row's ``live_counts`` selected key blocks, fp32 accumulation, output
in q's dtype, exact zeros for ``cnt == 0`` rows.  With ``group_dedup`` the
selection has one row per KV head, shared by the query heads of the group;
without it the KV head is query head // group.  Compute-bound on the H100.
``forward_route`` picks the tile: bf16 at a (q/k, v) pair of
``WGMMA_PAIRS`` ((64, 64), (128, 128), MLA's (192, 128) and (192, 192),
(256, 256)) and a block that is a multiple of 128 runs on the tensor cores
(TMA + wgmma, 128-row tiles of 64- or 128-key tiles, P rounded to bf16
before P.V); fp32, and bf16 at the other shapes (the narrow pairs of
``HEAD_DIM_PAIRS``, any block under or off 128), on the fp32 CUDA cores
(64-row tiles, or one block's rows under 64).  The kernel reads only the
live prefix of each index row, so it needs no revisit filling.

Beside the kernel sits its plain PyTorch version
(``block_sparse_attention_plain``) and plain-int launch counters in
``LAUNCHES``: every forward launch, and one per tensor-core instance
(``wgmma_counter``).  The wrapper takes the plain version only for tensors on the
CPU; for a CUDA tensor it launches the kernel or raises.

With ``return_lse`` the forward also returns each row's natural-log
log-sum-exp (b, hq, n) fp32, +inf for a row that saw no key (serving asks
for none and pays nothing).

The gradient (``block_sparse_attention_bwd``, the training path's under
Stem): the TPU kernel has none, as the reference trains through XLA's
autodiff of its gather executor, so the port's counterpart is a
hand-written backward (``stem_block_sparse_attention_bwd``: dq over each
row's live prefix, then dk and dv over the transposed selection, no
atomics) that reads the forward's lse.  ``backward_route`` picks its
kernels, the forward's table: bf16 at ``WGMMA_PAIRS`` and a block that is a
multiple of 128 on the tensor cores (``csrc/attn_bwd_wgmma.cuh``, P and dS
rounded to bf16, one instance per pair), the rest on the fp32 CUDA cores
(``csrc/attn_bwd.cuh``).  Beside them sit the plain version
(``block_sparse_attention_bwd_plain``, the analytic backward ``dS = P * (dP
- delta)``, P in fp32) and counters of all backward launches, of the
tensor-core route's and of each of its instances.  ``transpose_selection``
builds the transposed selection on the device with torch ops over a static
width (no host sync).  ``attention`` is the differentiable call
(``torch.autograd.Function``): forward and backward both kernels on a CUDA
tensor, both plain versions on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (WGMMA_PAIRS, backward_route, check_head_dim_pair,
                                 forward_route, split_scratch, wgmma_counter)

NEG_INF = -1e30

LAUNCHES = {"block_sparse_attention": 0, "block_sparse_attention_bwd": 0,
            "block_sparse_attention_bwd_wgmma": 0,
            **{wgmma_counter(k, d, dv): 0
               for k in ("block_sparse_attention", "block_sparse_attention_bwd")
               for d, dv in WGMMA_PAIRS}}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib():
    from repro_torch.kernels import _build

    lib = _build.load("block_sparse_attn")
    if not getattr(lib, "_stem_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.stem_block_sparse_attention.argtypes = [p] * 7 + [i] * 10 + [f, p]
        lib.stem_block_sparse_attention.restype = i
        lib.stem_block_sparse_attention_bwd.argtypes = [p] * 15 + [i] * 11 + [f, p, i]
        lib.stem_block_sparse_attention_bwd.restype = i
        lib.stem_block_sparse_attention_bwd_split.argtypes = [i] * 6
        lib.stem_block_sparse_attention_bwd_split.restype = i
        lib._stem_typed = True
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def block_sparse_attention_plain(q, k, v, indices, live_counts, *,
                                 block_size: int, scale=None,
                                 group_dedup: bool = False, return_lse: bool = False):
    """Plain version: per query-block row, gather the row's live selected
    K/V blocks and take the causal masked softmax in fp32, with the kernel's
    ``max(l, 1e-20)`` normalizer floor (cnt == 0 rows give exact zeros).
    Streams over chunks of query-block rows to bound memory.
    q: (b, hq, n, d); k: (b, hk, n, d); v: (b, hk, n, dv); indices (b,
    h_sel, nq, k_max); live_counts (b, h_sel, nq).  Returns (b, hq, n, dv)
    in q's dtype; with ``return_lse`` also each row's log-sum-exp m + ln l
    (b, hq, n) fp32, +inf where the row saw no key."""
    b, hq, n, d = q.shape
    hk = k.shape[1]
    dv = v.shape[-1]
    group = hq // hk
    bs = block_size
    nq, nk = n // bs, k.shape[2] // bs
    k_max = indices.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    dev = q.device
    if group_dedup:
        indices = torch.repeat_interleave(indices, group, dim=1)
        live_counts = torch.repeat_interleave(live_counts, group, dim=1)
    idx = indices.long()                                    # (b, hq, nq, k_max)
    live = torch.arange(k_max, device=dev) < live_counts.long()[..., None]
    kb = k.reshape(b, hk, nk, bs, d)
    vb = v.reshape(b, hk, nk, bs, dv)
    bi = torch.arange(b, device=dev)[:, None, None, None]
    hi = (torch.arange(hq, device=dev) // group)[None, :, None, None]
    out = torch.empty((b, hq, n, dv), dtype=q.dtype, device=dev)
    lse = torch.empty((b, hq, n), dtype=torch.float32, device=dev)
    step = max(1, (1 << 26) // max(b * hq * k_max * bs * max(bs, d), 1))
    for i0 in range(0, nq, step):
        i1 = min(nq, i0 + step)
        r = i1 - i0
        qr = q[:, :, i0 * bs:i1 * bs].float().reshape(b, hq, r, bs, d) * scale
        sel = idx[:, :, i0:i1]
        gk = kb[bi, hi, sel].float()                        # (b, hq, r, kmax, bs, d)
        gv = vb[bi, hi, sel].float()
        s = torch.einsum("bhrqd,bhrkjd->bhrqkj", qr, gk)
        k_pos = sel[..., None] * bs + torch.arange(bs, device=dev)      # (b,hq,r,kmax,bs)
        q_pos = (torch.arange(i0, i1, device=dev)[:, None] * bs
                 + torch.arange(bs, device=dev)[None, :])               # (r, bs)
        keep = k_pos[:, :, :, None] <= q_pos[None, None, :, :, None, None]
        keep = keep & live[:, :, i0:i1, None, :, None]
        s = torch.where(keep, s, NEG_INF).reshape(b, hq, r, bs, k_max * bs)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(keep.reshape(s.shape), torch.exp(s - m), 0.0)
        total = p.sum(dim=-1, keepdim=True)
        l = torch.clamp(total, min=1e-20)
        o = torch.einsum("bhrqn,bhrnd->bhrqd", p,
                         gv.reshape(b, hq, r, k_max * bs, dv)) / l
        out[:, :, i0 * bs:i1 * bs] = o.reshape(b, hq, r * bs, dv).to(q.dtype)
        if return_lse:
            rl = torch.where(total > 0, m + torch.log(l), torch.inf)
            lse[:, :, i0 * bs:i1 * bs] = rl.reshape(b, hq, r * bs)
    return (out, lse) if return_lse else out


def block_sparse_attention(q, k, v, indices, slot_mask=None, *,
                           block_size: int = 128, scale=None,
                           group_dedup: bool = False, live_counts=None,
                           return_lse: bool = False):
    """Sparse causal attention over selected key blocks.

    q: (b, hq, n, d); k: (b, hk, n, d); v: (b, hk, n, dv); indices: (b,
    h_sel, nq, k_max) int32 selected block ids with h_sel = hq, or hk with
    ``group_dedup``; live slots form a prefix of each row, counted by
    ``live_counts`` (derived from ``slot_mask`` when omitted).  CPU tensors
    take the plain version; CUDA tensors launch the kernel.  Returns (b,
    hq, n, dv); with ``return_lse`` the pair (out, lse), lse (b, hq, n)
    fp32 each row's natural-log log-sum-exp, +inf for a row that saw no
    key (the backward's input)."""
    cnt = (slot_mask.sum(dim=-1, dtype=torch.int32) if live_counts is None
           else live_counts)
    if q.device.type == "cpu":
        return block_sparse_attention_plain(
            q, k, v, indices, cnt, block_size=block_size, scale=scale,
            group_dedup=group_dedup, return_lse=return_lse)
    _check(q.device.type == "cuda",
           f"block_sparse_attention: unsupported device {q.device}")
    b, hq, n, d = q.shape
    hk, dv = k.shape[1], v.shape[-1]
    hsel = hk if group_dedup else hq
    bs = block_size
    _check(all(t.device == q.device for t in (k, v, indices, cnt)),
           "block_sparse_attention: all tensors must be on one device")
    _check(q.dtype in (torch.float32, torch.bfloat16)
           and k.dtype == q.dtype and v.dtype == q.dtype,
           "block_sparse_attention: q/k/v must share a float32 or bfloat16 dtype")
    _check(indices.dtype == torch.int32 and cnt.dtype == torch.int32,
           "block_sparse_attention: indices and live counts must be int32")
    _check(all(t.is_contiguous() for t in (q, k, v, indices, cnt)),
           "block_sparse_attention: inputs must be contiguous")
    _check(tuple(k.shape) == (b, hk, n, d) and tuple(v.shape) == (b, hk, n, dv),
           "block_sparse_attention: needs seq_q == seq_k, equal q/k head dims and "
           "v of shape (b, hk, n, dv)")
    check_head_dim_pair("block_sparse_attention", d, dv)
    _check(hk > 0 and hq % hk == 0,
           "block_sparse_attention: kv heads must divide q heads")
    _check(bs > 0 and n % bs == 0,
           "block_sparse_attention: block size must divide the sequence")
    _check(all(t.data_ptr() % 16 == 0 for t in (q, k, v)),
           "block_sparse_attention: inputs must be 16-byte aligned (TMA, 16-byte loads)")
    _check(indices.dim() == 4 and tuple(indices.shape[:3]) == (b, hsel, n // bs)
           and tuple(cnt.shape) == (b, hsel, n // bs),
           "block_sparse_attention: selection shapes disagree with q")
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty((b, hq, n, dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, hq, n), dtype=torch.float32, device=q.device) if return_lse
           else None)
    err = _lib().stem_block_sparse_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), indices.data_ptr(),
        cnt.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
        b, hq, hk, int(group_dedup), n, d, dv, bs, indices.shape[-1],
        int(q.dtype == torch.bfloat16), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"stem_block_sparse_attention launch failed: cudaError {err}")
    LAUNCHES["block_sparse_attention"] += 1
    if forward_route(q.dtype, d, dv, bs) == "wgmma":
        LAUNCHES[wgmma_counter("block_sparse_attention", d, dv)] += 1
    return (out, lse) if return_lse else out


def _live_mask(idx: torch.Tensor, live_counts: torch.Tensor, nq: int) -> torch.Tensor:
    """The live prefix of each selection row (``idx`` int64), ids outside
    [0, nq) dead."""
    return ((torch.arange(idx.shape[-1], device=idx.device) < live_counts.long()[..., None])
            & (idx >= 0) & (idx < nq))


def block_sparse_attention_bwd_plain(q, k, v, o, do, indices, live_counts, *,
                                     block_size: int, scale=None,
                                     group_dedup: bool = False) -> tuple:
    """Plain version of the backward: per query-block row, the row's live
    selected K/V blocks gathered and, in fp32, P as the forward normalizes
    it (``max(l, 1e-20)``), delta = rowsum(do * o), dP = do.v^T, dS = P *
    (dP - delta); dq = scale * dS.k, and dk = scale * dS^T.q and dv =
    P^T.do added back into the selected blocks.  Only the live prefix of
    each row counts; cnt == 0 rows get zero gradient.  P is recomputed, so
    it takes no lse.  Returns (dq, dk, dv) in the inputs' dtype."""
    b, hq, n, d = q.shape
    hk, dv_dim = k.shape[1], v.shape[-1]
    group = hq // hk
    bs = block_size
    nq, nk = n // bs, k.shape[2] // bs
    k_max = indices.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    dev = q.device
    if group_dedup:
        indices = torch.repeat_interleave(indices, group, dim=1)
        live_counts = torch.repeat_interleave(live_counts, group, dim=1)
    live = _live_mask(indices.long(), live_counts, nk)
    idx = torch.where(live, indices.long(), 0)
    kb = k.reshape(b, hk, nk, bs, d).float()
    vb = v.reshape(b, hk, nk, bs, dv_dim).float()
    dkb = torch.zeros_like(kb)
    dvb = torch.zeros_like(vb)
    bi = torch.arange(b, device=dev)[:, None, None, None]
    hi = (torch.arange(hq, device=dev) // group)[None, :, None, None]
    dq = torch.empty_like(q)
    step = max(1, (1 << 24) // max(b * hq * k_max * bs * max(bs, d), 1))
    for i0 in range(0, nq, step):
        i1 = min(nq, i0 + step)
        r = i1 - i0
        rows = slice(i0 * bs, i1 * bs)
        qr = q[:, :, rows].float().reshape(b, hq, r, bs, d)
        orr = o[:, :, rows].float().reshape(b, hq, r, bs, dv_dim)
        dor = do[:, :, rows].float().reshape(b, hq, r, bs, dv_dim)
        sel = idx[:, :, i0:i1]
        gk = kb[bi, hi, sel]                                 # (b, hq, r, kmax, bs, d)
        gv = vb[bi, hi, sel]
        s = torch.einsum("bhrqd,bhrkjd->bhrqkj", qr, gk) * scale
        k_pos = sel[..., None] * bs + torch.arange(bs, device=dev)
        q_pos = (torch.arange(i0, i1, device=dev)[:, None] * bs
                 + torch.arange(bs, device=dev)[None, :])
        keep = k_pos[:, :, :, None] <= q_pos[None, None, :, :, None, None]
        keep = keep & live[:, :, i0:i1, None, :, None]
        s = torch.where(keep, s, NEG_INF)
        m = s.amax(dim=(-1, -2), keepdim=True)
        p = torch.where(keep, torch.exp(s - m), 0.0)
        p = p / torch.clamp(p.sum(dim=(-1, -2), keepdim=True), min=1e-20)
        delta = (dor * orr).sum(dim=-1)[..., None, None]      # (b, hq, r, bs, 1, 1)
        dp = torch.einsum("bhrqd,bhrkjd->bhrqkj", dor, gv)
        ds = p * (dp - delta)
        dq[:, :, rows] = (torch.einsum("bhrqkj,bhrkjd->bhrqd", ds, gk) * scale).reshape(
            b, hq, r * bs, d).to(q.dtype)
        gdk = torch.einsum("bhrqkj,bhrqd->bhrkjd", ds, qr) * scale
        gdv = torch.einsum("bhrqkj,bhrqd->bhrkjd", p, dor)
        ix = (bi.expand_as(sel), hi.expand_as(sel), sel)
        dkb.index_put_(ix, gdk, accumulate=True)
        dvb.index_put_(ix, gdv, accumulate=True)
    return (dq, dkb.reshape(k.shape).to(k.dtype), dvb.reshape(v.shape).to(v.dtype))


def transpose_selection(indices: torch.Tensor, live_counts: torch.Tensor,
                        nq: int) -> tuple:
    """The transposed selection of ``indices`` (b, h, nq, k_max) with live
    prefixes ``live_counts`` (b, h, nq): (tidx (b, h, nq, nq), tcnt (b, h,
    nq)) int32, where the first ``tcnt[.., j]`` entries of ``tidx[.., j, :]``
    are the query blocks whose live prefix holds key block j, in increasing
    order.  Dead slots (a revisit-filled selection repeats live blocks
    there) and ids outside [0, nq) are not counted.  Torch ops over the
    static width nq: no host sync."""
    idx = indices.long()
    live = _live_mask(idx, live_counts, nq)
    hit = torch.zeros(indices.shape[:-1] + (nq + 1,), dtype=torch.bool,
                      device=indices.device)
    hit.scatter_(-1, torch.where(live, idx, nq), torch.ones_like(live))
    hit_t = hit[..., :nq].transpose(-1, -2)            # (b, h, key block, query block)
    tcnt = hit_t.sum(dim=-1, dtype=torch.int32)
    tidx = torch.argsort((~hit_t).to(torch.uint8), dim=-1, stable=True)
    return tidx.to(torch.int32).contiguous(), tcnt.contiguous()


def block_sparse_attention_bwd(q, k, v, o, do, indices, live_counts, *,
                               block_size: int, scale=None,
                               group_dedup: bool = False, transposed=None,
                               lse=None) -> tuple:
    """The gradient of ``block_sparse_attention``: (dq, dk, dv) for its
    inputs q, k, v and selection (indices, live_counts), its output o, o's
    gradient do and the forward's ``lse`` (``return_lse``; required on a
    CUDA tensor).  ``transposed`` optionally gives the transposed selection
    (``transpose_selection``'s pair; built here when None).  CPU tensors
    take the plain version; CUDA tensors launch the kernels of
    ``backward_route`` (two launches, one count, and on the wgmma route one
    more and one of its instance's)."""
    if q.device.type == "cpu":
        return block_sparse_attention_bwd_plain(
            q, k, v, o, do, indices, live_counts, block_size=block_size,
            scale=scale, group_dedup=group_dedup)
    return _bwd_launch(q, k, v, o, do, indices, live_counts, block_size, scale,
                       group_dedup, transposed, lse, None)


def _bwd_launch(q, k, v, o, do, indices, live_counts, block_size, scale, group_dedup,
                transposed, lse, route) -> tuple:
    """``block_sparse_attention_bwd`` on the card, on ``route``: None for
    ``backward_route``'s, or "cuda_core" for the CUDA-core kernels at any
    shape (the route the tensor-core kernels replaced; chip_smoke.py times
    and checks it beside them)."""
    name = "block_sparse_attention_bwd"
    _check(q.device.type == "cuda", f"{name}: unsupported device {q.device}")
    b, hq, n, d = q.shape
    hk, dv_dim = k.shape[1], v.shape[-1]
    hsel = hk if group_dedup else hq
    bs = block_size
    _check(bs > 0 and n % bs == 0, f"{name}: block size must divide the sequence")
    nq = n // bs
    tidx, tcnt = (transpose_selection(indices, live_counts, nq) if transposed is None
                  else transposed)
    _check(lse is not None and lse.dtype == torch.float32
           and tuple(lse.shape) == (b, hq, n) and lse.is_contiguous(),
           f"{name}: needs the forward's lse, (b, hq, n) contiguous fp32")
    _check(all(t.device == q.device
               for t in (k, v, o, do, lse, indices, live_counts, tidx, tcnt)),
           f"{name}: all tensors must be on one device")
    _check(q.dtype in (torch.float32, torch.bfloat16)
           and all(t.dtype == q.dtype for t in (k, v, o, do)),
           f"{name}: q/k/v/o/do must share a float32 or bfloat16 dtype")
    _check(all(t.dtype == torch.int32 for t in (indices, live_counts, tidx, tcnt)),
           f"{name}: the selection and its transpose must be int32")
    _check(all(t.is_contiguous()
               for t in (q, k, v, o, do, indices, live_counts, tidx, tcnt)),
           f"{name}: inputs must be contiguous")
    _check(tuple(k.shape) == (b, hk, n, d) and tuple(v.shape) == (b, hk, n, dv_dim)
           and tuple(o.shape) == (b, hq, n, dv_dim) and do.shape == o.shape,
           f"{name}: needs seq_q == seq_k, equal q/k head dims, v of shape (b, hk, n, "
           "dv) and o, do of shape (b, hq, n, dv)")
    check_head_dim_pair(name, d, dv_dim)
    _check(hk > 0 and hq % hk == 0, f"{name}: kv heads must divide q heads")
    _check(all(t.data_ptr() % 16 == 0 for t in (q, k, v, o, do)),
           f"{name}: inputs must be 16-byte aligned (TMA, 16-byte loads)")
    _check(indices.dim() == 4 and tuple(indices.shape[:3]) == (b, hsel, nq)
           and tuple(live_counts.shape) == (b, hsel, nq)
           and tuple(tidx.shape) == (b, hsel, nq, nq) and tuple(tcnt.shape) == (b, hsel, nq),
           f"{name}: selection shapes disagree with q")
    scale = d ** -0.5 if scale is None else scale
    _check(route in (None, "cuda_core"), f"{name}: unknown route {route!r}")
    route = route or backward_route(q.dtype, d, dv_dim, bs)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    part = split_scratch(_lib().stem_block_sparse_attention_bwd_split, route, q, k, v)
    err = _lib().stem_block_sparse_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), indices.data_ptr(), live_counts.data_ptr(), tidx.data_ptr(),
        tcnt.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
        part.data_ptr() if part is not None else None, b, hq, hk, int(group_dedup), n, d,
        dv_dim, bs, indices.shape[-1],
        int(q.dtype == torch.bfloat16), int(route == "wgmma"), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream, q.device.index)
    if err != 0:
        raise RuntimeError(f"stem_block_sparse_attention_bwd launch failed ({route}): "
                           f"cudaError {err}")
    LAUNCHES["block_sparse_attention_bwd"] += 1
    if route == "wgmma":
        LAUNCHES["block_sparse_attention_bwd_wgmma"] += 1
        LAUNCHES[wgmma_counter("block_sparse_attention_bwd", d, dv_dim)] += 1
    return dq, dk, dv


class _Attention(torch.autograd.Function):
    """Block-sparse causal attention with its hand-written gradient.  The
    forward runs ``block_sparse_attention`` with ``return_lse`` and saves
    q, k, v, the output, the row log-sum-exp and the selection; the
    backward hands them with do to ``block_sparse_attention_bwd``, which on
    the card routes bf16 at ``WGMMA_PAIRS`` and blocks of a multiple of 128
    to the wgmma kernels and every other shape to the CUDA-core ones (neither
    recomputes the lse).  On the CPU both are plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, indices, live_counts, block_size, scale, group_dedup):
        out, lse = block_sparse_attention(q, k, v, indices, block_size=block_size,
                                          scale=scale, group_dedup=group_dedup,
                                          live_counts=live_counts, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, indices, live_counts)
        ctx.args = (block_size, scale, group_dedup)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, indices, live_counts = ctx.saved_tensors
        block_size, scale, group_dedup = ctx.args
        dq, dk, dv = block_sparse_attention_bwd(
            q, k, v, out, do.contiguous(), indices, live_counts,
            block_size=block_size, scale=scale, group_dedup=group_dedup, lse=lse)
        return dq, dk, dv, None, None, None, None, None


def attention(q, k, v, indices, live_counts, *, block_size: int, scale=None,
              group_dedup: bool = False) -> torch.Tensor:
    """Differentiable block-sparse causal attention:
    ``block_sparse_attention`` forward, ``block_sparse_attention_bwd``
    backward (kernels on a CUDA tensor, the plain versions on the CPU).  A
    call that needs no gradient (serving, or under ``torch.no_grad``) is
    the plain forward call: no lse is stored."""
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))):
        return block_sparse_attention(q, k, v, indices, block_size=block_size, scale=scale,
                                      group_dedup=group_dedup, live_counts=live_counts)
    return _Attention.apply(q, k, v, indices, live_counts, block_size, scale,
                            group_dedup)
