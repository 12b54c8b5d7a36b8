"""Stem block-sparse causal attention: the executor of the one-shot Stem
prefill (port of ``repro/kernels/block_sparse_attn.py``).

``block_sparse_attention`` launches a hand-written CUDA kernel for
``sm_90a`` (``csrc/block_sparse_attn.cu``) that replaces the Pallas TPU
kernel ``_sparse_kernel`` (``src/repro/kernels/block_sparse_attn.py:52``):
causal flash attention of each (batch, selection head, query block) over
that row's ``live_counts`` selected key blocks, fp32 accumulation, output
in q's dtype, exact zeros for ``cnt == 0`` rows.  With ``group_dedup`` the
selection has one row per KV head, shared by the query heads of the group;
without it the KV head is query head // group.  Compute-bound on the H100:
bf16 at head_dim 128 and a block that is a multiple of 128 runs on the
tensor cores (TMA + wgmma, 128-row tiles, P rounded to bf16 before P.V);
fp32, and bf16 at the other shapes (head_dims of ``HEAD_DIMS``, any block),
on the fp32 CUDA cores (64-row tiles, or one block's rows under 64).  The kernel reads only the
live prefix of each index row, so it needs no revisit filling.

Beside the kernel sits its plain PyTorch version
(``block_sparse_attention_plain``) and a plain-int launch counter in
``LAUNCHES``.  The wrapper takes the plain version only for tensors on the
CPU; for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import HEAD_DIMS

NEG_INF = -1e30

LAUNCHES = {"block_sparse_attention": 0}


def reset_launches() -> None:
    LAUNCHES["block_sparse_attention"] = 0


def _lib():
    from repro_torch.kernels import _build

    lib = _build.load("block_sparse_attn")
    if not getattr(lib, "_stem_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.stem_block_sparse_attention.argtypes = [
            p, p, p, p, p, p, i, i, i, i, i, i, i, i, i, f, p]
        lib.stem_block_sparse_attention.restype = i
        lib._stem_typed = True
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def block_sparse_attention_plain(q, k, v, indices, live_counts, *,
                                 block_size: int, scale=None,
                                 group_dedup: bool = False) -> torch.Tensor:
    """Plain version: per query-block row, gather the row's live selected
    K/V blocks and take the causal masked softmax in fp32, with the kernel's
    ``max(l, 1e-20)`` normalizer floor (cnt == 0 rows give exact zeros).
    Streams over chunks of query-block rows to bound memory.
    q: (b, hq, n, d); k, v: (b, hk, n, d); indices (b, h_sel, nq, k_max);
    live_counts (b, h_sel, nq).  Returns (b, hq, n, dv) in q's dtype."""
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
        l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-20)
        o = torch.einsum("bhrqn,bhrnd->bhrqd", p,
                         gv.reshape(b, hq, r, k_max * bs, dv)) / l
        out[:, :, i0 * bs:i1 * bs] = o.reshape(b, hq, r * bs, dv).to(q.dtype)
    return out


def block_sparse_attention(q, k, v, indices, slot_mask=None, *,
                           block_size: int = 128, scale=None,
                           group_dedup: bool = False, live_counts=None):
    """Sparse causal attention over selected key blocks.

    q: (b, hq, n, d); k, v: (b, hk, n, d); indices: (b, h_sel, nq, k_max)
    int32 selected block ids with h_sel = hq, or hk with ``group_dedup``;
    live slots form a prefix of each row, counted by ``live_counts``
    (derived from ``slot_mask`` when omitted).  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    cnt = (slot_mask.sum(dim=-1, dtype=torch.int32) if live_counts is None
           else live_counts)
    if q.device.type == "cpu":
        return block_sparse_attention_plain(
            q, k, v, indices, cnt, block_size=block_size, scale=scale,
            group_dedup=group_dedup)
    _check(q.device.type == "cuda",
           f"block_sparse_attention: unsupported device {q.device}")
    b, hq, n, d = q.shape
    hk = k.shape[1]
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
    _check(tuple(k.shape) == (b, hk, n, d) and tuple(v.shape) == (b, hk, n, d),
           "block_sparse_attention: needs seq_q == seq_k and equal q/k/v head dims")
    _check(d in HEAD_DIMS,
           f"block_sparse_attention: head_dim must be one of {HEAD_DIMS}")
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
    out = torch.empty_like(q)
    err = _lib().stem_block_sparse_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), indices.data_ptr(),
        cnt.data_ptr(), out.data_ptr(), b, hq, hk, int(group_dedup), n, d, bs,
        indices.shape[-1], int(q.dtype == torch.bfloat16), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"stem_block_sparse_attention launch failed: cudaError {err}")
    LAUNCHES["block_sparse_attention"] += 1
    return out
