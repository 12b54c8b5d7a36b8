"""Fused paged attention for the serving hot path (decode + chunk lanes).

Port of ``repro/kernels/paged_attn.py``.  Two hand-written CUDA kernels for
``sm_90a`` (``csrc/paged_attn.cu``) replace the two Pallas TPU kernels:

* ``score_pages`` replaces ``_score_kernel``
  (``src/repro/kernels/paged_attn.py:142``): routing score
  ``scale * sum_u <qp[pair(u)], kg[kv_head, page_table[b, p], u]>`` of every
  (row, candidate page), read straight off the pool summaries without
  materializing ``pool.kg[:, page_table]``; ``pair`` folds the chunk lane's
  anti-diagonal pairing ``u -> (s - u) % s`` into the kernel's loads.
  Bytes-bound on the H100 (each page's fp32 kg tile is read for 2*s*d flops
  per query row).  A query broadcast over s (the decode lane; mean pooling)
  takes one warp a page: the tile summed over u, then g * nc dot products.
  Otherwise (the chunk lane) a CTA's threads split the s*d contraction,
  hold their strip of the KV head's query rows in registers and stream the
  kg strips of a few pages past them, reduce-scattering the partial sums;
  pages per CTA are chosen so the grid fills the card.  Those two kernels
  take head_dim 128 with stride 8, 16 or 32; every other head_dim and
  stride (the small configurations: head_dim 8, stride 4) takes one warp a
  page over the whole s*d tile.
* ``attend_pages`` replaces ``_attend_kernel``
  (``src/repro/kernels/paged_attn.py:249``): flash online-softmax attention
  of each (row, query head, chunk row) over that row's selected pages, fp32
  accumulation, decode masking ``tok < len`` and chunk masking
  ``tok <= q_pos`` at absolute positions, exact zeros for ``cnt == 0``,
  page ids outside ``[0, P)`` skipped.

  - The decode lane (one query row a head) is bytes-bound, and one row's
    pages are too little work for one CTA: it is split across the card
    (flash-decoding).  A split kernel gives each CTA ``PAGES_PER_SPLIT``
    slots of one (head, row), taken in page order so that the heads of a
    GQA group read their shared pages side by side, streams their K / V
    through a shared-memory ring of 16 KiB bulk copies and scores a key per
    16 lanes with 16-byte loads; a combine kernel merges the row's fp32
    partials (a workspace the wrapper allocates) and finalizes.  All math
    fp32, in both dtypes.
  - The chunk lane (block_size query rows) is compute-bound.  bf16 at head_dim
    and page size 128 runs on the tensor cores: the one-shot prefill's TMA +
    wgmma tile with the page table in its producer, each selected page one
    128-key tile; it rounds the probabilities P to bf16 before P.V, so its
    bf16 outputs are held to a looser rule than the other lanes' (the
    ``p_bf16`` rule of the card tests: 1e-2 of the row's max|plain| in
    place of 1e-3).  fp32, and bf16 at the other shapes, keep a tile on
    the fp32 CUDA cores.

  Every kernel is built for the head_dims of ``HEAD_DIMS`` (8-256) and page
  sizes up to 128; the scorer takes any stride.

Beside each kernel sits its plain PyTorch version (``score_pages_plain``,
``attend_pages_plain``) and a plain-int launch counter in ``LAUNCHES``.  A
wrapper takes the plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises — there is no fallback.

Selection (budgets, forced floors, stable top-k), the OAM
``beta * max(vm, 0)`` term and ``group_reduce`` stay in PyTorch, shared with
the gather oracle, so the fused path is selection-identical to it by
construction.  Supported metrics: ``OutputAwareMetric`` / ``RoutingMetric``
with "antidiag" or "mean" pooling, and ``StreamingMetric`` (zero scores, no
scorer launch); any other metric or pooling raises ``NotImplementedError``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import chunked as chunked_lib
from repro_torch.core import decode as decode_lib
from repro_torch.core import metric as metric_lib
from repro_torch.core import policy as policy_lib
from repro_torch.core.selection import revisit_indices
from repro_torch.kernels import HEAD_DIMS, stem_metric

NEG_INF = -1e30
MAX_SMEM_BYTES = 232448          # H100 dynamic shared memory per block
# Slots of a decode row per CTA of the split kernel.  Four pages (256 KiB of
# bf16 K and V) amortize a CTA's start-up and still give >= 2 CTAs per SM of
# the H100's 132 in the engine's 2-slot decode at long contexts (16 heads x
# (16 + 14) CTAs at 16k + 11k tokens, budget_frac 0.5) and in chip_smoke's
# b = 4 decode (16 heads x 46 CTAs); eight would leave that 2-slot decode
# under 264 CTAs.
PAGES_PER_SPLIT = 4

# Kernel launches per (kernel, lane), counted where each wrapper launches
# its CUDA kernel and nowhere else (the CPU plain path does not count).
LAUNCHES = {"score/decode": 0, "score/chunk": 0,
            "attend/decode": 0, "attend/chunk": 0}


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


def _lib():
    from repro_torch.kernels import _build

    lib = _build.load("paged_attn")
    if not getattr(lib, "_stem_typed", False):
        p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
        lib.stem_paged_score.argtypes = [p, ll, ll, ll, ll, i, p, p, p,
                                         i, i, i, i, i, i, i, i, f, p]
        lib.stem_paged_score.restype = i
        lib.stem_paged_attend.argtypes = [p, p, p, p, p, p, p, p, p,
                                          i, i, i, i, i, i, i, i, i, i, i, i,
                                          f, p]
        lib.stem_paged_attend.restype = i
        lib.stem_paged_attend_tile_smem.argtypes = [i, i, i]
        lib.stem_paged_attend_tile_smem.restype = ll
        lib.stem_paged_decode_splits.argtypes = [i, i]
        lib.stem_paged_decode_splits.restype = i
        lib._stem_typed = True
    return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# Selection packing (shared by both executors' kernels)
# ---------------------------------------------------------------------------

def pack_selection(indices, live, page_table):
    """Selection -> the kernel's (gp, idx, cnt) int32 triple: revisit-filled
    global page ids, revisit-filled logical ids, and per-row live counts.
    indices/live: (b, heads..., k_max); page_table: (b, max_pages)."""
    b, maxp = page_table.shape
    lead = indices.shape[:-1]
    pt = page_table.reshape((b,) + (1,) * (len(lead) - 1) + (maxp,)).expand(
        lead + (maxp,))
    gp = torch.take_along_dim(pt.long(), indices.long(), dim=-1)
    return (revisit_indices(gp, live), revisit_indices(indices, live),
            live.sum(dim=-1, dtype=torch.int32))


# ---------------------------------------------------------------------------
# Kernel 1: summary-resident page scoring
# ---------------------------------------------------------------------------

def score_pages_plain(qp, kg_pool, page_table, *, group: int, scale: float,
                      pair: bool = False):
    """Plain version: qp (b, hq, nc, s, d) f32; kg_pool (hk, P, s, d) f32;
    page_table (b, maxp) -> (b, hq, nc, maxp) f32.  ``pair``: group u of kg
    meets group (s - u) % s of qp (the anti-diagonal pairing)."""
    if pair:
        s = qp.shape[-2]
        qp = qp.index_select(-2, (s - torch.arange(s, device=qp.device)) % s)
    rows = kg_pool[:, page_table.long()].transpose(0, 1)   # (b, hk, maxp, s, d)
    rows = torch.repeat_interleave(rows, group, dim=1)     # (b, hq, maxp, s, d)
    return torch.einsum("bhcsd,bhpsd->bhcp", qp.float(), rows.float()) * scale


def score_pages(qp, kg_pool, page_table, *, group: int, scale: float,
                lane: str, pair: bool = False):
    """Routing scores of every (row, candidate page) off the pool summaries;
    a page id outside [0, P) scores NaN on the card.  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if qp.device.type == "cpu":
        return score_pages_plain(qp, kg_pool, page_table, group=group,
                                 scale=scale, pair=pair)
    _check(qp.device.type == "cuda", f"unsupported device {qp.device}")
    b, hq, nc, s, d = qp.shape
    hk, num_pages = kg_pool.shape[0], kg_pool.shape[1]
    maxp = page_table.shape[1]
    _check(kg_pool.device == qp.device and page_table.device == qp.device,
           "score_pages: all tensors must be on one device")
    _check(qp.dtype == torch.float32 and kg_pool.dtype == torch.float32,
           "score_pages: qp and kg must be float32")
    _check(page_table.dtype == torch.int32 and page_table.is_contiguous(),
           "score_pages: page_table must be contiguous int32")
    _check(kg_pool.is_contiguous() and tuple(kg_pool.shape[2:]) == (s, d),
           "score_pages: kg pool must be contiguous (hk, P, s, d)")
    _check(d in HEAD_DIMS, f"score_pages: head_dim must be one of {HEAD_DIMS}")
    sb, sh, sc, ss, sd = qp.stride()
    _check(sd == 1 and qp.data_ptr() % 16 == 0
           and all(x % 4 == 0 for x in (sb, sh, sc, ss)),
           "score_pages: qp must be 16-byte aligned with head_dim contiguous "
           "and its other strides multiples of 4")
    _check(hq == hk * group and page_table.shape[0] == b,
           "score_pages: head/batch shapes disagree")
    out = torch.empty((b, hq, nc, maxp), dtype=torch.float32, device=qp.device)
    err = _lib().stem_paged_score(
        qp.data_ptr(), sb, sh, sc, ss, int(pair), kg_pool.data_ptr(),
        page_table.data_ptr(), out.data_ptr(), b, hq, hk, nc, s, d, maxp,
        num_pages, float(scale), _stream_ptr(qp.device))
    if err != 0:
        raise RuntimeError(f"stem_paged_score launch failed: cudaError {err}")
    LAUNCHES["score/" + lane] += 1
    return out


def decode_page_scores(q, kg_pool, page_table, *, group: int):
    """Scorer-backed ``decode_routing_scores`` against the pool.
    q: (b, hq, 1, d) -> (b, hk, g, maxp) f32."""
    b, hq, _, d = q.shape
    s = kg_pool.shape[-2]
    scale = 1.0 / (s * float(d) ** 0.5)
    # One pooled row per slot: the single query broadcast over the s groups
    # (a stride-0 view, nothing is materialized).
    qp = q.float()[:, :, :, None, :].expand(b, hq, 1, s, d)
    out = score_pages(qp, kg_pool, page_table, group=group, scale=scale,
                      lane="decode")
    return out.reshape(b, hq // group, group, page_table.shape[1])


def chunk_page_scores(q, kg_pool, page_table, *, block_size: int,
                      pooling: str, group: int):
    """Scorer-backed ``chunk_routing_scores`` against the pool.  The
    anti-diagonal pairing u -> (s - u) % s is folded into the scorer's loads
    (``pair``); mean pooling broadcasts the block mean over s (a stride-0
    view, which the scorer reads as a single row).
    q: (b, hq, C, d) -> (b, hq, nc, maxp) f32."""
    d = q.shape[-1]
    s = kg_pool.shape[-2]
    # The pooled queries are rounded to q's dtype, as the reference (and the
    # gather executor's metric) keep them, then read by the scorer in fp32.
    qp = stem_metric.antidiag_pool(q.contiguous(), block_size=block_size,
                                   stride=s, out_dtype=q.dtype)  # (b, hq, nc, s, d)
    if pooling == "mean":
        qp = qp.mean(dim=-2, keepdim=True).float().expand(qp.shape)
    elif pooling == "antidiag":
        qp = qp.float()
    else:
        raise NotImplementedError(f"fused chunk scoring: pooling {pooling!r}")
    scale = 1.0 / (s * float(d) ** 0.5)
    return score_pages(qp, kg_pool, page_table, group=group, scale=scale,
                       lane="chunk", pair=pooling == "antidiag")


# ---------------------------------------------------------------------------
# Kernel 2: attention over selected pages
# ---------------------------------------------------------------------------

def attend_pages_plain(q, k_pool, v_pool, gp, idx, cnt, pos, *,
                       block_size: int, causal: bool):
    """Plain version: q (b, hq, nc, rows, d); k/v_pool (hk, P, bs, d);
    gp/idx (b, hq, nc, k_max) int32; cnt (b, hq, nc); pos (b,).  The
    kernel's online softmax equals this masked softmax with the same
    ``max(l, 1e-20)`` normalizer floor, so cnt == 0 rows are exact zeros.
    Returns (b, hq, nc, rows, dv) in q's dtype."""
    b, hq, nc, rows, d = q.shape
    hk = k_pool.shape[0]
    group = hq // hk
    bs = block_size
    k_max = gp.shape[-1]
    dev = q.device
    heads = (torch.arange(hq, device=dev) // group)[None, :, None, None]
    gk = k_pool[heads, gp.long()].float()          # (b, hq, nc, kmax, bs, d)
    gv = v_pool[heads, gp.long()].float()
    qs = q.float() * (float(d) ** -0.5)
    sc = torch.einsum("bhcrd,bhcpkd->bhcrpk", qs, gk)
    tok = idx.long()[..., None] * bs + torch.arange(bs, device=dev)  # (b,hq,nc,kmax,bs)
    if causal:
        q_pos = (pos.long()[:, None, None] + torch.arange(nc, device=dev)[None, :, None] * rows
                 + torch.arange(rows, device=dev)[None, None, :])    # (b, nc, rows)
        keep = tok[:, :, :, None] <= q_pos[:, None, :, :, None, None]
    else:
        keep = (tok < pos.long()[:, None, None, None, None])[:, :, :, None]
    live = torch.arange(k_max, device=dev) < cnt.long()[..., None]   # (b,hq,nc,kmax)
    keep = keep & live[:, :, :, None, :, None]
    sc = torch.where(keep, sc, NEG_INF).reshape(b, hq, nc, rows, k_max * bs)
    m = sc.amax(dim=-1, keepdim=True)
    p = torch.where(keep.reshape(sc.shape), torch.exp(sc - m), 0.0)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-20)
    o = torch.einsum("bhcrn,bhcnd->bhcrd", p,
                     gv.reshape(b, hq, nc, k_max * bs, gv.shape[-1]))
    return (o / l).to(q.dtype)


def attend_pages(q, k_pool, v_pool, gp, idx, cnt, pos, *, block_size: int,
                 causal: bool, lane: str):
    """Attention over each row's selected pages.  CPU tensors take the plain
    version; CUDA tensors launch the kernels, which run the two shapes the
    lanes give them: one non-causal query row (decode: the split and
    combine kernels) or a causal tile of block_size rows (chunk), at the
    head_dims of ``HEAD_DIMS`` and page sizes up to 128."""
    if q.device.type == "cpu":
        return attend_pages_plain(q, k_pool, v_pool, gp, idx, cnt, pos,
                                  block_size=block_size, causal=causal)
    _check(q.device.type == "cuda", f"unsupported device {q.device}")
    b, hq, nc, rows, d = q.shape
    hk, num_pages, bs, dk = k_pool.shape
    k_max = gp.shape[-1]
    tensors = (k_pool, v_pool, gp, idx, cnt, pos)
    _check(all(t.device == q.device for t in tensors),
           "attend_pages: all tensors must be on one device")
    _check(q.dtype in (torch.float32, torch.bfloat16)
           and k_pool.dtype == q.dtype and v_pool.dtype == q.dtype,
           "attend_pages: q/k/v must share a float32 or bfloat16 dtype")
    _check(all(t.dtype == torch.int32 for t in (gp, idx, cnt, pos)),
           "attend_pages: gp/idx/cnt/pos must be int32")
    _check(all(t.is_contiguous() for t in (q,) + tensors),
           "attend_pages: inputs must be contiguous")
    _check(d in HEAD_DIMS and dk == d and tuple(v_pool.shape) == tuple(k_pool.shape),
           f"attend_pages: head_dim must be one of {HEAD_DIMS}, equal for q/k/v")
    _check(causal == (rows > 1),
           "attend_pages: the kernel runs one non-causal row or a causal tile")
    _check(bs == block_size and 0 < bs <= 128, "attend_pages: page size must be <= 128")
    _check(hq % hk == 0 and tuple(gp.shape) == (b, hq, nc, k_max)
           and tuple(idx.shape) == tuple(gp.shape)
           and tuple(cnt.shape) == (b, hq, nc) and tuple(pos.shape) == (b,),
           "attend_pages: selection shapes disagree with q")
    _check(all(t.data_ptr() % 16 == 0 for t in (q, k_pool, v_pool)),
           "attend_pages: q/k/v must be 16-byte aligned (bulk copies, TMA)")
    lib = _lib()
    splits, ws = 0, None
    if rows == 1:
        splits = lib.stem_paged_decode_splits(k_max, PAGES_PER_SPLIT)
        ws = torch.empty((b * hq * nc, splits, d + 2), dtype=torch.float32,
                         device=q.device)
    elif not (q.dtype == torch.bfloat16 and d == rows == bs == 128):
        _check(lib.stem_paged_attend_tile_smem(d, rows, bs) <= MAX_SMEM_BYTES,
               "attend_pages: query tile exceeds shared memory")
    out = torch.empty((b, hq, nc, rows, d), dtype=q.dtype, device=q.device)
    err = lib.stem_paged_attend(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), gp.data_ptr(),
        idx.data_ptr(), cnt.data_ptr(), pos.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(),
        b, hq, hk, nc, rows, d, bs, k_max, num_pages, splits, PAGES_PER_SPLIT,
        int(q.dtype == torch.bfloat16), float(d) ** -0.5,
        _stream_ptr(q.device))
    if err != 0:
        raise RuntimeError(f"stem_paged_attend launch failed: cudaError {err}")
    LAUNCHES["attend/" + lane] += 1
    return out


# ---------------------------------------------------------------------------
# Fused entry points (the "fused" paged executor)
# ---------------------------------------------------------------------------

def _metric_kind(metric) -> str:
    """"zero" (content-free) or "routing" (kernel-scorable); anything else
    raises — there is no fallback to the gather oracle."""
    if isinstance(metric, policy_lib.StreamingMetric):
        return "zero"
    if isinstance(metric, (policy_lib.OutputAwareMetric,
                           policy_lib.RoutingMetric)):
        return "routing"
    raise NotImplementedError(
        f"the fused paged executor cannot score metric "
        f"{type(metric).__name__}; use executor='gather'")


def fused_paged_decode(q, pool, page_table, cache_lens, cfg,
                       budget_frac=decode_lib.DEFAULT_BUDGET_FRAC):
    """Kernel-backed ``runtime.paged.paged_sparse_decode`` (same signature
    and semantics).  q: (b, hq, 1, d) -> (b, hq, 1, dv)."""
    policy = policy_lib.as_policy(cfg)
    kind = _metric_kind(policy.metric)
    b, hq, _, d = q.shape
    hk = pool.k.shape[0]
    group = hq // hk
    maxp = page_table.shape[1]
    lens = torch.as_tensor(cache_lens, dtype=torch.int32,
                           device=q.device).expand(b).contiguous()
    pt = page_table.to(torch.int32).contiguous()

    if kind == "zero":
        m = torch.zeros((b, hk, group, maxp), dtype=torch.float32,
                        device=q.device)
    else:
        m = decode_page_scores(q, pool.kg, pt, group=group)
        beta = getattr(policy.metric, "beta", 0.0)
        if beta:
            vm_rows = pool.vm[:, pt.long()].transpose(0, 1)
            m = m + beta * torch.clamp(vm_rows, min=0.0)[:, :, None, :]

    sel = policy.decode_select(m, lens, budget_frac=budget_frac)
    gp, idx, cnt = pack_selection(sel.indices, sel.live, pt)
    out = attend_pages(
        q.reshape(b, hq, 1, 1, d).contiguous(), pool.k, pool.v,
        gp.reshape(b, hq, 1, -1).contiguous(),
        idx.reshape(b, hq, 1, -1).contiguous(),
        cnt.reshape(b, hq, 1).contiguous(), lens,
        block_size=policy.block_size, causal=False, lane="decode")
    return out.reshape(b, hq, 1, -1)


def fused_paged_chunk(q, pool, page_table, chunk_start, budgets, cfg,
                      k_max: int = 0):
    """Kernel-backed ``core.chunked.chunked_prefill_attention`` (chunk pages
    already written).  q: (b, hq, C, d) -> (b, hq, C, dv)."""
    policy = policy_lib.as_policy(cfg)
    kind = _metric_kind(policy.metric)
    b, hq, c, d = q.shape
    hk = pool.k.shape[0]
    group = hq // hk
    bs = policy.block_size
    nc = c // bs
    maxp = page_table.shape[1]
    start = chunk_start.to(torch.int32).contiguous()
    pt = page_table.to(torch.int32).contiguous()

    if kind == "zero":
        m = torch.zeros((b, hq, nc, maxp), dtype=torch.float32, device=q.device)
    else:
        m = chunk_page_scores(q, pool.kg, pt, block_size=bs,
                              pooling=getattr(policy.metric, "pooling", "antidiag"),
                              group=group)
        beta = getattr(policy.metric, "beta", 0.0)
        if beta:
            vm_rows = pool.vm[:, pt.long()].transpose(0, 1)
            mv = torch.repeat_interleave(vm_rows, group, dim=1)   # (b, hq, maxp)
            m = m + beta * torch.clamp(mv, min=0.0)[..., None, :]
        m = metric_lib.group_reduce_metric(m, group, policy.group_reduce)

    rows = (torch.div(start, bs, rounding_mode="floor")[:, None]
            + torch.arange(nc, device=q.device)[None, :])
    sel = chunked_lib.select_chunk_blocks(m, rows, budgets, policy, k_max)
    gp, idx, cnt = pack_selection(sel.indices, sel.live, pt)
    out = attend_pages(
        q.reshape(b, hq, nc, bs, d).contiguous(), pool.k, pool.v,
        gp.contiguous(), idx.contiguous(), cnt.contiguous(), start,
        block_size=bs, causal=True, lane="chunk")
    return out.reshape(b, hq, c, -1)


policy_lib.register_paged_executor(
    "fused", decode_fn=fused_paged_decode, chunk_fn=fused_paged_chunk)
