"""The port's CUDA kernels against their plain PyTorch versions on the
card.  These need a CUDA card and the CUDA toolkit (the kernels have no CPU
mode) and skip without one; the file imports no JAX, so it runs on the GPU
machine:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

fp32 within 1e-4 abs; bf16 within 2 bf16 ulps of the plain output plus a
floor of 1e-3 * max|plain| over the element's row (its last axis), except
the attention kernels that run bf16 on the tensor-core tile (the one-shot
prefill's flash and block-sparse attention where ``kernels.forward_route``
says "wgmma": bf16 at (64, 64), (128, 128), (192, 128), (192, 192) and
(256, 256), blocks of a multiple of 128; the paged chunk lane at page size
128): the tile rounds the probabilities P to bf16 before P.V (as
SDPA's and flex_attention's kernels do), which the plain version keeps in
fp32, so their floor is 1e-2 * the row's max|plain| (the ``p_bf16`` rule).
The floor is per row because a row that attends to m keys has outputs of
about sqrt(e / m): one number for the whole tensor would be as large as a
long row's values.  ``cnt == 0`` rows must be exact zeros.  Covers the
paged scorer (both kernels: the query broadcast over s and the chunk
lane's strided, paired layouts; bad page ids; ragged page counts) and page
attention (both lanes, their selection edges), the one-shot prefill's flash
and block-sparse attention (and the products of their tensor-core tile),
and the metric pooling (both load widths, every block size and stride the
port uses, the engine's shapes) / value-magnitude kernels.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import HEAD_DIM_PAIRS, backward_route, forward_route, wgmma_counter
from repro_torch.kernels import block_sparse_attn as t_bsa
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import paged_attn as t_kern
from repro_torch.kernels import stem_metric as t_sm
from repro_torch.kernels import replay
from repro_torch.kernels.replay import grad_tolerance, tolerance


def _assert_close(got, want, *, p_bf16=False):
    """p_bf16: the kernel rounds P to bf16 before P.V (bf16 attention on
    the tensor-core tile: flash, block-sparse, the paged chunk lane at page
    size 128), so a bf16 output's row floor is 1e-2 * max|plain| in place
    of 1e-3."""
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
        return
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    assert bool((diff <= tolerance(want, torch.bfloat16, p_bf16)).all()), \
        f"max |kernel - plain| = {float(diff.max())}"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [1, 2])
def test_kernels_match_plain_on_card(cuda, dtype, group):
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(group)
    hq, d, bs, s, maxp, b = 8, 128, 128, 16, 12, 3
    hk = hq // group
    P = 1 + b * maxp
    k = torch.randn((hk, P, bs, d), generator=gen, device=cuda).to(dt)
    v = torch.randn((hk, P, bs, d), generator=gen, device=cuda).to(dt)
    kg = torch.randn((hk, P, s, d), generator=gen, device=cuda)
    pt = (1 + torch.randperm(P - 1, generator=gen, device=cuda)[:b * maxp]).to(
        torch.int32).reshape(b, maxp)
    qp = torch.randn((b, hq, 2, s, d), generator=gen, device=cuda)
    got = t_kern.score_pages(qp, kg, pt, group=group, scale=0.1, lane="chunk")
    want = t_kern.score_pages_plain(qp, kg, pt, group=group, scale=0.1)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    for rows, causal, nc in ((1, False, 1), (bs, True, 2)):
        kmax = 5
        gp = pt[:, None, None, :kmax].expand(b, hq, nc, kmax).contiguous()
        idx = torch.arange(kmax, dtype=torch.int32, device=cuda).expand(
            b, hq, nc, kmax).contiguous()
        cnt = torch.randint(0, kmax + 1, (b, hq, nc), generator=gen,
                            device=cuda).to(torch.int32)
        pos = torch.tensor([130, 600, 0], dtype=torch.int32, device=cuda)
        q = torch.randn((b, hq, nc, rows, d), generator=gen, device=cuda).to(dt)
        got = t_kern.attend_pages(q, k, v, gp, idx, cnt, pos, block_size=bs,
                                  causal=causal, lane="decode")
        want = t_kern.attend_pages_plain(q, k, v, gp, idx, cnt, pos,
                                         block_size=bs, causal=causal)
        _assert_close(got, want, p_bf16=causal)
        assert torch.all(got[cnt == 0] == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_group_16_on_card(cuda, dtype):
    """glm4-9b's heads (32 query / 2 KV, GQA group 16) through every
    attention kernel: the page scorer (decode broadcast and chunk
    layouts), both page-attention lanes, block-sparse attention (with and
    without group dedup) and flash attention."""
    _gqa_through_every_kernel(cuda, dtype, 32, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_group_7_on_card(cuda, dtype):
    """arctic-480b's heads (56 query / 8 KV: an odd GQA group of 7) through
    every attention kernel, as above."""
    _gqa_through_every_kernel(cuda, dtype, 56, 8)


def _gqa_through_every_kernel(cuda, dtype, hq, hk):
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(hq // hk)
    d, bs, s, maxp, b = 128, 128, 16, 6, 2
    group = hq // hk
    P = 1 + b * maxp
    k = torch.randn((hk, P, bs, d), generator=gen, device=cuda).to(dt)
    v = torch.randn((hk, P, bs, d), generator=gen, device=cuda).to(dt)
    kg = torch.randn((hk, P, s, d), generator=gen, device=cuda)
    pt = (1 + torch.randperm(P - 1, generator=gen, device=cuda)).to(
        torch.int32).reshape(b, maxp)
    for nc, lane, pair in ((1, "decode", False), (2, "chunk", True)):
        qp = torch.randn((b, hq, nc, s, d), generator=gen, device=cuda)
        if lane == "decode":
            qp = qp[:, :, :, :1].expand(b, hq, nc, s, d)
        got = t_kern.score_pages(qp, kg, pt, group=group, scale=0.1, lane=lane,
                                 pair=pair)
        want = t_kern.score_pages_plain(qp, kg, pt, group=group, scale=0.1,
                                        pair=pair)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    for rows, causal, nc, lane in ((1, False, 1, "decode"), (bs, True, 2, "chunk")):
        kmax = 4
        gp = pt[:, None, None, :kmax].expand(b, hq, nc, kmax).contiguous()
        idx = torch.arange(kmax, dtype=torch.int32, device=cuda).expand(
            b, hq, nc, kmax).contiguous()
        cnt = torch.randint(0, kmax + 1, (b, hq, nc), generator=gen,
                            device=cuda).to(torch.int32)
        pos = torch.tensor([300, 2 * bs], dtype=torch.int32, device=cuda)
        q = torch.randn((b, hq, nc, rows, d), generator=gen, device=cuda).to(dt)
        got = t_kern.attend_pages(q, k, v, gp, idx, cnt, pos, block_size=bs,
                                  causal=causal, lane=lane)
        want = t_kern.attend_pages_plain(q, k, v, gp, idx, cnt, pos,
                                         block_size=bs, causal=causal)
        _assert_close(got, want, p_bf16=causal)
        assert torch.all(got[cnt == 0] == 0)
    n, nq = 4 * bs, 4
    q = torch.randn((1, hq, n, d), generator=gen, device=cuda).to(dt)
    kk = torch.randn((1, hk, n, d), generator=gen, device=cuda).to(dt)
    vv = torch.randn((1, hk, n, d), generator=gen, device=cuda).to(dt)
    _assert_close(t_fa.flash_attention(q, kk, vv),
                  t_fa.flash_attention_plain(q, kk, vv), p_bf16=True)
    rows_ = torch.arange(nq, device=cuda)[:, None]
    for dedup in (False, True):
        hsel = hk if dedup else hq
        idx = torch.clamp(rows_ - torch.arange(3, device=cuda)[None, :], min=0)
        idx = idx.expand(1, hsel, nq, 3).to(torch.int32).contiguous()
        cnt = torch.minimum(torch.randint(1, 4, (1, hsel, nq), generator=gen,
                                          device=cuda), rows_[:, 0] + 1)
        cnt = cnt.to(torch.int32).contiguous()
        got = t_bsa.block_sparse_attention(q, kk, vv, idx, live_counts=cnt,
                                           block_size=bs, group_dedup=dedup)
        want = t_bsa.block_sparse_attention_plain(q, kk, vv, idx, cnt, block_size=bs,
                                                  group_dedup=dedup)
        _assert_close(got, want, p_bf16=True)


def _page_lists(rng, lists, kmax, table, bad_id):
    """Per-row logical page lists -> (gp, idx, cnt) of the raw lists (with
    one out-of-range physical id inserted where ``bad_id`` gives one) and
    of the clean lists the plain version is held to.  Dead slots repeat
    the last live entry; a list of None is a cnt == 0 row."""
    shape = lists.shape
    out = {k: np.zeros(shape + (kmax,), np.int32) for k in ("gp", "idx", "gpc", "idxc")}
    cnt = np.zeros(shape, np.int32)
    cntc = np.zeros(shape, np.int32)
    for r in np.ndindex(shape):
        pages = lists[r]
        empty = pages is None
        pages = [0] if empty else pages
        ids = [int(table[r[0], j]) for j in pages]
        raw_gp, raw_idx = list(ids), list(pages)
        bad = bad_id(r)
        if bad is not None:
            at = rng.randint(0, len(raw_gp) + 1)
            raw_gp.insert(at, bad)
            raw_idx.insert(at, 0)
        for key, g, i in (("", raw_gp, raw_idx), ("c", ids, pages)):
            out["gp" + key][r] = g + [g[-1]] * (kmax - len(g))
            out["idx" + key][r] = i + [i[-1]] * (kmax - len(i))
        cnt[r] = 0 if empty else len(raw_gp)
        cntc[r] = 0 if empty else len(ids)
    return (out["gp"], out["idx"], cnt), (out["gpc"], out["idxc"], cntc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [1, 2])
def test_chunk_lane_selection_edges_on_card(cuda, dtype, group):
    """The chunk lane (bf16: the wgmma kernel) on chunks that start at 130,
    8192 + 64 and 0: each row lists lower pages, the one or two pages that
    straddle its tile (anywhere in the list), a page wholly above the tile
    (skipped) and, in some rows, an out-of-range page id (skipped: held
    against the plain version on the list without it); some rows are
    empty (exact zeros)."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(30 + group)
    rng = np.random.RandomState(30 + group)
    hq, d, bs, nc, kmax = 4, 128, 128, 2, 12
    hk = hq // group
    pos = np.asarray([130, 8192 + 64, 0], np.int32)
    b = len(pos)
    maxp = (int(pos.max()) + nc * bs) // bs + 2
    P = 1 + b * maxp
    table = (1 + rng.permutation(P - 1)[:b * maxp]).reshape(b, maxp)
    lists = np.empty((b, hq, nc), object)
    for r in np.ndindex(lists.shape):
        q0 = int(pos[r[0]]) + r[2] * bs
        first, last = q0 // bs, (q0 + bs - 1) // bs
        pages = [int(x) for x in rng.permutation(first)[:kmax - 4]]
        for j in list(range(first, last + 1)) + [last + 1]:
            pages.insert(rng.randint(0, len(pages) + 1), j)
        lists[r] = None if sum(r) % 5 == 3 else pages
    raw, clean = _page_lists(rng, lists, kmax, table,
                             lambda r: [P + 3, -1, None][sum(r) % 3])
    k = torch.randn((hk, P, bs, d), generator=gen, device=cuda).to(dt)
    v = torch.randn((hk, P, bs, d), generator=gen, device=cuda).to(dt)
    q = torch.randn((b, hq, nc, bs, d), generator=gen, device=cuda).to(dt)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    posd = t(pos)
    got = t_kern.attend_pages(q, k, v, *map(t, raw), posd, block_size=bs,
                              causal=True, lane="chunk")
    want = t_kern.attend_pages_plain(q, k, v, *map(t, clean), posd,
                                     block_size=bs, causal=True)
    _assert_close(got, want, p_bf16=True)
    empty = t(raw[2]) == 0
    assert bool(empty.any()) and torch.all(got[empty] == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [1, 2])
def test_decode_lane_split_edges_on_card(cuda, dtype, group):
    """The decode lane's split and combine kernels with live counts of 0, 1,
    exactly one split (PAGES_PER_SPLIT), one more than a split, one more
    than two splits and the full width.  The two heads of every other head
    pair list the same pages in another order (the split kernel takes a
    row's slots in page order); the other pairs list their own pages.
    Lists hold the row's partial last page (unaligned lengths) and pages
    past the length (masked), and some rows an out-of-range page id
    (skipped)."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(40 + group)
    rng = np.random.RandomState(40 + group)
    pps = t_kern.PAGES_PER_SPLIT
    hq, d, bs = 8, 128, 128
    hk = hq // group
    kmax = 3 * pps + 1
    lens = np.asarray([bs * 12 + 37, 700], np.int32)
    b, maxp = len(lens), 16
    P = 1 + b * maxp
    table = (1 + rng.permutation(P - 1)[:b * maxp]).reshape(b, maxp)
    counts = [0, 1, pps, pps + 1, 2 * pps + 1, kmax - 1]
    lists = np.empty((b, hq, 1), object)
    for r in np.ndindex(lists.shape):
        pair = r[1] // 2
        n = counts[(r[0] * hq // 2 + pair) % len(counts)]
        if r[1] % 2 and pair % 2 == 0:                 # the pair's first list
            twin = lists[r[0], r[1] - 1, 0]
            lists[r] = None if twin is None else [int(x) for x in rng.permutation(twin)]
            continue
        last = (int(lens[r[0]]) - 1) // bs
        others = [int(x) for x in rng.permutation(maxp) if x != last]
        pages = others[:max(n - 1, 0)]
        pages.insert(rng.randint(0, len(pages) + 1), last)
        lists[r] = None if n == 0 else pages[:n]
    raw, clean = _page_lists(rng, lists, kmax, table,
                             lambda r: P + 1 if r[1] % 3 == 1 else None)
    k = torch.randn((hk, P, bs, d), generator=gen, device=cuda).to(dt)
    v = torch.randn((hk, P, bs, d), generator=gen, device=cuda).to(dt)
    q = torch.randn((b, hq, 1, 1, d), generator=gen, device=cuda).to(dt)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    lensd = t(lens)
    got = t_kern.attend_pages(q, k, v, *map(t, raw), lensd, block_size=bs,
                              causal=False, lane="decode")
    want = t_kern.attend_pages_plain(q, k, v, *map(t, clean), lensd,
                                     block_size=bs, causal=False)
    _assert_close(got, want)
    empty = t(raw[2]) == 0
    assert bool(empty.any()) and torch.all(got[empty] == 0)


@pytest.mark.parametrize("group", [1, 2])
def test_bf16_rule_rejects_a_dropped_page_on_card(cuda, group):
    """The p_bf16 rule holds the chunk lane's long rows: at a chunk at
    position 4096 over every causal page (the straddled page first), the
    wgmma kernel's output passes it, and fails it once the last live page
    is dropped from every row that has two or more."""
    gen = torch.Generator(device=cuda).manual_seed(50 + group)
    hq, d, bs, nc, start = 4, 128, 128, 2, 4096
    hk = hq // group
    nk = start // bs + nc
    k = torch.randn((hk, nk, bs, d), generator=gen, device=cuda).to(torch.bfloat16)
    v = torch.randn((hk, nk, bs, d), generator=gen, device=cuda).to(torch.bfloat16)
    q = torch.randn((1, hq, nc, bs, d), generator=gen, device=cuda).to(torch.bfloat16)
    # chunk row ci lists its own page first, then pages 0 .. its own - 1
    own = start // bs + torch.arange(nc, device=cuda)[:, None]
    j = torch.arange(nk, device=cuda)[None, :]
    idx = torch.where(j == 0, own, j - 1).expand(1, hq, nc, nk).to(torch.int32).contiguous()
    cnt = (own[:, 0] + 1).expand(1, hq, nc).to(torch.int32).contiguous()
    pos = torch.tensor([start], dtype=torch.int32, device=cuda)
    run = lambda c: t_kern.attend_pages(q, k, v, idx, idx, c, pos, block_size=bs,
                                        causal=True, lane="chunk")
    want = t_kern.attend_pages_plain(q, k, v, idx, idx, cnt, pos, block_size=bs,
                                     causal=True)
    _assert_close(run(cnt), want, p_bf16=True)
    with pytest.raises(AssertionError):
        _assert_close(run(torch.where(cnt >= 2, cnt - 1, cnt).contiguous()), want,
                      p_bf16=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("n", [100, 200, 256, 1000, 4096])
def test_flash_matches_plain_on_card(cuda, dtype, group, n):
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(n + group)
    hq, d = 4, 128
    q = torch.randn((2, hq, n, d), generator=gen, device=cuda).to(dt)
    k = torch.randn((2, hq // group, n, d), generator=gen, device=cuda).to(dt)
    v = torch.randn((2, hq // group, n, d), generator=gen, device=cuda).to(dt)
    got = t_fa.flash_attention(q, k, v)
    _assert_close(got, t_fa.flash_attention_plain(q, k, v), p_bf16=True)


@pytest.mark.parametrize("group", [1, 2])
def test_bf16_rule_rejects_a_dropped_key_tile_on_card(cuda, group):
    """The bf16 attention rule holds long rows: at n = 4096 the flash
    kernel's output passes it, and the block-sparse kernel's output over
    every causal block passes it too, but not once one key tile (block
    i - 1) is dropped from each row past 2k."""
    gen = torch.Generator(device=cuda).manual_seed(20 + group)
    n, hq, d, bs = 4096, 4, 128, 128
    nq = n // bs
    q = torch.randn((1, hq, n, d), generator=gen, device=cuda).to(torch.bfloat16)
    k = torch.randn((1, hq // group, n, d), generator=gen, device=cuda).to(torch.bfloat16)
    v = torch.randn((1, hq // group, n, d), generator=gen, device=cuda).to(torch.bfloat16)
    want = t_fa.flash_attention_plain(q, k, v)
    _assert_close(t_fa.flash_attention(q, k, v), want, p_bf16=True)
    # row i lists its diagonal block first, then blocks 0..i-1
    i = torch.arange(nq, device=cuda)[:, None]
    j = torch.arange(nq, device=cuda)[None, :]
    idx = torch.where(j == 0, i, j - 1).expand(1, hq, nq, nq).to(torch.int32).contiguous()
    run = lambda cnt: t_bsa.block_sparse_attention(
        q, k, v, idx, live_counts=cnt.expand(1, hq, nq).to(torch.int32).contiguous(),
        block_size=bs)
    _assert_close(run(i[:, 0] + 1), want, p_bf16=True)
    with pytest.raises(AssertionError):
        _assert_close(run(torch.where(i[:, 0] >= nq // 2, i[:, 0], i[:, 0] + 1)),
                      want, p_bf16=True)


def test_wgmma_tile_products_on_card(cuda):
    """The tensor-core tile's layouts (128-byte swizzled TMA boxes, K-major
    descriptors of Q and K, the MN-major V descriptor, P's register
    fragments) on one 128 x 128 tile against torch.matmul: a wrong layout
    gives wrong numbers, not a crash."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    a, b, p, v = (torch.randn((128, 128), generator=gen, device=cuda).to(torch.bfloat16)
                  for _ in range(4))
    s, o = t_fa.wgmma_tile_products(a, b, p, v)
    for got, want in ((s, a.double() @ b.double().T), (o, p.double() @ v.double())):
        err = float((got.double() - want).abs().max())
        assert err <= 1e-3 * float(want.abs().max()), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dedup", [False, True])
def test_block_sparse_matches_plain_on_card(cuda, dtype, dedup):
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(int(dedup))
    b, hq, hk, d, bs, nq, kmax = 2, 4, 2, 128, 128, 6, 4
    n = nq * bs
    hsel = hk if dedup else hq
    q = torch.randn((b, hq, n, d), generator=gen, device=cuda).to(dt)
    k = torch.randn((b, hk, n, d), generator=gen, device=cuda).to(dt)
    v = torch.randn((b, hk, n, d), generator=gen, device=cuda).to(dt)
    # Row i selects its diagonal block first, then lower blocks; live counts
    # cover 0..min(i+1, kmax) slots, so some rows are empty.
    rows = torch.arange(nq, device=cuda)[:, None]
    idx = torch.clamp(rows - torch.arange(kmax, device=cuda)[None, :], min=0)
    idx = idx.expand(b, hsel, nq, kmax).to(torch.int32).contiguous()
    cnt = torch.randint(0, kmax + 1, (b, hsel, nq), generator=gen, device=cuda)
    cnt = torch.minimum(cnt, rows[:, 0] + 1).to(torch.int32).contiguous()
    got = t_bsa.block_sparse_attention(q, k, v, idx, live_counts=cnt,
                                       block_size=bs, group_dedup=dedup)
    want = t_bsa.block_sparse_attention_plain(q, k, v, idx, cnt, block_size=bs,
                                              group_dedup=dedup)
    _assert_close(got, want, p_bf16=True)
    full = torch.repeat_interleave(cnt, hq // hsel, dim=1)
    assert torch.all(got.reshape(b, hq, nq, bs, d)[full == 0] == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("bs", [128, 256])
def test_block_sparse_selection_edges_on_card(cuda, dtype, dedup, bs):
    """Rows whose diagonal block is not last, whose live prefix holds ids
    outside [0, nq) and blocks above the diagonal, and empty rows: the
    kernel skips the bad ids (held against the plain version on the list
    without them) and writes exact zeros for cnt == 0."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(10 + int(dedup))
    rng = np.random.RandomState(bs + int(dedup))
    b, hq, hk, d, nq, kmax = 1, 4, 2, 128, 7, 6
    n = nq * bs
    hsel = hk if dedup else hq
    q = torch.randn((b, hq, n, d), generator=gen, device=cuda).to(dt)
    k = torch.randn((b, hk, n, d), generator=gen, device=cuda).to(dt)
    v = torch.randn((b, hk, n, d), generator=gen, device=cuda).to(dt)
    idx = np.zeros((b, hsel, nq, kmax), np.int32)
    clean = np.zeros_like(idx)
    cnt = np.zeros((b, hsel, nq), np.int32)
    cnt_clean = np.zeros_like(cnt)
    for h in range(hsel):
        for i in range(nq):
            good = list(rng.permutation(i))[:kmax - 3]
            good.insert(rng.randint(0, max(len(good), 1)), i)   # diagonal, not last
            if i + 1 < nq:
                good.insert(rng.randint(0, len(good) + 1), i + 1)   # above: no key
            row = list(good)
            row.insert(rng.randint(0, len(row) + 1), [nq + 2, -1][(h + i) % 2])
            live = 0 if (h + i) % 5 == 3 else len(row)
            idx[0, h, i, :len(row)] = row
            cnt[0, h, i] = live
            clean[0, h, i, :len(good)] = good
            cnt_clean[0, h, i] = len(good) if live else 0
    t = lambda a: torch.from_numpy(a).to(cuda)
    got = t_bsa.block_sparse_attention(q, k, v, t(idx), live_counts=t(cnt),
                                       block_size=bs, group_dedup=dedup)
    want = t_bsa.block_sparse_attention_plain(q, k, v, t(clean), t(cnt_clean),
                                              block_size=bs, group_dedup=dedup)
    _assert_close(got, want, p_bf16=True)
    full = torch.repeat_interleave(t(cnt), hq // hsel, dim=1)
    assert bool((full == 0).any())
    assert torch.all(got.reshape(b, hq, nq, bs, d)[full == 0] == 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("out_dtype", ["float32", "input"])
def test_metric_kernels_match_plain_on_card(cuda, dtype, out_dtype):
    dt = getattr(torch, dtype)
    od = dt if out_dtype == "input" else torch.float32
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((2, 3, 512, 128), generator=gen, device=cuda).to(dt)
    x[0, 1, 128:256] = 0                      # an all-zero block: the norm floor
    got = t_sm.antidiag_pool(x, block_size=128, stride=16, out_dtype=od)
    assert got.dtype == od
    _assert_close(got, t_sm.antidiag_pool_plain(x, block_size=128, stride=16,
                                                out_dtype=od))
    vm = t_sm.value_magnitude(x, block_size=128)
    torch.testing.assert_close(vm, t_sm.value_magnitude_plain(x, block_size=128),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("s", [8, 16, 32])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("nc", [1, 8, 16])
def test_scorer_layouts_on_card(cuda, nc, group, s):
    """Both scorer kernels against ``score_pages_plain`` at atol 1e-4, at the
    lanes' scale 1 / (s sqrt(d)): the query broadcast over s (stride 0: the
    decode lane and mean pooling; the kernel sums each tile over s before
    its dot products, another summation order than the plain einsum),
    contiguous, strided (heads and chunk rows swapped in storage, half of a
    padded head_dim) and with the anti-diagonal pairing folded in.
    maxp = 37 is no multiple of any CTA's page count; page ids -1, P and
    P + 5 score NaN in exactly their columns, the rest as the clean table."""
    gen = torch.Generator(device=cuda).manual_seed(100 + nc + 7 * group + s)
    hq, d, b, maxp = 8, 128, 2, 37
    hk = hq // group
    P = 1 + b * maxp
    kg = torch.randn((hk, P, s, d), generator=gen, device=cuda)
    pt = (1 + torch.randperm(P - 1, generator=gen, device=cuda)[:b * maxp]).to(
        torch.int32).reshape(b, maxp).contiguous()
    bad = pt.clone()
    bad[0, 3], bad[1, 0], bad[1, maxp - 1] = -1, P, P + 5
    nan = torch.zeros((b, hq, nc, maxp), dtype=torch.bool, device=cuda)
    nan[0, ..., 3] = nan[1, ..., 0] = nan[1, ..., maxp - 1] = True
    scale = 1.0 / (s * d ** 0.5)
    q = torch.randn((b, hq, nc, 1, d), generator=gen, device=cuda)
    full = torch.randn((b, hq, nc, s, d), generator=gen, device=cuda)
    wide = torch.randn((b, nc, hq, s, 2 * d), generator=gen, device=cuda)
    layouts = {"broadcast": (q.expand(b, hq, nc, s, d), False),
               "contiguous": (full, False),
               "strided": (wide.transpose(1, 2)[..., d:], False),
               "paired": (full, True)}
    for name, (qp, pair) in layouts.items():
        want = t_kern.score_pages_plain(qp, kg, pt, group=group, scale=scale,
                                        pair=pair)
        before = t_kern.LAUNCHES["score/chunk"]
        got = t_kern.score_pages(qp, kg, pt, group=group, scale=scale,
                                 lane="chunk", pair=pair)
        assert t_kern.LAUNCHES["score/chunk"] == before + 1
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0, msg=name)
        got = t_kern.score_pages(qp, kg, bad, group=group, scale=scale,
                                 lane="chunk", pair=pair)
        assert torch.equal(torch.isnan(got), nan), name
        torch.testing.assert_close(got[~nan], want[~nan], atol=1e-4, rtol=0, msg=name)


@pytest.mark.parametrize("s", [8, 16, 32])
@pytest.mark.parametrize("bs", [64, 128, 256])
def test_pool_kernel_shapes_on_card(cuda, bs, s):
    """The pool kernel (16-byte loads) against its plain version over one
    block and 24 blocks of every (block size, stride) pair, fp32 and bf16
    inputs, fp32 and input-dtype outputs."""
    gen = torch.Generator(device=cuda).manual_seed(bs + s)
    for n in (bs, 24 * bs):
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn((2, 3, n, 128), generator=gen, device=cuda).to(dt)
            for od in (torch.float32, dt):
                got = t_sm.antidiag_pool(x, block_size=bs, stride=s, out_dtype=od)
                assert got.dtype == od and got.shape == (2, 3, n // bs, s, 128)
                assert t_sm.pool_vector_width(x, got) == 16 // x.element_size()
                _assert_close(got, t_sm.antidiag_pool_plain(
                    x, block_size=bs, stride=s, out_dtype=od))


@pytest.mark.parametrize("shape,out_dtype", [
    ((1, 16, 1024, 128), "float32"),      # the chunk lane's query pooling
    ((1, 8, 1024, 128), "bfloat16"),      # a chunk's page summaries
    ((1, 16, 16384, 128), "float32"),     # a 16k prompt's metric pooling
    ((1, 16, 16384, 128), "bfloat16"),
])
def test_pool_kernel_engine_shapes_on_card(cuda, shape, out_dtype):
    """The pool kernel at the shapes the serving lanes and the one-shot
    prefill give it (bf16 input, block 128, stride 16)."""
    gen = torch.Generator(device=cuda).manual_seed(shape[1] + shape[2])
    x = torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)
    od = getattr(torch, out_dtype)
    got = t_sm.antidiag_pool(x, block_size=128, stride=16, out_dtype=od)
    assert got.dtype == od and t_sm.pool_vector_width(x, got) == 8
    _assert_close(got, t_sm.antidiag_pool_plain(x, block_size=128, stride=16,
                                                out_dtype=od))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_kernel_scalar_variant_on_card(cuda, monkeypatch, dtype):
    """A contiguous view one element off 16-byte alignment, and (bf16) a
    row of 72 bytes, launch the scalar-load variant of the pool kernel —
    a counted kernel launch that matches the plain version — and never the
    plain version itself (patched to raise here).  fp32 rows of 144 bytes
    keep the 16-byte loads."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(7)
    buf = torch.randn((2 * 3 * 512 * 128 + 1,), generator=gen, device=cuda).to(dt)
    cases = [(buf[1:].view(2, 3, 512, 128), 1),
             (torch.randn((2, 512, 36), generator=gen, device=cuda).to(dt),
              1 if dt == torch.bfloat16 else 4)]
    wants = [t_sm.antidiag_pool_plain(x, block_size=128, stride=16, out_dtype=od)
             for x, _ in cases for od in (torch.float32, dt)]

    def plain(*a, **kw):
        raise AssertionError("the plain version ran on the card")

    monkeypatch.setattr(t_sm, "antidiag_pool_plain", plain)
    gots = []
    for x, width in cases:
        assert x.is_contiguous()
        for od in (torch.float32, dt):
            before = t_sm.LAUNCHES["antidiag_pool"]
            got = t_sm.antidiag_pool(x, block_size=128, stride=16, out_dtype=od)
            assert t_sm.LAUNCHES["antidiag_pool"] == before + 1
            assert t_sm.pool_vector_width(x, got) == width
            gots.append(got)
    for got, want in zip(gots, wants):
        _assert_close(got, want)


# ---------------------------------------------------------------------------
# Every shape the reference serves: head_dims 8-256, any stride, blocks and
# pages of 8-128 (the CUDA-core paths beside the d = 128 kernels)
# ---------------------------------------------------------------------------

SHAPE_DIMS = [8, 16, 64, 128, 256]
SHAPE_BLOCKS = [8, 16, 64, 128]


def _on_wgmma(dtype, d, bs, dv=None):
    """Whether a block-sparse call (bs the block; None: flash) takes the
    tensor-core tile, the path that rounds P to bf16, held to the p_bf16
    rule: ``kernels.forward_route``."""
    return forward_route(dtype, d, d if dv is None else dv, bs) == "wgmma"


def _rejects_dropped_block(q, k, v, want, bs, p_bf16):
    """The rule must see a dropped key tile at these shapes: the
    block-sparse kernel with every causal block of size bs selected (the
    diagonal first, then 0..i-1) passes it against the plain flash output
    ``want``, and fails it once the last block below the diagonal is
    dropped from each row."""
    b, hq, m = q.shape[:3]
    i = torch.arange(m // bs, device=q.device)[:, None]
    j = torch.arange(m // bs, device=q.device)[None, :]
    idx = torch.where(j == 0, i, j - 1).expand(b, hq, m // bs, m // bs)
    idx = idx.to(torch.int32).contiguous()
    cnt = (i[:, 0] + 1).expand(b, hq, m // bs).to(torch.int32).contiguous()
    run = lambda c: t_bsa.block_sparse_attention(q, k, v, idx, live_counts=c, block_size=bs)
    _assert_close(run(cnt), want, p_bf16=p_bf16)
    with pytest.raises(AssertionError):
        _assert_close(run(torch.where(cnt >= 2, cnt - 1, cnt).contiguous()), want,
                      p_bf16=p_bf16)


@pytest.mark.parametrize("s", [2, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("d", SHAPE_DIMS)
def test_scorer_head_dims_and_strides_on_card(cuda, d, s):
    """Both scorer kernels (fp32 only, as the lanes call them) at every head
    dim and stride: the tiled chunk kernel where s * d is 1024, 2048 or
    4096, the one-warp-a-page kernel elsewhere; broadcast, contiguous,
    strided and paired query layouts, and bad page ids -> NaN columns."""
    gen = torch.Generator(device=cuda).manual_seed(200 + d + s)
    hq, hk, b, nc, maxp = 4, 2, 2, 3, 13
    P = 1 + b * maxp
    kg = torch.randn((hk, P, s, d), generator=gen, device=cuda)
    pt = (1 + torch.randperm(P - 1, generator=gen, device=cuda)[:b * maxp]).to(
        torch.int32).reshape(b, maxp).contiguous()
    bad = pt.clone()
    bad[0, 2], bad[1, maxp - 1] = -1, P
    nan = torch.zeros((b, hq, nc, maxp), dtype=torch.bool, device=cuda)
    nan[0, ..., 2] = nan[1, ..., maxp - 1] = True
    scale = 1.0 / (s * d ** 0.5)
    q = torch.randn((b, hq, nc, 1, d), generator=gen, device=cuda)
    full = torch.randn((b, hq, nc, s, d), generator=gen, device=cuda)
    wide = torch.randn((b, nc, hq, s, 2 * d), generator=gen, device=cuda)
    layouts = {"broadcast": (q.expand(b, hq, nc, s, d), False),
               "contiguous": (full, False),
               "strided": (wide.transpose(1, 2)[..., d:], False),
               "paired": (full, True)}
    for name, (qp, pair) in layouts.items():
        want = t_kern.score_pages_plain(qp, kg, pt, group=2, scale=scale, pair=pair)
        got = t_kern.score_pages(qp, kg, pt, group=2, scale=scale, lane="chunk",
                                 pair=pair)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0, msg=name)
        got = t_kern.score_pages(qp, kg, bad, group=2, scale=scale, lane="chunk",
                                 pair=pair)
        assert torch.equal(torch.isnan(got), nan), name
        torch.testing.assert_close(got[~nan], want[~nan], atol=1e-4, rtol=0, msg=name)


def _visible_page_lists(causal, bs, nc, pos, hq, kmax):
    """Logical page lists whose every page holds a key the row sees: a chunk
    row lists its own (straddled) page first, then the pages below it in
    order; a decode row its last page first, then the earlier ones.  So
    the last live page of a row with two or more is a wholly visible page
    (the planted fault drops it).  Rows (b + h + ci) % 4 == 3 are empty."""
    b = len(pos)
    idx = np.zeros((b, hq, nc, kmax), np.int32)
    cnt = np.zeros((b, hq, nc), np.int32)
    for r in np.ndindex(b, hq, nc):
        own = (pos[r[0]] + r[2] * bs + bs - 1) // bs if causal else (pos[r[0]] - 1) // bs
        pages = [own] + list(range(own))[:kmax - 1]
        idx[r] = pages + [pages[-1]] * (kmax - len(pages))
        cnt[r] = 0 if sum(r) % 4 == 3 else len(pages)
    return idx, cnt


@pytest.mark.parametrize("lane", ["decode", "chunk"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bs", SHAPE_BLOCKS)
@pytest.mark.parametrize("d", SHAPE_DIMS)
def test_attend_head_dims_and_pages_on_card(cuda, d, bs, dtype, lane):
    """Page attention at every head_dim and page size, both lanes: the
    decode lane's split + combine kernels (rows past two splits, a partial
    last page, cnt == 0) and the chunk lane (an aligned and an unaligned
    chunk start); exact zeros for empty rows; and the rule must reject the
    output with the last live page dropped from each row with two or more."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(300 + d + bs)
    causal = lane == "chunk"
    hq, hk = 4, 2
    nc, rows = (2, bs) if causal else (1, 1)
    pos = np.asarray([3 * bs, 5] if causal else [9 * bs + bs // 2 + 1, 2 * bs], np.int32)
    b, maxp = len(pos), 12
    kmax = maxp
    P = 1 + b * maxp
    table = torch.randperm(P - 1, generator=gen, device=cuda)[:b * maxp] + 1
    table = table.reshape(b, maxp)
    idx, cnt = _visible_page_lists(causal, bs, nc, pos, hq, kmax)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    idx, cnt, posd = t(idx), t(cnt), t(pos)
    gp = torch.take_along_dim(table[:, None, None, :].expand(b, hq, nc, maxp).long(),
                              idx.long(), dim=-1).to(torch.int32).contiguous()
    k = torch.randn((hk, P, bs, d), generator=gen, device=cuda).to(dt)
    v = torch.randn((hk, P, bs, d), generator=gen, device=cuda).to(dt)
    q = torch.randn((b, hq, nc, rows, d), generator=gen, device=cuda).to(dt)
    run = lambda c: t_kern.attend_pages(q, k, v, gp, idx, c, posd, block_size=bs,
                                        causal=causal, lane=lane)
    want = t_kern.attend_pages_plain(q, k, v, gp, idx, cnt, posd, block_size=bs,
                                     causal=causal)
    p_bf16 = causal and dt == torch.bfloat16 and d == bs == 128    # the chunk lane's tile
    got = run(cnt)
    _assert_close(got, want, p_bf16=p_bf16)
    assert bool((cnt == 0).any()) and torch.all(got[cnt == 0] == 0)
    with pytest.raises(AssertionError):
        _assert_close(run(torch.where(cnt >= 2, cnt - 1, cnt).contiguous()), want,
                      p_bf16=p_bf16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bs", SHAPE_BLOCKS)
@pytest.mark.parametrize("d", SHAPE_DIMS)
def test_block_sparse_head_dims_and_blocks_on_card(cuda, d, bs, dtype):
    """Block-sparse attention at every head_dim and block size (a block
    under 64 rows takes a CTA of one block's rows), with and without group
    dedup: each row lists its diagonal block first, then the blocks below
    it; some rows are empty (exact zeros); and the rule must reject the
    output with the last live block dropped from each row with two or
    more."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(400 + d + bs)
    b, hq, hk, nq = 1, 4, 2, 6
    n = nq * bs
    q = torch.randn((b, hq, n, d), generator=gen, device=cuda).to(dt)
    k = torch.randn((b, hk, n, d), generator=gen, device=cuda).to(dt)
    v = torch.randn((b, hk, n, d), generator=gen, device=cuda).to(dt)
    p_bf16 = _on_wgmma(dt, d, bs)
    for dedup in (False, True):
        hsel = hk if dedup else hq
        i = torch.arange(nq, device=cuda)[:, None]
        j = torch.arange(nq, device=cuda)[None, :]
        idx = torch.where(j == 0, i, j - 1).expand(b, hsel, nq, nq)
        idx = idx.to(torch.int32).contiguous()
        cnt = (i[:, 0] + 1).expand(b, hsel, nq).clone()
        cnt[:, 1, 2] = 0
        cnt = cnt.to(torch.int32).contiguous()
        run = lambda c: t_bsa.block_sparse_attention(
            q, k, v, idx, live_counts=c, block_size=bs, group_dedup=dedup)
        want = t_bsa.block_sparse_attention_plain(q, k, v, idx, cnt, block_size=bs,
                                                  group_dedup=dedup)
        got = run(cnt)
        _assert_close(got, want, p_bf16=p_bf16)
        full = torch.repeat_interleave(cnt, hq // hsel, dim=1)
        assert torch.all(got.reshape(b, hq, nq, bs, d)[full == 0] == 0)
        with pytest.raises(AssertionError):
            _assert_close(run(torch.where(cnt >= 2, cnt - 1, cnt).contiguous()), want,
                          p_bf16=p_bf16)


@pytest.mark.parametrize("n", [100, 1000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [8, 16, 64, 256])
def test_flash_head_dims_on_card(cuda, d, dtype, n):
    """Flash attention at the head_dims beside 128, at lengths that are no
    multiple of a tile: fp32 and the narrow head_dims on the CUDA-core tile
    (bf16 loaded and stored around fp32 math, the 1e-3 row rule), bf16 at
    64 and 256 on the tensor-core tile (its own instance, whose counter
    must move; the p_bf16 rule).  The rule must reject a dropped key tile
    at these shapes: over the first rows that fill whole blocks, the
    block-sparse kernel with every causal block selected (8-key blocks; at
    n 1000 on the tensor-core route 128-key blocks, so that it runs the
    same tile) passes it against the plain flash output, and fails it once
    the last block below the diagonal is dropped from each row."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(500 + d + n)
    q = torch.randn((2, 4, n, d), generator=gen, device=cuda).to(dt)
    k = torch.randn((2, 2, n, d), generator=gen, device=cuda).to(dt)
    v = torch.randn((2, 2, n, d), generator=gen, device=cuda).to(dt)
    wg = _on_wgmma(dt, d, None)
    t_fa.reset_launches()
    _assert_close(t_fa.flash_attention(q, k, v), t_fa.flash_attention_plain(q, k, v),
                  p_bf16=wg)
    assert t_fa.LAUNCHES.get(wgmma_counter("flash_attention", d, d), 0) == int(wg)
    bs = 128 if wg and n >= 256 else 8
    m = n - n % bs
    qm, km, vm = (x[:, :, :m].contiguous() for x in (q, k, v))
    _rejects_dropped_block(qm, km, vm, t_fa.flash_attention_plain(qm, km, vm), bs,
                           p_bf16=_on_wgmma(dt, d, bs))


# MLA's (q/k, v) head_dim pairs: deepseek-v3-671b's attention and its MTP
# layer, and the reduced config's.
MLA_PAIRS = [(192, 128), (192, 192), (24, 16), (24, 24)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,dv", MLA_PAIRS, ids=lambda p: str(p))
def test_flash_separate_v_head_dim_on_card(cuda, d, dv, dtype):
    """Flash attention at MLA's pairs (V, the output and its store at dv,
    the scores at d), 128 query / KV heads as deepseek-v3-671b has them at
    a short length and GQA group 2 at a length that is no multiple of a
    tile; the output is (b, hq, n, dv).  bf16 at (192, 128) and (192, 192)
    runs the tensor-core tile (its instance's counter moves; the p_bf16
    rule, which must reject a dropped 128-key block at n 256), the rest the
    CUDA-core tile (the 1e-3 row rule)."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(900 + d + dv)
    wg = _on_wgmma(dt, d, None, dv)
    for b, hq, hk, n in ((1, 128, 128, 256), (2, 4, 2, 300)):
        q = torch.randn((b, hq, n, d), generator=gen, device=cuda).to(dt)
        k = torch.randn((b, hk, n, d), generator=gen, device=cuda).to(dt)
        v = torch.randn((b, hk, n, dv), generator=gen, device=cuda).to(dt)
        t_fa.reset_launches()
        got = t_fa.flash_attention(q, k, v)
        assert tuple(got.shape) == (b, hq, n, dv) and got.dtype == dt
        assert t_fa.LAUNCHES.get(wgmma_counter("flash_attention", d, dv), 0) == int(wg)
        want = t_fa.flash_attention_plain(q, k, v)
        _assert_close(got, want, p_bf16=wg)
        if wg and n % 128 == 0:
            _rejects_dropped_block(q, k, v, want, 128, p_bf16=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bs", [8, 128])
@pytest.mark.parametrize("d,dv", MLA_PAIRS, ids=lambda p: str(p))
def test_block_sparse_separate_v_head_dim_on_card(cuda, d, dv, bs, dtype):
    """Block-sparse attention at MLA's pairs, with and without group
    dedup, block 8 (the reduced config's) and 128 (the published): every
    causal block selected, some rows empty (exact zeros), and the rule
    must reject the output with the last live block dropped from each row
    with two or more.  bf16 at (192, 128) / (192, 192) and block 128 runs
    the tensor-core tile (its counter moves; the p_bf16 rule)."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(950 + d + dv + bs)
    b, hq, hk, nq = 1, 4, 2, 6
    wg = _on_wgmma(dt, d, bs, dv)
    n = nq * bs
    q = torch.randn((b, hq, n, d), generator=gen, device=cuda).to(dt)
    k = torch.randn((b, hk, n, d), generator=gen, device=cuda).to(dt)
    v = torch.randn((b, hk, n, dv), generator=gen, device=cuda).to(dt)
    for dedup in (False, True):
        hsel = hk if dedup else hq
        i = torch.arange(nq, device=cuda)[:, None]
        j = torch.arange(nq, device=cuda)[None, :]
        idx = torch.where(j == 0, i, j - 1).expand(b, hsel, nq, nq)
        idx = idx.to(torch.int32).contiguous()
        cnt = (i[:, 0] + 1).expand(b, hsel, nq).clone()
        cnt[:, 1, 2] = 0
        cnt = cnt.to(torch.int32).contiguous()
        run = lambda c: t_bsa.block_sparse_attention(
            q, k, v, idx, live_counts=c, block_size=bs, group_dedup=dedup)
        want = t_bsa.block_sparse_attention_plain(q, k, v, idx, cnt, block_size=bs,
                                                  group_dedup=dedup)
        t_bsa.reset_launches()
        got = run(cnt)
        assert t_bsa.LAUNCHES.get(wgmma_counter("block_sparse_attention", d, dv), 0) == int(wg)
        assert tuple(got.shape) == (b, hq, n, dv)
        _assert_close(got, want, p_bf16=wg)
        full = torch.repeat_interleave(cnt, hq // hsel, dim=1)
        assert torch.all(got.reshape(b, hq, nq, bs, dv)[full == 0] == 0)
        with pytest.raises(AssertionError):
            _assert_close(run(torch.where(cnt >= 2, cnt - 1, cnt).contiguous()), want,
                          p_bf16=wg)


def test_unlisted_head_dim_pairs_raise_on_card(cuda):
    """A (q/k, v) pair outside kernels.HEAD_DIM_PAIRS raises ValueError in
    both prefill wrappers: no fallback to the plain version."""
    idx = torch.zeros((1, 2, 2, 1), dtype=torch.int32, device=cuda)
    cnt = torch.ones((1, 2, 2), dtype=torch.int32, device=cuda)
    for d, dv in ((192, 64), (128, 192), (24, 8)):
        qk = torch.zeros((1, 2, 256, d), device=cuda)
        v = torch.zeros((1, 2, 256, dv), device=cuda)
        with pytest.raises(ValueError, match="head_dim"):
            t_fa.flash_attention(qk, qk, v)
        with pytest.raises(ValueError, match="head_dim"):
            t_bsa.block_sparse_attention(qk, qk, v, idx, live_counts=cnt,
                                         block_size=128)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bs", SHAPE_BLOCKS)
@pytest.mark.parametrize("d", SHAPE_DIMS)
def test_vmag_head_dims_and_blocks_on_card(cuda, d, bs, dtype):
    """The value-magnitude kernel (16-byte strips) at every head_dim and
    block size, a block count that leaves the card idle (thread-block
    clusters split each block's rows) and one that fills it, with an
    all-zero block (log of the 1e-20 floor)."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(600 + d + bs)
    for nb in (3, 200):
        v = torch.randn((2, 3, nb * bs, d), generator=gen, device=cuda).to(dt)
        v[0, 1, bs:2 * bs] = 0
        assert t_sm.vmag_vector_width(v) == 16 // v.element_size()
        got = t_sm.value_magnitude(v, block_size=bs)
        want = t_sm.value_magnitude_plain(v, block_size=bs)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
        assert float(got[0, 1, 1]) == pytest.approx(float(np.log(np.float32(1e-20))))


@pytest.mark.parametrize("shape", [
    (1, 8, 1024, 128),        # a chunk's page summaries (the chunk lane)
    (1, 8, 128, 128),         # one page
    (1, 8, 16384, 128),       # a 16k prompt
])
def test_vmag_engine_shapes_on_card(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(shape[2])
    v = torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)
    v[0, 0, :128] = 0
    torch.testing.assert_close(t_sm.value_magnitude(v, block_size=128),
                               t_sm.value_magnitude_plain(v, block_size=128),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vmag_scalar_variant_on_card(cuda, monkeypatch, dtype):
    """A contiguous view one element off 16-byte alignment, and rows that
    are not a power-of-two number of 16-byte strips (d 96, 36), launch the
    scalar-load variant of the vmag kernel — a counted kernel launch that
    matches the plain version — and never the plain version itself."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(8)
    buf = torch.randn((2 * 3 * 512 * 128 + 1,), generator=gen, device=cuda).to(dt)
    cases = [buf[1:].view(2, 3, 512, 128),
             torch.randn((2, 512, 96), generator=gen, device=cuda).to(dt),
             torch.randn((2, 512, 36), generator=gen, device=cuda).to(dt)]
    cases[1][1, 128:256] = 0
    wants = [t_sm.value_magnitude_plain(x, block_size=128) for x in cases]

    def plain(*a, **kw):
        raise AssertionError("the plain version ran on the card")

    monkeypatch.setattr(t_sm, "value_magnitude_plain", plain)
    for x, want in zip(cases, wants):
        assert x.is_contiguous() and t_sm.vmag_vector_width(x) == 1
        before = t_sm.LAUNCHES["value_magnitude"]
        got = t_sm.value_magnitude(x, block_size=128)
        assert t_sm.LAUNCHES["value_magnitude"] == before + 1
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


def test_unsupported_shapes_raise_on_card(cuda):
    """Outside the kernels' shapes the wrappers raise ValueError: no
    fallback to the plain version."""
    x = torch.zeros((1, 2, 256, 96), device=cuda)
    idx = torch.zeros((1, 2, 2, 1), dtype=torch.int32, device=cuda)
    cnt = torch.ones((1, 2, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        t_fa.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="head_dim"):
        t_bsa.block_sparse_attention(x, x, x, idx, live_counts=cnt, block_size=128)
    kg = torch.zeros((2, 3, 4, 96), device=cuda)
    pt = torch.ones((1, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        t_kern.score_pages(torch.zeros((1, 2, 1, 4, 96), device=cuda), kg, pt, group=1,
                           scale=1.0, lane="chunk")
    sel = torch.zeros((1, 2, 1, 1), dtype=torch.int32, device=cuda)
    lens = torch.ones((1,), dtype=torch.int32, device=cuda)
    for d, page in ((96, 8), (8, 256)):
        pool = torch.zeros((2, 3, page, d), device=cuda)
        with pytest.raises(ValueError):
            t_kern.attend_pages(torch.zeros((1, 2, 1, 1, d), device=cuda), pool, pool,
                                sel, sel, cnt[:, :, :1].contiguous(), lens,
                                block_size=page, causal=False, lane="decode")


# ---------------------------------------------------------------------------
# The small configurations served on the card under the default executor
# ---------------------------------------------------------------------------

# tests/test_engine.py's config, policy and trace, and the reduced qwen3-0.6b
# (head_dim 16) at block 128 / stride 16 with a smaller budget floor
TINY = dict(name="engine-tiny", family="dense", num_layers=2, d_model=32,
            num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64,
            qk_norm=True, dtype="float32")
TINY_STEM = dict(block_size=8, sink_blocks=1, local_blocks=1, min_budget_blocks=2,
                 stride=4)
TINY_TRACE = [(5, 4, 0), (13, 6, 0), (8, 3, 1), (20, 5, 3), (9, 4, 5)]
REDUCED_STEM = dict(sink_blocks=1, local_blocks=1, min_budget_blocks=2)
REDUCED_TRACE = [(100, 6, 0), (700, 6, 0), (1300, 5, 1), (260, 5, 3)]
CHUNKED_KERNELS = ("score/decode", "score/chunk", "attend/decode", "attend/chunk",
                   "antidiag_pool", "value_magnitude")
MONOLITHIC_KERNELS = ("score/decode", "attend/decode", "block_sparse_attention",
                      "flash_attention", "antidiag_pool", "value_magnitude")


def _small_config(name, dtype="float32"):
    from repro_torch.configs import ARCTIC_480B, QWEN3_0_6B, reduced
    from repro_torch.configs.base import ArchConfig
    from repro_torch.core import policy as t_policy
    if name == "tiny":
        return ArchConfig(**TINY), t_policy.get_policy("stem").with_updates(
            **TINY_STEM), TINY_TRACE
    base = ARCTIC_480B if name == "arctic-480b-reduced" else QWEN3_0_6B
    return (reduced(base).replace(dtype=dtype),
            t_policy.get_policy("stem").with_updates(**REDUCED_STEM), REDUCED_TRACE)


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(x, device) for k, x in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(x, device) for x in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def serve_small(name, device, executor, monolithic, dtype="float32"):
    """Serve a small configuration's trace (2 slots, budget_frac 0.5) with
    seeded weights drawn on the CPU; returns the greedy streams and the
    launch counts of the run (zeroed just before it, read just after).  On
    the card every call the run makes to a kernel is recorded
    (kernels/replay.py) and held against its plain version on the recorded
    arguments (fp32 1e-4; bf16 2 ulps + 1e-3 of the row's max|plain|)."""
    from repro_torch.models import registry as t_registry
    from repro_torch.runtime import engine as t_engine
    cfg, policy, trace = _small_config(name, dtype)
    bundle = t_registry.build(cfg)
    params = _to_device(bundle.init_params(torch.Generator().manual_seed(0),
                                           device="cpu"), device)
    ecfg = t_engine.EngineConfig.for_trace(
        max_slots=2, max_prompt=max(p for p, _, _ in trace),
        max_new_tokens=max(m for _, m, _ in trace), page_size=policy.block_size,
        budget_frac=0.5, executor=executor, monolithic_prefill=monolithic)
    engine = t_engine.StemEngine(bundle, params, policy, ecfg)
    rng = np.random.RandomState(7)
    reqs = [t_engine.Request(uid=i, prompt=rng.randint(0, cfg.vocab_size, size=(p,))
                             .astype(np.int32), max_new_tokens=m, arrival_step=a)
            for i, (p, m, a) in enumerate(trace)]
    counters = (t_kern, t_bsa, t_fa, t_sm)
    for mod in counters:
        mod.reset_launches()
    with replay.Recorder() as rec:
        finished = engine.run(reqs)
    launches = {}
    for mod in counters:
        launches.update(mod.LAUNCHES)
    if device.type == "cuda":
        rec.check()
    assert [f.uid for f in finished] == list(range(len(trace)))
    assert engine.allocator.available == ecfg.num_pages - 1
    return [f.tokens for f in finished], launches


@pytest.mark.parametrize("monolithic", [False, True], ids=["chunked", "monolithic"])
@pytest.mark.parametrize("name", ["tiny", "qwen3-0.6b-reduced", "arctic-480b-reduced"])
def test_small_configs_serve_fused_on_card(cuda, name, monolithic):
    """TINY (head_dim 8, stride 4, block 8), the reduced qwen3-0.6b
    (head_dim 16) and the reduced arctic-480b (the MoE FFN: 8 experts,
    top-2, a residual dense FFN) in fp32 serve under the default "fused" executor on the
    card: every kernel of the path launches, and the greedy streams equal
    the "gather" executor's on the card and the port's CPU run."""
    fused, launches = serve_small(name, cuda, "fused", monolithic)
    need = MONOLITHIC_KERNELS if monolithic else CHUNKED_KERNELS
    assert all(launches[k] > 0 for k in need), launches
    assert serve_small(name, cuda, "gather", monolithic)[0] == fused
    assert serve_small(name, torch.device("cpu"), "fused", monolithic)[0] == fused


@pytest.mark.parametrize("monolithic", [False, True], ids=["chunked", "monolithic"])
def test_reduced_qwen3_serves_bf16_on_card(cuda, monolithic):
    """The reduced qwen3-0.6b in its own dtype (bf16: the CUDA-core tiles'
    bf16 loads and stores at head_dim 16) serves under "fused" through every
    kernel of the path, each recorded kernel call within the bf16 rule of
    its plain version, and its greedy streams equal the "gather"
    executor's on the card."""
    streams, launches = serve_small("qwen3-0.6b-reduced", cuda, "fused", monolithic,
                                    dtype="bfloat16")
    need = MONOLITHIC_KERNELS if monolithic else CHUNKED_KERNELS
    assert all(launches[k] > 0 for k in need), launches
    assert serve_small("qwen3-0.6b-reduced", cuda, "gather", monolithic,
                       dtype="bfloat16")[0] == streams


def serve_preempted(device, monolithic):
    """TINY in fp32 under "fused", one slot: a priority-1 arrival preempts
    the running request (its pages offloaded to host memory and restored
    into other pages), under an alloc denial and a step failure.  Returns
    the streams, the engine counts and the offload peak bytes."""
    from repro_torch.models import registry as t_registry
    from repro_torch.runtime import chaos as t_chaos
    from repro_torch.runtime import engine as t_engine
    cfg, policy, _ = _small_config("tiny")
    bundle = t_registry.build(cfg)
    params = _to_device(bundle.init_params(torch.Generator().manual_seed(0),
                                           device="cpu"), device)
    ecfg = t_engine.EngineConfig.for_trace(
        max_slots=1, max_prompt=20, max_new_tokens=8, page_size=policy.block_size,
        budget_frac=0.5, monolithic_prefill=monolithic)
    chaos = t_chaos.ChaosInjector(t_chaos.ChaosConfig(deny_alloc_steps=(0,),
                                                      fail_steps=(2,)))
    engine = t_engine.StemEngine(bundle, params, policy, ecfg, chaos=chaos)
    rng = np.random.RandomState(23)
    reqs = [t_engine.Request(uid=0, prompt=rng.randint(0, 64, size=(20,)).astype(
                np.int32), max_new_tokens=8),
            t_engine.Request(uid=1, prompt=rng.randint(0, 64, size=(13,)).astype(
                np.int32), max_new_tokens=4, priority=1, arrival_step=4)]
    finished = engine.run(reqs)
    assert all(f.error is None for f in finished)
    engine.allocator.check_conservation([])
    counts = {k: engine.stats[k] for k in ("preemptions", "restores", "aborts",
                                           "step_failures", "alloc_denials")}
    return [f.tokens for f in finished], counts, engine.metrics["offload_peak_bytes"]


@pytest.mark.parametrize("monolithic", [False, True], ids=["chunked", "monolithic"])
def test_tiny_preempts_and_restores_on_card(cuda, monolithic):
    """Preemption with host offload on the card: the pinned host snapshot
    round-trips bitwise into other pages, and TINY's preempted run (under
    an alloc denial and a step failure) equals the port's CPU run: streams,
    counts and offloaded bytes."""
    from repro_torch.runtime import offload as t_offload
    from repro_torch.runtime import paged as t_paged
    pool = t_paged.init_pool(8, 2, 8, 8, 4, device=cuda, layers=2)
    for leaf in pool:
        leaf.normal_()
    tree = [{"sub0": pool}]
    store = t_offload.HostPageStore()
    store.put(0, t_offload.gather_pages(tree, torch.tensor([2, 5, 3], device=cuda)))
    snap = store.get(0)
    assert all(t.is_pinned() for t in t_offload.leaves(snap))
    want = [t.clone() for t in t_offload.leaves(snap)]
    t_offload.scatter_pages(tree, torch.tensor([6, 1, 4], device=cuda), store.pop(0))
    back = t_offload.gather_pages(tree, torch.tensor([6, 1, 4], device=cuda))
    assert all(torch.equal(b.cpu(), w) for b, w in zip(t_offload.leaves(back), want))

    card = serve_preempted(cuda, monolithic)
    assert card[1]["preemptions"] == card[1]["restores"] == 1, card[1]
    assert card == serve_preempted(torch.device("cpu"), monolithic)


def _shared_prefix_trace(name, vocab):
    """A system prompt of two pages shared by four tenants (suffixes of
    about half a page to two and a half pages, two of them arriving late)
    and one prompt equal to the system prompt (copy on write)."""
    bs = 8 if name == "tiny" else 128
    rng = np.random.RandomState(29)
    system = rng.randint(0, vocab, size=(2 * bs,))
    specs = [(bs // 2 + 1, 5, 0), (bs + 3, 4, 0), (2 * bs + 5, 5, 4),
             (bs // 2 + 3, 3, 6), (0, 4, 7)]
    return [(np.concatenate([system, rng.randint(0, vocab, size=(suf,))]), m, a)
            for suf, m, a in specs]


def serve_prefix_async(name, device, executor, prefix_cache, async_depth,
                       sync_free=False):
    """A small configuration serves the shared-prefix trace (2 slots,
    budget_frac 0.5, fp32) with the prefix cache on or off, through the
    sync or the async loop.  With ``sync_free`` every ``_dispatch`` runs
    under ``torch.cuda.set_sync_debug_mode("error")``: a call in the step
    path that waits on the card raises.  Returns (streams, counts)."""
    from repro_torch.models import registry as t_registry
    from repro_torch.runtime import engine as t_engine
    cfg, policy, _ = _small_config(name)
    trace = _shared_prefix_trace(name, cfg.vocab_size)
    bundle = t_registry.build(cfg)
    params = _to_device(bundle.init_params(torch.Generator().manual_seed(0),
                                           device="cpu"), device)
    ecfg = t_engine.EngineConfig.for_trace(
        max_slots=2, max_prompt=max(len(p) for p, _, _ in trace),
        max_new_tokens=max(m for _, m, _ in trace), page_size=policy.block_size,
        budget_frac=0.5, executor=executor, prefix_cache=prefix_cache,
        async_depth=async_depth)
    engine = t_engine.StemEngine(bundle, params, policy, ecfg)
    dispatch = engine._dispatch
    calls = []

    def checked(dec, grant):
        torch.cuda.set_sync_debug_mode("error")
        try:
            dispatch(dec, grant)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        calls.append(1)
    if sync_free:
        engine._dispatch = checked
    reqs = [t_engine.Request(uid=i, prompt=p.astype(np.int32), max_new_tokens=m,
                             arrival_step=a) for i, (p, m, a) in enumerate(trace)]
    finished = engine.run(reqs)
    assert all(f.error is None for f in finished)
    engine.allocator.check_conservation([])
    if sync_free:
        assert len(calls) == engine.stats["step_calls"] > 0
    counts = {k: engine.stats[k] for k in ("prefix_hits", "prefix_pages_shared",
                                           "prefix_cows", "chunks", "prefills")}
    return [f.tokens for f in finished], counts


@pytest.mark.parametrize("name", ["tiny", "qwen3-0.6b-reduced", "arctic-480b-reduced"])
def test_prefix_cache_and_async_on_card(cuda, name):
    """Under "fused" on the card: prefix cache on == off and the async loop
    == the sync loop (each alone and together), equal to "gather" on the
    card and to the port's CPU run; the prefix counters agree; and no
    ``_dispatch`` of the async loop waits on the card.  For the MoE config
    on == off does not hold: the fully matched prompt recomputes its last
    page as a chunk of its own, whose tokens compete for expert capacity
    without the page before it (the reference's semantics), so the
    cache-on arms are held to each other."""
    off, _ = serve_prefix_async(name, cuda, "fused", False, 0)
    on, counts = serve_prefix_async(name, cuda, "fused", True, 0)
    assert counts["prefix_hits"] >= 2 and counts["prefix_cows"] == 1, counts
    if name != "arctic-480b-reduced":
        assert on == off
    both, both_counts = serve_prefix_async(name, cuda, "fused", True, 1,
                                           sync_free=True)
    assert both == on and both_counts == counts
    assert serve_prefix_async(name, cuda, "fused", False, 1, sync_free=True)[0] == off
    assert serve_prefix_async(name, cuda, "gather", True, 1)[0] == on
    assert serve_prefix_async(name, torch.device("cpu"), "fused", True, 1) == \
        (both, both_counts)


@pytest.mark.parametrize("variant", ["arctic", "shared"])
def test_moe_apply_on_card_matches_cpu(cuda, variant):
    """moe.apply (fp32, a binding capacity) on the card against its CPU
    run: routing integers equal, output within 1e-4, aux within 1e-6."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import common as t_common
    from repro_torch.models import moe as t_moe
    extra = (dict(residual_dense=True, residual_d_ff=96) if variant == "arctic"
             else dict(shared_experts=1, shared_d_ff=96))
    cfg = MoEConfig(num_experts=16, top_k=2, expert_d_ff=96, **extra)
    ini = t_common.Initializer(torch.Generator().manual_seed(3), torch.float32,
                               "cpu")
    params = t_moe.init(ini, 64, cfg, "silu")
    x = torch.randn((3, 200, 64), generator=torch.Generator().manual_seed(4))
    want = t_moe.route(params, x, cfg), t_moe.apply(params, x, cfg, "silu")
    dev = _to_device(params, cuda)
    got = t_moe.route(dev, x.to(cuda), cfg), t_moe.apply(dev, x.to(cuda), cfg, "silu")
    for a, b in zip(got[0][2:5], want[0][2:5]):          # experts, pos, keep
        assert torch.equal(a.cpu(), b)
    assert not bool(want[0][4].all())
    torch.testing.assert_close(got[1][0].cpu(), want[1][0], atol=1e-4, rtol=0)
    torch.testing.assert_close(got[1][1].cpu(), want[1][1], atol=0, rtol=1e-6)


def _deepseek_reduced_run(device, executor, dtype):
    """The reduced deepseek-v3-671b (MLA at q/k 24, v 16; the MTP layer at
    24 / 24): loss_fn under stem (block 8: the sparse path at 64 tokens;
    the MTP layer's dense flash at 63), then a ragged stem prefill of 40
    tokens and 6 dense decode steps (the fixed batch's path).  Seeded
    weights drawn on the CPU.  Returns (loss metrics, greedy streams,
    launches, the recorder)."""
    from repro_torch.configs import DEEPSEEK_V3_671B, reduced
    from repro_torch.core import policy as t_policy
    from repro_torch.launch import steps as t_steps
    from repro_torch.models import registry as t_registry
    cfg = reduced(DEEPSEEK_V3_671B).replace(dtype=dtype)
    policy = t_policy.get_policy("stem").with_updates(executor=executor, **TINY_STEM)
    bundle = t_registry.build(cfg)
    params = _to_device(bundle.init_params(torch.Generator().manual_seed(0),
                                           device="cpu"), device)
    rng = np.random.RandomState(9)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size, size=(2, 65)), device=device)
    counters = (t_kern, t_bsa, t_fa, t_sm)
    for mod in counters:
        mod.reset_launches()
    with replay.Recorder() as rec:
        _, metrics = bundle.loss_fn(params, {"tokens": toks[:, :-1],
                                             "labels": toks[:, 1:]}, stem_cfg=policy)
        last = torch.tensor([39, 22], device=device)
        logits, caches = bundle.prefill(params, {"tokens": toks[:, :40]}, max_len=48,
                                        stem_cfg=policy, last_pos=last)
        serve = t_steps.make_serve_step(bundle)
        tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
        stream = [tok[:, 0].tolist()]
        for i in range(6):
            logits, caches = serve(params, tok, caches, None if i else last + 1)
            assert bool(torch.isfinite(logits).all())
            tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
            stream.append(tok[:, 0].tolist())
    launches = {}
    for mod in counters:
        launches.update(mod.LAUNCHES)
    return {k: float(v) for k, v in metrics.items()}, stream, launches, rec


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_deepseek_fused_on_card(cuda, dtype):
    """MLA on the card at the reduced widths: flash and block-sparse at
    (24, 16) and (24, 24), the pool on q / k at 24 and vmag on v at 16 all
    launch under "fused", and every recorded call matches its plain
    version.  In fp32 the loss metrics equal the "gather" executor's on the
    card and the CPU run's within 1e-4 and the greedy streams are equal; in
    bf16 they are finite."""
    metrics, stream, launches, rec = _deepseek_reduced_run(cuda, "fused", dtype)
    assert all(launches[k] > 0 for k in ("block_sparse_attention", "flash_attention",
                                         "antidiag_pool", "value_magnitude")), launches
    shapes = {tuple(a["v"].shape[-1:]) + tuple(a["q"].shape[-1:])
              for key in ("flash_attention", "block_sparse_attention")
              for a, _ in rec.calls[key]}
    assert {(16, 24), (24, 24)} <= shapes, shapes
    rec.check()
    assert all(np.isfinite(v) for v in metrics.values())
    if dtype == "float32":
        for executor, device in (("gather", cuda), ("fused", torch.device("cpu"))):
            m, s, _, _ = _deepseek_reduced_run(device, executor, dtype)
            for key in metrics:
                assert abs(m[key] - metrics[key]) <= 1e-4, (executor, device, key)
            assert s == stream, (executor, device)


# ---------------------------------------------------------------------------
# The SSM, hybrid, encoder-decoder and VLM-stub families
# ---------------------------------------------------------------------------

# The serving CLI's stem geometry at a 128-token block (whisper's decoder).
CLI_STEM = dict(block_size=128, stride=4, sink_blocks=1, local_blocks=1,
                min_budget_blocks=2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_shaped_kernels_on_card(cuda, dtype):
    """whisper-medium's decoder self-attention (MHA 16 / 16, head_dim 64,
    a 2048-token prompt) under stem at the CLI's geometry (block 128,
    stride 4): block-sparse attention over the policy's own selection, flash
    attention, the pool on q and k and vmag on v, each against its plain
    version (bf16 at head_dim 64 runs the tensor-core tile: flash and
    block-sparse at block 128 under the p_bf16 rule)."""
    from repro_torch.core import policy as t_policy
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(64)
    n, h, d, bs = 2048, 16, 64, 128
    q, k, v = (torch.randn((1, h, n, d), generator=gen, device=cuda).to(dt)
               for _ in range(3))
    pol = t_policy.get_policy("stem").with_updates(**CLI_STEM)
    sel, _ = pol.prefill_select(q, k, v, with_block_mask=False)
    idx, cnt = sel.indices, sel.live_counts
    assert int(cnt.sum()) < h * (n // bs) * (n // bs + 1) // 2     # sparse
    wg = _on_wgmma(dt, d, None)
    _assert_close(t_bsa.block_sparse_attention(q, k, v, idx, live_counts=cnt,
                                               block_size=bs),
                  t_bsa.block_sparse_attention_plain(q, k, v, idx, cnt, block_size=bs),
                  p_bf16=wg)
    _assert_close(t_fa.flash_attention(q, k, v), t_fa.flash_attention_plain(q, k, v),
                  p_bf16=wg)
    for x in (q, k):
        _assert_close(t_sm.antidiag_pool(x, block_size=bs, stride=4),
                      t_sm.antidiag_pool_plain(x, block_size=bs, stride=4))
    torch.testing.assert_close(t_sm.value_magnitude(v, block_size=bs),
                               t_sm.value_magnitude_plain(v, block_size=bs),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_attention_auto_routes_by_form_on_card(cuda, dtype):
    """On the card, causal maskless self-attention launches the flash
    kernel; non-causal attention (whisper's encoder: 1500 frames;
    cross-attention: 300 queries over 1500 frames) and masked attention
    (local windows) run the plain path, launching nothing, and equal the
    CPU run."""
    from repro_torch.core import sparse_attention as t_sa
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(65)
    enc = [torch.randn((1, 4, 1500, 64), generator=gen, device=cuda).to(dt)
           for _ in range(3)]
    xq = torch.randn((1, 4, 300, 64), generator=gen, device=cuda).to(dt)
    n = 256
    i = torch.arange(n, device=cuda)
    mask = ((i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - 32)).expand(1, 4, n, n)
    local = [x[:, :, :n].contiguous() for x in enc]
    t_fa.reset_launches()
    calls = [((*enc,), dict(causal=False)),
             ((xq, enc[1], enc[2]), dict(causal=False, scale=0.125)),
             ((*local,), dict(causal=True, mask=mask))]
    for args, kw in calls:
        got = t_sa.dense_attention_auto(*args, **kw)
        cpu_kw = {k: (v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in kw.items()}
        want = t_sa.dense_attention_auto(*(a.cpu() for a in args), **cpu_kw)
        torch.testing.assert_close(got.float().cpu(), want.float(),
                                   atol=1e-4 if dtype == "float32" else 2e-2, rtol=0)
    assert t_fa.LAUNCHES["flash_attention"] == 0
    t_sa.dense_attention_auto(*local)
    assert t_fa.LAUNCHES["flash_attention"] == 1


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-2b",
                                  "whisper-medium", "pixtral-12b"])
def test_reduced_families_on_card(cuda, arch):
    """Each new family's reduced config in fp32 on the card equals its CPU
    run: the prefill's logits (under the CLI's stem at block 8 where the
    config uses Stem, with its kernels launched and every recorded call
    within its plain version's limit) and 6 greedy decode steps, logits
    within 1e-4 and streams equal."""
    from repro_torch import configs as t_configs
    from repro_torch.core import policy as t_policy
    from repro_torch.models import registry as t_registry
    cfg = t_configs.reduced(t_configs.get_config(arch)).replace(dtype="float32")
    bundle = t_registry.build(cfg)
    params = bundle.init_params(torch.Generator().manual_seed(0), device="cpu")
    pol = t_policy.get_policy("stem").with_updates(**TINY_STEM) if cfg.use_stem else None
    rng = np.random.RandomState(11)
    batch = {"tokens": torch.as_tensor(rng.randint(0, cfg.vocab_size, size=(2, 48)))}
    if arch == "whisper-medium":
        batch["frames"] = torch.as_tensor(rng.randn(2, 16, 64).astype(np.float32))
    if arch == "pixtral-12b":
        batch["patch_embeds"] = torch.as_tensor(rng.randn(2, 16, 64).astype(np.float32))
    runs = {}
    for device in (cuda, torch.device("cpu")):
        dparams, dbatch = _to_device(params, device), _to_device(batch, device)
        for mod in (t_bsa, t_fa, t_sm):
            mod.reset_launches()
        with replay.Recorder() as rec:
            logits, caches = bundle.prefill(dparams, dbatch, max_len=80, stem_cfg=pol)
            rows = [logits.cpu()]
            for _ in range(6):
                tok = torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
                logits, caches = bundle.decode_step(dparams, tok, caches)
                rows.append(logits.cpu())
        runs[device.type] = torch.stack(rows)
        if device.type == "cuda" and pol is not None:
            assert t_bsa.LAUNCHES["block_sparse_attention"] > 0
            assert t_sm.LAUNCHES["antidiag_pool"] > 0
            assert t_sm.LAUNCHES["value_magnitude"] > 0
            rec.check()
    torch.testing.assert_close(runs["cuda"], runs["cpu"], atol=1e-4, rtol=0)
    assert torch.equal(runs["cuda"].argmax(-1), runs["cpu"].argmax(-1))


# ---------------------------------------------------------------------------
# the training path: the attention backward kernels and loss_fn gradients
# ---------------------------------------------------------------------------

def _grad_rule(got, want, p_bf16=False):
    """Each of (dq, dk, dv) within ``replay.grad_tolerance``: the forward's
    rule (fp32 1e-4 abs; bf16 2 ulps + 1e-3 * the row's max|plain| on the
    CUDA-core route, which keeps P and dS in fp32, or 1e-2 with p_bf16: the
    tensor-core route rounds them to bf16 before its products) plus, in
    bf16, 1e-4 * the tensor's max|plain|: a row whose gradient cancels (a
    query row that sees one key has dS = dP - delta = 0 up to the fp32
    sums' rounding, taken in other orders by the kernel and the plain
    version) is ~1e-7 of the tensor's scale in one and ~0 in the other."""
    for g, w in zip(got, want):
        if g.dtype == torch.float32:
            torch.testing.assert_close(g, w, atol=1e-4, rtol=0)
            continue
        g, w = g.float(), w.float()
        limit = grad_tolerance(w, torch.bfloat16, p_bf16)
        diff = (g - w).abs()
        assert bool((diff <= limit).all()), f"max |kernel - plain| = {float(diff.max())}"


def _assert_lse(got, want):
    """A forward kernel's saved log-sum-exp against the plain forward's
    (what the CUDA-core dq kernel recomputed before the forwards saved it):
    +inf in the same rows (no key seen), elsewhere within 1e-5 of scale."""
    inf = torch.isinf(want)
    assert torch.equal(torch.isinf(got), inf) and bool((got[inf] > 0).all())
    torch.testing.assert_close(got[~inf], want[~inf], rtol=0,
                               atol=1e-5 * float(want[~inf].abs().max()))


def _causal_selection(gen, b, hs, nq, kmax, device):
    """Random causal selections: a live prefix of 0..min(kmax, i + 1)
    distinct blocks (row 1 of every head at cnt 0), the dead slots
    revisit-filled with the first live block."""
    idx = torch.zeros((b, hs, nq, kmax), dtype=torch.int32)
    cnt = torch.zeros((b, hs, nq), dtype=torch.int32)
    for bb in range(b):
        for h in range(hs):
            for i in range(nq):
                c = 0 if i == 1 else int(torch.randint(1, min(kmax, i + 1) + 1, (),
                                                       generator=gen))
                live = torch.randperm(i + 1, generator=gen)[:c]
                idx[bb, h, i, :c] = live.to(torch.int32)
                idx[bb, h, i, c:] = int(live[0]) if c else 0
                cnt[bb, h, i] = c
    return idx.to(device), cnt.to(device)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pair", HEAD_DIM_PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_backward_kernels_match_plain_on_card(cuda, pair, dtype):
    """Both backward kernels at every (q/k, v) head_dim pair of
    HEAD_DIM_PAIRS against their plain versions, fed the forwards' saved
    log-sum-exp (held against the plain forwards'): flash at n = 200 (no
    multiple of a tile) and 256 (GQA group 2), block-sparse at n = 256 and
    blocks 16 / 64 / 128 / 256 with and without group_dedup
    (revisit-filled dead slots, cnt == 0 rows).  bf16 at a pair of
    WGMMA_PAIRS (and a block that is a multiple of 128) takes the
    tensor-core route, whose counter and the pair's instance counter must
    move, under the p_bf16 rule (at these shapes the dk / dv kernel splits
    each KV head's query heads over CTAs: the head split and its reduction
    pass run too); every other case the CUDA-core route under the 1e-3
    rule.  Two calls bitwise equal (no atomics); the rule rejects a (query
    block, key block) pair dropped from the transposed selection (dk / dv)
    and a selected block dropped from the rows of one selection row
    (dq)."""
    d, dv = pair
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(d * 7 + dv)
    b, hq, hk = 2, 4, 2
    for n in (200, 256):
        q, k, v, do = (torch.randn(s, generator=gen).to(cuda, dt) for s in
                       ((b, hq, n, d), (b, hk, n, d), (b, hk, n, dv), (b, hq, n, dv)))
        o, lse = t_fa.flash_attention(q, k, v, return_lse=True)
        assert torch.equal(o, t_fa.flash_attention(q, k, v))
        _assert_lse(lse, t_fa.flash_attention_plain(q, k, v, return_lse=True)[1])
        wgmma = backward_route(dt, d, dv) == "wgmma"
        t_fa.reset_launches()
        got = t_fa.flash_attention_bwd(q, k, v, o, do, lse=lse)
        assert t_fa.LAUNCHES["flash_attention_bwd_wgmma"] == int(wgmma)
        assert t_fa.LAUNCHES.get(wgmma_counter("flash_attention_bwd", d, dv), 0) == int(wgmma)
        again = t_fa.flash_attention_bwd(q, k, v, o, do, lse=lse)
        _grad_rule(got, t_fa.flash_attention_bwd_plain(q, k, v, o, do), p_bf16=wgmma)
        assert all(torch.equal(x, y) for x, y in zip(got, again))
    for bs, dedup in ((16, True), (64, False), (128, False), (128, True), (256, False),
                      (256, True)):
        nq = n // bs
        idx, cnt = _causal_selection(gen, b, hk if dedup else hq, nq, 4, cuda)
        kw = dict(block_size=bs, group_dedup=dedup)
        o, lse = t_bsa.block_sparse_attention(q, k, v, idx, live_counts=cnt, return_lse=True,
                                              **kw)
        assert torch.equal(o, t_bsa.block_sparse_attention(q, k, v, idx, live_counts=cnt, **kw))
        _assert_lse(lse, t_bsa.block_sparse_attention_plain(q, k, v, idx, cnt,
                                                            return_lse=True, **kw)[1])
        wgmma = backward_route(dt, d, dv, bs) == "wgmma"
        t_bsa.reset_launches()
        got = t_bsa.block_sparse_attention_bwd(q, k, v, o, do, idx, cnt, lse=lse, **kw)
        assert t_bsa.LAUNCHES["block_sparse_attention_bwd_wgmma"] == int(wgmma)
        assert t_bsa.LAUNCHES.get(wgmma_counter("block_sparse_attention_bwd", d, dv),
                                  0) == int(wgmma)
        again = t_bsa.block_sparse_attention_bwd(q, k, v, o, do, idx, cnt, lse=lse, **kw)
        want = t_bsa.block_sparse_attention_bwd_plain(q, k, v, o, do, idx, cnt, **kw)
        _grad_rule(got, want, p_bf16=wgmma)
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        # dropping one (query block, key block) pair from the transposed
        # selection must show in that key block's dk / dv
        tidx, tcnt = t_bsa.transpose_selection(idx, cnt, nq)
        j = int(tcnt[0, 0].argmax())
        if int(tcnt[0, 0, j]) >= 1:
            faulted = tcnt.clone()
            faulted[0, 0, j] -= 1
            bad = t_bsa.block_sparse_attention_bwd(q, k, v, o, do, idx, cnt, lse=lse,
                                                   transposed=(tidx, faulted), **kw)
            with pytest.raises(AssertionError):
                _grad_rule(bad[1:2], want[1:2], p_bf16=wgmma)
            with pytest.raises(AssertionError):
                _grad_rule(bad[2:], want[2:], p_bf16=wgmma)
        # dropping the last live block of the last selection row with two or
        # more (of batch 0, selection head 0) must show in its rows' dq
        rows = [i for i in range(nq) if int(cnt[0, 0, i]) >= 2]
        if rows:
            fewer = cnt.clone()
            fewer[0, 0, rows[-1]] -= 1
            bad = t_bsa.block_sparse_attention_bwd(q, k, v, o, do, idx, fewer, lse=lse, **kw)
            with pytest.raises(AssertionError):
                _grad_rule(bad[:1], want[:1], p_bf16=wgmma)


def test_backward_kernels_raise_outside_pairs_on_card(cuda):
    """A (q/k, v) pair outside HEAD_DIM_PAIRS raises ValueError in both
    backward wrappers: no fallback to the plain version.  So does a call
    without the forward's lse: the kernels no longer recompute it."""
    idx = torch.zeros((1, 2, 2, 1), dtype=torch.int32, device=cuda)
    cnt = torch.ones((1, 2, 2), dtype=torch.int32, device=cuda)
    lse = torch.zeros((1, 2, 256), device=cuda)
    for d, dv in ((192, 64), (48, 48)):
        qk = torch.zeros((1, 2, 256, d), device=cuda)
        v = torch.zeros((1, 2, 256, dv), device=cuda)
        with pytest.raises(ValueError, match="head_dim"):
            t_fa.flash_attention_bwd(qk, qk, v, v, v, lse=lse)
        with pytest.raises(ValueError, match="head_dim"):
            t_bsa.block_sparse_attention_bwd(qk, qk, v, v, v, idx, cnt, block_size=128,
                                             lse=lse)
    qk = torch.zeros((1, 2, 256, 128), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="lse"):
        t_fa.flash_attention_bwd(qk, qk, qk, qk, qk)
    with pytest.raises(ValueError, match="lse"):
        t_bsa.block_sparse_attention_bwd(qk, qk, qk, qk, qk, idx, cnt, block_size=128)


@pytest.mark.parametrize("pair", [(64, 64), (192, 128)], ids=lambda p: f"{p[0]}-{p[1]}")
def test_attention_grads_over_tensor_core_forwards_on_card(cuda, pair):
    """The differentiable ``attention`` of both kernels in bf16 at whisper's
    (64, 64) and deepseek-v3-671b's (192, 128): the forward runs that
    pair's tensor-core instance (its counter moves) and saves its lse, the
    backward that pair's tensor-core instance fed that lse (its counters
    move; the CUDA-core backward launches nothing); q, k, v's gradients
    within the p_bf16 gradient rule of the plain backward on the forward's
    own output."""
    d, dv = pair
    gen = torch.Generator().manual_seed(d + dv)
    b, hq, hk, n, bs = 1, 4, 2, 512, 128
    q, k, v, do = (torch.randn(s, generator=gen).to(cuda, torch.bfloat16) for s in
                   ((b, hq, n, d), (b, hk, n, d), (b, hk, n, dv), (b, hq, n, dv)))
    idx, cnt = _causal_selection(gen, b, hq, n // bs, 3, cuda)
    cases = (
        (t_fa, "flash_attention", lambda x, y, z: t_fa.attention(x, y, z),
         lambda o: t_fa.flash_attention_bwd_plain(q, k, v, o, do)),
        (t_bsa, "block_sparse_attention",
         lambda x, y, z: t_bsa.attention(x, y, z, idx, cnt, block_size=bs),
         lambda o: t_bsa.block_sparse_attention_bwd_plain(q, k, v, o, do, idx, cnt,
                                                          block_size=bs)))
    for mod, key, run, plain in cases:
        leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        mod.reset_launches()
        out = run(*leaves)
        out.backward(do)
        assert mod.LAUNCHES[wgmma_counter(key, d, dv)] == 1
        assert mod.LAUNCHES[f"{key}_bwd"] == 1 and mod.LAUNCHES[f"{key}_bwd_wgmma"] == 1
        assert mod.LAUNCHES[wgmma_counter(f"{key}_bwd", d, dv)] == 1
        _grad_rule([x.grad for x in leaves], plain(out.detach()), p_bf16=True)


def test_whisper_trains_on_tensor_core_backward_on_card(cuda, monkeypatch):
    """The training CLI on whisper-medium at full width cut to 2 encoder and
    2 decoder layers, bf16, 2 steps under --stem at 1024 tokens (block 128):
    the losses finite, and every backward of the decoder's self-attention
    on the block-sparse backward's (64, 64) tensor-core instance (2 layers
    x 2 steps; none on the CUDA-core route)."""
    import dataclasses
    from repro_torch import configs as t_configs
    from repro_torch.launch import train as t_train
    cfg = t_configs.get_config("whisper-medium")
    cfg = cfg.replace(num_layers=2, encdec=dataclasses.replace(cfg.encdec, encoder_layers=2))
    monkeypatch.setattr(t_configs, "get_config", lambda name: cfg)
    t_bsa.reset_launches()
    res = t_train.main(["--arch", "whisper-medium", "--steps", "2", "--batch", "1",
                        "--seq", "1024", "--stem"])
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    n = t_bsa.LAUNCHES
    assert n[wgmma_counter("block_sparse_attention_bwd", 64, 64)] == 4
    assert n["block_sparse_attention_bwd"] == n["block_sparse_attention_bwd_wgmma"] == 4


@pytest.mark.parametrize("arch,stem", [
    ("qwen3-0.6b", False), ("qwen3-0.6b", True), ("arctic-480b", True),
    ("deepseek-v3-671b", True), ("mamba2-370m", False), ("recurrentgemma-2b", False),
    ("whisper-medium", True), ("pixtral-12b", True)])
def test_reduced_loss_fn_gradients_on_card(cuda, monkeypatch, arch, stem):
    """Each family's reduced config in fp32: the train step's loss and
    gradient (``steps.loss_and_grads``) on the card, through the attention
    kernels in both directions, equal the CPU's (the plain versions) within
    1e-4 of each leaf's max|g|; the backward kernels launched wherever the
    family's attention runs them, and no plain backward called on the
    card."""
    from repro_torch import configs as t_configs
    from repro_torch.core.config import StemConfig
    from repro_torch.launch import steps as t_steps
    from repro_torch.models import registry as t_registry
    from repro_torch.optim.adamw import tree_leaves
    cfg = t_configs.reduced(t_configs.get_config(arch)).replace(dtype="float32")
    bundle = t_registry.build(cfg)
    master = bundle.init_params(torch.Generator().manual_seed(0), device="cpu")
    pol = StemConfig(block_size=16, min_budget_blocks=2, sink_blocks=1, local_blocks=1,
                     stride=4) if stem else None
    rng = np.random.RandomState(5)
    batch = {"tokens": torch.as_tensor(rng.randint(0, cfg.vocab_size, size=(2, 64))),
             "labels": torch.as_tensor(rng.randint(0, cfg.vocab_size, size=(2, 64)))}
    if arch == "whisper-medium":
        batch["frames"] = torch.as_tensor(rng.randn(2, 16, 64).astype(np.float32))
    if arch == "pixtral-12b":
        batch = {k: v[:, :48] for k, v in batch.items()}
        batch["patch_embeds"] = torch.as_tensor(rng.randn(2, 16, 64).astype(np.float32))
    plain = []
    for mod, fn in ((t_fa, "flash_attention_bwd_plain"),
                    (t_bsa, "block_sparse_attention_bwd_plain")):
        orig = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda *a, orig=orig, **kw: plain.append(1)
                            or orig(*a, **kw))
    runs = {}
    for device in (cuda, torch.device("cpu")):
        for mod in (t_bsa, t_fa, t_sm):
            mod.reset_launches()
        loss, _, grads = t_steps.loss_and_grads(
            bundle, _to_device(master, device), _to_device(batch, device), stem_cfg=pol)
        runs[device.type] = (float(loss), [g.cpu() for g in tree_leaves(grads)])
        if device.type == "cuda":
            assert not plain
            attn = cfg.family not in ("ssm", "hybrid")
            if attn and stem:
                assert t_bsa.LAUNCHES["block_sparse_attention_bwd"] > 0
            if attn and (not stem or cfg.mtp):
                assert t_fa.LAUNCHES["flash_attention_bwd"] > 0
    (lc, gc), (lp, gp) = runs["cuda"], runs["cpu"]
    assert abs(lc - lp) <= 1e-5 * abs(lp)
    for a, w in zip(gc, gp):
        assert float((a - w).abs().max()) <= 1e-4 * max(float(w.abs().max()), 1e-30)
