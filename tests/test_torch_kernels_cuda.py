"""The port's CUDA kernels against their plain PyTorch versions on the
card.  These need a CUDA card and the CUDA toolkit (the kernels have no CPU
mode) and skip without one; the file imports no JAX, so it runs on the GPU
machine:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

fp32 within 1e-4 abs; bf16 within 2 bf16 ulps of the plain output plus a
floor of 1e-3 * max|plain| over the element's row (its last axis), except
the one-shot prefill's flash and block-sparse attention in bf16: their
tensor-core tile rounds the probabilities P to bf16 before P.V (as SDPA's
and flex_attention's kernels do), which the plain version keeps in fp32, so
their floor is 1e-2 * the row's max|plain|.  The floor is per row because a
row that attends to m keys has outputs of about sqrt(e / m): one number for
the whole tensor would be as large as a long row's values.  ``cnt == 0``
rows must be exact zeros.  Covers the paged scorer and page attention, the
one-shot prefill's flash and block-sparse attention (and the products of
their tensor-core tile), and the metric pooling / value-magnitude kernels.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import block_sparse_attn as t_bsa
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import paged_attn as t_kern
from repro_torch.kernels import stem_metric as t_sm


def _assert_close(got, want, *, p_bf16=False):
    """p_bf16: the kernel rounds P to bf16 before P.V (bf16 prefill
    attention), so a bf16 output's row floor is 1e-2 * max|plain|."""
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
        return
    got, want = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=1e-30))) - 7)
    floor = (1e-2 if p_bf16 else 1e-3) * want.abs().amax(dim=-1, keepdim=True)
    diff = (got - want).abs()
    assert bool((diff <= 2 * ulp + floor).all()), \
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
        _assert_close(got, want)
        assert torch.all(got[cnt == 0] == 0)


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
