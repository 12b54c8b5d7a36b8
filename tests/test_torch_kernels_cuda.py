"""The port's CUDA kernels against their plain PyTorch versions on the
card.  These need a CUDA card and the CUDA toolkit (the kernels have no CPU
mode) and skip without one; the file imports no JAX, so it runs on the GPU
machine:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py

fp32 within 1e-4 abs; bf16 within 2 bf16 ulps of the plain output plus
1e-3 * max|plain|; ``cnt == 0`` rows must be exact zeros.
"""
import pytest
import torch

from repro_torch.kernels import paged_attn as t_kern


def _assert_close(got, want):
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
        return
    got, want = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=1e-30))) - 7)
    limit = 2 * ulp + 1e-3 * want.abs().max()
    diff = (got - want).abs()
    assert bool((diff <= limit).all()), f"max |kernel - plain| = {float(diff.max())}"


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
