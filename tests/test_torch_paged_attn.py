"""Differential tests for the module that holds the port's kernels
(``repro_torch/kernels/paged_attn.py``) and its gather oracle.

On the CPU the fused entry points run the kernels' plain PyTorch versions;
they are held against the reference's fused entry points (Pallas in
interpret mode), and the port's "gather" executor against the reference's
XLA gather oracle.  GQA groups {1, 2, 4}, ragged and unaligned lengths,
budget_frac {0.25, 1.0}, antidiag / mean pooling and zero-live rows (exact
zeros) are covered; floats within 1e-4 (fp32), selections exact.  The
kernel-vs-plain cases on the card are in ``test_torch_kernels_cuda.py``
(no JAX there: the GPU machine has none).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import chunked as j_chunked
from repro.core import policy as j_policy
from repro.kernels import paged_attn as j_kern
from repro.runtime import paged as j_paged

from repro_torch.core import chunked as t_chunked
from repro_torch.core import policy as t_policy
from repro_torch.kernels import paged_attn as t_kern
from repro_torch.runtime import paged as t_paged

torch.set_num_threads(1)

BS, STRIDE, D, HQ = 8, 4, 8, 4
TOL = 1e-4


def _pair(name="stem", **updates):
    kw = dict(block_size=BS, stride=STRIDE, sink_blocks=1, local_blocks=1,
              min_budget_blocks=2, **updates)
    return (j_policy.get_policy(name).with_updates(ignore_missing=True, **kw),
            t_policy.get_policy(name).with_updates(ignore_missing=True, **kw))


def _to_port(jpool):
    return t_paged.PagePool(*(torch.from_numpy(np.array(x)) for x in jpool))


def _decode_case(group, lens, seed, npages=4, name="stem"):
    hk = HQ // group
    rng = np.random.default_rng(seed)
    jp, tp = _pair(name)
    b = len(lens)
    pool = j_paged.init_pool(1 + b * npages, hk, BS, D, STRIDE)
    pt = np.zeros((b, npages), np.int32)
    for i in range(b):
        pt[i] = 1 + i * npages + np.arange(npages)
        k = rng.standard_normal((hk, npages * BS, D)).astype(np.float32)
        v = rng.standard_normal((hk, npages * BS, D)).astype(np.float32)
        pool = j_paged.write_prefill_pages(pool, jnp.asarray(pt[i]), jnp.asarray(k),
                                           jnp.asarray(v), jnp.asarray(int(lens[i])), jp)
    q = rng.standard_normal((b, HQ, 1, D)).astype(np.float32)
    return jp, tp, pool, pt, q, np.asarray(lens, np.int32)


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("frac", [0.25, 1.0])
def test_decode_fused_matches_pallas(group, frac):
    jp, tp, pool, pt, q, lens = _decode_case(group, [29, 0, 13, 32], seed=group)
    want = j_kern.fused_paged_decode(jnp.asarray(q), pool, jnp.asarray(pt),
                                     jnp.asarray(lens), jp, frac)
    got = t_kern.fused_paged_decode(torch.from_numpy(q), _to_port(pool),
                                    torch.from_numpy(pt), torch.from_numpy(lens),
                                    tp, frac)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    assert np.all(got.numpy()[1] == 0.0), "zero-live row must be exactly zero"


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("frac", [0.25, 1.0])
def test_decode_gather_matches_xla(group, frac):
    jp, tp, pool, pt, q, lens = _decode_case(group, [17, 31, 0], seed=10 + group)
    want = j_paged._paged_decode_xla(jnp.asarray(q), pool, jnp.asarray(pt),
                                     jnp.asarray(lens), jp, frac)
    got = t_paged._paged_decode_gather(torch.from_numpy(q), _to_port(pool),
                                       torch.from_numpy(pt), torch.from_numpy(lens),
                                       tp, frac)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    assert np.all(got.numpy()[2] == 0.0), "zero-live row must be exactly zero"


def test_decode_streaming_and_scores():
    """Streaming needs no scorer; the OAM scorer's scores match the
    reference kernel's (decode_page_scores) directly."""
    jp, tp, pool, pt, q, lens = _decode_case(2, [17, 32, 5], seed=3,
                                             name="streaming")
    want = j_kern.fused_paged_decode(jnp.asarray(q), pool, jnp.asarray(pt),
                                     jnp.asarray(lens), jp, 1.0)
    got = t_kern.fused_paged_decode(torch.from_numpy(q), _to_port(pool),
                                    torch.from_numpy(pt), torch.from_numpy(lens),
                                    tp, 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    sc_j = j_kern.decode_page_scores(jnp.asarray(q), pool.kg, jnp.asarray(pt),
                                     group=2)
    sc_t = t_kern.decode_page_scores(torch.from_numpy(q), torch.from_numpy(
        np.array(pool.kg)), torch.from_numpy(pt), group=2)
    np.testing.assert_allclose(sc_t.numpy(), np.asarray(sc_j), atol=TOL, rtol=0)


def test_pack_selection_matches():
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 6, size=(2, 2, 3, 5)).astype(np.int32)
    live = np.arange(5) < rng.integers(0, 6, size=(2, 2, 3))[..., None]
    pt = rng.integers(1, 50, size=(2, 6)).astype(np.int32)
    want = j_kern.pack_selection(jnp.asarray(idx), jnp.asarray(live), jnp.asarray(pt))
    got = t_kern.pack_selection(torch.from_numpy(idx), torch.from_numpy(live),
                                torch.from_numpy(pt))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _chunk_case(group, hist_pages, tail, seed, nc=2, name="stem", **updates):
    hk = HQ // group
    rng = np.random.default_rng(seed)
    jp, tp = _pair(name, **updates)
    b, maxp, chunk = 2, hist_pages + nc, nc * BS
    pool = j_paged.init_pool(1 + b * maxp, hk, BS, D, STRIDE)
    pt = np.zeros((b, maxp), np.int32)
    start = np.full((b,), hist_pages * BS, np.int32)
    true_len = np.asarray([start[0] + tail, start[1] + max(1, tail - 3)], np.int32)
    for i in range(b):
        pt[i] = 1 + i * maxp + np.arange(maxp)
        if hist_pages:
            k = rng.standard_normal((hk, hist_pages * BS, D)).astype(np.float32)
            v = rng.standard_normal((hk, hist_pages * BS, D)).astype(np.float32)
            pool = j_paged.write_prefill_pages(
                pool, jnp.asarray(pt[i, :hist_pages]), jnp.asarray(k),
                jnp.asarray(v), jnp.asarray(int(start[i])), jp)
    kc = rng.standard_normal((b, hk, chunk, D)).astype(np.float32)
    vc = rng.standard_normal((b, hk, chunk, D)).astype(np.float32)
    pool = j_paged.write_chunk_pages(pool, jnp.asarray(pt), jnp.asarray(start),
                                     jnp.asarray(kc), jnp.asarray(vc),
                                     jnp.asarray(true_len), jp)
    q = rng.standard_normal((b, HQ, chunk, D)).astype(np.float32)
    budgets = np.stack([j_chunked.chunk_budget_rows(jp, maxp * BS, int(start[i]), nc)
                        for i in range(b)]).astype(np.int32)
    jargs = (jnp.asarray(q), pool, jnp.asarray(pt), jnp.asarray(start),
             jnp.asarray(budgets), jp)
    targs = (torch.from_numpy(q), _to_port(pool), torch.from_numpy(pt),
             torch.from_numpy(start), torch.from_numpy(budgets), tp)
    return jargs, targs


CHUNK_CASES = [  # (group, hist_pages, tail, pooling, group_reduce)
    (1, 2, 11, "antidiag", "none"),
    (2, 3, 16, "antidiag", "mean"),
    (4, 1, 5, "mean", "none"),
    (2, 0, 9, "antidiag", "max"),
]


@pytest.mark.parametrize("group,hist,tail,pooling,reduce", CHUNK_CASES)
def test_chunk_fused_matches_pallas(group, hist, tail, pooling, reduce):
    jargs, targs = _chunk_case(group, hist, tail, seed=group + hist,
                               pooling=pooling, group_reduce=reduce)
    want = j_kern.fused_paged_chunk(*jargs)
    got = t_kern.fused_paged_chunk(*targs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("group,hist,tail,pooling,reduce", CHUNK_CASES)
def test_chunk_gather_matches_xla(group, hist, tail, pooling, reduce):
    jargs, targs = _chunk_case(group, hist, tail, seed=7 + group,
                               pooling=pooling, group_reduce=reduce)
    want = j_chunked._chunked_prefill_xla(*jargs)
    got = t_chunked._chunked_prefill_gather(*targs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_chunk_streaming_and_sam_policies():
    for name in ("streaming", "stem-sam"):
        jargs, targs = _chunk_case(2, 2, 13, seed=9, name=name)
        np.testing.assert_allclose(t_kern.fused_paged_chunk(*targs).numpy(),
                                   np.asarray(j_kern.fused_paged_chunk(*jargs)),
                                   atol=TOL, rtol=0)


def test_attend_plain_zero_live_rows_exact():
    """cnt == 0 rows of the plain attention are exact zeros in both lanes,
    whatever the (revisit-filled) page ids point at."""
    rng = np.random.default_rng(0)
    k = torch.from_numpy(rng.standard_normal((2, 5, BS, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 5, BS, D)).astype(np.float32))
    gp = torch.tensor([[[[3, 3]], [[1, 2]]]], dtype=torch.int32).expand(1, 2, 1, 2)
    gp = torch.cat([gp, gp], dim=1).contiguous()            # (1, 4, 1, 2)
    cnt = torch.tensor([[[0], [2], [0], [1]]], dtype=torch.int32)
    pos = torch.tensor([12], dtype=torch.int32)
    for rows, causal in ((1, False), (BS, True)):
        q = torch.from_numpy(rng.standard_normal((1, 4, 1, rows, D)).astype(np.float32))
        out = t_kern.attend_pages(q, k, v, gp, gp.clone(), cnt, pos,
                                  block_size=BS, causal=causal, lane="decode")
        assert torch.all(out[:, 0] == 0) and torch.all(out[:, 2] == 0)
        assert torch.isfinite(out).all() and torch.any(out[:, 1] != 0)


def _attend_selection_case(group, causal, seed, d=D):
    """Inputs of the page attention in the order the reference kernel takes
    them (numpy): q (b, hq, nc, rows, d), the k / v pools, and per row a
    shuffled list of logical pages mapped to physical ones through a
    per-batch page table.  Chunk rows start at unaligned positions; their
    lists hold both pages that straddle the tile (the "diagonal" pages, in
    any order), lower pages and one page wholly above the tile's last query
    (it must add nothing).  Decode rows list their pages up to and past an
    unaligned length.  Some rows have cnt == 0; dead slots repeat the last
    live one (revisit filling)."""
    rng = np.random.default_rng(seed)
    hk = HQ // group
    b, nc, kmax, maxp = 2, 2, 6, 6
    P = 1 + b * maxp
    rows = BS if causal else 1
    k = rng.standard_normal((hk, P, BS, d)).astype(np.float32)
    v = rng.standard_normal((hk, P, BS, d)).astype(np.float32)
    q = rng.standard_normal((b, HQ, nc, rows, d)).astype(np.float32)
    pos = np.asarray([13, 3] if causal else [29, 5], np.int32)
    table = 1 + rng.permutation(P - 1)[:b * maxp].reshape(b, maxp)
    gp = np.zeros((b, HQ, nc, kmax), np.int32)
    idx = np.zeros_like(gp)
    cnt = np.zeros((b, HQ, nc), np.int32)
    for bi in range(b):
        for h in range(HQ):
            for ci in range(nc):
                if causal:
                    q0 = int(pos[bi]) + ci * BS
                    first, last = q0 // BS, (q0 + BS - 1) // BS
                    pages = list(rng.permutation(first))[:kmax - 3]
                    pages += list(range(first, last + 1)) + [last + 1]
                else:
                    pages = list(range((int(pos[bi]) + BS - 1) // BS + 1))
                pages = [int(x) for x in rng.permutation(pages)[:kmax]]
                live = 0 if (h + ci + bi) % 4 == 3 else len(pages)
                row = pages + [pages[-1]] * (kmax - len(pages))
                idx[bi, h, ci] = row
                gp[bi, h, ci] = table[bi, row]
                cnt[bi, h, ci] = live
    return q, k, v, gp, idx, cnt, pos


@pytest.mark.parametrize("group,causal", [(1, True), (2, True), (4, True), (2, False)])
def test_attend_plain_matches_reference_kernel(group, causal):
    """The semantics the page-attention kernels must match, pinned on the
    plain version: the reference kernel (interpret mode) and
    ``attend_pages_plain`` agree within 1e-4 on unaligned chunk starts, a
    page above the chunk's tile in the list, the diagonal pages out of order
    and zero-live rows (exact zeros)."""
    args = _attend_selection_case(group, causal, seed=40 + group + 10 * causal)
    want = j_kern._attend_pages(*(jnp.asarray(a) for a in args), block_size=BS,
                                causal=causal, interpret=True, name="attend_test")
    got = t_kern.attend_pages_plain(*(torch.from_numpy(a) for a in args),
                                    block_size=BS, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    cnt = args[5]
    assert (cnt == 0).any() and np.all(got.numpy()[cnt == 0] == 0.0)
    assert np.all(np.abs(got.numpy()[cnt > 0]).sum(-1) > 0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [8, 16, 256])
def test_attend_plain_head_dims_match_reference_kernel(d, causal):
    """The page attention's semantics at the head_dims the card's CUDA-core
    paths take (8, 16, 256; page size 8): the reference kernel (interpret
    mode) against ``attend_pages_plain`` within 1e-4, on the selection case
    above."""
    args = _attend_selection_case(2, causal, seed=70 + d + causal, d=d)
    want = j_kern._attend_pages(*(jnp.asarray(a) for a in args), block_size=BS,
                                causal=causal, interpret=True, name="attend_test")
    got = t_kern.attend_pages_plain(*(torch.from_numpy(a) for a in args),
                                    block_size=BS, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    assert np.all(got.numpy()[args[5] == 0] == 0.0)


@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("d", [8, 16, 256])
def test_score_plain_head_dims_match_reference_kernel(d, pair):
    """The scorer's semantics at head_dims 8, 16 and 256 and stride 4 (the
    one-warp-a-page kernel's shapes on the card): the reference
    ``_score_pages`` (interpret mode) against ``score_pages_plain``, the
    pairing folded in or not, within 1e-4."""
    rng = np.random.default_rng(80 + d + pair)
    hk, b, maxp, nc = 2, 2, 5, 3
    P = 1 + b * maxp
    qp = rng.standard_normal((b, HQ, nc, STRIDE, d)).astype(np.float32)
    kg = rng.standard_normal((hk, P, STRIDE, d)).astype(np.float32)
    table = (1 + rng.permutation(P - 1)[:b * maxp]).reshape(b, maxp).astype(np.int32)
    perm = (STRIDE - np.arange(STRIDE)) % STRIDE
    scale = 1.0 / (STRIDE * float(d) ** 0.5)
    want = j_kern._score_pages(jnp.asarray(qp[..., perm, :] if pair else qp),
                               jnp.asarray(kg), jnp.asarray(table), group=2,
                               scale=scale, interpret=True, name="score_test")
    got = t_kern.score_pages_plain(torch.from_numpy(qp), torch.from_numpy(kg),
                                   torch.from_numpy(table), group=2,
                                   scale=scale, pair=pair)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("nc", [1, 8])
def test_score_plain_matches_reference_kernel(nc, group, pair):
    """The scorer's semantics, pinned on its plain version: the reference
    ``_score_pages`` (interpret mode) on pooled queries whose groups are
    already permuted u -> (s - u) % s, against ``score_pages_plain`` given
    the unpermuted queries and ``pair=True`` (the pairing folded into the
    scorer), or both the same queries with ``pair=False``; within 1e-4."""
    rng = np.random.default_rng(60 + 10 * nc + group + 3 * pair)
    hk, b, maxp = HQ // group, 2, 5
    P = 1 + b * maxp
    qp = rng.standard_normal((b, HQ, nc, STRIDE, D)).astype(np.float32)
    kg = rng.standard_normal((hk, P, STRIDE, D)).astype(np.float32)
    table = (1 + rng.permutation(P - 1)[:b * maxp]).reshape(b, maxp).astype(np.int32)
    perm = (STRIDE - np.arange(STRIDE)) % STRIDE
    scale = 1.0 / (STRIDE * float(D) ** 0.5)
    want = j_kern._score_pages(jnp.asarray(qp[..., perm, :] if pair else qp),
                               jnp.asarray(kg), jnp.asarray(table), group=group,
                               scale=scale, interpret=True, name="score_test")
    got = t_kern.score_pages_plain(torch.from_numpy(qp), torch.from_numpy(kg),
                                   torch.from_numpy(table), group=group,
                                   scale=scale, pair=pair)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_unsupported_metric_raises():
    """No silent fallback: a metric the scorer cannot serve raises."""
    _, tp = _pair()

    class OddMetric:
        stride = STRIDE

    pol = tp.__class__(metric=OddMetric(), schedule=tp.schedule,
                       selector=tp.selector, block_size=BS)
    q = torch.zeros((1, HQ, 1, D))
    pool = t_paged.init_pool(3, 2, BS, D, STRIDE, device="cpu")
    with pytest.raises(NotImplementedError):
        t_kern.fused_paged_decode(q, pool, torch.ones((1, 2), dtype=torch.int32),
                                  torch.tensor([5], dtype=torch.int32), pol)
    with pytest.raises(KeyError):
        t_policy.get_paged_executor("xla")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_query_pooling_goes_through_pool_kernel(monkeypatch, dtype):
    """The chunk scorer pools its queries through the pool kernel's wrapper
    (q read in its own dtype, group means rounded to it, as the reference
    keeps them) and scores as the plain pooling does."""
    from repro_torch.kernels import stem_metric as t_sm
    calls = []
    pool = t_sm.antidiag_pool

    def rec_pool(x, **kw):
        calls.append((x.dtype, kw.get("out_dtype", torch.float32)))
        return pool(x, **kw)

    _, targs = _chunk_case(2, 2, 11, seed=3)
    q, tpool, pt = targs[0].to(getattr(torch, dtype)), targs[1], targs[2]
    want = t_kern.score_pages_plain(
        t_sm.antidiag_pool_plain(q, block_size=BS, stride=STRIDE,
                                 out_dtype=q.dtype).float().index_select(
            -2, (STRIDE - torch.arange(STRIDE)) % STRIDE),
        tpool.kg, pt, group=2, scale=1.0 / (STRIDE * float(D) ** 0.5))
    monkeypatch.setattr(t_sm, "antidiag_pool", rec_pool)
    got = t_kern.chunk_page_scores(q, tpool.kg, pt, block_size=BS,
                                   pooling="antidiag", group=2)
    assert calls == [(q.dtype, q.dtype)]
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("pooling", ["antidiag", "mean"])
def test_bf16_chunk_scores_match_reference(pooling):
    """bf16 queries: the fused chunk scorer (its plain version here) scores
    as the reference's kernel-backed scorer and as the gather executor's
    metric do — pooled queries rounded to bf16, then fp32 products."""
    from repro_torch.core import metric as t_metric
    jargs, targs = _chunk_case(2, 2, 11, seed=5)
    q, tpool, pt = targs[0].to(torch.bfloat16), targs[1], targs[2]
    got = t_kern.chunk_page_scores(q, tpool.kg, pt, block_size=BS,
                                   pooling=pooling, group=2)
    want = j_kern.chunk_page_scores(
        jargs[0].astype(jnp.bfloat16), jargs[1].kg, jargs[2], block_size=BS,
        pooling=pooling, group=2, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=1e-5, rtol=0)
    kg_rows = tpool.kg[:, pt.long()].transpose(0, 1)
    gather = t_metric.chunk_routing_scores(q, kg_rows, block_size=BS,
                                           pooling=pooling)
    torch.testing.assert_close(got, gather.float(), atol=1e-5, rtol=0)
