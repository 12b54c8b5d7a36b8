"""The attention forwards' saved log-sum-exp, the backward's route and the
bf16 gradient rule of its tensor-core route, on the CPU.

* The plain forwards' ``return_lse`` (flash with GQA; block-sparse with
  dead slots, ``group_dedup`` and a ``cnt == 0`` row) against
  ``jax.nn.logsumexp`` of the same masked scores built from numpy inputs,
  within 1e-5 of scale; a row that sees no key gives +inf (P = 0).  And
  ``exp(S - lse) . V`` against the reference's ``ref.py`` oracles
  (``flash_attention_ref``, ``block_sparse_attention_ref``) within 1e-5:
  the lse normalises each row as the forward did.
* The routes over (dtype, d, dv, block_size) at every pair of
  ``HEAD_DIM_PAIRS``: ``forward_route`` "wgmma" exactly for bf16 at a pair
  of ``WGMMA_PAIRS`` (block-sparse: blocks a multiple of 128), which is
  where ``replay.KERNELS`` holds a recorded forward call to the p_bf16 rule;
  ``backward_route`` is the same table (elsewhere the CUDA-core backward
  reads the lse of the CUDA-core forward).
* A test-local backward that rounds P and dS to bf16 before its products,
  as the tensor-core kernels do, within ``replay.grad_tolerance(...,
  p_bf16=True)`` of the fp32 plain backwards on bf16-valued inputs, at d 64
  and at MLA's (192, 128); the same backward with one (query block, key
  block) pair dropped from dk / dv, or one selected key block dropped from
  a row's dq, over that rule in most of the rows the fault touches.  This
  pins on the CPU that the rule the card tests apply admits the rounding
  and rejects the faults.
* ``attention`` without a gradient to take (serving) is the forward
  wrapper's own call: no lse, no autograd node, a plain recorded output.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ref as j_ref

from repro_torch.kernels import (HEAD_DIM_PAIRS, WGMMA_PAIRS, backward_route, forward_route,
                                 replay)
from repro_torch.kernels import block_sparse_attn as t_bsa
from repro_torch.kernels import flash_attention as t_fa

torch.set_num_threads(1)


def _inputs(seed, b, hq, hk, n, d, dv):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((b, hq, n, d), (b, hk, n, d), (b, hk, n, dv), (b, hq, n, dv))]


def _selection(rng, b, hs, nq, kmax, dead=((0, 0, 3),)):
    """Causal selections with a live prefix of random length (the diagonal
    block always live), dead slots revisit-filled with the first live block,
    and the listed (b, h, row) at cnt == 0."""
    idx = np.zeros((b, hs, nq, kmax), np.int32)
    cnt = np.zeros((b, hs, nq), np.int32)
    for bb in range(b):
        for h in range(hs):
            for i in range(nq):
                c = 0 if (bb, h, i) in dead else int(rng.integers(1, min(kmax, i + 1) + 1))
                live = np.concatenate([[i], rng.permutation(i)])[:c]
                idx[bb, h, i, :c] = live
                idx[bb, h, i, c:] = live[0] if c else 0
                cnt[bb, h, i] = c
    return idx, cnt


def _token_mask(idx, cnt, bs, n, group, dedup):
    """(b, hq, n, n) bool: key j visible from query i (causal, selected)."""
    if dedup:
        idx, cnt = np.repeat(idx, group, axis=1), np.repeat(cnt, group, axis=1)
    b, hq, nq, kmax = idx.shape
    blocks = np.zeros((b, hq, nq, nq), bool)
    for s in range(kmax):
        live = s < cnt
        bi, hi, ri = np.nonzero(live)
        blocks[bi, hi, ri, idx[bi, hi, ri, s]] = True
    tok = np.repeat(np.repeat(blocks, bs, axis=-2), bs, axis=-1)
    return tok & np.tril(np.ones((n, n), bool))


def _scores(q, k, scale):
    b, hq, n, d = q.shape
    hk = k.shape[1]
    kk = np.repeat(k, hq // hk, axis=1)
    return np.einsum("bhqd,bhkd->bhqk", q, kk) * scale


def _check_lse(lse, out, q, k, v, mask, want_out):
    """lse against jax.nn.logsumexp of the masked scores; exp(S - lse) . V
    against the reference forward."""
    scale = q.shape[-1] ** -0.5
    s = _scores(q, k, scale)
    ref = np.asarray(jax.nn.logsumexp(jnp.where(mask, s, -jnp.inf), axis=-1))
    empty = ~mask.any(-1)
    lse = lse.numpy()
    assert np.array_equal(np.isposinf(lse), empty) and np.isfinite(lse[~empty]).all()
    scl = np.abs(ref[~empty]).max()
    np.testing.assert_allclose(lse[~empty], ref[~empty], atol=1e-5 * scl, rtol=0)
    p = np.where(mask, np.exp(s - lse[..., None]), 0.0)
    vv = np.repeat(v, q.shape[1] // v.shape[1], axis=1)
    recon = np.einsum("bhqk,bhkd->bhqd", p, vv)
    want_out = np.asarray(want_out)
    np.testing.assert_allclose(recon, want_out, atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.numpy(), want_out, atol=1e-5, rtol=0)


@pytest.mark.parametrize("hq,hk", [(2, 2), (4, 2), (8, 1)])
def test_flash_plain_lse_matches_jax(hq, hk):
    b, n, d = 2, 96, 16
    q, k, v, _ = _inputs(hq * 10 + hk, b, hq, hk, n, d, d)
    out, lse = t_fa.flash_attention_plain(*map(torch.from_numpy, (q, k, v)), return_lse=True)
    assert lse.shape == (b, hq, n) and lse.dtype == torch.float32
    mask = np.broadcast_to(np.tril(np.ones((n, n), bool)), (b, hq, n, n))
    _check_lse(lse, out, q, k, v, mask, j_ref.flash_attention_ref(q, k, v))
    # the wrapper on a CPU tensor returns the plain pair; without return_lse
    # the output is the same tensor
    got, lse2 = t_fa.flash_attention(*map(torch.from_numpy, (q, k, v)), return_lse=True)
    assert torch.equal(got, out) and torch.equal(lse2, lse)
    assert torch.equal(t_fa.flash_attention(*map(torch.from_numpy, (q, k, v))), out)


@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("hq,hk", [(2, 2), (4, 2)])
def test_block_sparse_plain_lse_matches_jax(hq, hk, dedup):
    b, n, d, bs, kmax = 2, 64, 16, 8, 3
    q, k, v, _ = _inputs(hq * 10 + hk + dedup, b, hq, hk, n, d, d)
    rng = np.random.default_rng(hq + dedup)
    idx, cnt = _selection(rng, b, hk if dedup else hq, n // bs, kmax)
    kw = dict(block_size=bs, group_dedup=dedup)
    out, lse = t_bsa.block_sparse_attention_plain(
        *map(torch.from_numpy, (q, k, v, idx, cnt)), return_lse=True, **kw)
    mask = _token_mask(idx, cnt, bs, n, hq // hk, dedup)
    assert (~mask.any(-1)).any()                   # the cnt == 0 row
    ri, rc = ((np.repeat(idx, hq // hk, 1), np.repeat(cnt, hq // hk, 1)) if dedup
              else (idx, cnt))
    want = j_ref.block_sparse_attention_ref(q, k, v, ri, np.arange(kmax) < rc[..., None],
                                            block_size=bs)
    _check_lse(lse, out, q, k, v, mask, want)
    got = t_bsa.block_sparse_attention(*map(torch.from_numpy, (q, k, v, idx)),
                                       live_counts=torch.from_numpy(cnt), return_lse=True,
                                       **kw)
    assert torch.equal(got[0], out) and torch.equal(got[1], lse)


def _on_tensor_cores(kernel, dtype, d, dv, bs=None):
    """The forward's route as ``replay.KERNELS`` holds its recorded calls."""
    a = {"q": torch.empty((1, 1, 1, d), dtype=dtype, device="meta"),
         "v": torch.empty((1, 1, 1, dv), dtype=dtype, device="meta"), "block_size": bs}
    return replay.KERNELS[kernel][2](a)


@pytest.mark.parametrize("pair", HEAD_DIM_PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_backward_route_mirrors_forward(pair):
    """Both routes and the replay predicates against their stated table:
    the tensor-core tile for bf16 at WGMMA_PAIRS (and blocks of a multiple
    of 128), forward and backward alike, so a backward runs on the tensor
    cores exactly where its forward did."""
    d, dv = pair
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        tile = dtype == torch.bfloat16 and pair in WGMMA_PAIRS
        fwd, bwd = forward_route(dtype, d, dv), backward_route(dtype, d, dv)
        assert fwd in ("wgmma", "cuda_core") and bwd in ("wgmma", "cuda_core")
        assert (fwd == "wgmma") == tile == _on_tensor_cores("flash_attention", dtype, d, dv)
        assert bwd == fwd
        for bs in (8, 16, 64, 128, 192, 256, 512):
            fwd, bwd = forward_route(dtype, d, dv, bs), backward_route(dtype, d, dv, bs)
            assert (fwd == "wgmma") == (tile and bs % 128 == 0) == _on_tensor_cores(
                "block_sparse_attention", dtype, d, dv, bs)
            assert bwd == fwd


# ---------------------------------------------------------------------------
# the tensor-core route's bf16 rule
# ---------------------------------------------------------------------------

def _bf16(x):
    return x.to(torch.bfloat16).float()


def _tile_bwd(q, k, v, o, do, mask, scale, drop_kv=None, drop_q=None):
    """The backward as the tensor-core kernels compute it, on one dense
    token mask (b, hq, n, n): P = exp(S - lse) and dS = P * (dP - delta) in
    fp32, each rounded to bf16 before dV = P^T.dO, dK = dS^T.Q and dQ =
    dS.K (fp32 sums).  drop_kv / drop_q: (b, h, query rows, key rows) left
    out of dk / dv only, or of dq only (planted faults)."""
    group = q.shape[1] // k.shape[1]
    kk, vv = (x.repeat_interleave(group, dim=1) for x in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q, kk) * scale
    s = torch.where(mask, s, -torch.inf)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - lse), 0.0)
    delta = (do * o).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", do, vv) - delta)
    p, ds = _bf16(p), _bf16(ds)
    pk, dsk, dsq = p.clone(), ds.clone(), ds.clone()
    for drop, tensors in ((drop_kv, (pk, dsk)), (drop_q, (dsq,))):
        if drop is not None:
            bb, h, rows, cols = drop
            for x in tensors:
                x[bb, h, rows, cols] = 0.0
    b, hq, n, _ = q.shape
    hk = k.shape[1]
    dq = torch.einsum("bhqk,bhkd->bhqd", dsq, kk) * scale
    dk = (torch.einsum("bhqk,bhqd->bhkd", dsk, q) * scale).reshape(b, hk, group, n, -1).sum(2)
    dv = torch.einsum("bhqk,bhqd->bhkd", pk, do).reshape(b, hk, group, n, -1).sum(2)
    return dq, dk, dv


def _over(got, want):
    """Per gradient: (rows over the p_bf16 gradient rule, as a bool mask
    over (b, h, n)) and the largest |got - want| / limit."""
    out = []
    for g, w in zip(got, want):
        r = (g - w).abs() / replay.grad_tolerance(w, torch.bfloat16, p_bf16=True)
        out.append(((r > 1).any(-1), float(r.max())))
    return out


@pytest.mark.parametrize("dedup", [False, True])
def test_bf16_rule_admits_rounding_and_rejects_dropped_pairs(dedup):
    """bf16-valued inputs (b 1, 4 / 2 heads, d 64, n 512): the tile's
    rounding of P and dS stays within the p_bf16 gradient rule of the fp32
    plain backwards (flash, and block-sparse at block 64); a (query block,
    key block) pair dropped from dk / dv, and one selected key block dropped
    from a query block's dq, put most of the touched rows over it."""
    _bf16_rule_case(dedup, 64, 64, 7 + dedup)


def test_bf16_rule_at_mla_pair():
    """The same at MLA's (192, 128), the pair whose dk / dv kernel splits
    S / P / dK and dP / dS / dV over its two warpgroups (the rounding it
    does is the same: P and dS to bf16 before their products)."""
    _bf16_rule_case(False, 192, 128, 26)


def _bf16_rule_case(dedup, d, dv, seed):
    b, hq, hk, n, bs = 1, 4, 2, 512, 64
    q, k, v, do = (_bf16(torch.from_numpy(x)) for x in _inputs(seed, b, hq, hk, n, d, dv))
    scale = d ** -0.5
    nq = n // bs
    rng = np.random.default_rng(11 + dedup)
    idx, cnt = _selection(rng, b, hk if dedup else hq, nq, 4, dead=())
    ti, tc = torch.from_numpy(idx), torch.from_numpy(cnt)
    kw = dict(block_size=bs, group_dedup=dedup)
    cases = {
        "flash": (torch.tril(torch.ones((n, n), dtype=torch.bool)).expand(b, hq, n, n),
                  lambda o: t_fa.flash_attention_bwd_plain(q, k, v, o, do),
                  _bf16(t_fa.flash_attention_plain(q, k, v))),
        "block-sparse": (torch.from_numpy(_token_mask(idx, cnt, bs, n, hq // hk, dedup)),
                         lambda o: t_bsa.block_sparse_attention_bwd_plain(
                             q, k, v, o, do, ti, tc, **kw),
                         _bf16(t_bsa.block_sparse_attention_plain(q, k, v, ti, tc, **kw)))}
    for name, (mask, plain, o) in cases.items():
        want = plain(o)
        for part, (rows, worst) in zip(("dq", "dk", "dv"), _over(
                _tile_bwd(q, k, v, o, do, mask, scale), want)):
            assert worst <= 1, f"{name} {part}: bf16 rounding at {worst:.2f}x the rule"
        # query block 7 (the last) and the earliest key block it sees, in
        # the first query head of KV head 0
        i = nq - 1
        j = int(np.nonzero(mask[0, 0, i * bs].numpy())[0][0]) // bs
        qrows, krows = slice(i * bs, (i + 1) * bs), slice(j * bs, (j + 1) * bs)
        assert bool(mask[0, 0, qrows, krows].any())
        fault = (0, 0, qrows, krows)
        res = _over(_tile_bwd(q, k, v, o, do, mask, scale, drop_kv=fault), want)
        for part, (rows, worst) in zip(("dk", "dv"), res[1:]):
            bad = int(rows[0, 0, krows].sum())
            assert 2 * bad > bs, f"{name} {part}: dropped pair over the rule in {bad} of {bs} rows"
        res = _over(_tile_bwd(q, k, v, o, do, mask, scale, drop_q=fault), want)
        bad = int(res[0][0][0, 0, qrows].sum())
        assert 2 * bad > bs, f"{name} dq: dropped key block over the rule in {bad} of {bs} rows"


def test_attention_without_grad_is_the_forward_call():
    """Serving calls the differentiable ``attention`` with tensors that need
    no gradient: it is then the forward wrapper's own call (no lse asked
    for, no autograd node), so a replay recorder sees a plain output; with
    a gradient needed, the autograd Function runs."""
    b, hq, hk, n, d, bs = 1, 4, 2, 32, 16, 8
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(3, b, hq, hk, n, d, d))
    idx, cnt = (torch.from_numpy(x) for x in _selection(np.random.default_rng(3), b, hq,
                                                         n // bs, 2))
    calls = ((t_fa.attention, (), {}),
             (t_bsa.attention, (idx, cnt), dict(block_size=bs)))
    with replay.Recorder() as rec:
        for fn, args, kw in calls:
            out = fn(q, k, v, *args, **kw)
            assert out.grad_fn is None and isinstance(out, torch.Tensor)
            with torch.no_grad():
                assert fn(q.requires_grad_(), k, v, *args, **kw).grad_fn is None
            q.requires_grad_(False)
    report = rec.check()
    assert report["flash_attention"]["checked"] == 2
    assert report["block_sparse_attention"]["checked"] == 2
    for fn, args, kw in calls:
        out = fn(q.clone().requires_grad_(), k, v, *args, **kw)
        assert type(out.grad_fn).__name__ == "_AttentionBackward"
