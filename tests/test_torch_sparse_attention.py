"""Differential tests of the port's one-shot prefill attention against the
JAX reference: the plain versions of the four prefill kernels (flash,
block-sparse, anti-diagonal pooling, value magnitude) against the
reference's Pallas kernels in interpret mode and its ``ref.py`` oracles, and
``sparse_attention`` under every registered policy for the port's
"gather" / "dense" / "fused"-on-CPU executors against the reference's
"xla" / "dense" / "pallas".  Inputs come from seeded numpy.

MLA's shape, a v head dim apart from q/k's, runs through the same plain
versions and executors at the reduced deepseek-v3-671b's (24, 16) and its
MTP layer's (24, 24).

Selections (indices, slot masks, live counts, budgets) must be exactly
equal; float outputs agree within 1e-4 in fp32 (both sides sum in fp32 in
different orders) and within 2 bf16 ulps + 1e-3 * max|ref| in bf16 (the
two frameworks round the fp32 result to bf16 at different points)."""
import importlib
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.sparse_attention  # noqa: F401 (module, not the function)
from repro.core import metric as j_metric
from repro.core import policy as j_policy
from repro.core import selection as j_selection
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref

from repro_torch.core import chunked as t_chunked
from repro_torch.core import policy as t_policy
from repro_torch.core import selection as t_selection
from repro_torch.core.config import StemConfig as TStem
from repro_torch import kernels as t_kernels
from repro_torch.kernels import block_sparse_attn as t_bsa
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import stem_metric as t_sm

j_sa = sys.modules["repro.core.sparse_attention"]
# the module: the package exports the function of the same name
t_sa = importlib.import_module("repro_torch.core.sparse_attention")
torch.set_num_threads(1)

TOL = 1e-4
SMALL = dict(block_size=16, stride=4, min_budget_blocks=2, sink_blocks=1,
             local_blocks=1, tau=0.5)      # tau reaches xattention only
POLICIES = ("stem", "stem-sam", "uniform-oam", "streaming", "dense", "xattention")
EXECUTORS = (("xla", "gather"), ("dense", "dense"), ("pallas", "fused"))


def _arrays(seed, shapes, dtype="float32"):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _j(x, dtype="float32"):
    return jnp.asarray(x, dtype=getattr(jnp, dtype))


def _t(x, dtype="float32"):
    return torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch, dtype))


def _close(got: torch.Tensor, want, dtype="float32"):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
        return
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    limit = 2 * ulp + 1e-3 * np.abs(want).max()
    assert np.all(np.abs(got - want) <= limit), float(np.abs(got - want).max())


def _policies(name, **kw):
    return (j_policy.get_policy(name).with_updates(ignore_missing=True, **SMALL, **kw),
            t_policy.get_policy(name).with_updates(ignore_missing=True, **SMALL, **kw))


# ---------------------------------------------------------------------------
# The kernels' plain versions against the reference's kernels and oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hq,hk", [(4, 2), (8, 1)])
def test_flash_plain_matches_jax(dtype, hq, hk):
    q, k, v = _arrays(hq, [(1, hq, 256, 32), (1, hk, 256, 32), (1, hk, 256, 32)])
    got = t_fa.flash_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype))
    assert got.dtype == getattr(torch, dtype)
    _close(got, j_ops.flash_attention(_j(q, dtype), _j(k, dtype), _j(v, dtype)), dtype)
    _close(t_fa.flash_attention_plain(_t(q, dtype), _t(k, dtype), _t(v, dtype)),
           j_ref.flash_attention_ref(_j(q, dtype), _j(k, dtype), _j(v, dtype)), dtype)


def _selection(seed, b, hsel, nq, kmax):
    """Prefix-live selections: row i picks distinct causal blocks (its
    diagonal first); live counts 0..min(i+1, kmax), so some rows are empty."""
    rng = np.random.RandomState(seed)
    idx = np.zeros((b, hsel, nq, kmax), np.int32)
    cnt = np.zeros((b, hsel, nq), np.int32)
    for bi in range(b):
        for h in range(hsel):
            for i in range(nq):
                pick = [i] + list(rng.permutation(i))[:kmax - 1]
                idx[bi, h, i, :len(pick)] = pick
                cnt[bi, h, i] = rng.randint(0, len(pick) + 1)
    cnt[0, 0, 1] = 0                                # at least one empty row
    return idx, cnt, np.arange(kmax)[None, None, None] < cnt[..., None]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dedup", [False, True])
def test_block_sparse_plain_matches_jax(dtype, dedup):
    b, hq, hk, n, d, bs, kmax = 2, 4, 2, 128, 16, 32, 3
    hsel = hk if dedup else hq
    q, k, v = _arrays(5, [(b, hq, n, d), (b, hk, n, d), (b, hk, n, d)])
    idx, cnt, msk = _selection(7 + dedup, b, hsel, n // bs, kmax)
    got = t_bsa.block_sparse_attention(
        _t(q, dtype), _t(k, dtype), _t(v, dtype), torch.from_numpy(idx),
        torch.from_numpy(msk), block_size=bs, group_dedup=dedup,
        live_counts=torch.from_numpy(cnt))
    want = j_ops.block_sparse_attention(
        _j(q, dtype), _j(k, dtype), _j(v, dtype), jnp.asarray(idx),
        jnp.asarray(msk), block_size=bs, group_dedup=dedup,
        live_counts=jnp.asarray(cnt))
    _close(got, want, dtype)
    rows = np.repeat(cnt, hq // hsel, axis=1) == 0
    assert rows.any()
    assert torch.all(got.reshape(b, hq, n // bs, bs, d)[torch.from_numpy(rows)] == 0)
    if not dedup:
        _close(t_bsa.block_sparse_attention_plain(
                   _t(q, dtype), _t(k, dtype), _t(v, dtype),
                   torch.from_numpy(idx), torch.from_numpy(cnt), block_size=bs),
               j_ref.block_sparse_attention_ref(
                   _j(q, dtype), _j(k, dtype), _j(v, dtype), jnp.asarray(idx),
                   jnp.asarray(msk), block_size=bs), dtype)


@pytest.mark.parametrize("dv", [16, 24])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_separate_v_head_dim_matches_jax(dtype, dv):
    """q/k at 24 with v at 16 (MLA's shape, reduced) and 24: the wrapper
    (the plain version on the CPU) and the plain version against the
    reference's Pallas kernel; at dv == d also against ``ref.py``'s
    oracle (which reshapes its output to d, so it takes no other dv)."""
    q, k, v = _arrays(dv, [(1, 4, 128, 24), (1, 2, 128, 24), (1, 2, 128, dv)])
    got = t_fa.flash_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype))
    assert tuple(got.shape) == (1, 4, 128, dv) and got.dtype == getattr(torch, dtype)
    want = j_ops.flash_attention(_j(q, dtype), _j(k, dtype), _j(v, dtype))
    _close(got, want, dtype)
    _close(t_fa.flash_attention_plain(_t(q, dtype), _t(k, dtype), _t(v, dtype)),
           want, dtype)
    if dv == 24:
        _close(got, j_ref.flash_attention_ref(_j(q, dtype), _j(k, dtype),
                                              _j(v, dtype)), dtype)


@pytest.mark.parametrize("dv", [16, 24])
@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_sparse_plain_separate_v_head_dim_matches_jax(dtype, dedup, dv):
    """Block-sparse attention at q/k 24 with v 16 and 24, with and without
    group dedup: against the reference's Pallas kernel; empty rows exact
    zeros; at dv == d without dedup also against ``ref.py``."""
    b, hq, hk, n, d, bs, kmax = 2, 4, 2, 128, 24, 32, 3
    hsel = hk if dedup else hq
    q, k, v = _arrays(40 + dv, [(b, hq, n, d), (b, hk, n, d), (b, hk, n, dv)])
    idx, cnt, msk = _selection(11 + dedup, b, hsel, n // bs, kmax)
    got = t_bsa.block_sparse_attention(
        _t(q, dtype), _t(k, dtype), _t(v, dtype), torch.from_numpy(idx),
        torch.from_numpy(msk), block_size=bs, group_dedup=dedup,
        live_counts=torch.from_numpy(cnt))
    assert tuple(got.shape) == (b, hq, n, dv)
    want = j_ops.block_sparse_attention(
        _j(q, dtype), _j(k, dtype), _j(v, dtype), jnp.asarray(idx),
        jnp.asarray(msk), block_size=bs, group_dedup=dedup,
        live_counts=jnp.asarray(cnt))
    _close(got, want, dtype)
    rows = np.repeat(cnt, hq // hsel, axis=1) == 0
    assert torch.all(got.reshape(b, hq, n // bs, bs, dv)[torch.from_numpy(rows)] == 0)
    if dv == d and not dedup:
        _close(got, j_ref.block_sparse_attention_ref(
            _j(q, dtype), _j(k, dtype), _j(v, dtype), jnp.asarray(idx),
            jnp.asarray(msk), block_size=bs), dtype)


@pytest.mark.parametrize("executors", EXECUTORS, ids=lambda e: e[1])
def test_sparse_attention_separate_v_head_dim_matches_jax(executors):
    """sparse_attention under stem at q/k 24, v 16 (the reduced MLA's
    sparse path): the port's gather / dense / fused-on-CPU executors
    against the reference's xla / dense / pallas, selections through the
    OAM value term read off the 16-wide v; and the dense arm."""
    q, k, v = _arrays(3, [(1, 4, 256, 24), (1, 2, 256, 24), (1, 2, 256, 16)])
    jpol, tpol = _policies("stem")
    jout, jstats = j_sa.sparse_attention(q, k, v, jpol, executor=executors[0],
                                         return_stats=True)
    tout, tstats = t_sa.sparse_attention(_t(q), _t(k), _t(v), tpol,
                                         executor=executors[1], return_stats=True)
    assert tuple(tout.shape) == (1, 4, 256, 16)
    _close(tout, jout)
    np.testing.assert_allclose(float(tstats.density), float(jstats.density), rtol=1e-6)
    assert float(tstats.density) < 0.9
    _close(t_sa.dense_attention_auto(_t(q), _t(k), _t(v), scale=0.2),
           j_sa.dense_attention_auto(q, k, v, scale=0.2))


def test_head_dim_pairs_match_the_cuda_switch():
    """kernels.HEAD_DIM_PAIRS lists exactly the (q/k, v) pairs that
    csrc/head_dims.cuh instantiates, every head_dim of HEAD_DIMS at v = q/k
    among them; the wrappers' check raises ValueError on any other pair; and
    kernels.WGMMA_PAIRS, forward_route's bf16 tensor-core pairs, are the
    pairs of its STEM_WGMMA_PAIR_SWITCH."""
    src = (pathlib.Path(t_kernels.__file__).parent / "csrc" / "head_dims.cuh").read_text()
    switch = src[src.index("#define STEM_HEAD_DIM_PAIR_SWITCH"):]
    pairs = {(int(a), int(b)) for a, b in
             re.findall(r"STEM_HEAD_DIM_PAIR_CASE\((\d+), (\d+),", switch)}
    assert pairs == set(t_kernels.HEAD_DIM_PAIRS)
    assert {(d, d) for d in t_kernels.HEAD_DIMS} < pairs
    assert {(24, 16), (24, 24), (192, 128), (192, 192)} < pairs
    for d, dv in t_kernels.HEAD_DIM_PAIRS:
        t_kernels.check_head_dim_pair("flash_attention", d, dv)
    # the bf16 forwards' tensor-core pairs: forward_route is defined at
    # every pair, and its "wgmma" pairs are exactly the ones the .cu
    # dispatch's STEM_WGMMA_PAIR_SWITCH routes to the tile
    routed = {(int(a), int(b)) for a, b in
              re.findall(r"STEM_WGMMA_PAIR_CASE\((\d+), (\d+),", src)}
    bf16 = torch.bfloat16
    assert routed == set(t_kernels.WGMMA_PAIRS) == {
        p for p in t_kernels.HEAD_DIM_PAIRS if t_kernels.forward_route(bf16, *p) == "wgmma"}
    assert {(64, 64), (128, 128), (192, 128), (192, 192), (256, 256)} == routed
    for d, dv in t_kernels.HEAD_DIM_PAIRS:
        for dtype, bs in ((torch.float32, None), (bf16, None), (bf16, 128), (bf16, 64)):
            assert t_kernels.forward_route(dtype, d, dv, bs) in ("wgmma", "cuda_core")
    for d, dv in ((24, 8), (192, 64), (128, 192), (96, 96), (16, 24)):
        with pytest.raises(ValueError, match="head_dim"):
            t_kernels.check_head_dim_pair("block_sparse_attention", d, dv)


@pytest.mark.parametrize("bs,s", [(64, 8), (32, 4), (128, 16), (256, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_metric_plain_matches_jax(dtype, bs, s):
    (x,) = _arrays(9, [(2, 3, 512, 32)])
    x[0, 1, bs:2 * bs] = 0                          # an all-zero block
    xt, xj = _t(x, dtype), _j(x, dtype)
    pooled = t_sm.antidiag_pool(xt, block_size=bs, stride=s)
    assert pooled.dtype == torch.float32
    _close(pooled, j_ops.antidiag_pool(xj, block_size=bs, stride=s))
    _close(t_sm.antidiag_pool_plain(xt, block_size=bs, stride=s),
           j_ref.antidiag_pool_ref(xj, bs, s))
    # rounded to the input dtype: the reference's metric.antidiag_pool
    rounded = t_sm.antidiag_pool(xt, block_size=bs, stride=s, out_dtype=xt.dtype)
    assert rounded.dtype == xt.dtype
    _close(rounded, j_metric.antidiag_pool(xj, bs, s), dtype)
    # The reference kernel floors the squared norm at 1e-40, a subnormal
    # that flushes to zero, so its all-zero block reads -inf; the port
    # follows the reference's metric and oracle (log of the 1e-20 floor).
    live = np.ones(x.shape[:2] + (x.shape[2] // bs,), bool)
    live[0, 1, 1] = False
    np.testing.assert_allclose(
        t_sm.value_magnitude(xt, block_size=bs).numpy()[live],
        np.asarray(j_ops.value_magnitude(xj, block_size=bs))[live], atol=TOL, rtol=0)
    _close(t_sm.value_magnitude_plain(xt, block_size=bs), j_ref.value_magnitude_ref(xj, bs))
    _close(t_sm.value_magnitude(xt, block_size=bs),
           j_metric.value_block_magnitude(xj, bs))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [8, 16, 256])
def test_metric_plain_head_dims_match_jax(d, dtype):
    """The pool and value-magnitude kernels' semantics at head_dims 8, 16
    and 256, stride 4, block 8 (the small configurations' shapes): the
    reference kernels (interpret mode) against the plain versions; an
    all-zero block compared as in the test above."""
    bs, s = 8, 4
    (x,) = _arrays(10 + d, [(2, 3, 64, d)])
    x[1, 2, bs:2 * bs] = 0
    xt, xj = _t(x, dtype), _j(x, dtype)
    _close(t_sm.antidiag_pool_plain(xt, block_size=bs, stride=s),
           j_ops.antidiag_pool(xj, block_size=bs, stride=s))
    live = np.ones(x.shape[:2] + (x.shape[2] // bs,), bool)
    live[1, 2, 1] = False
    np.testing.assert_allclose(
        t_sm.value_magnitude_plain(xt, block_size=bs).numpy()[live],
        np.asarray(j_ops.value_magnitude(xj, block_size=bs))[live], atol=TOL, rtol=0)
    _close(t_sm.value_magnitude_plain(xt, block_size=bs),
           j_metric.value_block_magnitude(xj, bs))


@pytest.mark.parametrize("pooling", ["antidiag", "mean"])
def test_chunk_routing_scores_mixed_dtypes_match_jax(pooling):
    """A bf16 chunk against the pool's fp32 key summaries (the gather
    executor of a bf16 model): the scores are taken in fp32, as the
    reference's einsum promotes bf16 x fp32."""
    from repro_torch.core import metric as t_metric
    q, kg = _arrays(12, [(1, 4, 32, 16), (1, 2, 5, 4, 16)])
    got = t_metric.chunk_routing_scores(_t(q, "bfloat16"), _t(kg), block_size=16,
                                        pooling=pooling)
    want = j_metric.chunk_routing_scores(_j(q, "bfloat16"), _j(kg), block_size=16,
                                         pooling=pooling)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want)


# ---------------------------------------------------------------------------
# Dense attention (the dense arm and its plain versions)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [64, 512])
def test_dense_attention_matches_jax(n):
    q, k, v = _arrays(n, [(1, 4, n, 16), (1, 2, n, 16), (1, 2, n, 16)])
    tq, tk, tv = _t(q), _t(k), _t(v)
    _close(t_sa.dense_attention(tq, tk, tv), j_sa.dense_attention(q, k, v))
    _close(t_sa.dense_attention_chunked(tq, tk, tv, q_chunk=128, kv_chunk=64),
           j_sa.dense_attention_chunked(q, k, v, q_chunk=128, kv_chunk=64))
    _close(t_sa.dense_attention_auto(tq, tk, tv, threshold=256),
           j_sa.dense_attention_auto(q, k, v, threshold=256))
    mask = np.random.RandomState(1).rand(1, 4, n, n) < 0.5
    mask[..., 0] = True
    _close(t_sa.dense_attention(tq, tk, tv, mask=torch.from_numpy(mask)),
           j_sa.dense_attention(q, k, v, mask=jnp.asarray(mask)))


# ---------------------------------------------------------------------------
# Selection and sparse_attention under every policy
# ---------------------------------------------------------------------------

def _qkv(seed=0, n=256):
    return _arrays(seed, [(1, 4, n, 16), (1, 2, n, 16), (1, 2, n, 16)])


def _assert_selection_equal(tsel, jsel):
    for name in ("indices", "slot_mask", "budgets", "live_counts"):
        np.testing.assert_array_equal(getattr(tsel, name).numpy(),
                                      np.asarray(getattr(jsel, name)), err_msg=name)
    if jsel.block_mask is not None:
        np.testing.assert_array_equal(tsel.block_mask.numpy(),
                                      np.asarray(jsel.block_mask))


def _check_tau_margin(jpol, q, k, v):
    """The cumulative-mass cut compares fp32 cumulative sums with tau; the
    two frameworks may sum in other orders, so the test's tau must keep
    every block's preceding mass at least 1e-6 away from it."""
    if isinstance(jpol.selector, j_policy.CumulativeMassSelector):
        m = np.asarray(jpol.prefill_scores(q, k, v), np.float64)
        nq, nk = m.shape[-2:]
        causal = np.tril(np.ones((nq, nk), bool), nk - nq)
        m = np.where(causal, m, -np.inf)
        p = np.exp(m - m.max(-1, keepdims=True))
        p = -np.sort(-(p / p.sum(-1, keepdims=True)), axis=-1)
        before = np.cumsum(p, -1) - p
        assert np.abs(before - jpol.selector.tau).min() > 1e-6


@pytest.mark.parametrize("name", POLICIES)
@pytest.mark.parametrize("group_reduce", ["none", "mean"])
def test_selection_matches_jax(name, group_reduce):
    q, k, v = _qkv()
    jpol, tpol = _policies(name, group_reduce=group_reduce)
    _check_tau_margin(jpol, q, k, v)
    jsel, jk = j_sa.select_for(q, k, v, jpol)
    tsel, tk = t_sa.select_for(_t(q), _t(k), _t(v), tpol)
    assert tk == jk
    _assert_selection_equal(tsel, jsel)
    np.testing.assert_allclose(
        float(t_selection.selection_density(tsel, 16)),
        float(j_selection.selection_density(jsel, 16)), rtol=1e-6)


@pytest.mark.parametrize("name", POLICIES)
@pytest.mark.parametrize("executors", EXECUTORS, ids=lambda e: e[1])
def test_sparse_attention_matches_jax(name, executors):
    q, k, v = _qkv(1)
    jpol, tpol = _policies(name)
    _check_tau_margin(jpol, q, k, v)
    jout, jstats = j_sa.sparse_attention(q, k, v, jpol, executor=executors[0],
                                         return_stats=True)
    tout, tstats = t_sa.sparse_attention(_t(q), _t(k), _t(v), tpol,
                                         executor=executors[1], return_stats=True)
    _close(tout, jout)
    assert tstats.k_max == jstats.k_max
    np.testing.assert_allclose(float(tstats.density), float(jstats.density), rtol=1e-6)
    np.testing.assert_allclose(float(tstats.avg_budget_blocks),
                               float(jstats.avg_budget_blocks), rtol=1e-6)
    if name != "dense":
        assert float(tstats.density) < 0.9          # the selection is sparse


@pytest.mark.parametrize("ragged", [True, False])
@pytest.mark.parametrize("executors", EXECUTORS, ids=lambda e: e[1])
def test_group_dedup_and_padded_schedule_match_jax(ragged, executors):
    """group_reduce="mean" shares the selection per KV head (the executors'
    GQA dedup path); ragged=False runs the gather executor's padded
    schedule.  slot_chunk 2 makes the ragged schedule segment rows."""
    q, k, v = _qkv(2)
    jpol, tpol = _policies("stem", group_reduce="mean", ragged=ragged,
                           slot_chunk=2)
    _close(t_sa.sparse_attention(_t(q), _t(k), _t(v), tpol, executor=executors[1]),
           j_sa.sparse_attention(q, k, v, jpol, executor=executors[0]))


def test_stem_attention_shim_matches_jax():
    from repro.core.config import StemConfig as JStem

    q, k, v = _qkv(3)
    cfg = dict(block_size=16, stride=4, min_budget_blocks=2, sink_blocks=1,
               local_blocks=1)
    _close(t_sa.stem_attention(_t(q), _t(k), _t(v), TStem(backend="gather", **cfg)),
           j_sa.stem_attention(q, k, v, JStem(backend="xla", **cfg)))


def test_selection_helpers_match_jax():
    m = np.random.RandomState(4).randn(1, 2, 6, 8).astype(np.float32)
    budgets = np.array([1, 2, 2, 3, 3, 4], np.int32)
    for with_mask in (True, False):
        _assert_selection_equal(
            t_selection.select_blocks(_t(m), torch.from_numpy(budgets), 4,
                                      sink_blocks=1, local_blocks=1,
                                      with_block_mask=with_mask),
            j_selection.select_blocks(jnp.asarray(m), jnp.asarray(budgets), 4,
                                      sink_blocks=1, local_blocks=1,
                                      with_block_mask=with_mask))
    for nq, nk in ((6, 8), (4, 4)):
        np.testing.assert_array_equal(t_selection.causal_block_mask(nq, nk).numpy(),
                                      np.asarray(j_selection.causal_block_mask(nq, nk)))
        np.testing.assert_array_equal(
            t_selection.forced_block_mask(nq, nk, 2, 1).numpy(),
            np.asarray(j_selection.forced_block_mask(nq, nk, 2, 1)))
    bm = np.random.RandomState(5).rand(1, 2, 3, 3) < 0.6
    np.testing.assert_array_equal(
        t_selection.block_mask_to_token_mask(torch.from_numpy(bm), 4, 4, 12, 12).numpy(),
        np.asarray(j_selection.block_mask_to_token_mask(jnp.asarray(bm), 4, 4, 12, 12)))
    for chunk in (1, 2, 3):
        assert (t_selection.budget_sorted_segments(budgets, chunk)
                == j_selection.budget_sorted_segments(budgets, chunk))


# ---------------------------------------------------------------------------
# Ties, thresholds and executor names
# ---------------------------------------------------------------------------

def test_cumulative_mass_ties_keep_index_order():
    """Equal probabilities: the stable sort keeps the lower block first, as
    ``jnp.argsort`` does (tau 0.6 keeps 3 of 4 blocks at 0.25 each)."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3],
                      [0.0, 0.5, 0.0, 0.5]], np.float32)
    for tau in (0.3, 0.6):
        np.testing.assert_array_equal(
            t_policy._cumulative_mass_keep(_t(probs), tau).numpy(),
            np.asarray(j_policy._cumulative_mass_keep(jnp.asarray(probs), tau)))
    flat = np.zeros((1, 2, 4, 4), np.float32)       # every block tied
    jsel = j_policy.CumulativeMassSelector(tau=0.6, sink_blocks=0,
                                           local_blocks=1).select(
        jnp.asarray(flat), None, 4, with_block_mask=True)
    tsel = t_policy.CumulativeMassSelector(tau=0.6, sink_blocks=0,
                                           local_blocks=1).select(
        _t(flat), None, 4, with_block_mask=True)
    _assert_selection_equal(tsel, jsel)


def test_cumulative_mass_decode_matches_jax():
    m = np.random.RandomState(6).randn(3, 2, 2, 8).astype(np.float32)
    lens = np.array([0, 20, 64], np.int32)
    kw = dict(block_size=8, schedule=None, budget_frac=0.5)
    tsel = t_policy.CumulativeMassSelector(tau=0.7, sink_blocks=1, local_blocks=1
                                           ).select_decode(_t(m), torch.from_numpy(lens), **kw)
    jsel = j_policy.CumulativeMassSelector(tau=0.7, sink_blocks=1, local_blocks=1
                                           ).select_decode(jnp.asarray(m), jnp.asarray(lens), **kw)
    for name in ("indices", "live", "budgets", "n_valid"):
        np.testing.assert_array_equal(getattr(tsel, name).numpy(),
                                      np.asarray(getattr(jsel, name)), err_msg=name)
    pol = t_policy.get_policy("xattention")
    assert pol.decode_budget_bound(8, 0.5) == j_policy.get_policy(
        "xattention").decode_budget_bound(8, 0.5) == 8


def test_executor_registries():
    for name in ("fused", "gather", "dense"):
        assert t_policy.get_executor(name).needs_block_mask == (name == "dense")
    assert set(t_policy.available_executors()) == {"fused", "gather", "dense"}
    with pytest.raises(KeyError, match="unknown executor"):
        t_policy.get_executor("pallas")
    # "dense" exists for the one-shot prefill only: a paged lane raises
    with pytest.raises(KeyError, match="unknown paged executor 'dense'"):
        t_policy.get_paged_executor("dense")
    with pytest.raises(NotImplementedError, match="monolithic_prefill=True"):
        t_chunked.validate_chunked_policy(t_policy.get_policy("xattention"))
    cfg = TStem(slot_chunk=3, ragged=False)
    assert (cfg.policy().slot_chunk, cfg.policy().ragged) == (3, False)
