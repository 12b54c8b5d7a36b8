"""Differential tests: the port's Stem selection math against the JAX
reference — budget schedules, pooled metrics, decode / chunk selection,
revisit filling — including deliberate top-k ties and the greedy tie rule.

Integers (budgets, selected indices, live masks) must match exactly; floats
within 1e-4 (fp32), the reference suites' own bound.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import chunked as j_chunked
from repro.core import metric as j_metric
from repro.core import policy as j_policy
from repro.core import schedule as j_schedule
from repro.core.selection import revisit_indices as j_revisit
from repro.runtime.sampling import GreedySampler as JGreedy

from repro_torch.core import chunked as t_chunked
from repro_torch.core import metric as t_metric
from repro_torch.core import policy as t_policy
from repro_torch.core import schedule as t_schedule
from repro_torch.core.selection import revisit_indices as t_revisit, stable_topk
from repro_torch.runtime.sampling import GreedySampler as TGreedy

torch.set_num_threads(1)

TOL = 1e-4
POLICIES = ["stem", "stem-sam", "uniform-sam", "uniform-oam", "streaming",
            "dense"]
SMALL = dict(block_size=8, stride=4, sink_blocks=1, local_blocks=1,
             min_budget_blocks=2)


def _pair(name, **updates):
    kw = dict(SMALL, **updates)
    return (j_policy.get_policy(name).with_updates(ignore_missing=True, **kw),
            t_policy.get_policy(name).with_updates(ignore_missing=True, **kw))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("nq,nk", [(1, 1), (7, 7), (16, 16), (5, 12), (40, 40)])
def test_schedules_match(nq, nk):
    np.testing.assert_array_equal(
        t_schedule.tpd_budget_blocks(nq, nk, 6, 0.7, min_budget_blocks=2),
        j_schedule.tpd_budget_blocks(nq, nk, 6, 0.7, min_budget_blocks=2))
    np.testing.assert_array_equal(t_schedule.uniform_budget_blocks(nq, nk, 3),
                                  j_schedule.uniform_budget_blocks(nq, nk, 3))
    np.testing.assert_array_equal(t_schedule.dense_budget_blocks(nq, nk),
                                  j_schedule.dense_budget_blocks(nq, nk))
    np.testing.assert_array_equal(
        t_schedule.sink_local_budget_blocks(nq, nk, 2, 3),
        j_schedule.sink_local_budget_blocks(nq, nk, 2, 3))
    np.testing.assert_array_equal(
        t_schedule.apply_sparse_segment(
            t_schedule.dense_budget_blocks(nq, nk) // 2, nq, nk, (0.25, 0.75)),
        j_schedule.apply_sparse_segment(
            j_schedule.dense_budget_blocks(nq, nk) // 2, nq, nk, (0.25, 0.75)))


@pytest.mark.parametrize("name", POLICIES)
def test_policy_budgets_match(name):
    """Prefill budgets (what the chunk lane slices) and the static chunk and
    decode widths agree for every ported built-in policy, at the paper's
    defaults and at test size."""
    for kw in ({}, SMALL):
        jp = j_policy.get_policy(name).with_updates(ignore_missing=True, **kw)
        tp = t_policy.get_policy(name).with_updates(ignore_missing=True, **kw)
        bs = jp.block_size
        for n in (1, 3, 17, 64, 130):
            np.testing.assert_array_equal(tp.prefill_budgets(n * bs),
                                          jp.prefill_budgets(n * bs))
            for frac in (0.25, 0.5, 1.0):
                assert tp.decode_budget_bound(n, frac) == \
                    jp.decode_budget_bound(n, frac)
        assert t_chunked.chunk_budget_bound(tp, 40) == \
            j_chunked.chunk_budget_bound(jp, 40)
        np.testing.assert_array_equal(
            t_chunked.chunk_budget_rows(tp, 24 * bs, 8 * bs, 4),
            j_chunked.chunk_budget_rows(jp, 24 * bs, 8 * bs, 4))


def test_pooling_and_value_magnitude():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 32, 8)).astype(np.float32)
    np.testing.assert_allclose(t_metric.antidiag_pool(_t(x), 8, 4).numpy(),
                               np.asarray(j_metric.antidiag_pool(x, 8, 4)),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(t_metric.mean_pool(_t(x), 8).numpy(),
                               np.asarray(j_metric.mean_pool(x, 8)),
                               atol=TOL, rtol=0)
    x[0, 0, :8] = 0.0                     # an all-zero block hits the floor
    np.testing.assert_allclose(t_metric.value_block_magnitude(_t(x), 8).numpy(),
                               np.asarray(j_metric.value_block_magnitude(x, 8)),
                               atol=TOL, rtol=0)


@pytest.mark.parametrize("pooling", ["antidiag", "mean"])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_chunk_and_decode_routing_scores(pooling, group):
    rng = np.random.default_rng(group)
    hq, d = 4, 8
    hk = hq // group
    q = rng.standard_normal((2, hq, 16, d)).astype(np.float32)
    kg = rng.standard_normal((2, hk, 5, 4, d)).astype(np.float32)
    np.testing.assert_allclose(
        t_metric.chunk_routing_scores(_t(q), _t(kg), block_size=8,
                                      pooling=pooling).numpy(),
        np.asarray(j_metric.chunk_routing_scores(q, kg, block_size=8,
                                                 pooling=pooling)),
        atol=TOL, rtol=0)
    np.testing.assert_allclose(
        t_metric.decode_routing_scores(_t(q[:, :, :1]), _t(kg)).numpy(),
        np.asarray(j_metric.decode_routing_scores(q[:, :, :1], kg)),
        atol=TOL, rtol=0)


@pytest.mark.parametrize("mode", ["none", "mean", "max"])
def test_group_reduce_metric(mode):
    m = np.random.default_rng(3).standard_normal((2, 4, 3, 6)).astype(np.float32)
    np.testing.assert_allclose(
        t_metric.group_reduce_metric(_t(m), 2, mode).numpy(),
        np.asarray(j_metric.group_reduce_metric(m, 2, mode)), atol=TOL, rtol=0)


def _decode_select_pair(name, m, lens, frac, **updates):
    jp, tp = _pair(name, **updates)
    js = jp.decode_select(jnp.asarray(m), jnp.asarray(lens, jnp.int32),
                          budget_frac=frac)
    ts = tp.decode_select(_t(m), _t(np.asarray(lens, np.int32)),
                          budget_frac=frac)
    np.testing.assert_array_equal(ts.indices.numpy(), np.asarray(js.indices))
    np.testing.assert_array_equal(ts.live.numpy(), np.asarray(js.live))
    np.testing.assert_array_equal(ts.budgets.numpy(), np.asarray(js.budgets))
    np.testing.assert_array_equal(ts.n_valid.numpy(), np.asarray(js.n_valid))
    return ts


@pytest.mark.parametrize("name", POLICIES)
@pytest.mark.parametrize("frac", [0.25, 0.5, 1.0])
def test_decode_select_matches(name, frac):
    rng = np.random.default_rng(11)
    m = rng.standard_normal((3, 2, 2, 9)).astype(np.float32)
    _decode_select_pair(name, m, [0, 37, 70], frac)


def test_decode_select_exact_ties():
    """Deliberate ties: the streaming metric scores every block 0 and every
    forced block scores exactly FORCE_BONUS; an all-equal OAM metric ties
    every candidate.  The live prefix must keep the lowest block ids, as
    ``jax.lax.top_k`` does."""
    zeros = np.zeros((2, 2, 2, 12), np.float32)
    sel = _decode_select_pair("streaming", zeros, [95, 41], 0.25,
                              sink_blocks=2, local_blocks=2)
    _decode_select_pair("stem", zeros, [95, 41], 0.25, min_budget_blocks=0)
    _decode_select_pair("uniform-sam", np.ones_like(zeros), [95, 3], 0.5)
    # streaming keeps exactly sink + local blocks, lowest id first among ties
    live = sel.indices[0, 0, 0][sel.live[0, 0, 0]].tolist()
    assert live == [0, 1, 10, 11]


def _chunk_select_pair(name, m, rows, budgets, k_max=0, **updates):
    jp, tp = _pair(name, **updates)
    js = j_chunked.select_chunk_blocks(jnp.asarray(m), jnp.asarray(rows),
                                       jnp.asarray(budgets), jp, k_max)
    ts = t_chunked.select_chunk_blocks(_t(m), _t(rows), _t(budgets), tp, k_max)
    np.testing.assert_array_equal(ts.indices.numpy(), np.asarray(js.indices))
    np.testing.assert_array_equal(ts.live.numpy(), np.asarray(js.live))
    return ts


@pytest.mark.parametrize("name", POLICIES)
@pytest.mark.parametrize("k_max", [0, 3])
def test_chunk_select_matches(name, k_max):
    rng = np.random.default_rng(5)
    m = rng.standard_normal((2, 4, 3, 10)).astype(np.float32)
    rows = np.array([[0, 1, 2], [6, 7, 8]], np.int32)
    budgets = np.array([[1, 2, 3], [3, 3, 2]], np.int32)
    _chunk_select_pair(name, m, rows, budgets, k_max)


def test_chunk_select_budget_narrower_than_forced_set():
    """Budgets below the forced sink + local count: only the lowest-index
    forced blocks survive the cut, exactly as in the reference."""
    m = np.zeros((1, 2, 2, 12), np.float32)
    rows = np.array([[9, 10]], np.int32)
    budgets = np.array([[1, 3]], np.int32)
    sel = _chunk_select_pair("streaming", m, rows, budgets,
                             sink_blocks=2, local_blocks=3)
    assert sel.indices[0, 0, 0][sel.live[0, 0, 0]].tolist() == [0]
    assert sel.indices[0, 0, 1][sel.live[0, 0, 1]].tolist() == [0, 1, 8]
    rng = np.random.default_rng(2)
    _chunk_select_pair("stem", rng.standard_normal((1, 2, 2, 12)).astype(np.float32),
                       rows, budgets, sink_blocks=2, local_blocks=3)


def test_revisit_indices_match():
    rng = np.random.default_rng(8)
    idx = rng.integers(0, 20, size=(3, 2, 6)).astype(np.int32)
    cnt = rng.integers(0, 7, size=(3, 2))
    live = np.arange(6)[None, None, :] < cnt[..., None]
    np.testing.assert_array_equal(t_revisit(_t(idx), _t(live)).numpy(),
                                  np.asarray(j_revisit(jnp.asarray(idx),
                                                       jnp.asarray(live))))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stable_topk_matches_lax_top_k(seed):
    x = np.random.default_rng(seed).integers(-3, 4, size=(4, 5, 17)).astype(
        np.float32)
    x[0, 0] = 1e30
    vals, idx = stable_topk(_t(x), 9)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 9)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))


def test_greedy_sampler_first_max_tie_rule():
    logits = np.zeros((4, 10), np.float32)
    logits[0, [3, 7]] = 2.0
    logits[1, [0, 9]] = -1.0
    logits[1, 1:9] = -5.0
    logits[2] = 1.0
    logits[3, [8, 2, 5]] = 4.0
    got = TGreedy()(_t(logits)).numpy()
    np.testing.assert_array_equal(got, np.argmax(logits, axis=-1))
    np.testing.assert_array_equal(got, np.asarray(JGreedy()(jnp.asarray(logits))))
    np.testing.assert_array_equal(got, [3, 0, 0, 2])
