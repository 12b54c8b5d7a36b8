"""The port's contiguous-cache decode against the JAX reference: the block
summaries and policy-sparse decode attention of ``core/decode.py`` (the
``tests/test_stem_decode.py`` cases: full budget equals dense, ragged and
unaligned lengths, partial-block masking, scalar vs vector lengths, the
zero-live row), the cache write, ``attention.apply_decode``,
``transformer.decode_step`` / ``paged_decode_step`` and
``steps.make_serve_step``.  Same inputs from a seed, weights carried from
JAX ``init_params``; fp32 within 1e-4, ids and selections exact."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as j_configs
from repro.core import StemConfig as JStem
from repro.core import decode as j_decode
from repro.core import policy as j_policy
from repro.launch import steps as j_steps
from repro.models import attention as j_attention
from repro.models import common as j_common
from repro.models import registry as j_registry
from repro.models import transformer as j_transformer

from repro_torch import configs as t_configs
from repro_torch.core import decode as t_decode
from repro_torch.core import policy as t_policy
from repro_torch.core.config import StemConfig as TStem
from repro_torch.core.selection import DecodeSelection
from repro_torch.launch import steps as t_steps
from repro_torch.models import attention as t_attention
from repro_torch.models import common as t_common
from repro_torch.models import registry as t_registry
from repro_torch.models import transformer as t_transformer
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

TOL = 1e-4
T = torch.from_numpy


def _setup(seed, b, hq, hk, L, d):
    """QKV with concentrated attention: a few keys aligned with the query
    group's sum, their values scaled up (``tests/test_stem_decode.py``'s
    regime, drawn with numpy)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, 1, d)).astype(np.float32)
    k = (rng.standard_normal((b, hk, L, d)) * 0.3).astype(np.float32)
    v = rng.standard_normal((b, hk, L, d)).astype(np.float32)
    hot = np.arange(L // 8, L, L // 5)
    qg = q.reshape(b, hk, hq // hk, d).sum(axis=2)
    k[:, :, hot] = (qg[:, :, None, :] * 1.2
                    + 0.1 * rng.standard_normal((b, hk, len(hot), d)))
    v[:, :, hot] *= 6.0
    return q, k, v


def _dense_decode(q, k, v, lens):
    b, hq, _, d = q.shape
    hk = k.shape[1]
    lens = np.broadcast_to(np.asarray(lens), (b,))
    qg = q.reshape(b, hk, hq // hk, 1, d).astype(np.float64)
    s = np.einsum("bhgqd,bhld->bhgql", qg, k.astype(np.float64)) * d ** -0.5
    valid = np.arange(k.shape[2])[None, :] < lens[:, None]
    s = np.where(valid[:, None, None, None, :], s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    return np.einsum("bhgql,bhld->bhgqd", p, v).reshape(b, hq, 1, d)


def _both(q, k, v, lens, kw, budget_frac):
    """(port output, JAX output, port summary, JAX summary)."""
    js = j_decode.summarize_cache(k, v, JStem(**kw))
    ts = t_decode.summarize_cache(T(k), T(v), TStem(**kw))
    jo = j_decode.sparse_decode_attention(q, k, v, js, jnp.asarray(lens),
                                          JStem(**kw), budget_frac=budget_frac)
    to = t_decode.sparse_decode_attention(T(q), T(k), T(v), ts, torch.as_tensor(lens),
                                          TStem(**kw), budget_frac=budget_frac)
    return to.numpy(), np.asarray(jo), ts, js


KW64 = dict(block_size=64, sink_blocks=1, local_blocks=1, min_budget_blocks=2, stride=8)
GQA = [(4, 4), (4, 2), (4, 1)]


@pytest.mark.parametrize("hq,hk", GQA)
def test_summaries_match(hq, hk):
    _, _, ts, js = _both(*_setup(0, 2, hq, hk, 512, 32), np.int32(512), KW64, 1.0)
    np.testing.assert_allclose(ts.k_groups.numpy(), np.asarray(js.k_groups),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(ts.v_mag.numpy(), np.asarray(js.v_mag),
                               atol=TOL, rtol=0)
    assert ts.k_groups.shape == (2, hk, 8, 8, 32) and ts.v_mag.shape == (2, hk, 8)


@pytest.mark.parametrize("budget_frac", [1.0, 0.5, 0.0])
@pytest.mark.parametrize("hq,hk", GQA)
def test_full_and_sparse_budget_match(hq, hk, budget_frac):
    """Scalar length 512: the full budget equals dense decode, and every
    budget equals the reference."""
    q, k, v = _setup(0, 2, hq, hk, 512, 32)
    got, want, _, _ = _both(q, k, v, np.int32(512), KW64, budget_frac)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    if budget_frac == 1.0:
        np.testing.assert_allclose(got, _dense_decode(q, k, v, 512), atol=TOL, rtol=0)


@pytest.mark.parametrize("budget_frac", [1.0, 0.5])
@pytest.mark.parametrize("hq,hk", GQA)
def test_ragged_lens_match(hq, hk, budget_frac):
    """Per-row lengths, none a block multiple."""
    q, k, v = _setup(3, 3, hq, hk, 320, 32)
    lens = np.array([317, 130, 65], np.int32)
    got, want, _, _ = _both(q, k, v, lens, KW64, budget_frac)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    if budget_frac == 1.0:
        np.testing.assert_allclose(got, _dense_decode(q, k, v, lens), atol=TOL, rtol=0)


@pytest.mark.parametrize("cache_len", [63, 64, 65, 127, 190])
def test_unaligned_scalar_matches(cache_len):
    q, k, v = _setup(4, 2, 4, 2, 256, 32)
    got, want, _, _ = _both(q, k, v, np.int32(cache_len), KW64, 1.0)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, _dense_decode(q, k, v, cache_len), atol=TOL, rtol=0)


def test_scalar_and_vector_lens_agree():
    q, k, v = _setup(5, 3, 4, 2, 256, 16)
    kw = dict(KW64, block_size=32)
    summ = t_decode.summarize_cache(T(k), T(v), TStem(**kw))
    a = t_decode.sparse_decode_attention(T(q), T(k), T(v), summ, 200, TStem(**kw),
                                         budget_frac=0.5)
    b = t_decode.sparse_decode_attention(T(q), T(k), T(v), summ,
                                         torch.full((3,), 200, dtype=torch.int32),
                                         TStem(**kw), budget_frac=0.5)
    assert torch.equal(a, b)
    want, _, _, _ = _both(q, k, v, np.full((3,), 200, np.int32), kw, 0.5)
    np.testing.assert_allclose(a.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("lens", [np.int32(300), np.array([250, 100, 33], np.int32)])
def test_partial_block_masking(lens):
    """Keys past each row's length (poisoned with 99) change nothing."""
    b = 1 if lens.ndim == 0 else 3
    q, k, v = _setup(7, b, 4, 2, 512, 16)
    kw = dict(KW64, block_size=32)
    out1, want, _, _ = _both(q, k, v, lens, kw, 1.0)
    tail = np.arange(512)[None, None, :, None] >= np.broadcast_to(lens, (b,))[:, None, None, None]
    k2, v2 = np.where(tail, 99.0, k).astype(np.float32), np.where(tail, 99.0, v).astype(np.float32)
    out2, _, _, _ = _both(q, k2, v2, lens, kw, 1.0)
    np.testing.assert_allclose(out1, want, atol=TOL, rtol=0)
    np.testing.assert_allclose(out2, out1, atol=TOL, rtol=0)


@pytest.mark.parametrize("policy", ["stem", "uniform-sam", "streaming", "dense",
                                    "xattention"])
def test_zero_live_row_is_exact_zero(policy):
    """A row with cache_lens == 0 returns an exact zero vector; the others
    match the reference."""
    q, k, v = _setup(8, 3, 4, 2, 256, 16)
    lens = np.array([200, 0, 37], np.int32)
    kw = dict(block_size=32, stride=4, sink_blocks=1, local_blocks=1,
              min_budget_blocks=2, ignore_missing=True)
    jp = j_policy.get_policy(policy).with_updates(**kw)
    tp = t_policy.get_policy(policy).with_updates(**kw)
    got = t_decode.sparse_decode_attention(
        T(q), T(k), T(v), t_decode.summarize_cache(T(k), T(v), tp), T(lens), tp,
        budget_frac=0.5)
    want = j_decode.sparse_decode_attention(
        q, k, v, j_decode.summarize_cache(k, v, jp), jnp.asarray(lens), jp,
        budget_frac=0.5)
    assert bool((got[1] == 0).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("policy", ["stem", "uniform-sam", "streaming", "dense",
                                    "xattention"])
@pytest.mark.parametrize("budget_frac", [1.0, 0.5, 0.1])
def test_decode_budget_bound_matches(policy, budget_frac):
    jp, tp = j_policy.get_policy(policy), t_policy.get_policy(policy)
    for nblk in (1, 5, 17, 64):
        assert (t_decode.decode_budget_bound(nblk, tp, budget_frac)
                == j_decode.decode_budget_bound(nblk, jp, budget_frac))


def test_debug_assert_live_rows(monkeypatch):
    """Opt-in through REPRO_DEBUG_DECODE: a non-empty row without a live
    block raises; an empty row (cache_lens == 0) and an unset variable do
    not."""
    live = torch.zeros((2, 1, 2, 3), dtype=torch.bool)
    live[0, 0, :, 0] = True
    sel = DecodeSelection(indices=torch.zeros((2, 1, 2, 3), dtype=torch.int32),
                          live=live, budgets=torch.tensor([1, 0]),
                          n_valid=torch.tensor([2, 1]))
    monkeypatch.delenv("REPRO_DEBUG_DECODE", raising=False)
    t_decode.debug_assert_live_rows(sel)
    monkeypatch.setenv("REPRO_DEBUG_DECODE", "1")
    with pytest.raises(AssertionError, match=r"\[\[1, 0, 0\], \[1, 0, 1\]\]"):
        t_decode.debug_assert_live_rows(sel, context="test")
    t_decode.debug_assert_live_rows(sel._replace(n_valid=torch.tensor([2, 0])))
    # a real selection with a zero-length row passes under the check
    q, k, v = _setup(9, 2, 4, 2, 128, 16)
    kw = dict(KW64, block_size=32)
    out = t_decode.sparse_decode_attention(
        T(q), T(k), T(v), t_decode.summarize_cache(T(k), T(v), TStem(**kw)),
        torch.tensor([70, 0]), TStem(**kw), budget_frac=0.5)
    assert bool((out[1] == 0).all())


@pytest.mark.parametrize("pos", [np.int32(5), np.array([0, 7, 3], np.int32)])
def test_update_cache_matches_in_place(pos):
    rng = np.random.default_rng(1)
    ck, cv = (rng.standard_normal((2, 3, 2, 8, 4)).astype(np.float32) for _ in range(2))
    nk, nv = (rng.standard_normal((3, 2, 1, 4)).astype(np.float32) for _ in range(2))
    jk, jv = j_common.update_cache(jnp.asarray(ck[1]), jnp.asarray(cv[1]),
                                   jnp.asarray(pos), nk, nv)
    stacked_k, stacked_v = T(ck.copy()), T(cv.copy())
    view_k, view_v = stacked_k[1], stacked_v[1]
    tk, tv = t_common.update_cache(view_k, view_v, torch.as_tensor(pos), T(nk), T(nv))
    assert tk.data_ptr() == view_k.data_ptr() and tk.is_contiguous()
    np.testing.assert_array_equal(stacked_k[1].numpy(), np.asarray(jk))
    np.testing.assert_array_equal(stacked_v[1].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(stacked_k[0].numpy(), ck[0])   # other layer untouched


# ---------------------------------------------------------------------------
# Model level: apply_decode, decode_step, make_serve_step, paged_decode_step
# ---------------------------------------------------------------------------

POLICY_KW = dict(block_size=16, stride=4, sink_blocks=1, local_blocks=1,
                 min_budget_blocks=2, ignore_missing=True)


@pytest.fixture(scope="module")
def qwen():
    jcfg = j_configs.reduced(j_configs.get_config("qwen3-0.6b")).replace(dtype="float32")
    tcfg = t_configs.reduced(t_configs.get_config("qwen3-0.6b")).replace(dtype="float32")
    jb, tb = j_registry.build(jcfg), t_registry.build(tcfg)
    jparams = jb.init_params(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, jb, jparams, tcfg, tb, tparams


def _policies(name):
    if name is None:
        return None, None
    return (j_policy.get_policy(name).with_updates(**POLICY_KW),
            t_policy.get_policy(name).with_updates(**POLICY_KW))


@pytest.mark.parametrize("policy", [None, "stem", "uniform-sam"])
@pytest.mark.parametrize("ragged", [False, True])
def test_apply_decode_matches(qwen, policy, ragged):
    jcfg, _, jparams, tcfg, _, tparams = qwen
    jp, tp = _policies(policy)
    rng = np.random.default_rng(2)
    b, L = 3, 64
    ck = rng.standard_normal((b, 2, L, 16)).astype(np.float32)
    cv = rng.standard_normal((b, 2, L, 16)).astype(np.float32)
    x = rng.standard_normal((b, 1, 64)).astype(np.float32)
    pos = np.array([40, 17, 63], np.int32) if ragged else np.int32(33)
    ja = jax.tree.map(lambda t: t[0], jparams["segment0"]["sub0"]["attn"])
    ta = {k: t[0] for k, t in tparams["segment0"]["sub0"]["attn"].items()}
    jout, jc = j_attention.apply_decode(
        ja, x, jcfg, j_attention.KVCache(k=jnp.asarray(ck), v=jnp.asarray(cv),
                                         pos=jnp.asarray(pos)),
        stem_cfg=jp, budget_frac=0.5)
    tcache = t_attention.KVCache(k=T(ck.copy()), v=T(cv.copy()), pos=torch.as_tensor(pos))
    tout, tc = t_attention.apply_decode(ta, T(x), tcfg, tcache, stem_cfg=tp,
                                        budget_frac=0.5)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=TOL, rtol=0)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=TOL, rtol=0)
    np.testing.assert_allclose(tc.v.numpy(), np.asarray(jc.v), atol=TOL, rtol=0)
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
    assert tc.k.data_ptr() == tcache.k.data_ptr()      # written in place


def test_apply_decode_validation(qwen):
    _, _, _, tcfg, _, tparams = qwen
    ta = {k: t[0] for k, t in tparams["segment0"]["sub0"]["attn"].items()}
    cache = t_attention.init_cache(tcfg, 1, 40, dtype=torch.float32, device="cpu")
    x = torch.zeros((1, 1, 64))
    _, tp = _policies("stem")
    with pytest.raises(ValueError, match="multiple of the policy block size"):
        t_attention.apply_decode(ta, x, tcfg, cache, stem_cfg=tp)
    with pytest.raises(NotImplementedError):
        t_attention.apply_decode(ta, x, tcfg, cache, window=16)
    with pytest.raises(NotImplementedError):
        t_attention.apply_decode(ta, x, tcfg, cache, window=16, stem_cfg=tp)


def _prompts(seed, lens, width):
    rng = np.random.RandomState(seed)
    toks = np.zeros((len(lens), width), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.randint(0, 512, size=(n,))
    return toks


@pytest.mark.parametrize("policy", [None, "stem", "uniform-sam", "streaming"])
def test_serve_step_matches_over_8_steps(qwen, policy):
    """Ragged prefill, then 8 greedy steps of make_serve_step with the
    first step's cache_lens: logits within 1e-4, ids exact, the stacked
    cache positions and contents equal."""
    jcfg, jb, jparams, tcfg, tb, tparams = qwen
    jp, tp = _policies(policy)
    lens = np.array([45, 29, 33], np.int32)
    toks = _prompts(4, lens, 48)
    max_len = 64
    jl, jcaches = jb.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len=max_len,
                             stem_cfg=jp, last_pos=jnp.asarray(lens - 1))
    tl, tcaches = tb.prefill(tparams, {"tokens": T(toks)}, max_len=max_len,
                             stem_cfg=tp, last_pos=T(lens - 1))
    jserve = j_steps.make_serve_step(jb, stem_cfg=jp, budget_frac=0.5)
    tserve = t_steps.make_serve_step(tb, stem_cfg=tp, budget_frac=0.5)
    jt, tt = jnp.argmax(jl, -1)[:, None], torch.argmax(tl, -1)[:, None]
    for i in range(8):
        jl, jcaches = jserve(jparams, jt, jcaches, jnp.asarray(lens) if i == 0 else None)
        tl, tcaches = tserve(tparams, tt, tcaches, T(lens) if i == 0 else None)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
        jt, tt = jnp.argmax(jl, -1)[:, None], torch.argmax(tl, -1)[:, None]
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    jc, tc = jcaches[0]["sub0"], tcaches[0]["sub0"]
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
    assert tuple(tc.pos.shape) == (tcfg.num_layers, 3)
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), atol=TOL, rtol=0)
    assert tc.k.is_contiguous() and tc.v.is_contiguous()


@pytest.mark.parametrize("policy", [None, "stem"])
def test_decode_step_scalar_pos_matches(qwen, policy):
    """decode_step straight off a uniform prefill (scalar positions)."""
    jcfg, jb, jparams, tcfg, tb, tparams = qwen
    jp, tp = _policies(policy)
    toks = _prompts(6, [32, 32], 32)
    jl, jcaches = jb.prefill(jparams, {"tokens": jnp.asarray(toks)}, max_len=48,
                             stem_cfg=jp)
    tl, tcaches = tb.prefill(tparams, {"tokens": T(toks)}, max_len=48, stem_cfg=tp)
    for _ in range(3):
        jt, tt = jnp.argmax(jl, -1)[:, None], torch.argmax(tl, -1)[:, None]
        kw = {} if policy is None else {"stem_cfg": jp, "budget_frac": 0.5}
        jl, jcaches = j_transformer.decode_step(jparams, jt, jcaches, jcfg, **kw)
        kw = {} if policy is None else {"stem_cfg": tp, "budget_frac": 0.5}
        tl, tcaches = t_transformer.decode_step(tparams, tt, tcaches, tcfg, **kw)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
    np.testing.assert_array_equal(tcaches[0]["sub0"].pos.numpy(),
                                  np.asarray(jcaches[0]["sub0"].pos))


def test_set_cache_positions(qwen):
    _, _, _, tcfg, tb, _ = qwen
    caches = tb.init_caches(2, 32, device="cpu")
    out = t_steps.set_cache_positions(caches, torch.tensor([5, 9]))
    assert out[0]["sub0"].pos.tolist() == [[5, 9]] * tcfg.num_layers
    assert out[0]["sub0"].k is caches[0]["sub0"].k


@pytest.mark.parametrize("budget_frac", [1.0, 0.5])
def test_paged_decode_step_matches(qwen, budget_frac):
    """The decode-only view of the paged mixed step, two slots (one idle)."""
    jcfg, _, jparams, tcfg, _, tparams = qwen
    jstem = JStem(block_size=16, sink_blocks=1, local_blocks=1, min_budget_blocks=2,
                  stride=4)
    tstem = TStem(block_size=16, sink_blocks=1, local_blocks=1, min_budget_blocks=2,
                  stride=4)
    jpools = j_transformer.init_page_pools(jcfg, 8, jstem)
    tpools = t_transformer.init_page_pools(tcfg, 8, tstem, device="cpu")
    prompt = _prompts(8, [37], 48)
    row = np.array([1, 2, 3, 4], np.int32)
    _, jpools = j_transformer.prefill_kv_pages(
        jparams, jnp.asarray(prompt), jnp.asarray(37), jpools, jnp.asarray(row),
        jcfg, jstem)
    _, tpools = t_transformer.prefill_kv_pages(
        tparams, T(prompt), 37, tpools, T(row), tcfg, tstem)
    table = np.stack([row, np.zeros(4, np.int32)])
    lens = np.array([37, 0], np.int32)
    tokens = np.array([[11], [0]], np.int32)
    for _ in range(3):
        jl, jpools = j_transformer.paged_decode_step(
            jparams, jnp.asarray(tokens), jpools, jnp.asarray(table), jnp.asarray(lens),
            jcfg, stem_cfg=jstem, budget_frac=budget_frac, executor="xla")
        tl, tpools = t_transformer.paged_decode_step(
            tparams, T(tokens), tpools, T(table), T(lens), tcfg, stem_cfg=tstem,
            budget_frac=budget_frac)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=0)
        tokens = np.array([[int(np.argmax(np.asarray(jl)[0]))], [0]], np.int32)
        lens = lens + np.array([1, 0], np.int32)
