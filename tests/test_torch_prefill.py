"""Differential tests of the port's one-shot (monolithic) Stem prefill
against the JAX reference on the engine-test config (2 layers, d_model 32,
4/2 heads, head_dim 8, fp32, qk-norm), weights carried across with
``from_jax_params``:

* ``transformer.prefill`` logits and caches (sparse, dense and per-layer
  policy overrides, right-padded prompts with ``last_pos``) and
  ``apply_full`` with its StemStats, within 1e-4;
* ``prefill_kv_pages`` / ``write_prefill_pages`` pool leaves (k, v, kg, vm)
  after poisoning the pools, within 1e-4;
* the engine with ``monolithic_prefill=True``: greedy streams and
  prefill / decode-step counts equal the JAX monolithic engine's on the
  ``tests/test_engine.py`` trace at budget_frac 1.0 and 0.5 under "stem"
  and "xattention" (tau 0.5), for the "fused" and "gather" executors;
* the chunked port engine refuses "xattention" with the reference's error.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import ArchConfig as JArch
from repro.core import policy as j_policy
from repro.core.config import StemConfig as JStem
from repro.launch import steps as j_steps
from repro.models import attention as j_attention
from repro.models import registry as j_registry
from repro.models import transformer as j_transformer
from repro.runtime import engine as j_engine
from repro.runtime import paged as j_paged

from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.core import policy as t_policy
from repro_torch.core.config import StemConfig as TStem
from repro_torch.launch import steps as t_steps
from repro_torch.models import attention as t_attention
from repro_torch.models import registry as t_registry
from repro_torch.models import transformer as t_transformer
from repro_torch.runtime import engine as t_engine
from repro_torch.runtime import paged as t_paged
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

TOL = 1e-4
TINY = dict(name="engine-tiny", family="dense", num_layers=2, d_model=32,
            num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64,
            qk_norm=True, dtype="float32")
STEM = dict(block_size=8, sink_blocks=1, local_blocks=1, min_budget_blocks=2,
            stride=4)
XATT = dict(block_size=8, stride=4, sink_blocks=1, local_blocks=1, tau=0.5)
TRACE = [(5, 4, 0), (13, 6, 0), (8, 3, 1), (20, 5, 3), (9, 4, 5)]


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = JArch(**TINY), TArch(**TINY)
    jbundle = j_registry.build(jcfg)
    jparams = jbundle.init_params(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, jbundle, jparams, tcfg, t_registry.build(tcfg), tparams


def _policy(name):
    if name == "stem":
        return JStem(**STEM), TStem(**STEM)
    if name == "xattention":
        return (j_policy.get_policy("xattention").with_updates(**XATT),
                t_policy.get_policy("xattention").with_updates(**XATT))
    return None, None


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=0)


def _tokens(n, seed=3):
    return np.random.RandomState(seed).randint(0, 64, size=(1, n)).astype(np.int32)


# ---------------------------------------------------------------------------
# transformer.prefill and apply_full
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["stem", "xattention", None])
@pytest.mark.parametrize("n,true_len", [(40, 40), (40, 35), (8, 7)])
def test_prefill_matches_jax(models, name, n, true_len):
    """40 tokens = 5 blocks (the sparse path); 8 tokens = one block (the
    dense arm); true_len < n is a right-padded prompt read at last_pos."""
    jcfg, _, jparams, tcfg, _, tparams = models
    jpol, tpol = _policy(name)
    toks = _tokens(n)
    jl, jc = j_transformer.prefill(jparams, {"tokens": jnp.asarray(toks)}, jcfg,
                                   max_len=n + 8, stem_cfg=jpol,
                                   last_pos=true_len - 1)
    tl, tc = t_transformer.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                                   tcfg, max_len=n + 8, stem_cfg=tpol,
                                   last_pos=true_len - 1)
    _close(tl, jl)
    assert len(tc) == len(jc)
    for js, ts in zip(jc, tc):
        jcache, tcache = js["sub0"], ts["sub0"]
        _close(tcache.k, jcache.k)
        _close(tcache.v, jcache.v)
        np.testing.assert_array_equal(tcache.pos.numpy(), np.asarray(jcache.pos))


def test_prefill_per_layer_policies_match_jax(models):
    jcfg, jbundle, jparams, tcfg, tbundle, tparams = models
    toks = _tokens(48, seed=4)
    jpol, tpol = _policy("stem")
    for over in ({1: "streaming"}, {0: None}):
        jo = {i: (j_policy.get_policy(p).with_updates(**STEM, ignore_missing=True)
                  if p else None) for i, p in over.items()}
        to = {i: (t_policy.get_policy(p).with_updates(**STEM, ignore_missing=True)
                  if p else None) for i, p in over.items()}
        jl, _ = j_steps.make_prefill_step(jbundle, max_len=48, stem_cfg=jpol,
                                          policies=jo)(jparams, {"tokens": jnp.asarray(toks)})
        tl, _ = t_steps.make_prefill_step(tbundle, max_len=48, stem_cfg=tpol,
                                          policies=to)(tparams, {"tokens": torch.from_numpy(toks)})
        _close(tl, jl)
    runs = t_transformer._policy_runs([tpol, tpol, None, tpol])
    assert runs == j_transformer._policy_runs([tpol, tpol, None, tpol])
    with pytest.raises(ValueError, match="out of range"):
        t_transformer._layer_policies(tcfg, tpol, {5: None})


def test_init_caches_match_jax(models):
    jcfg, _, _, tcfg, tbundle, _ = models
    jc = j_transformer.init_caches(jcfg, 2, 24)
    tc = tbundle.init_caches(2, 24, device="cpu")
    for js, ts in zip(jc, tc):
        for f in ("k", "v", "pos"):
            assert tuple(getattr(ts["sub0"], f).shape) == getattr(js["sub0"], f).shape
        assert ts["sub0"].k.dtype == torch.float32


@pytest.mark.parametrize("name", ["stem", None])
def test_apply_full_matches_jax(models, name):
    jcfg, _, jparams, tcfg, _, tparams = models
    jpol, tpol = _policy(name)
    x = np.random.RandomState(5).randn(1, 40, 32).astype(np.float32)
    jp = jax.tree.map(lambda t: t[0], jparams["segment0"]["sub0"]["attn"])
    tp = {k: v[0] for k, v in tparams["segment0"]["sub0"]["attn"].items()}
    jo, js = j_attention.apply_full(jp, jnp.asarray(x), jcfg,
                                    positions=jnp.arange(40), stem_cfg=jpol,
                                    return_stats=True)
    to, ts = t_attention.apply_full(tp, torch.from_numpy(x), tcfg,
                                    positions=torch.arange(40), stem_cfg=tpol,
                                    return_stats=True)
    _close(to, jo)
    assert (ts is None) == (js is None)
    if js is not None:
        np.testing.assert_allclose(float(ts.density), float(js.density), rtol=1e-6)
        assert float(ts.density) < 1.0
    # windowed (local) attention: the reference's banded path, no policy
    _close(t_attention.apply_full(tp, torch.from_numpy(x), tcfg,
                                  positions=torch.arange(40), window=8),
           j_attention.apply_full(jp, jnp.asarray(x), jcfg,
                                  positions=jnp.arange(40), window=8))


# ---------------------------------------------------------------------------
# Page writes: prefill_kv_pages and write_prefill_pages
# ---------------------------------------------------------------------------

def _poisoned_pools(jcfg, tcfg, num_pages, seed):
    """Dirty pools (every leaf random), identical on both sides."""
    jp = j_transformer.init_page_pools(jcfg, num_pages, JStem(**STEM))
    rng = np.random.RandomState(seed)
    arrays = jax.tree.map(lambda t: rng.randn(*t.shape).astype(np.float32), jp)
    tp = t_transformer.init_page_pools(tcfg, num_pages, TStem(**STEM), device="cpu")
    for jseg, tseg in zip(arrays, tp):
        for f, t in zip(jseg["sub0"], tseg["sub0"]):
            t.copy_(torch.from_numpy(f))
    return jax.tree.map(jnp.asarray, arrays), tp


@pytest.mark.parametrize("name", ["stem", "xattention"])
def test_prefill_kv_pages_matches_jax(models, name):
    jcfg, _, jparams, tcfg, _, tparams = models
    jpol, tpol = _policy(name)
    jpools, tpools = _poisoned_pools(jcfg, tcfg, 12, seed=6)
    toks = np.zeros((1, 24), np.int32)
    toks[0, :21] = _tokens(21, seed=7)[0]
    row = np.array([3, 7, 1, 9, 0], np.int32)           # 3 prompt pages + spill
    jl, jnew = j_transformer.prefill_kv_pages(
        jparams, jnp.asarray(toks), jnp.asarray(21, jnp.int32), jpools,
        jnp.asarray(row), jcfg, jpol)
    tl, tnew = t_transformer.prefill_kv_pages(
        tparams, torch.from_numpy(toks), 21, tpools, torch.from_numpy(row),
        tcfg, tpol)
    _close(tl, jl)
    for jseg, tseg in zip(jnew, tnew):
        for f in ("k", "v", "kg", "vm"):
            _close(getattr(tseg["sub0"], f), getattr(jseg["sub0"], f))


def test_write_prefill_pages_matches_jax():
    rng = np.random.RandomState(8)
    k, v = rng.randn(2, 2, 24, 8).astype(np.float32)
    pool = [rng.randn(*s).astype(np.float32)
            for s in ((2, 6, 8, 8), (2, 6, 8, 8), (2, 6, 4, 8), (2, 6))]
    ids = np.array([4, 2, 5], np.int32)
    jp = j_paged.write_prefill_pages(j_paged.PagePool(*map(jnp.asarray, pool)),
                                     jnp.asarray(ids), jnp.asarray(k),
                                     jnp.asarray(v), 19, JStem(**STEM))
    tp = t_paged.write_prefill_pages(t_paged.PagePool(*map(torch.from_numpy, pool)),
                                     torch.from_numpy(ids), torch.from_numpy(k),
                                     torch.from_numpy(v), 19, TStem(**STEM))
    for f in ("k", "v", "kg", "vm"):
        _close(getattr(tp, f), getattr(jp, f))


# ---------------------------------------------------------------------------
# The monolithic engine
# ---------------------------------------------------------------------------

def _requests(mod):
    rng = np.random.RandomState(7)
    return [mod.Request(uid=uid, prompt=rng.randint(0, 64, size=(plen,)).astype(
                np.int32), max_new_tokens=mnt, arrival_step=arr)
            for uid, (plen, mnt, arr) in enumerate(TRACE)]


def _ecfg(mod, budget_frac, **kw):
    per_slot = -(-max(p + n for p, n, _ in TRACE) // STEM["block_size"])
    return mod.EngineConfig(max_slots=2, num_pages=1 + 2 * per_slot,
                            max_pages_per_slot=per_slot, budget_frac=budget_frac,
                            monolithic_prefill=True, **kw)


@pytest.fixture(scope="module")
def jax_runs(models):
    _, jbundle, jparams, _, _, _ = models
    runs = {}
    for name in ("stem", "xattention"):
        for frac in (1.0, 0.5):
            eng = j_engine.StemEngine(jbundle, jparams, _policy(name)[0],
                                      _ecfg(j_engine, frac))
            runs[name, frac] = (eng.run(_requests(j_engine)), dict(eng.stats))
    return runs


@pytest.mark.parametrize("executor", ["fused", "gather"])
@pytest.mark.parametrize("budget_frac", [1.0, 0.5])
@pytest.mark.parametrize("name", ["stem", "xattention"])
def test_monolithic_engine_matches_jax(models, jax_runs, name, budget_frac,
                                       executor):
    _, _, _, _, tbundle, tparams = models
    jfin, jstats = jax_runs[name, budget_frac]
    eng = t_engine.StemEngine(tbundle, tparams, _policy(name)[1],
                              _ecfg(t_engine, budget_frac, executor=executor))
    tfin = eng.run(_requests(t_engine))
    assert [f.uid for f in tfin] == [f.uid for f in jfin]
    for t, j in zip(tfin, jfin):
        assert t.tokens == j.tokens, f"request {t.uid} stream differs"
        assert (t.admitted_step, t.finished_step, t.slot) == \
            (j.admitted_step, j.finished_step, j.slot)
    for key in ("prefills", "decode_steps", "step_calls", "tokens_generated",
                "slots_reused", "max_concurrency", "chunks"):
        assert eng.stats[key] == jstats[key], key
    assert eng.allocator.available == eng.ecfg.num_pages - 1
    eng.allocator.check_conservation([])


def test_chunked_engine_refuses_xattention(models):
    _, _, _, _, tbundle, tparams = models
    per_slot = 4
    ecfg = t_engine.EngineConfig(max_slots=1, num_pages=1 + per_slot,
                                 max_pages_per_slot=per_slot)
    with pytest.raises(NotImplementedError,
                       match="budget-driven selector; CumulativeMassSelector is "
                             "threshold-based — run the engine with "
                             "monolithic_prefill=True"):
        t_engine.StemEngine(tbundle, tparams, _policy("xattention")[1], ecfg)


def test_monolithic_step_and_config(models):
    _, jbundle, _, _, tbundle, tparams = models
    a = j_engine.EngineConfig.for_trace(max_slots=2, max_prompt=300,
                                        max_new_tokens=5, page_size=8,
                                        monolithic_prefill=True)
    b = t_engine.EngineConfig.for_trace(max_slots=2, max_prompt=300,
                                        max_new_tokens=5, page_size=8,
                                        monolithic_prefill=True)
    assert (a.num_pages, a.max_pages_per_slot, a.monolithic_prefill) == \
        (b.num_pages, b.max_pages_per_slot, b.monolithic_prefill)
    stem = t_policy.as_policy(TStem(**STEM))
    with pytest.raises(KeyError, match="unknown executor"):
        t_steps.make_monolithic_prefill(
            tbundle, stem_cfg=stem.with_updates(executor="pallas"))
    # the engine writes EngineConfig.executor into its policy once, and
    # both step builders read it from there
    with pytest.raises(KeyError, match="executor 'pallas'"):
        t_engine.StemEngine(tbundle, tparams, stem,
                            dataclasses.replace(b, executor="pallas"))
    engine = t_engine.StemEngine(tbundle, tparams, stem,
                                 dataclasses.replace(b, executor="gather"))
    assert engine.policy.executor == "gather"
