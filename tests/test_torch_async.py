"""The async engine loop of the port (``async_depth=1``: on-device
sampling, the device-resident fed-back token buffer, one-step lookahead
dispatch through the staging ring) and its samplers, on the
``tests/test_async_engine.py`` scenarios.

The async loop is held bitwise to the port's synchronous loop and to the
JAX engine at ``async_depth=0`` (the reference's own async EOS test fails
on the reference, so the JAX async engine is not the oracle): across
policies, with a mid-stream EOS (the lookahead step discarded), under
chaos, through a preempt / restore cycle and with the prefix cache on.
The reference's trace-count and Pallas-fallback tests have no
counterpart (the port runs eagerly and has no fallback); the host-sync
bound ``host_syncs <= 2 * finished`` holds here as there."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import ArchConfig as JArch
from repro.core import policy as j_policy
from repro.core.config import StemConfig as JStem
from repro.models import registry as j_registry
from repro.runtime import engine as j_engine
from repro.runtime import sampling as j_sampling

from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.core import policy as t_policy
from repro_torch.core.config import StemConfig as TStem
from repro_torch.models import registry as t_registry
from repro_torch.models import transformer as t_transformer
from repro_torch.runtime import chaos as t_chaos
from repro_torch.runtime import engine as t_engine
from repro_torch.runtime import sampling as t_sampling
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

TINY = dict(name="async-tiny", family="dense", num_layers=2, d_model=32,
            num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64,
            qk_norm=True, dtype="float32")
STEM = dict(block_size=8, sink_blocks=1, local_blocks=1, min_budget_blocks=2,
            stride=4)
BS = STEM["block_size"]
TRACE = [(5, 4, 0), (13, 6, 0), (8, 3, 1), (20, 5, 3), (9, 4, 5)]
SAME = ("chunks", "prefills", "tokens_generated", "preemptions", "restores",
        "restore_bytes", "aborts", "prefix_hits", "prefix_pages_shared",
        "prefix_cows")


@pytest.fixture(scope="module")
def built():
    jcfg, tcfg = JArch(**TINY), TArch(**TINY)
    jbundle = j_registry.build(jcfg)
    jparams = jbundle.init_params(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jbundle, jparams, t_registry.build(tcfg), tparams


def _trace(seed=7, trace=TRACE):
    rng = np.random.RandomState(seed)
    return [dict(uid=u, mnt=m, arrival=a,
                 prompt=rng.randint(0, TINY["vocab_size"], size=(p,)))
            for u, (p, m, a) in enumerate(trace)]


def _req(mod, r):
    return mod.Request(uid=r["uid"], prompt=np.array(r["prompt"], np.int32),
                       max_new_tokens=r["mnt"], arrival_step=r.get("arrival", 0),
                       priority=r.get("priority", 0))


def _ecfg(max_slots, reqs, **kw):
    per_slot = -(-max(len(r["prompt"]) + r["mnt"] for r in reqs) // BS)
    return dict(max_slots=max_slots, num_pages=1 + max_slots * per_slot,
                max_pages_per_slot=per_slot, **kw)


def _port(built, pol, kw, reqs, chaos=None):
    eng = t_engine.StemEngine(built[2], built[3], pol, t_engine.EngineConfig(**kw),
                              chaos=chaos)
    fin = eng.run([_req(t_engine, r) for r in reqs])
    return eng, fin


def _jax(built, pol, kw, reqs):
    eng = j_engine.StemEngine(built[0], built[1], pol, j_engine.EngineConfig(**kw))
    fin = eng.run([_req(j_engine, r) for r in reqs])
    return eng, fin


def _streams(fin):
    return {f.uid: f.tokens for f in fin}


def _assert_async_contract(eng, fin):
    """Pipeline bookkeeping of a finished async run."""
    assert not eng._inflight and eng.metrics["inflight_steps"] == 0
    assert eng.stats["host_syncs"] <= 2 * len(fin), eng.stats
    assert (eng.stats["step_calls"] <= eng.stats["id_fetches"]
            <= 2 * eng.stats["step_calls"]), eng.stats
    assert all(st is None for st in eng.slots)
    eng.allocator.check_conservation([])
    assert eng.allocator.available == eng.ecfg.num_pages - 1


def _policies(name):
    kw = dict(block_size=8, stride=4, sink_blocks=1, local_blocks=1,
              min_budget_blocks=2, ignore_missing=True)
    return (j_policy.get_policy(name).with_updates(**kw),
            t_policy.get_policy(name).with_updates(**kw))


@pytest.mark.parametrize("policy_name", ["stem", "streaming"])
def test_async_matches_sync_bit_identical(built, policy_name):
    """The staggered, slot-recycling trace: async == the port's sync loop
    == the JAX engine's sync loop, no speculative token leaks (max-new
    finishes never speculate), and the pipeline's counters hold."""
    jpol, tpol = _policies(policy_name)
    reqs = _trace()
    kw = _ecfg(2, reqs)
    jeng, jfin = _jax(built, jpol, kw, reqs)
    seng, sfin = _port(built, tpol, kw, reqs)
    aeng, afin = _port(built, tpol, dict(kw, async_depth=1), reqs)
    assert _streams(afin) == _streams(sfin) == _streams(jfin), policy_name
    for f, r in zip(afin, reqs):
        assert len(f.tokens) == r["mnt"]
    assert aeng.stats["lookahead_discards"] == 0
    for key in SAME:
        assert aeng.stats[key] == seng.stats[key] == jeng.stats[key], key
    assert aeng.stats["host_syncs"] < seng.stats["host_syncs"]
    _assert_async_contract(aeng, afin)


def test_eos_lookahead_discard_free(built):
    """EOS reconciles one step late: with a mid-stream token of the sync
    run as ``eos_id`` both loops (and the JAX sync loop) emit the same
    streams, and the speculative step past EOS is discarded."""
    _, tpol = _policies("stem")
    reqs = _trace()
    kw = _ecfg(2, reqs)
    _, probe = _port(built, TStem(**STEM), kw, reqs)
    eos = probe[1].tokens[2]
    _, jfin = _jax(built, JStem(**STEM), dict(kw, eos_id=eos), reqs)
    _, sfin = _port(built, TStem(**STEM), dict(kw, eos_id=eos), reqs)
    aeng, afin = _port(built, TStem(**STEM), dict(kw, eos_id=eos, async_depth=1),
                       reqs)
    assert _streams(afin) == _streams(sfin) == _streams(jfin)
    early = [f for f, r in zip(afin, reqs)
             if f.tokens[-1] == eos and len(f.tokens) < r["mnt"]]
    assert early, "the scenario no longer ends a request on EOS"
    assert 1 <= aeng.stats["lookahead_discards"] <= len(early)
    _assert_async_contract(aeng, afin)


def _chaos_trace():
    rng = np.random.RandomState(5)
    reqs = [dict(uid=i, mnt=5, prompt=rng.randint(0, 64, size=(10 + 3 * i,)))
            for i in range(4)]
    reqs.append(dict(uid=9, mnt=3, arrival=5, priority=2,
                     prompt=rng.randint(0, 64, size=(9,))))
    return reqs


def test_async_under_chaos_bit_identical(built):
    """An alloc denial and one step failure with the lookahead pipeline
    live: the streams equal the clean sync run's and the JAX engine's."""
    reqs = _chaos_trace()
    per_slot = -(-(20 + 8) // BS)
    kw = dict(max_slots=2, num_pages=1 + 2 * per_slot, max_pages_per_slot=per_slot)
    _, jfin = _jax(built, JStem(**STEM), kw, reqs)
    _, sfin = _port(built, TStem(**STEM), kw, reqs)
    chaos = t_chaos.ChaosInjector(t_chaos.ChaosConfig(deny_alloc_steps=(0,),
                                                      fail_steps=(3,)))
    aeng, afin = _port(built, TStem(**STEM), dict(kw, async_depth=1), reqs, chaos)
    assert chaos.counts["alloc_denied"] == 1 and chaos.counts["step_failed"] == 1
    assert aeng.stats["aborts"] == 0 and all(f.error is None for f in afin)
    assert _streams(afin) == _streams(sfin) == _streams(jfin)
    _assert_async_contract(aeng, afin)


def test_async_persistent_step_failure_aborts_like_sync(built):
    """A step failure past the retry bound: the pipeline drains, the
    lowest-priority request is aborted, and tokens and errors equal the
    sync loop's."""
    reqs = _chaos_trace()
    per_slot = -(-(20 + 8) // BS)
    kw = dict(max_slots=2, num_pages=1 + 2 * per_slot, max_pages_per_slot=per_slot)
    plan = t_chaos.ChaosConfig(fail_steps=(4,), step_repeats=3)
    seng, sfin = _port(built, TStem(**STEM), kw, reqs, t_chaos.ChaosInjector(plan))
    aeng, afin = _port(built, TStem(**STEM), dict(kw, async_depth=1), reqs,
                       t_chaos.ChaosInjector(plan))
    assert seng.stats["aborts"] == aeng.stats["aborts"] == 1
    for a, s in zip(afin, sfin):
        assert (a.uid, a.error is None) == (s.uid, s.error is None)
        if a.error is None:
            assert a.tokens == s.tokens
    aeng.allocator.check_conservation([])


def test_async_preempt_restore_cycle_bit_identical(built):
    """Priority preemption mid-pipeline: the in-flight step drains before
    the victim's pages move; both streams equal the sync run's and the
    JAX engine's, and the restore re-seeds the fed-back token."""
    rng = np.random.RandomState(23)
    reqs = [dict(uid=0, mnt=8, prompt=rng.randint(0, 64, size=(20,))),
            dict(uid=1, mnt=4, arrival=4, priority=1,
                 prompt=rng.randint(0, 64, size=(13,)))]
    per_slot = -(-(20 + 8) // BS)
    kw = dict(max_slots=1, num_pages=1 + per_slot, max_pages_per_slot=per_slot)
    jeng, jfin = _jax(built, JStem(**STEM), kw, reqs)
    seng, sfin = _port(built, TStem(**STEM), kw, reqs)
    aeng, afin = _port(built, TStem(**STEM), dict(kw, async_depth=1), reqs)
    assert _streams(afin) == _streams(sfin) == _streams(jfin)
    assert aeng.stats["preemptions"] == aeng.stats["restores"] == 1
    assert afin[1].finished_step < afin[0].finished_step
    for key in SAME:
        assert aeng.stats[key] == seng.stats[key] == jeng.stats[key], key
    _assert_async_contract(aeng, afin)


@pytest.mark.parametrize("evict", ["lru", "hit-rate"])
def test_async_with_prefix_cache(built, evict):
    """The prefix cache and the async loop together: registration at
    dispatch time serves later tenants; streams equal the cache-off sync
    run's and the JAX engine's, prefix counters the JAX engine's."""
    rng = np.random.RandomState(42)
    system = rng.randint(0, 64, size=(2 * BS,))
    reqs = [dict(uid=u, mnt=m, arrival=a,
                 prompt=np.concatenate([system, rng.randint(0, 64, size=(s,))]))
            for u, (s, m, a) in enumerate([(5, 4, 0), (7, 5, 0), (3, 4, 6),
                                           (9, 3, 8), (0, 3, 9)])]
    kw = _ecfg(2, reqs, budget_frac=1.0, prefix_evict=evict)
    jeng, jfin = _jax(built, JStem(**STEM), dict(kw, prefix_cache=True), reqs)
    _, sfin = _port(built, TStem(**STEM), kw, reqs)
    aeng, afin = _port(built, TStem(**STEM),
                       dict(kw, prefix_cache=True, async_depth=1), reqs)
    assert _streams(afin) == _streams(sfin) == _streams(jfin)
    assert aeng.stats["prefix_hits"] >= 2 and aeng.stats["prefix_cows"] == 1
    for key in ("prefix_hits", "prefix_pages_shared", "prefix_cows"):
        assert aeng.stats[key] == jeng.stats[key], key
    _assert_async_contract(aeng, afin)


# ---------------------------------------------------------------------------
# The sampled step
# ---------------------------------------------------------------------------

def test_sampled_step_feeds_back_on_device(built):
    """``paged_sampled_step`` equals ``paged_mixed_step`` + the sampler on
    the same inputs, and advances the fed-back buffer: granted decode
    lanes take their id, a completing chunk lane writes its first token
    into its slot's entry, an idle lane writes only the trash entry."""
    tcfg, stem = TArch(**TINY), TStem(**STEM)
    tparams = built[3]
    S, P, C = 3, 4, 2 * BS
    rng = np.random.RandomState(1)
    table = torch.tensor([[1, 2, 0, 0], [0, 0, 0, 0], [3, 4, 0, 0]],
                         dtype=torch.int32)
    lens = torch.tensor([11, 0, 9], dtype=torch.int32)
    chunk = {"tokens": torch.from_numpy(rng.randint(0, 64, size=(2, C)).astype(np.int32)),
             "page_table": torch.tensor([[5, 6, 0, 0], [0, 0, 0, 0]], dtype=torch.int32),
             "start": torch.zeros(2, dtype=torch.int32),
             "true_len": torch.tensor([13, 0], dtype=torch.int32),
             "budgets": torch.tensor([[1, 2], [0, 0]], dtype=torch.int32),
             "last": torch.tensor([12, 0], dtype=torch.int32),
             "slot": torch.tensor([1, 0], dtype=torch.int32),
             "emit": torch.tensor([True, False])}

    def pools():
        p = t_transformer.init_page_pools(tcfg, 8, stem, device="cpu")
        g = torch.Generator().manual_seed(3)
        for seg in p:
            for pool in seg.values():
                for leaf in pool:
                    leaf.copy_(torch.randn(leaf.shape, generator=g))
        return p
    buf = torch.tensor([7, 8, 9, 0], dtype=torch.int32)
    mask = torch.tensor([True, False, True])
    greedy = t_sampling.get_sampler("greedy")
    dec_logits, chunk_logits, _ = t_transformer.paged_mixed_step(
        tparams, buf[:S, None].clone(), pools(), table, lens, tcfg,
        stem_cfg=stem, chunk=chunk)
    dec_ids, chunk_ids, new_buf, _ = t_transformer.paged_sampled_step(
        tparams, buf, pools(), table, lens, mask, tcfg, stem_cfg=stem,
        sampler=greedy, chunk=chunk)
    assert torch.equal(dec_ids, greedy(dec_logits))
    assert torch.equal(chunk_ids, greedy(chunk_logits))
    assert new_buf is buf
    want = [int(dec_ids[0]), int(chunk_ids[0]), int(dec_ids[2]), int(chunk_ids[1])]
    assert buf.tolist() == want


# ---------------------------------------------------------------------------
# Config validation and the samplers
# ---------------------------------------------------------------------------

def test_config_validation():
    with pytest.raises(ValueError, match="async_depth"):
        t_engine.EngineConfig(async_depth=2)
    with pytest.raises(ValueError, match="monolithic"):
        t_engine.EngineConfig(async_depth=1, monolithic_prefill=True)
    with pytest.raises(ValueError, match="unknown sampler"):
        t_engine.EngineConfig(sampler="metropolis")
    assert dataclasses.asdict(t_engine.EngineConfig()).items() <= \
        dataclasses.asdict(j_engine.EngineConfig()).items()


def test_greedy_sampler_matches_host_argmax_with_ties():
    s = t_sampling.get_sampler("greedy")
    assert s.deterministic
    rng = np.random.RandomState(0)
    logits = rng.randn(4, 16).astype(np.float32)
    logits[1, 3] = logits[1, 11] = logits[1].max() + 1.0
    logits[2, :] = 0.0
    got = s(torch.from_numpy(logits)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.argmax(logits, axis=-1))
    np.testing.assert_array_equal(
        got, np.asarray(j_sampling.get_sampler("greedy")(jnp.asarray(logits))))


def test_sampler_registry():
    with pytest.raises(ValueError, match="unknown sampler"):
        t_sampling.get_sampler("temperature")      # not registered (as in the
    with pytest.raises(ValueError, match="already registered"):   # reference)
        t_sampling.register_sampler("greedy", t_sampling.GreedySampler)
    t_sampling.register_sampler("test-custom", t_sampling.GreedySampler)
    try:
        assert isinstance(t_sampling.get_sampler("test-custom"),
                          t_sampling.GreedySampler)
    finally:
        del t_sampling._SAMPLERS["test-custom"]


def test_temperature_sampler_op_level():
    with pytest.raises(ValueError, match="temperature"):
        t_sampling.TemperatureSampler(temperature=0.0)
    s = t_sampling.TemperatureSampler(temperature=0.7)
    assert not s.deterministic and not j_sampling.TemperatureSampler().deterministic
    logits = torch.from_numpy(np.random.RandomState(1).randn(3, 8).astype(np.float32))
    with pytest.raises(ValueError, match="Generator"):
        s(logits)
    ids = s(logits, generator=torch.Generator().manual_seed(0))
    assert ids.shape == (3,) and ids.dtype == torch.int32
    assert bool(((ids >= 0) & (ids < 8)).all())
    cold = t_sampling.TemperatureSampler(temperature=1e-6)
    np.testing.assert_array_equal(
        cold(logits, generator=torch.Generator().manual_seed(0)).numpy(),
        np.argmax(logits.numpy(), axis=-1))


@pytest.mark.parametrize("temperature", [0.5, 1.0, 2.0])
def test_temperature_sampler_frequencies(temperature):
    """20000 seeded draws of one row: each token's frequency is within 5
    standard errors (+ 1e-3) of ``softmax(logits / T)``, as are the
    reference sampler's."""
    logits = np.random.RandomState(2).randn(6).astype(np.float32)
    n = 20000
    p = np.exp(logits / temperature - np.max(logits / temperature))
    p /= p.sum()
    tol = 5 * np.sqrt(p * (1 - p) / n) + 1e-3
    rows = torch.from_numpy(np.tile(logits, (n, 1)))
    ids = t_sampling.TemperatureSampler(temperature)(
        rows, generator=torch.Generator().manual_seed(4)).numpy()
    freq = np.bincount(ids, minlength=6) / n
    assert (np.abs(freq - p) <= tol).all(), (freq, p)
    jids = np.asarray(j_sampling.TemperatureSampler(temperature)(
        jnp.asarray(rows.numpy()), key=jax.random.PRNGKey(4)))
    jfreq = np.bincount(jids, minlength=6) / n
    assert (np.abs(jfreq - p) <= tol).all(), (jfreq, p)
