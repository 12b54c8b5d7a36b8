"""The prefix cache with copy-on-write pages in the port
(``repro_torch.runtime.paged``'s prefix index and allocator, the engine's
prefix admission, ``transformer.prefill_kv_pages_suffix``) against the
JAX reference, on the ``tests/test_prefix_cache.py`` scenarios.

Both engines serve the same requests on the same weights (carried across
with ``repro_torch.weights``).  Each engine scenario holds the port to the
reference on greedy streams and on the prefix / copy-on-write /
preemption counters, and the port's cache-on run to its cache-off run
bitwise.  The allocator is held to the reference op by op (page ids,
refcounts, cached set in LRU order, reclaim order, index) under both
eviction policies, the prefix keys to the reference's hex strings, and
the suffix prefill to the one-shot prefill within 1e-4 (fp32)."""
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import ArchConfig as JArch
from repro.core.config import StemConfig as JStem
from repro.models import registry as j_registry
from repro.models import transformer as j_transformer
from repro.runtime import engine as j_engine
from repro.runtime import paged as j_paged

from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.core.config import StemConfig as TStem
from repro_torch.models import registry as t_registry
from repro_torch.models import transformer as t_transformer
from repro_torch.runtime import engine as t_engine
from repro_torch.runtime import offload as t_offload
from repro_torch.runtime import paged as t_paged
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

BS = 8
TINY = dict(name="prefix-tiny", family="dense", num_layers=2, d_model=32,
            num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64,
            qk_norm=True, dtype="float32")
STEM = dict(block_size=BS, sink_blocks=1, local_blocks=1, min_budget_blocks=2,
            stride=4)
COUNTS = ("prefix_hits", "prefix_pages_shared", "prefix_cows", "preemptions",
          "restores", "chunks", "prefills", "decode_steps", "step_calls",
          "tokens_generated", "host_syncs", "restore_bytes")
ALLOC = ("shares", "cows", "cache_reclaims", "total_alloced", "evictions",
         "restores", "cached_pages", "available")


@pytest.fixture(scope="module")
def built():
    jcfg, tcfg = JArch(**TINY), TArch(**TINY)
    jbundle = j_registry.build(jcfg)
    jparams = jbundle.init_params(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jbundle, jparams, t_registry.build(tcfg), tparams


def _ecfg(max_slots, per_slot, num_pages=None, **kw):
    return dict(max_slots=max_slots,
                num_pages=num_pages or 1 + max_slots * per_slot,
                max_pages_per_slot=per_slot, budget_frac=1.0, **kw)


def _req(mod, r):
    return mod.Request(uid=r["uid"], prompt=np.array(r["prompt"], np.int32),
                       max_new_tokens=r["mnt"],
                       arrival_step=r.get("arrival", 0),
                       priority=r.get("priority", 0))


def _run(built, kw, reqs, port: bool, prefix_cache: bool):
    jbundle, jparams, tbundle, tparams = built
    kw = dict(kw, prefix_cache=prefix_cache)
    if port:
        eng = t_engine.StemEngine(tbundle, tparams, TStem(**STEM),
                                  t_engine.EngineConfig(**kw))
        fin = eng.run([_req(t_engine, r) for r in reqs])
    else:
        eng = j_engine.StemEngine(jbundle, jparams, JStem(**STEM),
                                  j_engine.EngineConfig(**kw))
        fin = eng.run([_req(j_engine, r) for r in reqs])
    return eng, {f.uid: f.tokens for f in fin}


def _assert_like_reference(teng, jeng):
    for key in COUNTS:
        assert teng.stats[key] == jeng.stats[key], key
    for key in ALLOC:
        assert getattr(teng.allocator, key) == getattr(jeng.allocator, key), key
    assert teng.metrics["prefix_shares"] == jeng.metrics["prefix_shares"]
    assert (teng.metrics["prefix_cached_pages"]
            == jeng.metrics["prefix_cached_pages"])
    teng.allocator.check_conservation([])
    assert teng.allocator.available == teng.ecfg.num_pages - 1


def _system_trace(seed, specs, system_pages=2):
    """Requests sharing one ``system_pages``-page system prompt, each with
    its own suffix: specs of (suffix length, new tokens, arrival)."""
    rng = np.random.RandomState(seed)
    system = rng.randint(0, TINY["vocab_size"], size=(system_pages * BS,))
    return [dict(uid=uid, mnt=mnt, arrival=arr,
                 prompt=np.concatenate([system, rng.randint(
                     0, TINY["vocab_size"], size=(suf,))]))
            for uid, (suf, mnt, arr) in enumerate(specs)]


def _per_slot(reqs):
    return -(-max(len(r["prompt"]) + r["mnt"] for r in reqs) // BS)


# ---------------------------------------------------------------------------
# Engine differentials: cache on == off, port == reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("evict", ["lru", "hit-rate"])
def test_shared_system_prompt_differential(built, evict):
    """Four tenants share a 2-page system prompt, staggered so the late
    ones arrive after the first prefill registered its pages: the streams
    equal the cache-off run and the reference's, sharing happened, the
    counters are the reference's, and every page comes home."""
    reqs = _system_trace(42, [(5, 4, 0), (7, 5, 0), (3, 4, 6), (9, 3, 8)])
    kw = _ecfg(2, _per_slot(reqs), prefix_evict=evict)
    t_off, want = _run(built, kw, reqs, True, False)
    t_on, got = _run(built, kw, reqs, True, True)
    j_on, ref = _run(built, kw, reqs, False, True)
    assert got == want == ref, "prefix caching changed a token stream"
    assert t_on.stats["prefix_hits"] >= 2
    assert t_on.stats["prefix_pages_shared"] >= 4
    assert t_on.allocator.total_alloced < t_off.allocator.total_alloced
    assert t_off.stats["prefix_hits"] == 0 and t_off.allocator.shares == 0
    _assert_like_reference(t_on, j_on)
    t_off.allocator.check_conservation([])


def test_cow_on_fully_matched_prompt(built):
    """An exact page-multiple prompt that fully matches still replays its
    last page: admission copies it on write into a private page."""
    prompt = np.random.RandomState(5).randint(0, 64, size=(2 * BS,))
    reqs = [dict(uid=0, prompt=prompt, mnt=4), dict(uid=1, prompt=prompt, mnt=4)]
    per_slot = _per_slot(reqs)
    kw = _ecfg(1, per_slot, num_pages=1 + 2 * per_slot)
    _, want = _run(built, kw, reqs, True, False)
    t_on, got = _run(built, kw, reqs, True, True)
    j_on, ref = _run(built, kw, reqs, False, True)
    assert got == want == ref and got[0] == got[1]
    assert (t_on.stats["prefix_cows"], t_on.stats["prefix_hits"],
            t_on.stats["prefix_pages_shared"], t_on.allocator.cows) == (1, 1, 1, 1)
    _assert_like_reference(t_on, j_on)


def test_recycled_registration_enables_sequential_sharing(built):
    """Tenants through one slot: the first tenant's registered pages park
    in the cached set at recycle and are revived by the next ones."""
    reqs = _system_trace(11, [(5, 3, 0), (6, 3, 0), (4, 3, 0)])
    per_slot = _per_slot(reqs)
    kw = _ecfg(1, per_slot, num_pages=1 + 2 * per_slot)
    _, want = _run(built, kw, reqs, True, False)
    t_on, got = _run(built, kw, reqs, True, True)
    j_on, ref = _run(built, kw, reqs, False, True)
    assert got == want == ref
    assert t_on.stats["prefix_hits"] == 2
    assert t_on.allocator.cache_reclaims == 0
    assert t_on.stats["prefix_pages_shared"] == 4
    _assert_like_reference(t_on, j_on)


@pytest.mark.parametrize("evict", ["lru", "hit-rate"])
def test_cached_pages_reclaimed_under_pressure(built, evict):
    """A pool with no slack: later tenants with a new prompt reclaim the
    ref-0 cached pages, in the reference's order under each policy."""
    rng = np.random.RandomState(13)
    sys_a, sys_b = (rng.randint(0, 64, size=(2 * BS,)) for _ in range(2))
    reqs = [dict(uid=u, mnt=3, prompt=np.concatenate(
                [sys_, rng.randint(0, 64, size=(suf,))]))
            for u, (sys_, suf) in enumerate([(sys_a, 5), (sys_a, 6), (sys_b, 4),
                                             (sys_a, 7), (sys_b, 3)])]
    per_slot = _per_slot(reqs)
    kw = _ecfg(1, per_slot, num_pages=1 + per_slot, prefix_evict=evict)
    _, want = _run(built, kw, reqs, True, False)
    t_on, got = _run(built, kw, reqs, True, True)
    j_on, ref = _run(built, kw, reqs, False, True)
    assert got == want == ref
    assert t_on.allocator.cache_reclaims > 0
    assert t_on.allocator._cached == j_on.allocator._cached
    _assert_like_reference(t_on, j_on)


def test_preempt_slot_with_shared_pages(built):
    """A sharer preempted mid-decode by a priority-1 request: the snapshot
    holds its private pages only, its shared pages keep their references
    while it is offloaded, and its restored stream equals the
    uninterrupted run's, the cache-off run's and the reference's."""
    reqs = _system_trace(5, [(5, 10, 0), (7, 10, 2)])
    rng = np.random.RandomState(6)
    reqs.append(dict(uid=2, mnt=4, arrival=9, priority=1,
                     prompt=rng.randint(0, 64, size=(13,))))
    kw = _ecfg(2, _per_slot(reqs))
    _, want = _run(built, kw, reqs, True, False)
    j_on, ref = _run(built, kw, reqs, False, True)

    tbundle, tparams = built[2], built[3]
    eng = t_engine.StemEngine(tbundle, tparams, TStem(**STEM),
                              t_engine.EngineConfig(**dict(kw, prefix_cache=True)))
    seen = {}
    preempt = eng.preempt

    def watched(slot):
        shared = eng.slot_pages[slot][:eng.slot_nshared[slot]]
        private = len(eng.slot_pages[slot]) - len(shared)
        refs = [eng.allocator.refcount(p) for p in shared]
        preempt(slot)
        uid = eng.preempted[-1].st.req.uid
        seen.update(uid=uid, shared=shared, private=private,
                    snap_bytes=eng.host_store.nbytes,
                    pinned=eng.host_store.pinned(uid),
                    refs=refs, refs_out=[eng.allocator.refcount(p) for p in shared])
    eng.preempt = watched
    got = {f.uid: f.tokens for f in eng.run([_req(t_engine, r) for r in reqs])}
    assert got == want == ref
    assert seen["shared"] and seen["pinned"] == seen["shared"]
    assert seen["snap_bytes"] == seen["private"] * eng._page_nbytes
    assert seen["refs_out"] == seen["refs"], "offloading dropped a shared reference"
    assert eng.stats["preemptions"] == 1 and eng.stats["restores"] == 1
    assert eng.stats["restore_bytes"] == seen["private"] * eng._page_nbytes
    _assert_like_reference(eng, j_on)
    assert len(eng.host_store) == 0


def test_restore_failure_abort_releases_pins(built):
    """A sharer whose restore keeps failing is aborted with an error: its
    pins are released and every page comes home, as in the reference."""
    from repro.runtime import chaos as j_chaos
    from repro_torch.runtime import chaos as t_chaos
    reqs = _system_trace(5, [(5, 10, 0), (7, 10, 2)])
    reqs.append(dict(uid=2, mnt=8, arrival=9, priority=1,
                     prompt=np.random.RandomState(6).randint(0, 64, size=(13,))))
    kw = _ecfg(2, _per_slot(reqs), prefix_cache=True)
    plan = dict(fail_restore_steps=tuple(range(10, 40)), restore_repeats=1)
    jbundle, jparams, tbundle, tparams = built
    jeng = j_engine.StemEngine(jbundle, jparams, JStem(**STEM),
                               j_engine.EngineConfig(**kw),
                               chaos=j_chaos.ChaosInjector(j_chaos.ChaosConfig(**plan)))
    teng = t_engine.StemEngine(tbundle, tparams, TStem(**STEM),
                               t_engine.EngineConfig(**kw),
                               chaos=t_chaos.ChaosInjector(t_chaos.ChaosConfig(**plan)))
    jfin = jeng.run([_req(j_engine, r) for r in reqs])
    tfin = teng.run([_req(t_engine, r) for r in reqs])
    assert [(f.uid, f.tokens, f.error) for f in tfin] == \
        [(f.uid, f.tokens, f.error) for f in jfin]
    assert teng.stats["aborts"] == 1 and teng.stats["restore_failures"] >= 3
    teng.allocator.check_conservation([])
    assert teng.allocator.available == teng.ecfg.num_pages - 1


# ---------------------------------------------------------------------------
# Suffix prefill, page copy, keys, host store
# ---------------------------------------------------------------------------

def _poison_private(pools, private):
    for seg in pools:
        for pool in seg.values():
            for leaf in pool:
                leaf[:, :, private] += 7.0


def test_suffix_prefill_matches_full_prefill(built):
    """``prefill_kv_pages_suffix`` over written prefix pages equals the
    one-shot ``prefill_kv_pages`` (logits and every reserved page within
    1e-4 fp32), leaves the prefix pages it reads unwritten, and equals the
    reference's suffix prefill."""
    _, jparams, tbundle, tparams = built
    tcfg, stem = TArch(**TINY), TStem(**STEM)
    plen = 43
    prompt = np.random.RandomState(3).randint(0, 64, size=(plen,))
    npages = -(-plen // BS)
    row = list(range(1, npages + 2))
    toks = np.zeros((1, npages * BS), np.int32)
    toks[0, :plen] = prompt
    trow = torch.tensor(row, dtype=torch.int32)

    full = t_transformer.init_page_pools(tcfg, npages + 3, stem, device="cpu")
    ref_logits, full = t_transformer.prefill_kv_pages(
        tparams, torch.from_numpy(toks), plen, full, trow, tcfg, stem)
    start = 2 * BS
    shared, private = row[:2], row[2:]
    pools = [{k: t_paged.PagePool(*(x.clone() for x in p)) for k, p in seg.items()}
             for seg in full]
    _poison_private(pools, private)
    t_paged.reset_pools_stacked(pools, torch.tensor(private))
    before = [x[:, :, shared].clone() for x in t_offload.leaves(pools)]
    logits, pools = t_transformer.prefill_kv_pages_suffix(
        tparams, torch.from_numpy(toks), plen, start, pools, trow, tcfg, stem)
    torch.testing.assert_close(logits, ref_logits, atol=1e-4, rtol=1e-4)
    for got, want in zip(t_offload.leaves(pools), t_offload.leaves(full)):
        torch.testing.assert_close(got[:, :, row], want[:, :, row],
                                   atol=1e-4, rtol=1e-4)
    for b, x in zip(before, t_offload.leaves(pools)):
        assert torch.equal(b, x[:, :, shared]), "a shared prefix page was written"

    jpools = j_transformer.init_page_pools(JArch(**TINY), npages + 3, JStem(**STEM))
    _, jpools = j_transformer.prefill_kv_pages(
        jparams, jnp.asarray(toks), jnp.asarray(plen, jnp.int32), jpools,
        jnp.asarray(row), JArch(**TINY), JStem(**STEM))
    jlogits, _ = j_transformer.prefill_kv_pages_suffix(
        jparams, jnp.asarray(toks), jnp.asarray(plen, jnp.int32), start,
        jpools, jnp.asarray(row), JArch(**TINY), JStem(**STEM))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("start", [3, 2 * BS + 1, 3 * BS, -BS])
def test_suffix_prefill_rejects_misaligned_start(built, start):
    tcfg, stem = TArch(**TINY), TStem(**STEM)
    pools = t_transformer.init_page_pools(tcfg, 5, stem, device="cpu")
    with pytest.raises(ValueError, match="block"):
        t_transformer.prefill_kv_pages_suffix(
            built[3], torch.zeros((1, 3 * BS), dtype=torch.int32), 9, start,
            pools, torch.arange(1, 4, dtype=torch.int32), tcfg, stem)


def test_copy_pages_stacked_matches_reference():
    rng = np.random.RandomState(0)
    shapes = [(2, 2, 6, BS, 8), (2, 2, 6, BS, 8), (2, 2, 6, 4, 8), (2, 2, 6)]
    leaves = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tpools = [{"sub0": t_paged.PagePool(*(torch.from_numpy(x.copy()) for x in leaves))}]
    jpools = [{"sub0": j_paged.PagePool(*(jnp.asarray(x) for x in leaves))}]
    t_paged.copy_pages_stacked(tpools, 4, 2)
    jpools = j_paged.copy_pages_stacked(jpools, jnp.asarray(4), jnp.asarray(2))
    for t, j in zip(t_offload.leaves(tpools), jax.tree.leaves(jpools)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert torch.equal(tpools[0]["sub0"].k[:, :, 2], tpools[0]["sub0"].k[:, :, 4])


@pytest.mark.parametrize("seed", range(4))
def test_prefix_page_keys_match_reference(seed):
    rng = np.random.RandomState(seed)
    plen = int(rng.randint(1, 9 * BS))
    tokens = rng.randint(0, 50000, size=(plen,)).astype(np.int32)
    budgets = rng.randint(1, 9, size=(-(-plen // BS),))
    got = t_paged.prefix_page_keys(tokens, budgets, BS)
    assert got == j_paged.prefix_page_keys(tokens, budgets, BS)
    assert len(got) == plen // BS
    assert all(isinstance(k, str) and len(k) == 32 for k in got)
    if got:
        budgets[0] += 1
        assert t_paged.prefix_page_keys(tokens, budgets, BS)[-1] != got[-1]


def test_host_store_pins():
    store = t_offload.HostPageStore()
    snap = [{"sub0": t_paged.PagePool(*(torch.ones(1, 1, 2, 3) for _ in range(4)))}]
    store.put(7, snap, pinned=[3, 5])
    assert store.pinned(7) == [3, 5] and store.pinned(8) == []
    assert store.nbytes == 4 * 6 * 4
    store.pop(7)
    assert store.pinned(7) == [] and store.nbytes == 0 and store.peak_nbytes == 96


def test_prefix_config_validation():
    with pytest.raises(ValueError, match="chunked prefill"):
        t_engine.EngineConfig(prefix_cache=True, monolithic_prefill=True)
    with pytest.raises(ValueError, match="prefix_evict"):
        t_engine.EngineConfig(prefix_evict="belady")
    assert t_engine.EngineConfig().prefix_evict == "lru"
    assert not t_engine.EngineConfig().prefix_cache


# ---------------------------------------------------------------------------
# The allocator, op by op against the reference
# ---------------------------------------------------------------------------

def _state(a):
    return (list(a._free), sorted(a._allocated), dict(a._ref), dict(a._index),
            list(a._cached), dict(a._hits), a.available, a.cached_pages,
            a.shares, a.cows, a.cache_reclaims, a.total_alloced, a.evictions,
            a.restores)


@pytest.mark.parametrize("evict", ["lru", "hit-rate"])
@pytest.mark.parametrize("seed", range(6))
def test_allocator_ops_match_reference(seed, evict):
    """The same seeded sequence of alloc / free / probe / share / register
    / cow / evict / restore ops: identical page ids, refcounts, cached set
    (LRU order), reclaim order and index after every op, and refcount
    conservation against a mirror of every reference held."""
    rng = random.Random(seed)
    n = rng.randint(5, 14)
    t, j = t_paged.PageAllocator(n, evict), j_paged.PageAllocator(n, evict)
    held, keys, serial, evicted = [], [], 0, 0
    for _ in range(120):
        op = rng.choice(("alloc", "free", "register", "probe", "cow",
                         "evict", "restore"))
        if op == "alloc":
            k = rng.randint(1, max(1, t.available))
            got = t.alloc(k)
            assert got == j.alloc(k)
            held += got or []
        elif op == "free" and held:
            p = rng.choice(held)
            t.free([p])
            j.free([p])
            held.remove(p)
        elif op == "register" and held:
            p = rng.choice(held)
            serial += 1
            key = f"k{serial}"
            t.register(p, key)
            j.register(p, key)
            keys.append(key)
        elif op == "probe" and keys:
            key = rng.choice(keys)
            hit = t.probe(key)
            assert hit == j.probe(key)
            if hit is not None:
                assert t.share(hit) == j.share(hit)
                held.append(hit)
        elif op == "cow" and held:
            p = rng.choice(held)
            fresh = t.cow(p)
            assert fresh == j.cow(p)
            if fresh is not None:
                held.remove(p)
                held.append(fresh)
        elif op == "evict" and held:
            p = rng.choice(held)
            t.evict([p])
            j.evict([p])
            held.remove(p)
            evicted += 1
        elif op == "restore" and evicted:
            got = t.restore(1)
            assert got == j.restore(1)
            evicted -= 1
            held += got or []
        assert _state(t) == _state(j), op
        t.check_conservation(held)
    for p in list(held):
        t.free([p])
    t.check_conservation([])
    assert t.available == n - 1


def test_cached_lru_reclaim_invalidates_index():
    a = t_paged.PageAllocator(5)
    pages = a.alloc(4)
    keys = t_paged.prefix_page_keys(list(range(4 * BS)), [1, 1, 1, 1], BS)
    for p, k in zip(pages, keys):
        a.register(p, k)
    a.free(pages[:2])
    a.free(pages[2:])
    assert a.available == 4 and a.cached_pages == 4
    got = a.alloc(3)
    assert sorted(got) == sorted(pages[:3]) and a.cache_reclaims == 3
    assert all(a.probe(k) is None for k in keys[:3])
    assert a.probe(keys[3]) == pages[3]
    a.check_conservation(got)
    p = a.share(a.probe(keys[3]))
    assert p == pages[3] and a.refcount(p) == 1
    a.check_conservation(got + [p])


@pytest.mark.parametrize("evict,kept", [("hit-rate", True), ("lru", False)])
def test_eviction_policy_keeps_hot_pages(evict, kept):
    """The hottest page is also the oldest cached one: hit-rate keeps it,
    LRU reclaims it first."""
    a = t_paged.PageAllocator(5, evict_policy=evict)
    pages = a.alloc(4)
    keys = t_paged.prefix_page_keys(list(range(4 * BS)), [1, 1, 1, 1], BS)
    for p, k in zip(pages, keys):
        a.register(p, k)
    a.free(pages)
    a.free([a.share(pages[0])])
    a.free([a.share(pages[0])])
    for p in pages[1:]:
        a.free([a.share(p)])
    got = a.alloc(3)
    assert (a.probe(keys[0]) == pages[0]) is kept
    assert (pages[0] in got) is not kept
    a.check_conservation(got)


def test_allocator_validation_and_first_writer_wins():
    assert t_paged.PageAllocator(4).evict_policy == "lru"
    with pytest.raises(ValueError, match="evict_policy"):
        t_paged.PageAllocator(4, evict_policy="belady")
    a = t_paged.PageAllocator(4)
    p, q = a.alloc(2)
    a.register(p, "k1")
    a.register(p, "k1")
    a.register(q, "k1")
    assert a.probe("k1") == p
    a.register(p, "k2")
    assert a.probe("k1") is None and a.probe("k2") == p
    with pytest.raises(ValueError, match="unallocated"):
        a.register(3, "k3")
    with pytest.raises(ValueError, match="neither allocated nor cached"):
        a.share(3)
    a.check_conservation([p, q])
    with pytest.raises(AssertionError, match="refcount mismatch"):
        a.check_conservation([p, q, q])
    assert a.cow(p) == 3                # p parks in the cached set (keyed)
    assert a.cow(q) == p and a.cache_reclaims == 1
    rest = a.alloc(a.available)
    assert a.cow(3) is None and a.refcount(3) == 1 and a.cows == 2
    a.check_conservation([3, p] + rest)


def test_shared_refcounts_multiset():
    """A page shared by k holders appears k times in ``held``."""
    a = t_paged.PageAllocator(6)
    (p,) = a.alloc(1)
    a.register(p, "sys")
    a.share(a.probe("sys"))
    a.share(a.probe("sys"))
    assert a.refcount(p) == 3 and a.shares == 2
    a.check_conservation([p, p, p])
    a.free([p, p])
    a.check_conservation([p])
    a.free([p])
    assert a.cached_pages == 1 and a.available == 5
    a.check_conservation([])
