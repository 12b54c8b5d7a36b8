"""Preemption and host page offload in the port
(``repro_torch.runtime.offload``, the engine's preempt / restore) against
the JAX reference, on the ``tests/test_preemption.py`` scenarios.

Both engines serve the same requests on the same weights (carried across
with ``repro_torch.weights``).  Each scenario holds the port to the
reference on greedy tokens, errors, the preemption / restore counts and
the allocator's page ids; within the port, restored pages equal the
snapshot bitwise and a preempted run equals the uninterrupted one; the
port's snapshot (only the request's own pages) is within 1e-4 of the
first ``npages`` of the reference's trash-padded one (fp32)."""
import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import ArchConfig as JArch
from repro.core.config import StemConfig as JStem
from repro.models import registry as j_registry
from repro.runtime import engine as j_engine
from repro.runtime import offload as j_offload
from repro.runtime import paged as j_paged

from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.core.config import StemConfig as TStem
from repro_torch.models import registry as t_registry
from repro_torch.runtime import engine as t_engine
from repro_torch.runtime import offload as t_offload
from repro_torch.runtime import paged as t_paged
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

TINY = dict(name="preempt-tiny", family="dense", num_layers=2, d_model=32,
            num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64,
            qk_norm=True, dtype="float32")
STEM = dict(block_size=8, sink_blocks=1, local_blocks=1, min_budget_blocks=2,
            stride=4)
BS = STEM["block_size"]
COUNTS = ("preemptions", "restores", "restore_failures", "aborts", "shed",
          "chunks", "prefills", "decode_steps", "step_calls",
          "tokens_generated", "restore_bytes")


@pytest.fixture(scope="module")
def built():
    jcfg, tcfg = JArch(**TINY), TArch(**TINY)
    jbundle = j_registry.build(jcfg)
    jparams = jbundle.init_params(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jbundle, jparams, t_registry.build(tcfg), tparams


def _engines(built, ecfg_kw, chaos=None):
    """(JAX engine, port engine) on the same weights and config."""
    jbundle, jparams, tbundle, tparams = built
    return (j_engine.StemEngine(jbundle, jparams, JStem(**STEM),
                                j_engine.EngineConfig(**ecfg_kw)),
            t_engine.StemEngine(tbundle, tparams, TStem(**STEM),
                                t_engine.EngineConfig(**ecfg_kw)))


def _ecfg(max_slots, plen, mnt, **kw):
    per_slot = -(-(plen + mnt) // BS)
    return dict(max_slots=max_slots, num_pages=1 + max_slots * per_slot,
                max_pages_per_slot=per_slot, **kw)


def _req(mod, uid, prompt, mnt, **kw):
    return mod.Request(uid=uid, prompt=np.array(prompt, np.int32),
                       max_new_tokens=mnt, **kw)


def _assert_same_outcome(jeng, jfin, teng, tfin):
    """Tokens, errors, preemptions and finish order equal the reference's,
    and so do the engine counts; every page is back."""
    assert [f.uid for f in tfin] == [f.uid for f in jfin]
    for t, j in zip(tfin, jfin):
        assert t.tokens == j.tokens, f"request {t.uid} stream differs"
        assert (t.error, t.preemptions, t.priority) == \
            (j.error, j.preemptions, j.priority), t.uid
        assert (t.slot, t.admitted_step, t.finished_step) == \
            (j.slot, j.admitted_step, j.finished_step), t.uid
    for key in COUNTS:
        assert teng.stats[key] == jeng.stats[key], key
    assert (teng.allocator.evictions, teng.allocator.restores) == \
        (jeng.allocator.evictions, jeng.allocator.restores)
    teng.allocator.check_conservation([])
    assert len(teng.host_store) == 0


def _assert_snapshot_close(tsnap, jsnap):
    """The port's snapshot (npages wide) against the first npages of the
    reference's trash-padded one, leaf by leaf."""
    tl, jl = t_offload.leaves(tsnap), jax.tree.leaves(jsnap)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        j = np.asarray(j)[:, :, :t.shape[2]]
        assert t.shape == j.shape
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# The offload round trip at the page level
# ---------------------------------------------------------------------------

def _tree(pool):
    """One layer's pool -> the engine's stacked tree ``[{"sub0": ...}]``."""
    return [{"sub0": t_paged.PagePool(*(x[None] for x in pool))}]


def _untree(tree):
    return t_paged.PagePool(*(x[0] for x in tree[0]["sub0"]))


@pytest.mark.parametrize("hk,group,true_len", [
    (1, 1, 1), (1, 4, 13), (2, 2, 8), (2, 1, 21), (4, 2, 24), (4, 4, 17)])
def test_offload_roundtrip_property(hk, group, true_len):
    """gather -> host -> scatter into *different* pages reproduces the pool
    bitwise, decode and incremental growth off the restored pages equal
    the uninterrupted pool's bitwise, and the snapshot is the reference's
    (cache lengths that end mid-page included)."""
    d, npages_req, n_pages, maxp = 8, 3, 8, 4
    stem = TStem(**STEM)
    L = npages_req * BS
    rng = np.random.RandomState(1000 * hk + 10 * group + true_len)
    k, v = (rng.standard_normal((hk, L, d)).astype(np.float32) for _ in range(2))
    q = rng.standard_normal((1, hk * group, 1, d)).astype(np.float32)
    kn, vn = (rng.standard_normal((1, hk, 1, d)).astype(np.float32)
              for _ in range(2))
    pages_a, pages_b = [2, 5, 3], [6, 1, 4]
    table = lambda pages: torch.tensor([pages + [0] * (maxp - len(pages))])
    fresh = lambda: t_paged.init_pool(n_pages, hk, BS, d, STEM["stride"],
                                      device="cpu")
    written = lambda: t_paged.write_prefill_pages(
        fresh(), torch.tensor(pages_a), torch.from_numpy(k),
        torch.from_numpy(v), true_len, stem)

    pool_a = written()
    store = t_offload.HostPageStore()
    store.put(0, t_offload.gather_pages(_tree(pool_a), torch.tensor(pages_a)))
    snap = copy.deepcopy(store.get(0))
    assert store.nbytes == t_offload.snapshot_nbytes(snap) > 0
    t_paged.reset_pages(pool_a, torch.tensor(pages_a))           # evicted
    pool_b = _untree(t_offload.scatter_pages(
        _tree(fresh()), torch.tensor(pages_b), store.pop(0)))
    assert store.nbytes == 0 and store.peak_nbytes > 0

    back = t_offload.gather_pages(_tree(pool_b), torch.tensor(pages_b))
    for got, want, name in zip(t_offload.leaves(back), t_offload.leaves(snap),
                               ("k", "v", "kg", "vm")):
        assert torch.equal(got, want), f"{name} not bitwise"

    # The reference's gather over its trash-padded row.
    jpool = j_paged.write_prefill_pages(
        j_paged.init_pool(n_pages, hk, BS, d, STEM["stride"]),
        jnp.asarray(pages_a), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(true_len), JStem(**STEM))
    jsnap = j_offload.gather_pages(jax.tree.map(lambda x: x[None], [{"sub0": jpool}]),
                                   jnp.asarray(pages_a + [0] * (maxp - 3)))
    _assert_snapshot_close(snap, jsnap)

    lens = torch.tensor([true_len], dtype=torch.int32)
    qt = torch.from_numpy(q)
    out_a = t_paged.paged_sparse_decode(qt, written(), table(pages_a), lens,
                                        stem, budget_frac=0.5)
    out_b = t_paged.paged_sparse_decode(qt, pool_b, table(pages_b), lens, stem,
                                        budget_frac=0.5)
    assert torch.equal(out_a, out_b)
    if true_len < L:
        grown = t_paged.append_token(pool_b, table(pages_b), lens,
                                     torch.from_numpy(kn), torch.from_numpy(vn),
                                     stem)
        ref = t_paged.append_token(written(), table(pages_a), lens,
                                   torch.from_numpy(kn), torch.from_numpy(vn),
                                   stem)
        got = t_offload.gather_pages(_tree(grown), torch.tensor(pages_b))
        want = t_offload.gather_pages(_tree(ref), torch.tensor(pages_a))
        for g, w in zip(t_offload.leaves(got), t_offload.leaves(want)):
            assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# Forced preemption in the engine
# ---------------------------------------------------------------------------

def _forced_preempt(eng, req, after):
    """Serve ``req`` alone, preempt it after ``after`` steps, restore it at
    the next admission and drain.  Returns (host snapshot, pages read
    back right after the restore, finished request)."""
    eng.submit(req)
    for _ in range(after):
        eng.step()
    assert eng.slots[0] is not None
    eng.preempt(0)
    eng.allocator.check_conservation([])          # every page free while out
    assert eng.slots[0] is None and len(eng.preempted) == 1
    snap = copy.deepcopy(eng.host_store.get(req.uid))
    eng._admit()
    assert eng.slots[0] is not None and not eng.preempted
    back = None
    if isinstance(eng, t_engine.StemEngine):
        back = t_offload.gather_pages(eng.pools,
                                      torch.as_tensor(eng.slot_pages[0]))
    return snap, back, eng.run()[0]


@pytest.fixture(scope="module")
def jax_forced(built):
    """The reference's forced preempt / restore runs, once each."""
    out = {}
    for name, plen, mnt, after, mono in (
            ("mid-prefill", 20, 8, 1, False), ("mid-decode", 20, 8, 4, False),
            ("monolithic", 20, 8, 2, True)):
        prompt = np.random.RandomState(17).randint(0, 64, size=(plen,))
        kw = _ecfg(1, plen, mnt, budget_frac=0.5, monolithic_prefill=mono)
        jeng, jsolo = (j_engine.StemEngine(built[0], built[1], JStem(**STEM),
                                           j_engine.EngineConfig(**kw))
                       for _ in range(2))
        ref = jsolo.run([_req(j_engine, 0, prompt, mnt)])[0]
        snap, _, fin = _forced_preempt(jeng, _req(j_engine, 0, prompt, mnt),
                                       after)
        out[name] = (prompt, mnt, after, kw, ref, snap, fin, dict(jeng.stats))
    return out


@pytest.mark.parametrize("name", ["mid-prefill", "mid-decode", "monolithic"])
def test_engine_preempt_restore_differential(built, jax_forced, name):
    """A forced preemption (mid-prefill, mid-decode, and after a monolithic
    admission) then a drain: the restored pages equal the snapshot bitwise,
    the stream equals the uninterrupted run and the reference, and no
    chunk or prefill is recomputed."""
    prompt, mnt, after, kw, jref, jsnap, jfin, jstats = jax_forced[name]
    tbundle, tparams = built[2], built[3]
    solo = t_engine.StemEngine(tbundle, tparams, TStem(**STEM),
                               t_engine.EngineConfig(**kw))
    ref = solo.run([_req(t_engine, 0, prompt, mnt)])[0]
    teng = t_engine.StemEngine(tbundle, tparams, TStem(**STEM),
                               t_engine.EngineConfig(**kw))
    snap, back, fin = _forced_preempt(teng, _req(t_engine, 0, prompt, mnt), after)
    for got, want in zip(t_offload.leaves(back), t_offload.leaves(snap)):
        assert torch.equal(got, want), "restored pages differ from the snapshot"
    _assert_snapshot_close(snap, jsnap)
    assert ref.tokens == jref.tokens
    assert fin.tokens == ref.tokens == jfin.tokens
    assert fin.preemptions == jfin.preemptions == 1 and fin.error is None
    assert teng.stats["chunks"] == solo.stats["chunks"] == jstats["chunks"]
    assert teng.stats["prefills"] == solo.stats["prefills"] == 1
    assert teng.stats["restores"] == jstats["restores"] == 1
    assert teng.stats["restore_bytes"] == jstats["restore_bytes"]
    assert len(teng.host_store) == 0
    teng.allocator.check_conservation([])


# ---------------------------------------------------------------------------
# Priority preemption in the admission loop
# ---------------------------------------------------------------------------

def _prompt(rng, plen):
    return rng.randint(0, TINY["vocab_size"], size=(plen,)).astype(np.int32)


def _serve_both(built, kw, specs):
    """Serve the same requests ``(uid, prompt, mnt, extra)`` in both
    engines; returns (jeng, jfin, teng, tfin)."""
    jeng, teng = _engines(built, kw)
    jfin = jeng.run([_req(j_engine, u, p, m, **x) for u, p, m, x in specs])
    tfin = teng.run([_req(t_engine, u, p, m, **x) for u, p, m, x in specs])
    return jeng, jfin, teng, tfin


def test_priority_admission_preempts_lower(built):
    """A high-priority arrival evicts the running low-priority request
    (slot-blocked); the HP request finishes first, the victim restores and
    finishes with its uninterrupted stream."""
    rng = np.random.RandomState(23)
    lp, hp = _prompt(rng, 20), _prompt(rng, 13)
    jeng, jfin, teng, tfin = _serve_both(
        built, _ecfg(1, 20, 8),
        [(0, lp, 8, {}), (1, hp, 4, dict(priority=1, arrival_step=4))])
    _assert_same_outcome(jeng, jfin, teng, tfin)
    assert teng.stats["preemptions"] == 1 and teng.stats["restores"] == 1
    assert tfin[1].finished_step < tfin[0].finished_step
    assert tfin[0].preemptions == 1 and tfin[1].preemptions == 0
    solo = t_engine.StemEngine(built[2], built[3], TStem(**STEM),
                               t_engine.EngineConfig(**_ecfg(1, 20, 8)))
    assert solo.run([_req(t_engine, 0, lp, 8)])[0].tokens == tfin[0].tokens


@pytest.mark.parametrize("kw", [{"preemption": False}, {"scheduler": "fcfs"}])
def test_preemption_disabled_keeps_fcfs_order(built, kw):
    """With preemption off, or the fcfs scheduler, a high-priority arrival
    waits like anyone else."""
    rng = np.random.RandomState(29)
    lp, hp = _prompt(rng, 20), _prompt(rng, 13)
    jeng, jfin, teng, tfin = _serve_both(
        built, _ecfg(1, 20, 8, **kw),
        [(0, lp, 8, {}), (1, hp, 4, dict(priority=1, arrival_step=4))])
    _assert_same_outcome(jeng, jfin, teng, tfin)
    assert teng.stats["preemptions"] == 0
    assert tfin[0].finished_step < tfin[1].finished_step


def _cost_trace():
    rng = np.random.RandomState(31)
    return [(0, _prompt(rng, 5), 3, {}),                       # 1 page
            (1, _prompt(rng, 20), 8, {}),                      # 4 pages
            (2, _prompt(rng, 13), 4, dict(priority=1, arrival_step=2))]


def _cost_ecfg():
    per_slot = -(-28 // BS)
    return dict(max_slots=2, num_pages=1 + 3 * per_slot,
                max_pages_per_slot=per_slot)


def test_preemption_victim_minimizes_restore_cost(built):
    """Among the lowest priority class the victim is the request whose
    restore is cheapest (fewest pages), not the most recent slot."""
    jeng, jfin, teng, tfin = _serve_both(built, _cost_ecfg(), _cost_trace())
    _assert_same_outcome(jeng, jfin, teng, tfin)
    assert teng.stats["preemptions"] == 1
    assert tfin[0].preemptions == 1 and tfin[1].preemptions == 0


def test_restore_cost_model_prices_bytes_over_bandwidth(built):
    """``_restore_cost_s`` is pages x page bytes over the bandwidth EMA
    (seeded before any restore, measured after one), the page bytes are
    the reference's, and the moved bytes are accounted."""
    jeng, teng = _engines(built, _cost_ecfg())
    assert teng._page_nbytes == jeng._page_nbytes > 0
    assert teng._BW_SEED == jeng._BW_SEED and teng._h2d_bw_ema is None
    specs = _cost_trace()
    for eng, mod in ((jeng, j_engine), (teng, t_engine)):
        for u, p, m, x in specs[:2]:
            eng.submit(_req(mod, u, p, m, **x))
        eng.step()
        eng.step()
    costs = []
    for eng in (jeng, teng):
        by_uid = {st.req.uid: s for s, st in enumerate(eng.slots)}
        costs.append([eng._restore_cost_s(by_uid[u]) for u in (0, 1)])
    assert costs[0] == costs[1]
    pages = [len(teng.slot_pages[s]) for s in
             sorted(range(2), key=lambda s: teng.slots[s].req.uid)]
    assert pages == [1, 4]
    assert costs[1] == [n * teng._page_nbytes / teng._BW_SEED for n in pages]

    u, p, m, x = specs[2]
    jeng.submit(_req(j_engine, u, p, m, **x))
    teng.submit(_req(t_engine, u, p, m, **x))
    _assert_same_outcome(jeng, jeng.run(), teng, teng.run())
    assert teng._h2d_bw_ema is not None and teng._h2d_bw_ema > 0
    assert teng.metrics["h2d_bw_bytes_per_s"] == teng._h2d_bw_ema
    assert teng.stats["restore_bytes"] == teng._page_nbytes > 0
    assert teng.metrics["offload_peak_bytes"] == teng._page_nbytes
    assert teng.metrics["offload_resident_bytes"] == 0
    assert (teng.metrics["allocator_evictions"],
            teng.metrics["allocator_restores"]) == (1, 1)


def test_allocator_evict_restore_conservation():
    """evict / restore hand out and take back the reference's page ids and
    keep the free list and the allocated set a partition."""
    a, ref = t_paged.PageAllocator(8), j_paged.PageAllocator(8)
    held, other = a.alloc(3), a.alloc(2)
    assert (held, other) == (ref.alloc(3), ref.alloc(2))
    a.check_conservation(held + other)
    a.evict(held)
    ref.evict(held)
    a.check_conservation(other)
    back = a.restore(3)
    assert back == ref.restore(3)
    a.check_conservation(other + back)
    assert (a.evictions, a.restores) == (ref.evictions, ref.restores) == (1, 1)
    assert a.restore(10) is None and a.restores == 1
    a.free(back)
    a.free(other)
    a.check_conservation([])


def test_preempt_idle_slot_raises(built):
    _, teng = _engines(built, _ecfg(1, 20, 8))
    with pytest.raises(ValueError, match="not active"):
        teng.preempt(0)
    with pytest.raises(ValueError, match="unknown scheduler"):
        t_engine.EngineConfig(scheduler="edf")
    assert dataclasses.asdict(t_engine.EngineConfig()).items() <= {
        k: v for k, v in dataclasses.asdict(j_engine.EngineConfig()).items()
    }.items()
