"""The port's serving engine against the JAX engine on the
``tests/test_engine.py`` trace (mixed prompt lengths, staggered arrivals,
more requests than slots) at budget_frac 1.0 and 0.5: per-request greedy
streams and the chunk / prefill / decode-step counts must be equal, a
request's stream must not depend on its co-tenants inside the port, and
every page must return to the allocator."""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.configs.base import ArchConfig as JArch
from repro.core.config import StemConfig as JStem
from repro.models import registry as j_registry
from repro.runtime import engine as j_engine

from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.core.config import StemConfig as TStem
from repro_torch.models import registry as t_registry
from repro_torch.runtime import engine as t_engine
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

TINY = dict(name="engine-tiny", family="dense", num_layers=2, d_model=32,
            num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64,
            qk_norm=True, dtype="float32")
STEM = dict(block_size=8, sink_blocks=1, local_blocks=1, min_budget_blocks=2,
            stride=4)
TRACE = [(5, 4, 0), (13, 6, 0), (8, 3, 1), (20, 5, 3), (9, 4, 5)]
COUNTS = ("chunks", "prefills", "decode_steps", "step_calls",
          "tokens_generated", "slots_reused", "max_concurrency")


@pytest.fixture(scope="module")
def built():
    jcfg, tcfg = JArch(**TINY), TArch(**TINY)
    jbundle = j_registry.build(jcfg)
    jparams = jbundle.init_params(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jbundle, jparams, t_registry.build(tcfg), tparams


def _requests(mod, trace=TRACE, seed=7):
    rng = np.random.RandomState(seed)
    return [mod.Request(uid=uid, prompt=rng.randint(0, 64, size=(plen,)).astype(
                np.int32), max_new_tokens=mnt, arrival_step=arr)
            for uid, (plen, mnt, arr) in enumerate(trace)]


def _ecfg(mod, max_slots, budget_frac, **kw):
    per_slot = -(-max(p + n for p, n, _ in TRACE) // STEM["block_size"])
    return mod.EngineConfig(max_slots=max_slots, num_pages=1 + max_slots * per_slot,
                            max_pages_per_slot=per_slot, budget_frac=budget_frac,
                            **kw)


@pytest.fixture(scope="module")
def jax_runs(built):
    jbundle, jparams, _, _ = built
    runs = {}
    for frac in (1.0, 0.5):
        eng = j_engine.StemEngine(jbundle, jparams, JStem(**STEM),
                                  _ecfg(j_engine, 2, frac))
        runs[frac] = (eng.run(_requests(j_engine)), dict(eng.stats))
    return runs


def _check_drained(eng):
    assert eng.allocator.available == eng.ecfg.num_pages - 1
    assert all(st is None for st in eng.slots)
    eng.allocator.check_conservation([])


@pytest.mark.parametrize("executor", ["fused", "gather"])
@pytest.mark.parametrize("budget_frac", [1.0, 0.5])
def test_engine_matches_jax(built, jax_runs, budget_frac, executor):
    _, _, tbundle, tparams = built
    jfin, jstats = jax_runs[budget_frac]
    eng = t_engine.StemEngine(tbundle, tparams, TStem(**STEM),
                              _ecfg(t_engine, 2, budget_frac, executor=executor))
    tfin = eng.run(_requests(t_engine))
    assert [f.uid for f in tfin] == [f.uid for f in jfin]
    for t, j in zip(tfin, jfin):
        assert t.tokens == j.tokens, f"request {t.uid} stream differs"
        assert (t.admitted_step, t.finished_step, t.slot) == \
            (j.admitted_step, j.finished_step, j.slot)
    for key in COUNTS:
        assert eng.stats[key] == jstats[key], key
    _check_drained(eng)


@pytest.mark.parametrize("budget_frac", [1.0, 0.5])
def test_batch_invariance(built, jax_runs, budget_frac):
    """Each request alone in a fresh single-slot port engine emits the
    stream it emitted among co-tenants (and the reference's)."""
    _, _, tbundle, tparams = built
    jfin, _ = jax_runs[budget_frac]
    for req in _requests(t_engine):
        solo = t_engine.StemEngine(tbundle, tparams, TStem(**STEM),
                                   _ecfg(t_engine, 1, budget_frac))
        alone = solo.run([t_engine.Request(uid=req.uid, prompt=req.prompt,
                                           max_new_tokens=req.max_new_tokens)])
        assert alone[0].tokens == jfin[req.uid].tokens
        _check_drained(solo)


def test_admission_blocks_on_memory(built):
    """Two requests that each need the whole pool: serialized, both done."""
    _, _, tbundle, tparams = built
    rng = np.random.RandomState(11)
    reqs = [t_engine.Request(uid=i, prompt=rng.randint(0, 64, size=(20,)).astype(
                np.int32), max_new_tokens=5) for i in range(2)]
    per_slot = -(-(20 + 5) // STEM["block_size"])
    ecfg = t_engine.EngineConfig(max_slots=2, num_pages=1 + per_slot,
                                 max_pages_per_slot=per_slot)
    eng = t_engine.StemEngine(tbundle, tparams, TStem(**STEM), ecfg)
    assert len(eng.run(reqs)) == 2
    assert eng.stats["max_concurrency"] == 1
    _check_drained(eng)


def test_eos_and_oversized(built, jax_runs):
    _, _, tbundle, tparams = built
    jfin, _ = jax_runs[1.0]
    req = _requests(t_engine)[1]
    eos = jfin[1].tokens[2]
    ecfg = dataclasses.replace(_ecfg(t_engine, 1, 1.0), eos_id=eos)
    cut = t_engine.StemEngine(tbundle, tparams, TStem(**STEM), ecfg).run([
        t_engine.Request(uid=1, prompt=req.prompt,
                         max_new_tokens=req.max_new_tokens)])[0]
    assert cut.tokens == jfin[1].tokens[:jfin[1].tokens.index(eos) + 1]
    eng = t_engine.StemEngine(tbundle, tparams, TStem(**STEM),
                              _ecfg(t_engine, 1, 1.0))
    with pytest.raises(ValueError, match="max_pages_per_slot"):
        eng.submit(t_engine.Request(uid=0, prompt=np.zeros((10_000,), np.int32),
                                    max_new_tokens=4))


def test_for_trace_sizing():
    for mod in (j_engine, t_engine):
        assert mod.pages_needed(16000, 32, 128) == 126
    a = j_engine.EngineConfig.for_trace(max_slots=2, max_prompt=16000,
                                        max_new_tokens=32, page_size=128)
    b = t_engine.EngineConfig.for_trace(max_slots=2, max_prompt=16000,
                                        max_new_tokens=32, page_size=128)
    assert (a.num_pages, a.max_pages_per_slot) == (b.num_pages, b.max_pages_per_slot)
