"""Engine-level fault injection, load shedding, admission control and the
straggler monitor in the port (``repro_torch.runtime.chaos``,
``fault_tolerance``, ``straggler`` and the engine's failure paths) against
the JAX reference, on the ``tests/test_chaos.py`` scenarios.

Both engines serve the same requests on the same weights under the same
injection plan.  The contract under chaos: the engine never crashes and
never wedges — every request finishes or fails with an explicit error —
and every page returns.  The port must agree with the reference on greedy
tokens, errors, the chaos counts and the preemption / restore / abort /
shed counts.  Wall-clock readings (straggler flags, SLO headroom) are
compared only where a test fixes them."""
import numpy as np
import pytest
import torch

import jax

from repro.configs.base import ArchConfig as JArch
from repro.core.config import StemConfig as JStem
from repro.models import registry as j_registry
from repro.runtime import chaos as j_chaos
from repro.runtime import engine as j_engine
from repro.runtime import fault_tolerance as j_ft
from repro.runtime import straggler as j_straggler

from repro_torch.configs.base import ArchConfig as TArch
from repro_torch.core.config import StemConfig as TStem
from repro_torch.models import registry as t_registry
from repro_torch.runtime import chaos as t_chaos
from repro_torch.runtime import engine as t_engine
from repro_torch.runtime import fault_tolerance as t_ft
from repro_torch.runtime import straggler as t_straggler
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

TINY = dict(name="chaos-tiny", family="dense", num_layers=2, d_model=32,
            num_heads=4, num_kv_heads=2, head_dim=8, d_ff=64, vocab_size=64,
            qk_norm=True, dtype="float32")
STEM = dict(block_size=8, sink_blocks=1, local_blocks=1, min_budget_blocks=2,
            stride=4)
BS = STEM["block_size"]
COUNTS = ("preemptions", "restores", "restore_failures", "step_failures",
          "aborts", "shed", "alloc_denials", "admission_rejects", "chunks",
          "prefills", "decode_steps", "step_calls", "tokens_generated")


@pytest.fixture(scope="module")
def built():
    jcfg, tcfg = JArch(**TINY), TArch(**TINY)
    jbundle = j_registry.build(jcfg)
    jparams = jbundle.init_params(jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jbundle, jparams, t_registry.build(tcfg), tparams


def _ecfg(max_slots, per_slot, **kw):
    return dict(max_slots=max_slots, num_pages=1 + max_slots * per_slot,
                max_pages_per_slot=per_slot, **kw)


def _trace(seed, specs):
    """[(uid, prompt, max_new, extra)] from ``(uid, plen, max_new, extra)``."""
    rng = np.random.RandomState(seed)
    return [(u, rng.randint(0, TINY["vocab_size"], size=(p,)).astype(np.int32),
             m, x) for u, p, m, x in specs]


def _requests(mod, trace):
    return [mod.Request(uid=u, prompt=p.copy(), max_new_tokens=m, **x)
            for u, p, m, x in trace]


def _engine(built, mod, kw, chaos_kw=None, ema=None):
    jbundle, jparams, tbundle, tparams = built
    chaos = None
    if chaos_kw is not None:
        cm = j_chaos if mod is j_engine else t_chaos
        chaos = cm.ChaosInjector(cm.ChaosConfig(**chaos_kw))
    if mod is j_engine:
        eng = mod.StemEngine(jbundle, jparams, JStem(**STEM),
                             mod.EngineConfig(**kw), chaos=chaos)
    else:
        eng = mod.StemEngine(tbundle, tparams, TStem(**STEM),
                             mod.EngineConfig(**kw), chaos=chaos)
    if ema is not None:
        eng.monitor.ema = ema
    return eng


def _serve_both(built, kw, trace, chaos_kw=None, ema=None):
    jeng = _engine(built, j_engine, kw, chaos_kw, ema)
    jfin = jeng.run(_requests(j_engine, trace))
    teng = _engine(built, t_engine, kw, chaos_kw, ema)
    tfin = teng.run(_requests(t_engine, trace))
    _assert_same_outcome(jeng, jfin, teng, tfin)
    return teng, tfin


def _error_head(err):
    # An admission-control rejection ends in a wall-clock estimate.
    return None if err is None else err.split(" ~ ")[0]


def _assert_same_outcome(jeng, jfin, teng, tfin):
    assert [f.uid for f in tfin] == [f.uid for f in jfin]
    for t, j in zip(tfin, jfin):
        assert t.tokens == j.tokens, f"request {t.uid} stream differs"
        assert _error_head(t.error) == _error_head(j.error), t.uid
        assert (t.preemptions, t.priority, t.slot, t.admitted_step,
                t.finished_step) == (j.preemptions, j.priority, j.slot,
                                     j.admitted_step, j.finished_step), t.uid
    for key in COUNTS:
        assert teng.stats[key] == jeng.stats[key], key
    if jeng.chaos is not None:
        assert teng.chaos.counts == jeng.chaos.counts
        assert teng.metrics["chaos"] == teng.chaos.counts
    teng.allocator.check_conservation([])
    assert len(teng.host_store) == 0


def test_transient_chaos_absorbed_bit_identical(built):
    """Alloc denial + one step failure + one restore failure, all within
    the retry bounds: every request finishes with the chaos-free tokens."""
    per_slot = -(-(20 + 8) // BS)
    trace = _trace(5, [(i, 10 + 3 * i, 5, {}) for i in range(4)]
                   + [(9, 9, 3, dict(priority=2, arrival_step=5))])
    kw = _ecfg(2, per_slot)
    clean = _engine(built, t_engine, kw)
    want = {f.uid: f.tokens for f in clean.run(_requests(t_engine, trace))}
    teng, tfin = _serve_both(built, kw, trace, dict(
        deny_alloc_steps=(0,), fail_steps=(3,), fail_restore_steps=(7,)))
    assert teng.chaos.counts == {"alloc_denied": 1, "step_failed": 1,
                                 "restore_failed": 1}
    assert (teng.stats["alloc_denials"], teng.stats["step_failures"],
            teng.stats["restore_failures"], teng.stats["aborts"]) == (1, 1, 1, 0)
    assert teng.stats["preemptions"] == teng.stats["restores"] == 1
    assert all(f.error is None for f in tfin)
    assert {f.uid: f.tokens for f in tfin} == want, "chaos changed outputs"


def test_persistent_step_failure_degrades_not_crashes(built):
    """A step fault outlasting the retry bound aborts the lowest-priority
    active request; the higher-priority one still completes."""
    per_slot = -(-(20 + 8) // BS)
    teng, tfin = _serve_both(
        built, _ecfg(2, per_slot),
        _trace(7, [(0, 10, 6, dict(priority=0)), (1, 11, 6, dict(priority=1))]),
        dict(fail_steps=(2,), step_repeats=4))
    errs = {f.uid: f.error for f in tfin}
    assert errs[0] is not None and "step failed" in errs[0]
    assert errs[1] is None and len(tfin[1].tokens) == 6
    assert teng.stats["aborts"] == 1 and teng.stats["step_failures"] == 4


def test_total_step_failure_every_request_terminates(built):
    per_slot = -(-(20 + 8) // BS)
    teng, tfin = _serve_both(
        built, _ecfg(2, per_slot), _trace(9, [(i, 10, 6, {}) for i in range(2)]),
        dict(fail_steps=(2,), step_repeats=10_000))
    assert len(tfin) == 2 and all(f.error is not None for f in tfin)


def test_restore_failure_retries_then_aborts(built):
    """Persistent restore faults: the fresh pages are freed on every
    attempt, and the offloaded request is aborted after
    max_restore_retries with its snapshot dropped."""
    per_slot = -(-(20 + 8) // BS)
    teng, tfin = _serve_both(
        built, _ecfg(1, per_slot, max_restore_retries=2),
        _trace(11, [(0, 20, 8, dict(priority=0)),
                    (1, 13, 4, dict(priority=1, arrival_step=4))]),
        dict(fail_restore_steps=tuple(range(40))))
    errs = {f.uid: f.error for f in tfin}
    assert errs[1] is None
    assert errs[0] is not None and "restore failed" in errs[0]
    assert teng.stats["restore_failures"] == 3
    assert teng.stats["preemptions"] == 1 and teng.stats["restores"] == 0


@pytest.mark.parametrize("scheduler", ["slo", "fcfs"])
def test_load_shedding_bounds_waiting_queue(built, scheduler):
    """max_waiting: overflow sheds the lowest-priority (FCFS: the newest)
    waiting request as a failed FinishedRequest; every request ends."""
    per_slot = -(-(8 + 3) // BS)
    teng, tfin = _serve_both(
        built, _ecfg(1, per_slot, max_waiting=1, scheduler=scheduler),
        _trace(13, [(i, 8, 3, dict(priority=i % 2)) for i in range(4)]))
    shed = [f for f in tfin if f.error and f.error.startswith("shed")]
    assert len(tfin) == 4 and shed and teng.stats["shed"] == len(shed)
    if scheduler == "slo":
        assert all(f.priority == 0 for f in shed)
    assert all(f.slot == -1 and not f.tokens for f in shed)
    assert all(len(f.tokens) == 3 for f in tfin if f.error is None)


def test_alloc_denial_is_transient_not_preemption(built):
    per_slot = -(-(10 + 4) // BS)
    teng, tfin = _serve_both(
        built, _ecfg(2, per_slot),
        _trace(17, [(0, 10, 4, dict(priority=0)), (1, 10, 4, dict(priority=5))]),
        dict(deny_alloc_steps=(0, 1)))
    assert all(f.error is None for f in tfin)
    assert teng.stats["preemptions"] == 0 and teng.stats["alloc_denials"] == 2
    assert min(f.admitted_step for f in tfin) >= 2


def test_engine_stalled_error_names_requests(built):
    """The stall error names waiting and preempted uids as the reference's
    does, and the cap is relative to each run."""
    per_slot = -(-(8 + 3) // BS)
    kw = _ecfg(1, per_slot)
    trace = _trace(19, [(42, 8, 3, dict(arrival_step=10**9)), (43, 8, 3, {}),
                        (7, 8, 3, {})])
    msgs = []
    for mod in (j_engine, t_engine):
        eng = _engine(built, mod, kw)
        reqs = _requests(mod, trace)
        eng.submit(reqs[0])
        with pytest.raises(mod.EngineStalledError,
                           match=r"waiting uids \[42\], preempted uids \[\]") as e:
            eng.run(max_steps=5)
        msgs.append(str(e.value))
        eng.waiting.clear()
        fin = eng.run([reqs[1]], max_steps=50)
        assert [f.uid for f in fin if f.error is None] == [43]
        # A preempted request that can never be restored is named too.
        stuck = _engine(built, mod, kw, dict(deny_alloc_steps=tuple(range(1, 99))))
        stuck.submit(reqs[2])
        stuck.step()
        stuck.preempt(0)
        with pytest.raises(mod.EngineStalledError) as e:
            stuck.run(max_steps=5)
        assert e.value.preempted == [7] and e.value.running == []
        msgs.append(str(e.value))
    assert msgs[:2] == msgs[2:]


def test_straggler_monitor_wired_into_step_loop(built):
    """With a hair-trigger threshold every working step after the warm-up
    is flagged into stats and metrics (as in the reference)."""
    per_slot = -(-(13 + 6) // BS)
    kw = _ecfg(1, per_slot, straggler_threshold=1e-9)
    trace = _trace(23, [(0, 13, 6, {})])
    counts = []
    for mod in (j_engine, t_engine):
        eng = _engine(built, mod, kw)
        eng.run(_requests(mod, trace))
        assert eng.monitor.ema is not None and eng.monitor.ema > 0
        assert eng.stats["straggler_steps"] == len(eng.monitor.flagged) > 0
        assert eng.metrics["straggler_steps"] == list(eng.monitor.flagged)
        counts.append((eng.monitor.count, eng.stats["straggler_steps"]))
    assert counts[0] == counts[1]
    eng.reset_metrics()
    assert eng.metrics["straggler_steps"] == [] and eng.monitor.ema > 0
    assert not any(eng.stats.values()) and eng.finished == []


def test_straggler_monitor_matches_reference():
    """The same step times flag the same steps and give the same EMA."""
    times = [1.0, 1.1, 0.9, 1.0, 5.0, 1.0, 0.2, 4.0, 1.0]
    mons = [m.StragglerMonitor(threshold=2.5, warmup_steps=3)
            for m in (j_straggler, t_straggler)]
    for m in mons:
        for step, dt in enumerate(times):
            m.observe(step, dt)
    assert mons[0].flagged == mons[1].flagged == [(4, 5.0, mons[1].flagged[0][2]),
                                                  (7, 4.0, mons[1].flagged[1][2])]
    assert mons[0].ema == mons[1].ema
    with pytest.raises(RuntimeError):
        t_straggler.StragglerMonitor().stop(0)


@pytest.mark.parametrize("mod", [j_ft, t_ft], ids=["reference", "port"])
def test_failure_injector_repeats(mod):
    inj = mod.FailureInjector((3,), repeats=2)
    assert not inj.should_fail(2)
    assert inj.should_fail(3) and inj.should_fail(3)
    assert not inj.should_fail(3)
    assert inj.fired == 2
    with pytest.raises(mod.InjectedFailure, match="step 1"):
        mod.FailureInjector((1,)).maybe_fail(1)


def test_chaos_injector_counts():
    plan = dict(deny_alloc_steps=(0,), fail_steps=(1,), fail_restore_steps=(2,))
    for mod, ft in ((j_chaos, j_ft), (t_chaos, t_ft)):
        chaos = mod.ChaosInjector(mod.ChaosConfig(**plan))
        assert chaos.deny_alloc(0) and not chaos.deny_alloc(0)
        with pytest.raises(ft.InjectedFailure, match="step failure"):
            chaos.maybe_fail_step(1)
        chaos.maybe_fail_step(5)            # a step not in the plan: no-op
        with pytest.raises(ft.InjectedFailure, match="restore failure"):
            chaos.maybe_fail_restore(2)
        assert chaos.counts == {"alloc_denied": 1, "step_failed": 1,
                                "restore_failed": 1}


def test_admission_control_rejects_infeasible_ttft(built):
    """At a set step-time EMA (10 s a step), a request whose TTFT SLO is
    infeasible is rejected up front with no pages allocated; the same
    request runs with the flag off, or without a TTFT SLO."""
    per_slot = -(-(20 + 8) // BS)
    kw = _ecfg(2, per_slot, admission_control=True)
    slo = _trace(41, [(0, 13, 4, dict(ttft_slo_s=0.05))])
    teng, tfin = _serve_both(built, kw, slo, ema=10.0)
    assert tfin[0].error.startswith("rejected: TTFT SLO 50.0 ms infeasible")
    assert tfin[0].tokens == [] and teng.stats["admission_rejects"] == 1
    assert teng.allocator.available == kw["num_pages"] - 1
    off, fin_off = _serve_both(built, dict(kw, admission_control=False), slo,
                               ema=10.0)
    assert fin_off[0].error is None and len(fin_off[0].tokens) == 4
    no_slo = _trace(41, [(0, 13, 4, {})])
    _, fin2 = _serve_both(built, kw, no_slo, ema=10.0)
    assert fin2[0].error is None and len(fin2[0].tokens) == 4


def test_failed_step_leaves_pools_untouched(built):
    """The port writes its pools in place, so a step that fails must fail
    before its first write: after each step, the pools of an engine whose
    decode step 3 fails twice (retried within the bound) equal a clean
    engine's bitwise (a summary increment applied twice would show in kg)."""
    from repro_torch.runtime import offload as t_offload
    per_slot = -(-(13 + 6) // BS)
    trace = _trace(43, [(0, 13, 6, {})])
    clean = _engine(built, t_engine, _ecfg(1, per_slot))
    faulty = _engine(built, t_engine, _ecfg(1, per_slot),
                     dict(fail_steps=(3,), step_repeats=2))
    for eng in (clean, faulty):
        eng.submit(_requests(t_engine, trace)[0])
    for _ in range(5):
        clean.step()
        faulty.step()
        for a, b in zip(t_offload.leaves(clean.pools), t_offload.leaves(faulty.pools)):
            assert torch.equal(a, b)
    assert faulty.stats["step_failures"] == 2 and faulty.stats["aborts"] == 0
    assert clean.slots[0].tokens == faulty.slots[0].tokens
