"""Engine-level fault injection: the serving-side chaos harness (port of
``repro/runtime/chaos.py``).

Three failure modes, each injectable at configured *engine* steps:

  * **allocator exhaustion** (``deny_alloc_steps``) — an allocation that
    should succeed reports no memory.  The engine treats it exactly like a
    genuinely full pool: the admission blocks and retries next step;
    nothing leaks, nothing is preempted.
  * **step failure** (``fail_steps``) — the mixed step raises *before*
    any pool write (the port updates its pools in place, so a failure
    after the first write could not be retried soundly).  Transient by
    default; ``step_repeats`` above the engine's retry bound models a
    persistent fault, which the engine degrades through by aborting its
    lowest-priority active request and retrying with the smaller batch.
  * **restore failure** (``fail_restore_steps``) — re-admitting an
    offloaded request fails before its snapshot is scattered.  The engine
    frees the freshly allocated pages, keeps the host snapshot, and either
    retries later or aborts the request with an explicit error.

Every injection is deterministic (configured steps, no RNG), and
``counts`` records what fired.
"""
from __future__ import annotations

import dataclasses

from repro_torch.runtime.fault_tolerance import FailureInjector, InjectedFailure


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Deterministic injection plan, in engine-step coordinates."""
    deny_alloc_steps: tuple = ()     # page allocations forced to fail
    fail_steps: tuple = ()           # mixed steps that raise before any write
    fail_restore_steps: tuple = ()   # offload restores that raise
    step_repeats: int = 1            # consecutive failures per fail_step
    restore_repeats: int = 1         # consecutive failures per restore step


# The serving CLI's ``--chaos`` plan (the reference's): one denied
# allocation, one transient step failure, one failed restore.
CLI_PLAN = ChaosConfig(deny_alloc_steps=(2,), fail_steps=(4,),
                       fail_restore_steps=(7,))


class ChaosInjector:
    """Per-channel failure injectors + fired counters for one engine."""

    def __init__(self, cfg: ChaosConfig = ChaosConfig()):
        self.cfg = cfg
        self._alloc = FailureInjector(tuple(cfg.deny_alloc_steps))
        self._step = FailureInjector(tuple(cfg.fail_steps),
                                     repeats=cfg.step_repeats)
        self._restore = FailureInjector(tuple(cfg.fail_restore_steps),
                                        repeats=cfg.restore_repeats)

    @property
    def counts(self) -> dict:
        return {"alloc_denied": self._alloc.fired,
                "step_failed": self._step.fired,
                "restore_failed": self._restore.fired}

    def deny_alloc(self, step: int) -> bool:
        """True when this step's page allocation must report exhaustion."""
        return self._alloc.should_fail(step)

    def maybe_fail_step(self, step: int) -> None:
        """Raise ``InjectedFailure`` ahead of the mixed step's pool writes."""
        if self._step.should_fail(step):
            raise InjectedFailure(f"injected step failure at engine step {step}")

    def maybe_fail_restore(self, step: int) -> None:
        """Raise ``InjectedFailure`` before an offloaded request's scatter."""
        if self._restore.should_fail(step):
            raise InjectedFailure(
                f"injected restore failure at engine step {step}")
