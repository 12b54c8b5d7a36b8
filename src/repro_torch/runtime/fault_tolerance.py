"""Failure injection (port of ``InjectedFailure`` and ``FailureInjector``
from ``repro/runtime/fault_tolerance.py``).  The training path's restart
harness, ``run_with_restarts``, arrives with the training port."""
from __future__ import annotations


class InjectedFailure(RuntimeError):
    pass


class FailureInjector:
    """Raises at configured steps — ``repeats`` times per step (default
    once: the retried pass sails through cleanly, like a real transient
    node failure; ``repeats > 1`` models a persistent fault that outlives
    bounded retry).  The serving-side chaos harness (``runtime/chaos.py``)
    composes several of these, one per injection channel (allocator, step,
    restore)."""

    def __init__(self, fail_at_steps: tuple = (), repeats: int = 1):
        self.remaining = {s: repeats for s in fail_at_steps}
        self.fired = 0

    def should_fail(self, step: int) -> bool:
        """Consume one configured failure at ``step`` if any remain."""
        if self.remaining.get(step, 0) > 0:
            self.remaining[step] -= 1
            self.fired += 1
            return True
        return False

    def maybe_fail(self, step: int) -> None:
        if self.should_fail(step):
            raise InjectedFailure(f"injected node failure at step {step}")
