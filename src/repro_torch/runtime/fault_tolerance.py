"""Failure injection and restart-from-checkpoint orchestration (port of
``repro/runtime/fault_tolerance.py``): ``FailureInjector`` raises at
configured steps; ``run_with_restarts`` wraps a training function that
restores from its latest checkpoint on entry and may die at any step, and
restarts it, with the checkpoint manager and the seekable data pipeline
making the continuation bit-identical."""
from __future__ import annotations

from typing import Callable, Optional


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


def run_with_restarts(train_fn: Callable[[], object], max_restarts: int = 3,
                      on_restart: Optional[Callable[[int, Exception], None]] = None):
    """Run ``train_fn`` to completion, restarting it after an
    ``InjectedFailure``, at most ``max_restarts`` times (the single-process
    analogue of a cluster controller rescheduling a failed job).

    ``train_fn`` must be restart-safe: it restores state from its checkpoint
    manager at entry.  Returns train_fn's result."""
    attempt = 0
    while True:
        try:
            return train_fn()
        except InjectedFailure as e:   # noqa: PERF203
            attempt += 1
            if attempt > max_restarts:
                raise
            if on_restart:
                on_restart(attempt, e)
