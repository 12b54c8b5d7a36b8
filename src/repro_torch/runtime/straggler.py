"""Straggler detection: per-step wall-time EMA with outlier flagging (port
of ``repro/runtime/straggler.py``).  The engine times every working step
and counts the flagged ones; the training CLI reports them through
``on_straggler``."""
from __future__ import annotations

import time
from typing import Callable, Optional


class StragglerMonitor:
    def __init__(self, threshold: float = 2.5, ema_decay: float = 0.9,
                 warmup_steps: int = 3,
                 on_straggler: Optional[Callable[[int, float, float], None]] = None):
        self.threshold = threshold
        self.ema_decay = ema_decay
        self.warmup_steps = warmup_steps
        self.on_straggler = on_straggler
        self.ema: Optional[float] = None
        self.count = 0
        self.flagged: list = []          # (step, dt, ema at the time)
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.monotonic()

    def cancel(self) -> None:
        """Discard an in-flight timing (the timed step failed or did no
        work) without polluting the EMA baseline."""
        self._t0 = None

    def stop(self, step: int) -> float:
        if self._t0 is None:
            raise RuntimeError("StragglerMonitor.stop() without start()")
        dt = time.monotonic() - self._t0
        self._t0 = None
        self.observe(step, dt)
        return dt

    def observe(self, step: int, dt: float) -> bool:
        """Feed one step time; returns True if flagged as a straggler."""
        self.count += 1
        is_straggler = False
        if self.ema is not None and self.count > self.warmup_steps:
            if dt > self.threshold * self.ema:
                is_straggler = True
                self.flagged.append((step, dt, self.ema))
                if self.on_straggler:
                    self.on_straggler(step, dt, self.ema)
        # Outliers don't poison the baseline.
        if self.ema is None:
            self.ema = dt
        elif not is_straggler:
            self.ema = self.ema_decay * self.ema + (1 - self.ema_decay) * dt
        return is_straggler
