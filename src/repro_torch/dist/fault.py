"""Fault tolerance primitives: injected failures, straggler detection, and
the checkpoint-restart loop.

A stdlib copy of the reference's ``repro/dist/fault.py``: they wrap the
host-side training and serving loops, not the step, so they compose with
any family's step function.
"""
from __future__ import annotations

import statistics
import time
from collections import deque
from typing import Callable


class InjectedFailure(RuntimeError):
    """Raised by FailureInjector.check at the armed step."""


class FailureInjector:
    """Deterministically crash the training loop once at ``fail_at_step`` —
    the restart path must then restore from checkpoint and replay to an
    identical final state."""

    def __init__(self, fail_at_step: int):
        self.fail_at_step = fail_at_step
        self.fired = False

    def check(self, step: int) -> None:
        if not self.fired and step == self.fail_at_step:
            self.fired = True
            raise InjectedFailure(f"injected failure at step {step}")


class StragglerWatchdog:
    """Flags steps whose wall time exceeds ``factor`` x the running median.

    ``observe(step, seconds)`` returns True (and records the step in
    ``events`` / fires ``on_straggler(step, seconds, median)``) when the step
    is a straggler. Straggler times are excluded from the history so one slow
    step doesn't inflate the baseline.
    """

    def __init__(self, factor: float = 3.0, window: int = 64,
                 min_history: int = 5,
                 on_straggler: Callable[[int, float, float], None] | None = None,
                 metrics=None):
        self.factor = factor
        self.min_history = min_history
        self.on_straggler = on_straggler
        self.history: deque[float] = deque(maxlen=window)
        self.events: list[int] = []
        if metrics is None:
            from repro_torch.obs.metrics import MetricRegistry
            metrics = MetricRegistry()
        self._m_events = metrics.counter("fault.straggler_events_total",
                                         "steps flagged as stragglers")

    def observe(self, step: int, seconds: float) -> bool:
        straggler = False
        if len(self.history) >= self.min_history:
            med = statistics.median(self.history)
            if seconds > self.factor * med:
                straggler = True
                self.events.append(step)
                self._m_events.inc()
                if self.on_straggler is not None:
                    self.on_straggler(step, seconds, med)
        if not straggler:
            self.history.append(seconds)
        return straggler


def backoff_schedule(max_restarts: int, *, base: float = 0.05,
                     factor: float = 2.0, cap: float = 5.0) -> list[float]:
    """The deterministic (jitterless) delay before each restart:
    ``min(base * factor**n, cap)`` for restart n — testable by inspection."""
    return [min(base * factor ** n, cap) for n in range(max_restarts)]


def run_with_restarts(loop: Callable[[int], int], *,
                      restore_step: Callable[[], int],
                      max_restarts: int = 8,
                      retryable: tuple = (Exception,),
                      base_backoff: float = 0.05,
                      backoff_factor: float = 2.0,
                      max_backoff: float = 5.0,
                      sleep: Callable[[float], None] = time.sleep) -> int:
    """Run ``loop(start_step)`` to completion, restarting from
    ``restore_step()`` (the latest durable checkpoint) after each crash.

    Only exceptions matching ``retryable`` are retried — anything else
    (assertion failures, keyboard interrupts, OOMs you have classified as
    fatal) re-raises immediately, so a deterministic bug is never retried
    into the restart budget. Each restart waits a deterministic exponential
    backoff (``min(base * factor**n, cap)``, no jitter — replayable in
    tests; ``sleep`` is injectable for the same reason). Returns the loop's
    final return value; re-raises once the restart budget is exhausted.
    """
    delays = backoff_schedule(max_restarts, base=base_backoff,
                              factor=backoff_factor, cap=max_backoff)
    attempt = 0
    while True:
        try:
            return loop(restore_step())
        except retryable:
            attempt += 1
            if attempt > max_restarts:
                raise
            sleep(delays[attempt - 1])
