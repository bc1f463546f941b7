"""Fault-tolerance utilities: preemption handling + straggler watchdog.

* `PreemptionGuard` — installs SIGTERM/SIGINT handlers; the train loop polls
  `should_stop` and checkpoints before exiting (graceful preemption — the
  standard TPU-pod eviction contract).
* `StragglerWatchdog` — tracks per-step wall times; a step slower than
  `threshold ×` the running median is logged as a straggler event, and a
  callback (e.g. "checkpoint now + request reschedule") can be attached.
  On a real fleet this is fed per-host; here it watches the single process
  but keeps the fleet-shaped API.
"""
from __future__ import annotations

import signal
import statistics
import time
from typing import Callable


class PreemptionGuard:
    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._stop = False
        self._prev = {}
        for s in signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:        # non-main thread (tests)
                pass

    def _handler(self, signum, frame):
        self._stop = True

    @property
    def should_stop(self) -> bool:
        return self._stop

    def restore(self):
        for s, h in self._prev.items():
            signal.signal(s, h)


class StragglerWatchdog:
    def __init__(self, threshold: float = 2.5, window: int = 50,
                 on_straggler: Callable[[int, float, float], None] | None = None):
        self.threshold = threshold
        self.window = window
        self.on_straggler = on_straggler
        self.times: list[float] = []
        self.events: list[tuple[int, float, float]] = []
        self._t0: float | None = None

    def step_start(self):
        self._t0 = time.perf_counter()

    def step_end(self, step: int) -> float:
        dt = time.perf_counter() - self._t0
        med = statistics.median(self.times) if self.times else dt
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        if len(self.times) >= 5 and dt > self.threshold * med:
            self.events.append((step, dt, med))
            if self.on_straggler:
                self.on_straggler(step, dt, med)
        return dt
