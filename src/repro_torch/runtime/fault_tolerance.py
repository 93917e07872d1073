"""Fault tolerance around the train loop, as plain Python: the JAX
package's ``runtime/fault_tolerance.py``.

  * :class:`Supervisor` runs ``body(start_step)`` and, on a failure,
    resumes from the step ``resume_step()`` names (the checkpoint's),
    with bounded retries and exponential backoff;
  * :class:`Watchdog` times each step and flags one slower than
    ``threshold`` x the rolling median of the last ``window`` as a
    straggler; its clock is injectable (default ``time.perf_counter``),
    so it can be tested without sleeping;
  * :class:`FailureInjector` raises at given steps, once each, so the
    restart path can be driven on purpose.
"""
from __future__ import annotations

import logging
import time
from collections import deque
from typing import Callable, Optional

log = logging.getLogger("repro_torch.runtime")


class Watchdog:
    def __init__(self, threshold: float = 2.0, window: int = 32,
                 clock: Callable[[], float] = time.perf_counter):
        self.threshold = threshold
        self.times = deque(maxlen=window)
        self.incidents = []
        self.clock = clock
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = self.clock()

    def stop(self, step: int) -> bool:
        """Returns True if this step was a straggler."""
        dt = self.clock() - self._t0
        straggler = False
        if len(self.times) >= 8:
            med = sorted(self.times)[len(self.times) // 2]
            if dt > self.threshold * med:
                straggler = True
                self.incidents.append((step, dt, med))
                log.warning("straggler: step %d took %.3fs (median %.3fs)",
                            step, dt, med)
        self.times.append(dt)
        return straggler


class Supervisor:
    """Run ``body(start_step) -> last_step`` with restart-on-failure."""

    def __init__(self, max_restarts: int = 3, backoff: float = 0.1):
        self.max_restarts = max_restarts
        self.backoff = backoff
        self.restarts = 0

    def run(self, body: Callable[[int], int], resume_step: Callable[[], int]):
        while True:
            start = resume_step()
            try:
                return body(start)
            except Exception as e:  # noqa: BLE001 — any node fault
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                log.warning("restart %d/%d after failure at step>=%d: %r",
                            self.restarts, self.max_restarts, start, e)
                time.sleep(self.backoff * 2 ** (self.restarts - 1))


class FailureInjector:
    """Deterministic fault injection for tests: raise at given steps."""

    def __init__(self, fail_at=()):
        self.fail_at = set(fail_at)
        self.fired = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected node failure at step {step}")
