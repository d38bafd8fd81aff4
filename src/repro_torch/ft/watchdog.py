"""Straggler / hang detection for the training loop.

``StepWatchdog`` tracks a robust running median of step wall-times; a
step slower than ``ratio`` x the median flags a straggler event, and
``hang_timeout`` arms a background timer that fires ``on_hang`` if a step
never completes (a collective deadlock after a peer died).  The JAX
package's copy (``repro/ft/watchdog.py``) also holds the fleet-level
``Heartbeats``, which comes with the rest of ``ft/``.
"""
from __future__ import annotations

import statistics
import threading
import time


class StepWatchdog:
    def __init__(self, *, ratio: float = 3.0, window: int = 32,
                 hang_timeout: float | None = None, on_hang=None):
        self.ratio = ratio
        self.window = window
        self.hang_timeout = hang_timeout
        self.on_hang = on_hang or (lambda: None)
        self.times: list[float] = []
        self.straggler_steps: list[int] = []
        self._step = 0
        self._t0: float | None = None
        self._timer: threading.Timer | None = None

    # -- per-step protocol ---------------------------------------------------
    def start_step(self):
        self._t0 = time.perf_counter()
        if self.hang_timeout is not None:
            self._timer = threading.Timer(self.hang_timeout, self.on_hang)
            self._timer.daemon = True
            self._timer.start()

    def end_step(self) -> bool:
        """Returns True if this step was a straggler."""
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        dt = time.perf_counter() - self._t0
        straggler = False
        if len(self.times) >= 5:
            med = statistics.median(self.times[-self.window:])
            straggler = dt > self.ratio * med
        if straggler:
            self.straggler_steps.append(self._step)
        self.times.append(dt)
        self._step += 1
        return straggler

    @property
    def median(self) -> float:
        return statistics.median(self.times) if self.times else 0.0
