"""Straggler / hang / liveness detection.

``StepWatchdog`` tracks a robust running median of step wall-times; a
step slower than ``ratio`` x the median flags a straggler event, and
``hang_timeout`` arms a background timer that fires ``on_hang`` if a step
never completes (a collective deadlock after a peer died).

``Heartbeats`` is the fleet-level counterpart: passive liveness from
periodic beats (``ft.coordinator`` beats a server whenever its shard
output advances), with an injectable clock so death detection is
deterministic in tests.
"""
from __future__ import annotations

import statistics
import threading
import time


class Heartbeats:
    """Last-beat liveness tracking over named peers.

    ``beat(name)`` stamps a peer at the current clock; ``dead()`` lists
    peers whose last beat is older than ``timeout``.  The clock is
    injectable (any zero-arg callable returning seconds) because real
    wall clocks make death detection a flake: a test advances a
    fake clock by exact amounts and asserts exactly which server died.
    A beat can carry the peer's current ``epoch`` so epoch-lag
    stragglers fall out of the same bookkeeping.
    """

    def __init__(self, *, timeout: float, clock=time.monotonic):
        self.timeout = float(timeout)
        self._clock = clock
        self._last: dict[str, float] = {}
        self._epoch: dict[str, int] = {}

    def beat(self, name: str, *, epoch: int | None = None) -> None:
        self._last[name] = float(self._clock())
        if epoch is not None:
            self._epoch[name] = int(epoch)

    def seen(self) -> list[str]:
        return sorted(self._last)

    def epoch_of(self, name: str) -> int | None:
        return self._epoch.get(name)

    def dead(self) -> list[str]:
        now = float(self._clock())
        return sorted(n for n, t in self._last.items()
                      if now - t > self.timeout)

    def alive(self) -> list[str]:
        now = float(self._clock())
        return sorted(n for n, t in self._last.items()
                      if now - t <= self.timeout)


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
