"""Fleet coordinator: retune on DRIFT and FAILURE, not on a schedule.

A loop that retunes every fixed number of steps is wrong in the field: a
calm fleet re-publishes identical profiles forever (wasted tuning and
manifest churn), while a drifting fleet waits out the schedule serving a
stale plan.  The coordinator watches what the fleet actually reports and
acts when it diverges.

``FleetCoordinator.scan()`` is one poll cycle over the shard directory:

* **Liveness** — a server beats its heartbeat whenever its newest shard
  epoch advances (a crashed server simply stops producing shards, which
  is exactly what a real crash leaves behind).  Silence past
  ``heartbeat_timeout`` marks it dead; the injectable clock makes
  death assertions exact, not timing-dependent.
* **Stragglers** — a live server whose newest shard lags the fleet's
  newest epoch by more than ``straggler_epochs`` generations.
* **Drift** — merge the shards (quarantine accounting via
  ``Trace.merge_shards``; a quarantined shard's ``#@lat`` measurements
  are not trusted either) and price the merged workload under the LIVE
  stores twice: once on the base (modeled) backend and once on a
  ``FeedbackBackend`` over the fleet's own latency observations.  Their
  ratio is how wrong the live epoch's model is about current hardware/
  load; outside ``[1/drift_threshold, drift_threshold]`` the scan
  recommends a retune.

``scan`` only OBSERVES and recommends (``FleetStatus.retune``); the
serving harness owns the actual tune/publish/poll cycle, so the
coordinator stays safe to run anywhere — including dry in a test.
"""
from __future__ import annotations

import dataclasses
import pathlib
import time
import warnings

from repro_torch.core import trace as trace_mod
from repro_torch.core.trace import Trace, load_shard_latencies
from repro_torch.core.tuner import FeedbackBackend, estimate_trace_cost
from repro_torch.ft.watchdog import Heartbeats


@dataclasses.dataclass
class FleetStatus:
    """One ``scan``'s verdict on the fleet."""
    fleet_epoch: int                 # newest shard epoch seen (-1: none)
    alive: list[str]
    dead: list[str]
    stragglers: list[str]
    drift: float | None              # observed/modeled cost ratio
    quarantined: int                 # shards excluded by the merge
    retune: bool
    reasons: list[str]

    def summary(self) -> str:
        head = (f"fleet e{self.fleet_epoch}: {len(self.alive)} alive, "
                f"{len(self.dead)} dead, {len(self.stragglers)} "
                f"straggling, drift "
                f"{'n/a' if self.drift is None else f'{self.drift:.2f}x'}")
        if self.retune:
            head += " -> RETUNE (" + "; ".join(self.reasons) + ")"
        return head


class FleetCoordinator:
    """Watches a fleet's shard directory; recommends retunes.

    ``backend`` (required) is the modeled (base) tuner backend drift is
    judged against: a ``CostModelBackend`` on a ``Topo`` fit on this
    hardware, or a ``MeasuredBackend``.  ``ref`` is the live ``StoreRef``
    whose stores price the merged workload.  ``clock`` feeds the
    heartbeat bookkeeping — pass a fake for determinism.
    """

    def __init__(self, shard_dir, ref, *, backend,
                 heartbeat_timeout: float = 60.0,
                 straggler_epochs: int = 1,
                 drift_threshold: float = 1.5,
                 min_observed: int = 1,
                 clock=time.monotonic):
        if backend is None:
            raise ValueError("FleetCoordinator needs an explicit backend "
                             "(a CostModelBackend on a fitted Topo, or a "
                             "MeasuredBackend)")
        self.shard_dir = pathlib.Path(shard_dir)
        self.ref = ref
        self.backend = backend
        self.straggler_epochs = int(straggler_epochs)
        self.drift_threshold = float(drift_threshold)
        self.min_observed = int(min_observed)
        self.heartbeats = Heartbeats(timeout=heartbeat_timeout, clock=clock)
        self._newest: dict[str, int] = {}    # server -> newest shard epoch

    # -- one poll cycle ------------------------------------------------------
    def scan(self) -> FleetStatus:
        fleet_epoch = self._scan_liveness()
        dead = self.heartbeats.dead()
        alive = self.heartbeats.alive()
        stragglers = sorted(
            s for s in alive
            if self._newest.get(s, -1)
            < fleet_epoch - self.straggler_epochs)
        drift, quarantined = self._scan_drift()
        reasons = []
        if dead:
            reasons.append(f"server(s) dead: {', '.join(dead)}")
        if drift is not None and (
                drift > self.drift_threshold
                or drift < 1.0 / self.drift_threshold):
            reasons.append(f"cost drift {drift:.2f}x outside "
                           f"[{1.0 / self.drift_threshold:.2f}, "
                           f"{self.drift_threshold:.2f}]")
        return FleetStatus(fleet_epoch=fleet_epoch, alive=alive, dead=dead,
                           stragglers=stragglers, drift=drift,
                           quarantined=quarantined,
                           retune=bool(reasons), reasons=reasons)

    # -- internals -----------------------------------------------------------
    def _scan_liveness(self) -> int:
        """Beat every server whose newest shard epoch advanced; the
        fleet epoch is the max over all shards ever seen."""
        fleet_epoch = -1
        newest: dict[str, int] = {}
        if self.shard_dir.is_dir():
            for p in sorted(self.shard_dir.glob("shard-*.jsonl")):
                parts = trace_mod._shard_name_parts(p.name)
                if parts is None:
                    continue
                server, epoch = parts
                newest[server] = max(newest.get(server, -1), epoch)
                fleet_epoch = max(fleet_epoch, epoch)
        for server, epoch in newest.items():
            if epoch > self._newest.get(server, -1):
                self.heartbeats.beat(server, epoch=epoch)
                self._newest[server] = epoch
        return fleet_epoch

    def _scan_drift(self) -> tuple[float | None, int]:
        """Observed-vs-modeled cost ratio of the merged shard workload
        under the LIVE stores (None: nothing merged, no observations,
        or no modeled cost to compare against)."""
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # scan is periodic; the
            report = Trace.merge_shards(self.shard_dir)  # merge warns once
            skip = [n.path for n in report.quarantined]
            observed = load_shard_latencies(self.shard_dir, skip=skip)
        quarantined = len(report.quarantined)
        if report.trace.total() == 0:
            return None, quarantined
        n_obs = sum(len(v) for v in observed.values())
        if n_obs < self.min_observed:
            return None, quarantined
        base_backend = self.backend
        fb = FeedbackBackend(base_backend, observed)
        kw = dict(base=self.ref.base, phases=self.ref.phases)
        modeled = sum(estimate_trace_cost(
            report.trace, base_backend, **kw).values())
        obs = sum(estimate_trace_cost(report.trace, fb, **kw).values())
        if modeled <= 0.0:
            return None, quarantined
        return obs / modeled, quarantined
