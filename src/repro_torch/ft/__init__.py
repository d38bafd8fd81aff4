"""Fault tolerance: the step watchdog, fleet heartbeats, the restart
driver, deterministic fault injection and the fleet coordinator."""
from repro_torch.ft.watchdog import Heartbeats, StepWatchdog  # noqa: F401
from repro_torch.ft.restart import run_with_restarts  # noqa: F401
from repro_torch.ft.chaos import ChaosEvent, ChaosMonkey  # noqa: F401
from repro_torch.ft.coordinator import FleetCoordinator, FleetStatus  # noqa: F401
