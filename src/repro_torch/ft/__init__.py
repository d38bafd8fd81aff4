"""Fault tolerance: the step watchdog the train CLI uses."""
from repro_torch.ft.watchdog import StepWatchdog  # noqa: F401
