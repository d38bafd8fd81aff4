"""The sharded "application" layer over the tuned dispatcher: the axis
registry (``dist.axes``) and the model-parallel primitives (``dist.ops``)
whose collectives all go through ``repro_torch.core.api``."""
