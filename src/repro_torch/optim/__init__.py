"""Functional optimizers on stacked leaves (state trees mirror the
parameter tree and its sharding)."""
from repro_torch.optim.optimizers import (adafactor_init,  # noqa: F401
                                          adafactor_update, adamw_init,
                                          adamw_update, get_optimizer,
                                          lr_schedule, state_specs)
