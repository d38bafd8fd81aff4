"""The training step on the stacked axis and its host-side loop."""
from repro_torch.train.trainer import Trainer, make_step_fns  # noqa: F401
