"""Checkpoints in the JAX package's layout (``arrays.npz`` of global
arrays + ``manifest.json``), so either package restores the other's."""
from repro_torch.ckpt.checkpoint import (AsyncCheckpointer,  # noqa: F401
                                         latest_step, manifest, restore,
                                         save)
