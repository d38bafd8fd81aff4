"""Deterministic synthetic batches (numpy; the trainer moves them to the
card)."""
from repro_torch.data.synthetic import batch_specs, make_batch  # noqa: F401
