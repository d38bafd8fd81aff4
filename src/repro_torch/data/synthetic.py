"""Deterministic synthetic data pipeline, as numpy.

Every (step, arch, shape) produces the same batch: each process could
generate only its shard (seeded by (step, shard_index)) with no I/O.
Token streams are Zipf-ish, structured enough that the loss decreases.

The seed rule is the JAX package's (``repro/data/synthetic.py``), which
seeds from ``hash(cfg.name)``: Python salts string hashes per process
(``PYTHONHASHSEED``), so one process gives the JAX package's batch and
another process gives a different one.  Kept for parity (ROADMAP.md,
recorded reference differences).
"""
from __future__ import annotations

import numpy as np

from repro_torch.models.config import ModelConfig


def batch_specs(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """``(shape, dtype name)`` of each array of one global batch."""
    specs = {"tokens": ((batch, seq), "int32"),
             "labels": ((batch, seq), "int32")}
    if cfg.encdec is not None:
        specs["frames"] = ((batch, seq, cfg.d_model), "bfloat16")
        dec = max(seq // cfg.encdec.dec_ratio, 16)
        specs["tokens"] = ((batch, dec), "int32")
        specs["labels"] = ((batch, dec), "int32")
    if cfg.vlm is not None:
        specs["patches"] = ((batch, cfg.vlm.n_patches, cfg.vlm.patch_dim),
                            "bfloat16")
        txt = max(seq - cfg.vlm.n_patches, 16)
        specs["tokens"] = ((batch, txt), "int32")
        specs["labels"] = ((batch, txt), "int32")
    return specs


def make_batch(cfg: ModelConfig, batch: int, seq: int, step: int,
               *, shard: int = 0, n_shards: int = 1) -> dict:
    """Host-side numpy batch (the given shard slice of the global batch)."""
    if batch % n_shards:
        raise ValueError(f"batch {batch} does not split into {n_shards} "
                         "shards")
    b_loc = batch // n_shards
    rng = np.random.default_rng((hash(cfg.name) & 0xFFFF, step, shard))
    specs = batch_specs(cfg, batch, seq)
    t_shape = (b_loc,) + specs["tokens"][0][1:]
    # Zipf-distributed ids with per-sequence offset => learnable structure
    base = rng.zipf(1.3, size=t_shape).astype(np.int64)
    offs = rng.integers(0, 97, size=(b_loc, 1))
    toks = ((base + offs) % cfg.vocab_size).astype(np.int32)
    out = {"tokens": toks, "labels": toks.copy()}
    if cfg.encdec is not None:
        out["frames"] = rng.standard_normal(
            (b_loc, seq, cfg.d_model), dtype=np.float32)
    if cfg.vlm is not None:
        out["patches"] = rng.standard_normal(
            (b_loc, cfg.vlm.n_patches, cfg.vlm.patch_dim), dtype=np.float32)
    return out
