"""Checkpointing: atomic save/restore with a manifest, and an async
writer, in the JAX package's layout (``repro/ckpt/checkpoint.py``)::

    ckpt_dir/step_000123/
        manifest.json      # step, flat keys, shapes/dtypes, extra
        arrays.npz         # full (unsharded) arrays, keyed by flat path

The trees saved and restored here are GLOBAL: the trainer joins its
stacked shards back to their global shapes first (``Trainer.to_global``)
and cuts them again after a restore (``Trainer.from_global``), so a
checkpoint does not depend on the layout or the rank count that wrote
it, and either package restores the other's.  Keys are the tree paths
joined by "/"; bfloat16 is stored as its raw uint16 bits (npz has no
bfloat16) and the target tree names the dtype on restore, as in the JAX
package.

Writes are atomic (tmp dir + rename); ``AsyncCheckpointer`` overlaps the
disk write with training (the device->host copy happens synchronously,
the write on a worker thread) and keeps the newest K checkpoints.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading

import numpy as np
import torch

from repro_torch.models.params import tree_paths


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    a = np.asarray(leaf)
    if a.dtype.kind not in "biufc":       # ml_dtypes bfloat16, ...
        a = a.view(f"u{a.dtype.itemsize}")
    return a


def _flatten(tree) -> dict[str, np.ndarray]:
    return {k: _to_numpy(v) for k, v in tree_paths(tree)}


def save(ckpt_dir, step: int, tree, *, extra: dict | None = None,
         keep: int = 3) -> pathlib.Path:
    d = pathlib.Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    tmp = d / f".tmp_step_{step:09d}"
    final = d / f"step_{step:09d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    arrays = _flatten(tree)
    np.savez(tmp / "arrays.npz", **arrays)
    manifest_ = {
        "step": step,
        "keys": sorted(arrays.keys()),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest_, indent=1))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    _gc(d, keep)
    return final


def _gc(d: pathlib.Path, keep: int):
    steps = sorted(p for p in d.glob("step_*") if p.is_dir())
    for p in steps[:-keep]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir) -> int | None:
    d = pathlib.Path(ckpt_dir)
    if not d.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in d.glob("step_*")
                   if p.is_dir())
    return steps[-1] if steps else None


def _dtype(like) -> torch.dtype:
    dt = like.dtype
    return getattr(torch, dt) if isinstance(dt, str) else dt


def restore(ckpt_dir, step: int, like_tree):
    """Restore into the structure of ``like_tree``, whose leaves name a
    shape and a dtype (tensors, or ``ParamSpec``s with their dtype name):
    a tree of CPU tensors.  A leaf whose shape differs raises."""
    d = pathlib.Path(ckpt_dir) / f"step_{step:09d}"
    with np.load(d / "arrays.npz") as data:
        def load(node, prefix):
            if isinstance(node, dict):
                return {k: load(v, prefix + (str(k),))
                        for k, v in node.items()}
            if isinstance(node, list):
                return [load(v, prefix + (str(i),))
                        for i, v in enumerate(node)]
            key = "/".join(prefix)
            arr = data[key]
            if tuple(arr.shape) != tuple(node.shape):
                raise ValueError(f"shape mismatch for {key}: ckpt "
                                 f"{arr.shape} vs target {tuple(node.shape)}")
            tgt = _dtype(node)
            if tgt == torch.bfloat16 and arr.dtype == np.uint16:
                # raw-bits round trip
                return torch.from_numpy(arr.view(np.int16)).view(tgt)
            # ascontiguousarray makes a 0-dim leaf 1-dim: reshape back
            return torch.from_numpy(np.ascontiguousarray(arr)).reshape(
                arr.shape).to(tgt)
        return load(like_tree, ())


def manifest(ckpt_dir, step: int) -> dict:
    d = pathlib.Path(ckpt_dir) / f"step_{step:09d}"
    return json.loads((d / "manifest.json").read_text())


class AsyncCheckpointer:
    """Overlap checkpoint writes with training."""

    def __init__(self, ckpt_dir, *, keep: int = 3):
        self.ckpt_dir = pathlib.Path(ckpt_dir)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, tree, *, extra=None):
        self.wait()
        # the sync device->host copy, flat: its keys are the tree's paths
        host = {k: _to_numpy(v) for k, v in tree_paths(tree)}

        def work():
            try:
                save(self.ckpt_dir, step, host, extra=extra, keep=self.keep)
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

