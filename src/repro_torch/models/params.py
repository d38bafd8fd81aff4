"""Parameter specs: one declarative tree drives init and sharding.

Each leaf is a ``ParamSpec`` with a GLOBAL shape and per-dim axis
assignment ("model" = TP, "data" = FSDP/ZeRO-3, None = replicated), as in
the JAX package.  On the stacked axis a parameter is one tensor
``[p, *local_shape]``: rank r's shard at index r, where ``local_shape``
divides every "model" dim by p.  "data" stays unbound in this slice, so
its dims keep their full size.

The JAX package groups repeated layers into ``lax.scan`` groups whose
leaves carry a leading ``n_rep`` dim.  The port runs layers in a Python
loop, so a scanned group is a LIST of per-layer subtrees instead
(``lm.model_specs`` builds it; ``from_reference`` splits the JAX
package's stacked leaves into it).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core._axis import StackedAxis

Tree = Any      # nested dicts and lists of ParamSpec (or tensors)


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    dims: tuple[str | None, ...]
    init: str = "normal"      # normal | zeros | ones
    scale: float | None = None
    dtype: str = "bfloat16"

    def __post_init__(self):
        if len(self.shape) != len(self.dims):
            raise ValueError(f"shape {self.shape} and dims {self.dims} "
                             "differ in rank")

    def local_shape(self, sizes: dict[str, int]) -> tuple[int, ...]:
        out = []
        for s, d in zip(self.shape, self.dims):
            div = sizes.get(d, 1) if d else 1
            if s % div:
                raise ValueError(f"dim {s} not divisible by {d}={div}")
            out.append(s // div)
        return tuple(out)


def tree_map_specs(fn, tree: Tree):
    """Apply ``fn`` to every ``ParamSpec`` leaf of nested dicts and lists."""
    if isinstance(tree, ParamSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_specs(fn, v) for v in tree]
    raise TypeError(f"not a spec tree node: {type(tree).__name__}")


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def shard(full: torch.Tensor, spec: ParamSpec, axis: StackedAxis
          ) -> torch.Tensor:
    """A global leaf -> its stacked shards ``[p, *local_shape]``: every
    "model" dim cut into p blocks in rank order; other dims replicated."""
    p = axis.size
    for i, d in enumerate(spec.dims):
        if d == "model":
            s = full.shape[i]
            if s % p:
                raise ValueError(f"dim {s} not divisible by model={p}")
            return full.unflatten(i, (p, s // p)).movedim(i, 0).contiguous()
    return full.unsqueeze(0).expand((p,) + tuple(full.shape)).contiguous()


def _init_leaf(spec: ParamSpec, generator: torch.Generator,
               axis: StackedAxis) -> torch.Tensor:
    dt = torch_dtype(spec.dtype)
    if spec.init == "zeros":
        return torch.zeros((axis.size,) + spec.local_shape(
            {"model": axis.size}), dtype=dt, device=axis.device)
    if spec.init == "ones":
        return torch.ones((axis.size,) + spec.local_shape(
            {"model": axis.size}), dtype=dt, device=axis.device)
    if spec.init != "normal":
        raise ValueError(f"unknown init {spec.init!r}")
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    std = spec.scale if spec.scale is not None else fan_in ** -0.5
    full = torch.randn(spec.shape, generator=generator, device=axis.device,
                       dtype=torch.float32).mul_(std).to(dt)
    return shard(full, spec, axis)


def init_tree(tree: Tree, generator: torch.Generator, axis: StackedAxis):
    """Random stacked parameters for a spec tree, drawn from
    ``generator`` on the axis device with the JAX package's init kinds
    (``normal`` with ``scale`` or ``fan_in ** -0.5``, ``zeros``,
    ``ones``).  Each leaf is drawn at its global shape and cut into the
    ranks' shards, so a replicated leaf is the same on every rank and the
    model does not depend on p.  The generator must live on the axis
    device."""
    return tree_map_specs(lambda s: _init_leaf(s, generator, axis), tree)


def to_torch(a) -> torch.Tensor:
    """numpy -> CPU tensor; ``ml_dtypes`` bfloat16 is carried bit for bit."""
    a = np.array(a)               # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def from_reference(np_tree, specs: Tree, axis: StackedAxis):
    """The JAX package's GLOBAL parameter tree (its ``init_tree`` outside
    any mesh, each leaf mapped through ``np.asarray``) -> the port's
    stacked tensors for ``specs`` (``lm.model_specs(cfg, axis.size)``).

    A list node of ``specs`` is a scanned group: its i-th layer takes
    index i of the reference leaves' leading ``n_rep`` dim.  Every "model"
    dim is cut into p shards; bfloat16 bits are carried exactly."""
    if isinstance(specs, ParamSpec):
        full = to_torch(np_tree)
        if tuple(full.shape) != tuple(specs.shape):
            raise ValueError(f"reference leaf {tuple(full.shape)} != spec "
                             f"{specs.shape}")
        return shard(full.to(torch_dtype(specs.dtype)).to(axis.device),
                     specs, axis)
    if isinstance(specs, list):
        return [from_reference(_take(np_tree, i), s, axis)
                for i, s in enumerate(specs)]
    return {k: from_reference(np_tree[k], v, axis) for k, v in specs.items()}


def _take(tree, i: int):
    """Index i of the leading dim of every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]
