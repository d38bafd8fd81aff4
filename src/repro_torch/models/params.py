"""Parameter specs: one declarative tree drives init and sharding.

Each leaf is a ``ParamSpec`` with a GLOBAL shape and per-dim axis
assignment ("model" = TP, "data" = FSDP/ZeRO-3, None = replicated), as in
the JAX package.  On the stacked axis a parameter is one tensor
``[p, *local_shape]``: rank r's shard at index r, where ``local_shape``
divides every dim assigned to the BOUND axis name by p (``name``:
"model" for the serve path and the trainer's TP layout, "data" for its
FSDP layout); dims assigned to the other name keep their full size.  On
a ``StackedMesh`` (data and model together) the leaf is ``[d*t,
*local_shape]``: lane ``i*t + j`` holds data shard i of model shard j,
each dim cut by the size of the name it is assigned to, and a leaf with
no dim for one of the names is the same on every rank of that name.

The JAX package groups repeated layers into ``lax.scan`` groups whose
leaves carry a leading ``n_rep`` dim.  The port runs layers in a Python
loop, so a scanned group is a LIST of per-layer subtrees instead
(``lm.model_specs`` builds it; ``from_reference`` splits the JAX
package's stacked leaves into it).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.core._axis import StackedMesh

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


def stacked(n: int, spec: ParamSpec) -> ParamSpec:
    """Prepend a scan-stack dimension (replicated): the JAX package's
    layout of a scanned group's leaf, which checkpoints keep."""
    return ParamSpec((n,) + spec.shape, (None,) + spec.dims, spec.init,
                     spec.scale, spec.dtype)


def tree_map_specs(fn, tree: Tree):
    """Apply ``fn`` to every ``ParamSpec`` leaf of nested dicts and lists."""
    if isinstance(tree, ParamSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_specs(fn, v) for v in tree]
    raise TypeError(f"not a spec tree node: {type(tree).__name__}")


def tree_leaves(tree: Tree) -> list:
    """The leaves of nested dicts and lists, in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_paths(tree: Tree, prefix: tuple = ()):
    """``(path, leaf)`` of nested dicts and lists, the path's keys (and
    list indices) joined by "/" and dict keys in sorted order: the JAX
    package's checkpoint keys."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def tree_unflatten(like: Tree, leaves) -> Tree:
    """Rebuild ``like``'s structure from ``leaves`` (``tree_leaves``
    order)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v) for v in node]
        return next(it)
    return build(like)


def tree_nbytes(tree: Tree) -> int:
    """Bytes of a spec tree at its global shapes."""
    return sum(math.prod(s.shape) * torch_dtype(s.dtype).itemsize
               for s in tree_leaves(tree))


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def layout(axis, name: str = "model") -> list[tuple[str, int]]:
    """``(name, size)`` of each stacked axis, outer first: every name of a
    ``StackedMesh``, or the one ``name`` of a ``StackedAxis``."""
    if isinstance(axis, StackedMesh):
        return list(zip(axis.names, axis.shape))
    return [(name, axis.size)]


def shard(full: torch.Tensor, spec: ParamSpec, axis,
          name: str = "model") -> torch.Tensor:
    """A global leaf -> its stacked shards ``[L, *local_shape]``: the dim
    assigned to ``name`` (to each name of a ``StackedMesh`` ``axis``) cut
    into blocks in rank order; over a name the leaf has no dim for it is
    replicated."""
    lay = layout(axis, name)
    cur = full
    for k, (nm, size) in enumerate(lay):
        if nm in spec.dims:
            i = spec.dims.index(nm) + k
            s = cur.shape[i]
            if s % size:
                raise ValueError(f"dim {s} not divisible by {nm}={size}")
            cur = cur.unflatten(i, (size, s // size)).movedim(i, k)
        else:
            cur = cur.unsqueeze(k).expand(
                tuple(cur.shape[:k]) + (size,) + tuple(cur.shape[k:]))
    lanes = math.prod(size for _, size in lay)
    return cur.reshape((lanes,) + tuple(cur.shape[len(lay):])).contiguous()


def unshard(t: torch.Tensor, spec: ParamSpec, axis,
            name: str = "model") -> torch.Tensor:
    """Stacked shards ``[L, *local_shape]`` -> the global leaf (the
    inverse of ``shard``, with the same ``axis`` and ``name``; a leaf
    replicated over a name is that name's rank 0 copy)."""
    lay = layout(axis, name)
    cur = t.reshape(tuple(size for _, size in lay) + tuple(t.shape[1:]))
    for k in reversed(range(len(lay))):
        nm = lay[k][0]
        if nm in spec.dims:
            j = spec.dims.index(nm)
            cur = cur.movedim(k, k + j).flatten(k + j, k + j + 1)
        else:
            cur = cur.select(k, 0)
    return cur


def _init_leaf(spec: ParamSpec, generator: torch.Generator,
               axis, name: str) -> torch.Tensor:
    dt = torch_dtype(spec.dtype)
    if spec.init in ("zeros", "ones"):
        fill = torch.zeros if spec.init == "zeros" else torch.ones
        lay = layout(axis, name)
        return fill((math.prod(s for _, s in lay),)
                    + spec.local_shape(dict(lay)),
                    dtype=dt, device=axis.device)
    if spec.init != "normal":
        raise ValueError(f"unknown init {spec.init!r}")
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    std = spec.scale if spec.scale is not None else fan_in ** -0.5
    full = torch.randn(spec.shape, generator=generator, device=axis.device,
                       dtype=torch.float32).mul_(std).to(dt)
    return shard(full, spec, axis, name)


def init_tree(tree: Tree, generator: torch.Generator, axis,
              name: str = "model"):
    """Random stacked parameters for a spec tree, drawn from
    ``generator`` on the axis device with the JAX package's init kinds
    (``normal`` with ``scale`` or ``fan_in ** -0.5``, ``zeros``,
    ``ones``).  Each leaf is drawn at its global shape and cut into the
    ranks' shards along the dims assigned to ``name`` (to each name of a
    ``StackedMesh``), so a replicated leaf is the same on every rank and
    the model does not depend on the layout.
    The generator must live on the axis device."""
    return tree_map_specs(lambda s: _init_leaf(s, generator, axis, name),
                          tree)


def to_torch(a) -> torch.Tensor:
    """numpy -> CPU tensor; ``ml_dtypes`` bfloat16 is carried bit for bit."""
    a = np.array(a)               # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def from_reference(np_tree, specs: Tree, axis,
                   name: str = "model"):
    """The JAX package's GLOBAL tree (its ``init_tree`` outside any mesh,
    each leaf mapped through ``np.asarray``, or a checkpoint's arrays) ->
    the port's stacked tensors for ``specs`` (``lm.model_specs(cfg,
    tp)``).

    A list node of ``specs`` is a scanned group: its i-th layer takes
    index i of the reference leaves' leading ``n_rep`` dim.  Every dim
    assigned to ``name`` is cut into p shards (on a ``StackedMesh``
    ``axis``, every dim assigned to one of its names); bfloat16 bits are
    carried exactly."""
    if isinstance(specs, ParamSpec):
        full = np_tree if isinstance(np_tree, torch.Tensor) else \
            to_torch(np_tree)
        if tuple(full.shape) != tuple(specs.shape):
            raise ValueError(f"reference leaf {tuple(full.shape)} != spec "
                             f"{specs.shape}")
        return shard(full.to(torch_dtype(specs.dtype)).to(axis.device),
                     specs, axis, name)
    if isinstance(specs, list):
        return [from_reference(_take(np_tree, i), s, axis, name)
                for i, s in enumerate(specs)]
    return {k: from_reference(np_tree[k], v, axis, name)
            for k, v in specs.items()}


def to_reference(tree: Tree, specs: Tree, axis, name: str = "model"):
    """The inverse of ``from_reference``, with the same ``axis`` and
    ``name``: stacked tensors -> the JAX package's GLOBAL layout as CPU
    tensors, a list node (scanned group) stacked along a new leading
    ``n_rep`` dim.  Each leaf is moved to the host before its shards are
    joined."""
    if isinstance(specs, ParamSpec):
        return unshard(tree.detach().cpu(), specs, axis, name).contiguous()
    if isinstance(specs, list):
        layers = [to_reference(t, s, axis, name)
                  for t, s in zip(tree, specs)]
        return _stack(layers)
    return {k: to_reference(tree[k], v, axis, name)
            for k, v in specs.items()}


def _stack(layers: list):
    if isinstance(layers[0], dict):
        return {k: _stack([d[k] for d in layers]) for k in layers[0]}
    return torch.stack(layers)


def _take(tree, i: int):
    """Index i of the leading dim of every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return np.asarray(tree)[i]
