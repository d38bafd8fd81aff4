"""The axis registry: which named axes exist and how the port binds them.

=======  ==================================================================
axis     role
=======  ==================================================================
data     FSDP/ZeRO-3 parameter sharding + batch data parallelism; also
         the sequence axis for seq-sharded long-context decode
model    tensor parallelism (Megatron col/row splits) and expert
         parallelism for MoE
pod      pure data parallelism across pods — params never shard here
=======  ==================================================================

The JAX package asks its trace whether a name is bound (a ``shard_map``
mesh axis or ``vmap(axis_name=)``).  Eager PyTorch has no named axes, so
the port binds names to axis objects explicitly, per thread::

    with bind(model=StackedAxis(8, "cuda")):
        logits, caches = lm.prefill(params, cfg, batch, caches)

``has_axis``/``axis_size_or_1``/``axis_index`` answer from the innermost
binding.  An unbound axis makes every ``dist.ops`` primitive over it
degrade to its local meaning, as in the JAX package.

Dim 0 of every tensor holds the stacked lanes.  One name bound
(``model``: tensor parallelism, every rank sees the whole batch; or
``data``: FSDP, every rank holds its ZeRO-3 shards and its own slice of
the batch) is a one-axis ``StackedAxis``.  Both names bound are two views
of one ``StackedMesh`` (``core._axis``): lane ``i*t + j`` is data rank i
and model rank j, the order of the JAX package's nested ``vmap`` (outer
``data``) and of its ``make_host_mesh((d, t), ("data", "model"))``::

    mesh = StackedMesh((2, 4), ("data", "model"), "cuda")
    with bind(data=mesh["data"], model=mesh["model"]):
        ...

Every collective over one name then runs within the groups of lanes that
share the other name's coordinate, and the ops that need both axes at
once (``matmul_reducescatter_2d``, ``row_matmul(fsdp_dim=1)``) take the
two views.  ``pod`` is never bound.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch

from repro_torch.core._axis import StackedAxis


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """Canonical axis names; import ``AXES`` rather than string literals."""
    data: str = "data"
    model: str = "model"
    pod: str = "pod"

    def __iter__(self):
        return iter((self.data, self.model, self.pod))


AXES = MeshAxes()

_TLS = threading.local()


def _bound() -> dict[str, StackedAxis]:
    return getattr(_TLS, "axes", {})


@contextlib.contextmanager
def bind(**axes: StackedAxis):
    """Bind axis names to axis objects for the calls inside (nested
    bindings add to, and may shadow, the enclosing ones).  The ops that
    use two names at once need them to be views of one ``StackedMesh``
    and check it (``core.api``)."""
    for name in axes:
        if name not in tuple(AXES):
            raise ValueError(f"unknown axis name {name!r}; known: "
                             f"{tuple(AXES)}")
    prev = _bound()
    _TLS.axes = {**prev, **axes}
    try:
        yield
    finally:
        _TLS.axes = prev


def has_axis(axis_name: str | None) -> bool:
    """True iff ``axis_name`` is bound."""
    return bool(axis_name) and axis_name in _bound()


def get_axis(axis_name: str) -> StackedAxis:
    """The axis object bound to ``axis_name``; raises when unbound."""
    try:
        return _bound()[axis_name]
    except KeyError:
        raise LookupError(f"axis {axis_name!r} is not bound") from None


def axis_size(axis_name: str) -> int:
    return get_axis(axis_name).size


def axis_size_or_1(axis_name: str | None) -> int:
    """Size of ``axis_name``, or 1 when it is not bound."""
    return axis_size(axis_name) if has_axis(axis_name) else 1


def axis_index(axis_name: str) -> torch.Tensor:
    """Each lane's index along ``axis_name``: a ``[lanes]`` int64 tensor on
    the axis device (the stacked counterpart of ``lax.axis_index``)."""
    return get_axis(axis_name).index()
