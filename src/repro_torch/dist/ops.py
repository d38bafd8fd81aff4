"""Sharded model-parallel primitives — the "MPI application code" layer.

The model stack (``models/``) calls these ops; every collective they issue
goes through ``repro_torch.core.api``, never the axis directly, so an
active ``api.tuned(profiles=..., phase_profiles=..., force=...)`` context
or a ``PGTUNE_MODULE`` spec redirects serving traffic to the guideline
mock-ups, as PGMPITuneLib redirects ``MPI_*`` calls.

Operands are stacked over the bound ``model`` axis (``dist.axes``): a
per-rank ``[..., K]`` activation is a ``[p, ..., K]`` tensor and a
per-rank weight ``[K, M]`` is ``[p, K, M]``.  Local products are batched
over the rank dim (``_mm``).

FORWARD ONLY.  The JAX package pairs every op with a custom VJP whose
backward collective is dispatched too (``repro/dist/ops.py``); those
pairs come with the training slice as ``torch.autograd.Function``s.  The
forward halves keep the JAX package's branch conditions exactly, since
they decide which collective is recorded and tuned:

===================  ==========================================
op                   forward collective
===================  ==========================================
fsdp_gather          api.allgather (data)
tp_allgather         api.allgather (model)
tp_reducescatter     api.reducescatter (model)
tp_allreduce         api.allreduce (model)
tp_copy              identity
tp_psum_grad         identity
col_matmul           none; ``fsdp_dim=0`` -> matmul_accumulate
row_matmul           api.matmul_reducescatter + api.allgather when
                     the rows divide p, else api.allreduce;
                     ``fsdp_dim=1`` -> tp_allreduce(fsdp_matmul)
allgather_matmul     api.allgather_matmul
matmul_reducescatter api.matmul_reducescatter
fsdp_matmul          api.allgather_matmul (data, the weight
                     gathered, transposed)
matmul_accumulate    api.matmul_accumulate (data)
===================  ==========================================

An op over an unbound axis degrades to identity or a local matmul.  In
this slice ``data`` is never bound: the FSDP branches that need both axes
at once (``matmul_reducescatter_2d``) need the second stacked axis.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import api
from repro_torch.dist.axes import AXES, axis_size, get_axis, has_axis


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-rank ``x [..., K] @ w [K, M]`` on stacked operands:
    ``[p, ..., K] @ [p, K, M] -> [p, ..., M]``."""
    x2 = x.reshape(x.shape[0], -1, x.shape[-1])
    return torch.matmul(x2, w).reshape(*x.shape[:-1], w.shape[-1])


def _flat2(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Collapse per-rank leading dims: ``[p, ..., K] -> ([p, T, K], T)``."""
    t = math.prod(x.shape[1:-1])
    return x.reshape(x.shape[0], t, x.shape[-1]), t


def _moved(fn, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Apply a collective over per-rank dim 0 along per-rank ``dim``."""
    d = dim % (x.dim() - 1) + 1          # the per-rank dim's stacked index
    if d == 1:
        return fn(x.contiguous())
    return fn(x.movedim(d, 1).contiguous()).movedim(1, d)


def _gather(dim: int, axis: str, x: torch.Tensor) -> torch.Tensor:
    ax = get_axis(axis)
    return _moved(lambda a: api.allgather(a, ax), x, dim)


def fsdp_gather(x, dim: int = 0, axis: str = AXES.data):
    """All-gather a ZeRO-3-sharded param along ``dim`` over the data axis."""
    if not has_axis(axis):
        return x
    return _gather(dim, axis, x)


def tp_allgather(x, dim: int, axis: str = AXES.model):
    """All-gather a model-sharded activation along ``dim``."""
    if not has_axis(axis):
        return x
    return _gather(dim, axis, x)


def tp_reducescatter(x, dim: int = 0, axis: str = AXES.model):
    """Reduce-scatter along ``dim`` over the model axis (sum + keep own
    block)."""
    if not has_axis(axis):
        return x
    ax = get_axis(axis)
    return _moved(lambda a: api.reducescatter(a, ax), x, dim)


def tp_allreduce(x, axis: str = AXES.model):
    """Sum partial activations over the model axis (row-parallel output)."""
    if not has_axis(axis):
        return x
    return api.allreduce(x.contiguous(), get_axis(axis))


def tp_copy(x, axis: str = AXES.model):
    """A replicated activation entering a model-sharded region: identity
    forward (its backward sums the per-shard cotangents)."""
    return x


def tp_psum_grad(x, axis: str = AXES.model):
    """A replicated weight used on every model shard: identity forward
    (its backward sums the partial weight grads)."""
    return x


def allgather_matmul(x, w, axis: str = AXES.model):
    """``all_gather(x, rows) @ w``: x per-rank ``[n, K]``, w ``[K, M]`` ->
    ``[p*n, M]``; fused-vs-unfused is a dispatcher decision."""
    if not has_axis(axis):
        return _mm(x, w)
    return api.allgather_matmul(x, w, get_axis(axis))


def matmul_reducescatter(x, w, axis: str = AXES.model):
    """``reduce_scatter(x @ w, rows)``: x per-rank ``[p*n, K]``, w
    ``[K, M]`` -> ``[n, M]`` summed over ``axis``."""
    if not has_axis(axis):
        return _mm(x, w)
    return api.matmul_reducescatter(x, w, get_axis(axis))


def fsdp_matmul(x, w, axis: str = AXES.data):
    """``x @ all_gather(w, dim 1)`` with the ZeRO-3 weight gather fused
    into the matmul: ``(AG(w.T, rows) @ x.T).T``, the canonical
    allgather-matmul with the weight as the gathered operand."""
    if not has_axis(axis):
        return _mm(x, w)
    x2, _ = _flat2(x)
    zt = api.allgather_matmul(w.transpose(1, 2).contiguous(),
                              x2.transpose(1, 2).contiguous(),
                              get_axis(axis))
    return zt.transpose(1, 2).reshape(*x.shape[:-1], zt.shape[1])


def matmul_accumulate(x, w, axis: str = AXES.data):
    """``x @ all_gather(w, dim 0)``: the K-dim (contraction) weight gather
    fused into the matmul.  ``w`` per-rank ``[K/p, M]``, ``x [..., K]``.
    Unevenly padded shards (x's K != p·rows(w)) fall back to the tuned
    unfused gather + slice."""
    if not has_axis(axis):
        return _mm(x, w)
    k = x.shape[-1]
    if k != axis_size(axis) * w.shape[1]:
        return _mm(x, _gather(0, axis, w)[:, :k])
    x2, _ = _flat2(x)
    out = api.matmul_accumulate(x2, w.contiguous(), get_axis(axis))
    return out.reshape(*x.shape[:-1], w.shape[-1])


def col_matmul(x, w, axis: str = AXES.model, *, fsdp_dim: int | None = None,
               fsdp_axis: str = AXES.data):
    """Column-parallel matmul: ``x`` replicated, ``w`` sharded on its output
    dim -> output sharded on the last dim.  No forward collective.
    ``fsdp_dim=0``: ``w`` is also FSDP-sharded on its contraction dim and
    that gather fuses into the matmul (``matmul_accumulate``); other
    ``fsdp_dim`` values gather unfused first."""
    if fsdp_dim == 0:
        return matmul_accumulate(tp_copy(x, axis), w, fsdp_axis)
    if fsdp_dim is not None:
        w = fsdp_gather(w, fsdp_dim, fsdp_axis)
    return _mm(x, w)


def row_matmul(x, w, axis: str = AXES.model, *, fsdp_dim: int | None = None,
               fsdp_axis: str = AXES.data):
    """Row-parallel matmul: ``x`` sharded on the last dim, ``w`` on its
    input dim -> partial products summed over the model axis, issued as
    ``matmul_reducescatter`` + ``allgather`` when the rows divide p (one
    tuned ``allreduce`` otherwise).  ``fsdp_dim=1``: ``w`` is also
    FSDP-sharded on its output dim; with both axes bound that is the 2-D
    op (not ported: it needs the second axis), otherwise the 1-D
    composition ``tp_allreduce(fsdp_matmul(...))``."""
    rows = math.prod(x.shape[1:-1])
    if fsdp_dim == 1:
        if (has_axis(axis) and has_axis(fsdp_axis)
                and rows % axis_size(axis) == 0):
            raise NotImplementedError(
                "row_matmul(fsdp_dim=1) over bound model and data axes is "
                "matmul_reducescatter_2d, which needs the second axis")
        return tp_allreduce(fsdp_matmul(x, w, fsdp_axis), axis)
    if fsdp_dim is not None:
        w = fsdp_gather(w, fsdp_dim, fsdp_axis)
    if not has_axis(axis):
        return _mm(x, w)
    ax = get_axis(axis)
    if rows % ax.size == 0:
        x2, _ = _flat2(x)
        ys = api.matmul_reducescatter(x2, w, ax)
        return api.allgather(ys, ax).reshape(*x.shape[:-1], w.shape[-1])
    return tp_allreduce(_mm(x, w), axis)
