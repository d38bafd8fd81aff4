"""Composed hierarchical ring schedules for two-tier meshes.

A mesh whose axes cross interconnect tiers with an order-of-magnitude
link gap runs every synchronous step of a flat ring over the joint group
at the SLOW tier's rate.  The decompositions below keep most bytes on
the fast intra tier and move only a ``1/q`` share across the slow inter
tier, as in the JAX package's ``repro/kernels/hierarchical.py``:

* ``hier_allreduce``      RS-intra -> AR-inter -> AG-intra
* ``hier_allgather``      AG-intra -> AG-inter
* ``hier_reduce_scatter`` RS-inter -> RS-intra   (the all-gather dual)

All are built from the two exact ring primitives ``ring_reduce_scatter``
and ``ring_allgather``: neighbour ``pshift`` loops over one axis view of
a ``StackedMesh``.  ``inter_axis`` is the OUTER (slow) axis and
``intra_axis`` the INNER (fast) one; gathered and scattered blocks come
in outer-major order, as a flat collective over ``(inter, intra)`` gives
them.  This is torch code over stacked lanes, not a kernel: on one card
both tiers are copies in the same memory, so the tiers' different rates
exist only in the cost model (``costmodel.MeshTopo``).

The mock-ups call these directly (never the dispatcher); ``core.
collectives`` registers them as the ``MPIX_*`` impls.
"""
from __future__ import annotations

import torch

from repro_torch.core._axis import StackedAxis, ring_perm
from repro_torch.core.collectives import _pad_rows


def ring_reduce_scatter(x: torch.Tensor, axis: StackedAxis) -> torch.Tensor:
    """Exact (p-1)-hop travelling-accumulator ring reduce-scatter: per rank
    ``[p*n, ...]`` -> ``[n, ...]``, rank i holding the sum of block i over
    the axis.  Rows must divide p (the hierarchical wrappers pad)."""
    p = axis.size
    if p == 1:
        return x
    n = x.shape[1] // p
    idx, lane = axis.index(), axis.lane_index()
    blocks = x.reshape((x.shape[0], p, n) + tuple(x.shape[2:]))
    acc = None
    for s in range(p):
        blk = blocks[lane, (idx + (p - 1 - s)) % p]
        acc = blk if acc is None else acc + blk
        if s < p - 1:
            acc = axis.pshift(acc, ring_perm(p, 1))
    return acc


def ring_allgather(x: torch.Tensor, axis: StackedAxis) -> torch.Tensor:
    """Exact (p-1)-hop neighbour-ring all-gather: per rank ``[n, ...]`` ->
    ``[p*n, ...]`` in rank order."""
    p = axis.size
    if p == 1:
        return x
    lanes, n = x.shape[0], x.shape[1]
    idx, lane = axis.index(), axis.lane_index()
    out = x.new_zeros((lanes, p) + tuple(x.shape[1:]))
    out[lane, idx] = x
    cur = x
    for s in range(1, p):
        cur = axis.pshift(cur, ring_perm(p, 1))
        out[lane, (idx - s) % p] = cur
    return out.view((lanes, p * n) + tuple(x.shape[2:]))


def ring_allreduce(x: torch.Tensor, axis: StackedAxis) -> torch.Tensor:
    """Exact ring all-reduce = padded ring RS + ring AG (the GL6 shape):
    the inter-tier stage of ``hier_allreduce``."""
    p = axis.size
    if p == 1:
        return x
    n = x.shape[1]
    red = ring_reduce_scatter(_pad_rows(x, -(-n // p) * p), axis)
    return ring_allgather(red, axis)[:, :n]


def hier_allreduce(x: torch.Tensor, inter_axis: StackedAxis,
                   intra_axis: StackedAxis) -> torch.Tensor:
    """RS-intra -> AR-inter -> AG-intra: the full buffer moves only on the
    intra tier; the inter tier reduces ``1/q`` of it per rank.  The result
    is the sum over BOTH axes."""
    q = intra_axis.size
    n = x.shape[1]
    red = ring_reduce_scatter(_pad_rows(x, -(-n // q) * q), intra_axis)
    mid = ring_allreduce(red, inter_axis)
    return ring_allgather(mid, intra_axis)[:, :n]


def hier_allgather(x: torch.Tensor, inter_axis: StackedAxis,
                   intra_axis: StackedAxis) -> torch.Tensor:
    """AG-intra -> AG-inter: gather the fast tier first, then stream the
    assembled ``q*n`` node block across the slow tier once; outer-major
    block order, as a flat all-gather over ``(inter, intra)``."""
    return ring_allgather(ring_allgather(x, intra_axis), inter_axis)


def hier_reduce_scatter(x: torch.Tensor, inter_axis: StackedAxis,
                        intra_axis: StackedAxis) -> torch.Tensor:
    """RS-inter -> RS-intra (the ``hier_allgather`` dual): rank ``(i, j)``
    ends with the joint sum of block ``i*q + j``, ``psum_scatter`` over
    ``(inter, intra)``.  Rows must divide ``p*q``."""
    return ring_reduce_scatter(ring_reduce_scatter(x, inter_axis),
                               intra_axis)
