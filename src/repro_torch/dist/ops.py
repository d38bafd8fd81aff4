"""Sharded model-parallel primitives — the "MPI application code" layer.

The model stack (``models/``) and the trainer call these ops; every
collective they issue, forward AND backward, goes through
``repro_torch.core.api``, never the axis directly, so an active
``api.tuned(profiles=..., phase_profiles=..., force=...)`` context or a
``PGTUNE_MODULE`` spec redirects training and serving traffic to the
guideline mock-ups, as PGMPITuneLib redirects ``MPI_*`` calls.

Operands are stacked over the bound axis (``dist.axes``): a per-rank
``[..., K]`` activation is a ``[p, ..., K]`` tensor and a per-rank weight
``[K, M]`` is ``[p, K, M]``.  Local products are batched over the rank
dim (``_mm``).

Each op that issues a collective is a ``torch.autograd.Function`` that
mirrors the JAX package's custom-VJP pair (``repro/dist/ops.py``): the
forward runs the dispatched collective (autograd is off inside
``forward``; the mock-ups' CUDA and Triton kernels are not
differentiable), and the backward issues its own collective through the
dispatcher under ``api.phase("bwd")``, within the tuning context its
forward ran in (``api.within``: autograd runs the backward of CUDA
tensors on a thread of its own, where the caller's ``api.tuned`` is not
active).  On the stacked axis the
cotangent of rank r is row r of the stacked cotangent, so autograd of the
sum of the per-rank losses runs the reference's per-rank backward rules
exactly.  The branch conditions, the ``return_gathered=True`` reuse and
the transposes are the JAX package's:

===================  =========================  ==========================
op                   forward collective         backward collective
===================  =========================  ==========================
fsdp_gather          api.allgather (data)       api.reducescatter (data)
tp_allgather         api.allgather (model)      api.reducescatter (model)
tp_reducescatter     api.reducescatter          api.allgather
tp_allreduce         api.allreduce              identity (Megatron "g")
tp_copy              identity                   api.allreduce (Megatron "f")
tp_psum_grad         identity                   api.allreduce (weight marker)
row_matmul           api.matmul_reducescatter   identity
                     + api.allgather (rows
                     divide p, else allreduce)
col_matmul           identity                   api.matmul_reducescatter +
                                                api.allgather (input grad;
                                                api.allreduce when the
                                                rows do not divide p)
allgather_matmul     api.allgather_matmul       api.matmul_reducescatter (dx)
                                                + api.allgather (dw remat)
matmul_reducescatter api.matmul_reducescatter   api.allgather_matmul (dx; the
                                                gathered cotangent is reused
                                                for dw)
fsdp_matmul          api.allgather_matmul       api.matmul_reducescatter (dw)
                     (data, the weight
                     gathered, transposed)
matmul_accumulate    api.matmul_accumulate      api.matmul_reducescatter (dw);
                     (data)                     dx reuses the gathered weight
===================  =========================  ==========================

Every operand handed to a dispatched collective is made contiguous
here, where the pairing is written (``_contig``, which counts the copies
it makes and their bytes): the transposes ``w.T``, ``g.T``, ``x.T`` and
strided cotangents.  The Hopper GEMMs behind ``fused_ring`` take only
contiguous operands and do not copy for the caller.

An op over an unbound axis degrades to identity or a local matmul, as in
the JAX package.  Not ported yet: ``ep_alltoall`` (MoE) and the 2-D ops
that need both axes bound at once (``matmul_reducescatter_2d``, and
``row_matmul(fsdp_dim=1)`` over bound model and data axes).
"""
from __future__ import annotations

import contextlib
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


def _contig(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous tensor for a dispatched collective; a copy,
    where one is made, is counted in ``_contig.copies`` and
    ``_contig.bytes``."""
    if t.is_contiguous():
        return t
    _contig.copies += 1
    _contig.bytes += t.numel() * t.element_size()
    return t.contiguous()


_contig.copies = 0
_contig.bytes = 0


def _T(t: torch.Tensor) -> torch.Tensor:
    """Per-rank transpose of a stacked ``[p, a, b]``, contiguous."""
    return _contig(t.transpose(1, 2))


def _moved(fn, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Apply a collective over per-rank dim 0 along per-rank ``dim``."""
    d = dim % (x.dim() - 1) + 1          # the per-rank dim's stacked index
    if d == 1:
        return fn(_contig(x))
    return fn(_contig(x.movedim(d, 1))).movedim(1, d)


@contextlib.contextmanager
def _backward(ctx):
    """The backward collectives of a pair: phase ``bwd``, under the tuning
    context its forward ran in (autograd may run the backward on another
    thread, see ``api.within``)."""
    with api.within(ctx.tune), api.phase("bwd"):
        yield


def _grad_on(*ts: torch.Tensor) -> bool:
    """Whether autograd records a graph through any of ``ts`` (the JAX
    package differentiates its fwd rule then, and runs the primal
    otherwise)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


# ---------------------------------------------------------------------------
# allgather <-> reducescatter pair
# ---------------------------------------------------------------------------


def _ag(x, dim, ax):
    return _moved(lambda a: api.allgather(a, ax), x, dim)


def _rs(x, dim, ax):
    return _moved(lambda a: api.reducescatter(a, ax), x, dim)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.tune = api.current_context()
        ctx.dim, ctx.ax = dim, ax
        return _ag(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        with _backward(ctx):
            return _rs(g, ctx.dim, ctx.ax), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.tune = api.current_context()
        ctx.dim, ctx.ax = dim, ax
        return _rs(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        with _backward(ctx):
            return _ag(g, ctx.dim, ctx.ax), None, None


def _gather(dim: int, axis: str, x: torch.Tensor) -> torch.Tensor:
    return _Gather.apply(x, dim, get_axis(axis))


def fsdp_gather(x, dim: int = 0, axis: str = AXES.data):
    """All-gather a ZeRO-3-sharded param along ``dim`` over the data axis;
    the backward reduce-scatters the grad back to the owner shard (summed
    over the axis; the trainer divides by the axis size)."""
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
    block); the backward all-gathers the cotangent."""
    if not has_axis(axis):
        return x
    return _Scatter.apply(x, dim, get_axis(axis))


# ---------------------------------------------------------------------------
# allreduce <-> identity pair (Megatron f/g)
# ---------------------------------------------------------------------------


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return api.allreduce(_contig(x), ax)

    @staticmethod
    def backward(ctx, g):
        # the reduced value is ONE logical tensor replicated over the axis;
        # its (replicated) cotangent passes through untouched
        return g, None


class _PsumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.tune = api.current_context()
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with _backward(ctx):
            return api.allreduce(_contig(g), ctx.ax), None


def tp_allreduce(x, axis: str = AXES.model):
    """Sum partial activations over the model axis (row-parallel output)."""
    if not has_axis(axis):
        return x
    return _AllReduce.apply(x, get_axis(axis))


def tp_copy(x, axis: str = AXES.model):
    """Mark a replicated activation entering a model-sharded region: fwd is
    identity, bwd sums the per-shard partial cotangents."""
    if not has_axis(axis):
        return x
    return _PsumGrad.apply(x, get_axis(axis))


def tp_psum_grad(x, axis: str = AXES.model):
    """Mark a replicated weight used on every model shard: fwd identity,
    bwd sums the partial weight grads over the axis."""
    if not has_axis(axis):
        return x
    return _PsumGrad.apply(x, get_axis(axis))


# ---------------------------------------------------------------------------
# fused collective-matmul pair (the tuner arbitrates fused_ring vs unfused)
# ---------------------------------------------------------------------------


class _Agmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, ax):
        ctx.tune = api.current_context()
        ctx.ax = ax
        ctx.save_for_backward(x, w)
        return api.allgather_matmul(x, w, ax)

    @staticmethod
    def backward(ctx, g):
        # out = all_gather(x) @ w.  dx reduces+scatters the per-shard
        # partials g @ w.T (the mirror fused op); dw re-gathers x
        # (rematerialization: the unfused composition would have kept the
        # gathered copy alive)
        x, w = ctx.saved_tensors
        g = _contig(g)
        with _backward(ctx):
            dx = api.matmul_reducescatter(g, _T(w), ctx.ax)
            dw = torch.matmul(api.allgather(x, ctx.ax).transpose(1, 2), g)
        return dx, dw, None


def allgather_matmul(x, w, axis: str = AXES.model):
    """``all_gather(x, rows) @ w``: x per-rank ``[n, K]``, w ``[K, M]`` ->
    ``[p*n, M]``; fused-vs-unfused is a dispatcher decision, and the
    backward pairs ``matmul_reducescatter`` for the input grad."""
    if not has_axis(axis):
        return _mm(x, w)
    return _Agmm.apply(x, w, get_axis(axis))


class _Mmrs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, ax):
        ctx.tune = api.current_context()
        ctx.ax = ax
        ctx.save_for_backward(x, w)
        return api.matmul_reducescatter(x, w, ax)

    @staticmethod
    def backward(ctx, g):
        # out = reduce_scatter(x @ w).  The cotangent must be gathered
        # anyway (transpose of reduce-scatter); the fused op hands the
        # assembled all_gather(g) back so dw reuses it instead of
        # gathering twice
        x, w = ctx.saved_tensors
        with _backward(ctx):
            dx, gg = api.allgather_matmul(_contig(g), _T(w), ctx.ax,
                                          return_gathered=True)
            dw = torch.matmul(x.transpose(1, 2), gg)
        return dx, dw, None


def matmul_reducescatter(x, w, axis: str = AXES.model):
    """``reduce_scatter(x @ w, rows)``: x per-rank ``[p*n, K]``, w
    ``[K, M]`` -> ``[n, M]`` summed over ``axis``.  The backward pairs
    ``allgather_matmul`` (fused fwd <-> fused bwd)."""
    if not has_axis(axis):
        return _mm(x, w)
    return _Mmrs.apply(x, w, get_axis(axis))


class _FsdpMm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, ax, keep):
        # x @ AG(w, dim 1) == (AG(w.T, dim 0) @ x.T).T: the canonical
        # allgather-matmul with the WEIGHT as the gathered operand.  The
        # ring materializes the gathered weight anyway; keep it for dx
        ctx.tune = api.current_context()
        ctx.ax = ax
        x2, _ = _flat2(x)
        if keep:
            zt, wft = api.allgather_matmul(_T(w), _T(x2), ax,
                                           return_gathered=True)
            ctx.save_for_backward(x, wft)
        else:
            zt = api.allgather_matmul(_T(w), _T(x2), ax)
        return zt.transpose(1, 2).reshape(*x.shape[:-1], zt.shape[1])

    @staticmethod
    def backward(ctx, g):
        # dw is the FSDP gradient reduce-scatter, fused with its matmul:
        # dw.T = reduce_scatter(g.T @ x, rows over data).  dx reuses the
        # gathered weight saved by the forward
        x, wft = ctx.saved_tensors
        g2, _ = _flat2(g)
        x2, _ = _flat2(x)
        with _backward(ctx):
            dwt = api.matmul_reducescatter(_T(g2), _contig(x2), ctx.ax)
        dx = torch.matmul(g2, wft).reshape(x.shape)
        return dx, dwt.transpose(1, 2), None, None


def fsdp_matmul(x, w, axis: str = AXES.data):
    """``x @ all_gather(w, dim 1)`` with the ZeRO-3 weight gather fused
    into the matmul (the fsdp_gather -> matmul sites of row-parallel
    weights).  The backward fuses the FSDP grad reduce-scatter the same
    way."""
    if not has_axis(axis):
        return _mm(x, w)
    return _FsdpMm.apply(x, w, get_axis(axis), _grad_on(x, w))


class _AccMm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, ax, keep):
        # x @ AG(w, dim 0): the gathered dim is contracted away (the
        # accumulate ring).  The ring materializes the full weight anyway;
        # keep it so dx is a local matmul
        ctx.tune = api.current_context()
        ctx.ax = ax
        x2, _ = _flat2(x)
        if keep:
            out, wf = api.matmul_accumulate(_contig(x2), w, ax,
                                            return_gathered=True)
            ctx.save_for_backward(x, wf)
        else:
            out = api.matmul_accumulate(_contig(x2), w, ax)
        return out.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        # out = x @ W with W = AG(w, rows).  dw is W's cotangent (x.T @ g)
        # reduce-scattered back to the K-row owner shards (the mirror
        # fused op); dx reuses the gathered weight saved by the forward
        x, wf = ctx.saved_tensors
        g2, _ = _flat2(g)
        x2, _ = _flat2(x)
        with _backward(ctx):
            dw = api.matmul_reducescatter(_T(x2), _contig(g2), ctx.ax)
        dx = torch.matmul(g2, wf.transpose(1, 2)).reshape(x.shape)
        return dx, dw, None, None


def matmul_accumulate(x, w, axis: str = AXES.data):
    """``x @ all_gather(w, dim 0)``: the K-dim (contraction) weight gather
    fused into the matmul.  ``w`` per-rank ``[K/p, M]``, ``x [..., K]``.
    The backward pairs ``matmul_reducescatter`` for the weight grad (the
    FSDP reduce-scatter over K rows).  Unevenly padded shards (x's K !=
    p·rows(w)) fall back to the tuned unfused gather + slice."""
    if not has_axis(axis):
        return _mm(x, w)
    k = x.shape[-1]
    if k != axis_size(axis) * w.shape[1]:
        return _mm(x, _gather(0, axis, w)[:, :k])
    return _AccMm.apply(x, _contig(w), get_axis(axis), _grad_on(x, w))


# ---------------------------------------------------------------------------
# Megatron matmuls
# ---------------------------------------------------------------------------


class _ColMm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, ax):
        ctx.tune = api.current_context()
        ctx.ax = ax
        ctx.save_for_backward(x, w)
        return _mm(x, w)

    @staticmethod
    def backward(ctx, g):
        # dx = allreduce(g @ w.T) decomposed as reduce-scatter + all-gather
        # so the matmul half is fused-selectable; a single all-reduce when
        # the row count does not divide the axis
        x, w = ctx.saved_tensors
        g2, t = _flat2(g)
        x2, _ = _flat2(x)
        with _backward(ctx):
            if t % ctx.ax.size == 0:
                ds = api.matmul_reducescatter(_contig(g2), _T(w), ctx.ax)
                dx = api.allgather(ds, ctx.ax).reshape(x.shape)
            else:
                dx = api.allreduce(torch.matmul(g2, w.transpose(1, 2)),
                                   ctx.ax).reshape(x.shape)
        dw = torch.matmul(x2.transpose(1, 2), g2)
        return dx, dw, None


def col_matmul(x, w, axis: str = AXES.model, *, fsdp_dim: int | None = None,
               fsdp_axis: str = AXES.data):
    """Column-parallel matmul: ``x`` replicated, ``w`` sharded on its output
    dim -> output sharded on the last dim.  No forward collective; the
    input grad is summed over the axis through the fused-selectable
    ``matmul_reducescatter`` + all-gather decomposition.  ``fsdp_dim=0``:
    ``w`` is also FSDP-sharded on its contraction dim and that gather fuses
    into the matmul (``matmul_accumulate``), the model-axis input-grad sum
    carried by a ``tp_copy`` marker; other ``fsdp_dim`` values gather
    unfused first."""
    if fsdp_dim == 0:
        return matmul_accumulate(tp_copy(x, axis), w, fsdp_axis)
    if fsdp_dim is not None:
        w = fsdp_gather(w, fsdp_dim, fsdp_axis)
    if not has_axis(axis):
        return _mm(x, w)
    return _ColMm.apply(x, w, get_axis(axis))


class _RowMm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, ax):
        ctx.save_for_backward(x, w)
        x2, _ = _flat2(x)
        ys = api.matmul_reducescatter(_contig(x2), w, ax)
        return api.allgather(ys, ax).reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        # the reduced output is ONE logical replicated tensor (Megatron
        # "g"): its replicated cotangent needs no collective
        x, w = ctx.saved_tensors
        g2, _ = _flat2(g)
        x2, _ = _flat2(x)
        dx = torch.matmul(g2, w.transpose(1, 2)).reshape(x.shape)
        dw = torch.matmul(x2.transpose(1, 2), g2)
        return dx, dw, None


def row_matmul(x, w, axis: str = AXES.model, *, fsdp_dim: int | None = None,
               fsdp_axis: str = AXES.data):
    """Row-parallel matmul: ``x`` sharded on the last dim, ``w`` on its
    input dim -> partial products summed over the model axis, issued as
    ``matmul_reducescatter`` + ``allgather`` when the rows divide p (one
    tuned ``allreduce`` otherwise); the backward needs no collective.
    ``fsdp_dim=1``: ``w`` is also FSDP-sharded on its output dim; with
    both axes bound that is the 2-D op (not ported: it needs both axes at
    once), otherwise the 1-D composition ``tp_allreduce(fsdp_matmul(...))``.
    """
    rows = math.prod(x.shape[1:-1])
    if fsdp_dim == 1:
        if (has_axis(axis) and has_axis(fsdp_axis)
                and rows % axis_size(axis) == 0):
            raise NotImplementedError(
                "row_matmul(fsdp_dim=1) over bound model and data axes is "
                "matmul_reducescatter_2d, which needs both axes at once")
        return tp_allreduce(fsdp_matmul(x, w, fsdp_axis), axis)
    if fsdp_dim is not None:
        w = fsdp_gather(w, fsdp_dim, fsdp_axis)
    if not has_axis(axis):
        return _mm(x, w)
    if rows % axis_size(axis) == 0:
        return _RowMm.apply(x, w, get_axis(axis))
    return tp_allreduce(_mm(x, w), axis)

