"""Collective implementations: defaults + guideline mock-ups (GL1-GL22 + ⊕).

The PGMPITuneLib mock-up catalog, written once against the rank-axis
interface of ``core._axis``.  Every function takes a STACKED operand
(``[L, ...]``: one leading lane per rank of the mesh, ``L = axis.lanes``;
``L = p`` on a one-axis ``StackedAxis``) and the axis, and returns the
stacked result; on an axis of a ``StackedMesh`` every group of lanes that
shares the other coordinates runs the collective on its own.  Per-rank
conventions (payload ``n`` rows along the per-rank dim 0, i.e. dim 1 of
the stacked tensor):

=============== =============================== ===========================
op              input (per rank)                output (per rank)
=============== =============================== ===========================
allgather       ``[n, ...]``                    ``[p*n, ...]``
allreduce       ``[n, ...]``                    ``[n, ...]`` (sum over axis)
reducescatter   ``[p*n, ...]``                  ``[n, ...]``
alltoall        ``[p*n, ...]``                  ``[p*n, ...]``
bcast           ``[n, ...]``                    ``[n, ...]`` (root's values)
gather          ``[n, ...]``                    ``[p*n, ...]`` (valid on root)
scatter         ``[p*n, ...]`` (valid on root)  ``[n, ...]``
reduce          ``[n, ...]``                    ``[n, ...]`` (valid on root)
scan            ``[n, ...]``                    inclusive prefix over ranks
exscan          ``[n, ...]``                    exclusive prefix over ranks
allgather_      x ``[n, K]``, w ``[K, M]``      ``[p*n, M]``:
matmul                                          ``all_gather(x) @ w``
matmul_         x ``[p*n, K]``, w ``[K, M]``    ``[n, M]``: reduce_scatter
reducescatter                                   of ``x @ w``
matmul_         w ``[K, M/d]`` streamed over    ``[T/q, M]``: reduce_scatter
reducescatter_  the axis (d), x ``[T, K]``,     over ``rs_axis`` (q) of
2d              ``rs_axis=``                    ``x @ all_gather(w, cols)``
=============== =============================== ===========================

The two-axis impls take a second axis object: the 2-D op its
``rs_axis=``, the hierarchical ``MPIX_*`` impls (and the defaults of
allgather / allreduce / reducescatter) an ``inner_axis=`` (the fast,
intra tier; ``axis`` is the outer, slow one).

"valid on root" means only the root's output is part of the contract;
non-roots may receive the full result or zeros.  The irregular ("v")
emulations issue the paper's ``2pI`` count/displacement exchange for real
(``_v_metadata``); eager PyTorch runs it where it is written, so no
barrier is needed to keep it alive.

MOCK-UPS CALL CONCRETE SUB-IMPLEMENTATIONS, NEVER THE DISPATCHER — as
PGMPITuneLib mock-ups call ``PMPI_*`` and not the intercepted entry
points.  This rules out recursive re-tuning.
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Callable

import torch

from repro_torch.core._axis import StackedAxis, ring_perm, shift_perm
from repro_torch.core.cell import OP_MM_ROLE
from repro_torch.kernels import quant as Q
from repro_torch.kernels.pack import guideline_pack

# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _n_rows(x: torch.Tensor) -> int:
    return int(x.shape[1])


def _lane_view(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A ``[p]`` per-rank mask shaped to broadcast against ``x``."""
    return mask.view((-1,) + (1,) * (x.dim() - 1))


def _where_rank(mask: torch.Tensor, x: torch.Tensor,
                other: torch.Tensor | None = None) -> torch.Tensor:
    """Per rank: ``x`` where ``mask`` holds, else ``other`` (zeros)."""
    if other is None:
        other = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where(_lane_view(mask, x), x, other)


def _pad_rows(x: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Zero-pad each rank's rows up to ``n_pad``."""
    n = _n_rows(x)
    if n_pad == n:
        return x
    pad = x.new_zeros((x.shape[0], n_pad - n) + tuple(x.shape[2:]))
    return torch.cat([x, pad], dim=1)


def _blocks(x: torch.Tensor, n: int) -> torch.Tensor:
    """Each rank's rows cut into blocks of ``n``: ``[p, rows/n, n, ...]``."""
    return x.reshape((x.shape[0], x.shape[1] // n, n) + tuple(x.shape[2:]))


def _block_index(axis: StackedAxis, start: torch.Tensor, nb: int,
                 count: int):
    """Lane and block indices of ``count`` blocks from per-lane ``start``,
    clamped into range like ``lax.dynamic_slice``."""
    start = start.clamp(0, nb - count)
    lane = axis.lane_index()
    if count == 1:
        return lane, start
    return lane[:, None], start[:, None] + torch.arange(
        count, device=start.device)


def _take(x: torch.Tensor, axis: StackedAxis, start: torch.Tensor, n: int,
          count: int = 1) -> torch.Tensor:
    """Per rank, ``count`` blocks of ``n`` rows from block ``start[r]``."""
    xb = _blocks(x, n)
    lane, blk = _block_index(axis, start, xb.shape[1], count)
    return xb[lane, blk].reshape((x.shape[0], count * n) + tuple(x.shape[2:]))


def _put(buf: torch.Tensor, axis: StackedAxis, start: torch.Tensor,
         val: torch.Tensor, n: int) -> None:
    """Per rank, write ``val`` over the blocks from ``start[r]``.  In
    place: ``buf`` is always a buffer the calling mock-up allocated."""
    count = val.shape[1] // n
    bb = _blocks(buf, n)
    lane, blk = _block_index(axis, start, bb.shape[1], count)
    bb[lane, blk] = _blocks(val, n).reshape(
        (val.shape[0],) + ((count,) if count > 1 else ()) + (n,)
        + tuple(val.shape[2:]))


def _one_hot_place(x: torch.Tensor, axis: StackedAxis) -> torch.Tensor:
    """Place each rank's ``x`` at row offset ``rank*n`` inside a ``p*n``
    zero buffer (the paper's GL3/GL13 p-times-larger send buffer), through
    the ``guideline_pack`` kernel on CUDA.  Additive placement replaces
    the paper's MPI_BOR (same result, float friendly)."""
    p = axis.size
    n = _n_rows(x)
    rest = tuple(x.shape[2:])
    x3 = x.reshape(x.shape[0], n, math.prod(rest)).contiguous()
    out = guideline_pack(x3, axis.index(torch.int32), p)
    return out.view((x.shape[0], p * n) + rest)


def _v_metadata(x: torch.Tensor, axis: StackedAxis) -> torch.Tensor:
    """The irregular-collective count/displacement exchange: ``2p`` ints
    all-gathered over the axis (Table 1's ``2pI`` term)."""
    idx = axis.index(torch.int32)
    n = _n_rows(x)
    meta = torch.stack([torch.full_like(idx, n), idx * n], dim=1)
    return axis.all_gather(meta)


def _rel(idx: torch.Tensor, root: int, p: int) -> torch.Tensor:
    """Rank relative to a static root (binomial schedules)."""
    if root == 0:
        return idx
    return (idx - root) % p


def _abs_perm(rel_pairs, root: int, p: int):
    """Map relative-rank (src, dst) pairs to absolute ranks."""
    if root == 0:
        return rel_pairs
    return [((s + root) % p, (d + root) % p) for (s, d) in rel_pairs]


def _is_pow2(p: int) -> bool:
    return p & (p - 1) == 0


# ---------------------------------------------------------------------------
# defaults (what an untuned library would run)
# ---------------------------------------------------------------------------


def allgather_default(x, axis: StackedAxis, *,
                      inner_axis: StackedAxis | None = None, **_):
    """Flat: one all-gather.  With ``inner_axis`` (a hierarchical cell):
    gather the intra tier, then the inter tier, in outer-major block
    order, as one gather over the joint group orders them."""
    if inner_axis is not None:
        x = inner_axis.all_gather(x)
    return axis.all_gather(x)


def allreduce_default(x, axis: StackedAxis, *,
                      inner_axis: StackedAxis | None = None, **_):
    y = axis.psum(x)
    return y if inner_axis is None else inner_axis.psum(y)


def reducescatter_default(x, axis: StackedAxis, *,
                          inner_axis: StackedAxis | None = None, **_):
    y = axis.psum_scatter(x)
    return y if inner_axis is None else inner_axis.psum_scatter(y)


def alltoall_default(x, axis: StackedAxis, **_):
    return axis.all_to_all(x)


def bcast_as_psum(x, axis: StackedAxis, *, root: int = 0, **_):
    """Canonical broadcast-from-root: select + all-reduce."""
    return axis.psum(_where_rank(axis.index() == root, x))


def gather_as_allgather(x, axis: StackedAxis, *, root: int = 0, **_):
    """(GL11) root-gather served by all-gather; non-roots get a superset."""
    del root
    return axis.all_gather(x)


def scatter_as_alltoall(x, axis: StackedAxis, *, root: int = 0, **_):
    """Default scatter: mask non-root buffers, all-to-all, keep segment
    root."""
    y = axis.all_to_all(_where_rank(axis.index() == root, x))
    n = _n_rows(x) // axis.size
    return y[:, root * n:(root + 1) * n]


def reduce_as_allreduce(x, axis: StackedAxis, *, root: int = 0, **_):
    """(GL14) rooted reduce served by psum; non-roots ignore the result."""
    del root
    return axis.psum(x)


def scan_default(x, axis: StackedAxis, *, op: str = "add", **_):
    """Inclusive prefix over ranks — Hillis–Steele with log2(p) shifts."""
    p = axis.size
    idx = axis.index()
    y = x
    d = 1
    while d < p:
        shifted = axis.pshift(y, shift_perm(p, d))
        if op == "add":
            y = y + shifted  # the zero fill is the additive identity
        elif op == "max":
            y = _where_rank(idx >= d, torch.maximum(y, shifted), y)
        else:
            raise ValueError(f"unsupported scan op {op!r}")
        d *= 2
    return y


def exscan_default(x, axis: StackedAxis, *, op: str = "add", **_):
    """Exclusive prefix: shift inputs one rank up, then inclusive scan."""
    p = axis.size
    shifted = axis.pshift(x, shift_perm(p, 1))
    if op == "max":
        low = (-math.inf if x.dtype.is_floating_point
               else torch.iinfo(x.dtype).min)
        neg = torch.full_like(x, low)
        shifted = _where_rank(axis.index() == 0, neg, shifted)
    return scan_default(shifted, axis, op=op)


# ---------------------------------------------------------------------------
# MPI_Allgather mock-ups
# ---------------------------------------------------------------------------


def allgather_as_gather_bcast(x, axis: StackedAxis, **_):
    """(GL1) Gather + Bcast."""
    g = gather_as_allgather(x, axis, root=0)
    return bcast_as_psum(g, axis, root=0)


def allgather_as_alltoall(x, axis: StackedAxis, **_):
    """(GL2) p-times replicated send buffer, then all-to-all."""
    big = x.repeat((1, axis.size) + (1,) * (x.dim() - 2))
    return axis.all_to_all(big)


def allgather_as_allreduce(x, axis: StackedAxis, **_):
    """(GL3) one-hot placement into a p·n zero buffer, then all-reduce."""
    return axis.psum(_one_hot_place(x, axis))


def allgather_as_allgatherv(x, axis: StackedAxis, **_):
    """(GL4) irregular emulation: counts/displs metadata + gather."""
    _v_metadata(x, axis)
    return axis.all_gather(x)


def allgather_as_ring(x, axis: StackedAxis, **_):
    """(⊕) (p-1)-step neighbour ring."""
    p = axis.size
    n = _n_rows(x)
    idx = axis.index()
    buf = _one_hot_place(x, axis)
    cur = x
    for s in range(1, p):
        cur = axis.pshift(cur, ring_perm(p, 1))
        _put(buf, axis, (idx - s) % p, cur, n)  # block of rank idx - s
    return buf


def allgather_as_doubling(x, axis: StackedAxis, **_):
    """(⊕) recursive doubling: log2(p) rounds, partner i XOR d.  Requires a
    power-of-two axis; the registry guards this."""
    p = axis.size
    if not _is_pow2(p):
        raise ValueError("recursive doubling needs a power-of-two axis")
    buf = _one_hot_place(x, axis)
    d = 1
    while d < p:
        buf = buf + axis.pshift(buf, [(i, i ^ d) for i in range(p)])
        d *= 2
    return buf


# ---------------------------------------------------------------------------
# MPI_Allreduce mock-ups
# ---------------------------------------------------------------------------


def allreduce_as_reduce_bcast(x, axis: StackedAxis, **_):
    """(GL5) Reduce + Bcast through the library defaults."""
    r = reduce_as_allreduce(x, axis, root=0)
    return bcast_as_psum(r, axis, root=0)


def allreduce_as_tree_reduce_bcast(x, axis: StackedAxis, **_):
    """(⊕/GL5-variant) binomial-tree Reduce + binomial-tree Bcast."""
    r = reduce_as_tree(x, axis, root=0)
    return bcast_as_tree(r, axis, root=0)


def allreduce_as_rsb_allgather(x, axis: StackedAxis, **_):
    """(GL6) Reduce_scatter_block + Allgather, n padded to a multiple of p."""
    p = axis.size
    n = _n_rows(x)
    xp = _pad_rows(x, -(-n // p) * p)
    y = axis.all_gather(axis.psum_scatter(xp))
    return y[:, :n]


def allreduce_as_rs_allgatherv(x, axis: StackedAxis, *, chunk: int = 1, **_):
    """(GL7) Reduce_scatter + Allgatherv with round-robin chunks of size
    ``chunk`` (the paper's C): chunk-aligned padding + the 2pI exchange."""
    p = axis.size
    n = _n_rows(x)
    c = max(1, min(int(chunk), n))
    k = -(-(-(-n // c)) // p)  # ceil(ceil(n/c)/p) chunks per rank
    xp = _pad_rows(x, p * k * c)
    _v_metadata(x, axis)
    y = axis.all_gather(axis.psum_scatter(xp))
    return y[:, :n]


def allreduce_as_doubling(x, axis: StackedAxis, **_):
    """(⊕) recursive-doubling all-reduce (latency-optimal)."""
    p = axis.size
    if not _is_pow2(p):
        raise ValueError("recursive doubling needs a power-of-two axis")
    y = x
    d = 1
    while d < p:
        y = y + axis.pshift(y, [(i, i ^ d) for i in range(p)])
        d *= 2
    return y


# ---------------------------------------------------------------------------
# MPI_Alltoall mock-ups
# ---------------------------------------------------------------------------


def alltoall_as_alltoallv(x, axis: StackedAxis, **_):
    """(GL8) irregular emulation: metadata + all-to-all."""
    _v_metadata(x, axis)
    return axis.all_to_all(x)


def alltoall_as_ppermute(x, axis: StackedAxis, **_):
    """(⊕) (p-1) shifted-ring rounds."""
    p = axis.size
    n = _n_rows(x) // p
    idx = axis.index()
    out = torch.zeros_like(x)
    _put(out, axis, idx, _take(x, axis, idx, n), n)  # own chunk stays
    for s in range(1, p):
        piece = _take(x, axis, (idx + s) % p, n)
        recv = axis.pshift(piece, ring_perm(p, s))
        _put(out, axis, (idx - s) % p, recv, n)
    return out


# ---------------------------------------------------------------------------
# MPI_Bcast mock-ups
# ---------------------------------------------------------------------------


def bcast_as_allgatherv(x, axis: StackedAxis, *, root: int = 0, **_):
    """(GL9) root contributes n, everyone else 0, via allgatherv: masked
    all-gather + static segment select + metadata."""
    n = _n_rows(x)
    xz = _where_rank(axis.index() == root, x)
    _v_metadata(x, axis)
    y = axis.all_gather(xz)
    return y[:, root * n:(root + 1) * n]


def bcast_as_scatter_allgather(x, axis: StackedAxis, *, root: int = 0, **_):
    """(GL10) Scatter + Allgather (van de Geijn), n padded to a multiple
    of p."""
    p = axis.size
    n = _n_rows(x)
    xp = _pad_rows(x, -(-n // p) * p)
    y = axis.all_gather(scatter_as_alltoall(xp, axis, root=root))
    return y[:, :n]


def bcast_as_tree(x, axis: StackedAxis, *, root: int = 0, **_):
    """(⊕) binomial-tree broadcast: ceil(log2 p) rounds."""
    p = axis.size
    y = _where_rank(axis.index() == root, x)
    d = 1
    while d < p:
        rel_pairs = [(r, r + d) for r in range(d) if r + d < p]
        y = y + axis.pshift(y, _abs_perm(rel_pairs, root, p))
        d *= 2
    return y


# ---------------------------------------------------------------------------
# MPI_Gather mock-ups
# ---------------------------------------------------------------------------


def gather_as_gatherv(x, axis: StackedAxis, *, root: int = 0, **_):
    """(GL12) irregular emulation: metadata + gather; non-roots zeroed."""
    _v_metadata(x, axis)
    y = axis.all_gather(x)
    return _where_rank(axis.index() == root, y)


def gather_as_reduce(x, axis: StackedAxis, *, root: int = 0, **_):
    """(GL13) one-hot placement + rooted reduce (additive ≡ the paper's
    BOR on disjoint supports)."""
    return reduce_as_allreduce(_one_hot_place(x, axis), axis, root=root)


def gather_as_tree(x, axis: StackedAxis, *, root: int = 0, **_):
    """(⊕) binomial-tree gather on a p·n zero-merged buffer."""
    p = axis.size
    y = _one_hot_place(x, axis)
    d = 1
    while d < p:
        rel_pairs = [(r + d, r) for r in range(0, p, 2 * d) if r + d < p]
        y = y + axis.pshift(y, _abs_perm(rel_pairs, root, p))
        d *= 2
    return y


# ---------------------------------------------------------------------------
# MPI_Reduce mock-ups
# ---------------------------------------------------------------------------


def reduce_as_rsb_gather(x, axis: StackedAxis, *, root: int = 0, **_):
    """(GL15) Reduce_scatter_block + Gather (padded)."""
    p = axis.size
    n = _n_rows(x)
    xp = _pad_rows(x, -(-n // p) * p)
    y = gather_as_allgather(axis.psum_scatter(xp), axis, root=root)
    return y[:, :n]


def reduce_as_rs_gatherv(x, axis: StackedAxis, *, root: int = 0,
                         chunk: int = 1, **_):
    """(GL16) chunked Reduce_scatter + Gatherv (paper's C, metadata)."""
    p = axis.size
    n = _n_rows(x)
    c = max(1, min(int(chunk), n))
    k = -(-(-(-n // c)) // p)
    xp = _pad_rows(x, p * k * c)
    _v_metadata(x, axis)
    y = gather_as_allgather(axis.psum_scatter(xp), axis, root=root)
    return y[:, :n]


def reduce_as_tree(x, axis: StackedAxis, *, root: int = 0, **_):
    """(⊕) binomial-tree reduce to root: log2(p) rounds."""
    p = axis.size
    y = x
    d = 1
    while d < p:
        rel_pairs = [(r + d, r) for r in range(0, p, 2 * d) if r + d < p]
        y = y + axis.pshift(y, _abs_perm(rel_pairs, root, p))
        d *= 2
    return y


# ---------------------------------------------------------------------------
# MPI_Reduce_scatter_block mock-ups
# ---------------------------------------------------------------------------


def rsb_as_reduce_scatter(x, axis: StackedAxis, **_):
    """(GL17) Reduce + Scatter through the defaults."""
    r = reduce_as_allreduce(x, axis, root=0)
    return scatter_as_alltoall(r, axis, root=0)


def rsb_as_reduce_scatter_irr(x, axis: StackedAxis, **_):
    """(GL18) irregular reduce_scatter emulation: metadata + psum_scatter."""
    _v_metadata(x, axis)
    return axis.psum_scatter(x)


def rsb_as_allreduce(x, axis: StackedAxis, **_):
    """(GL19) Allreduce + keep my block."""
    n = _n_rows(x) // axis.size
    return _take(axis.psum(x), axis, axis.index(), n)


# ---------------------------------------------------------------------------
# MPI_Scan mock-ups
# ---------------------------------------------------------------------------


def scan_as_exscan_reducelocal(x, axis: StackedAxis, *, op: str = "add", **_):
    """(GL20) Exscan + local reduction."""
    ex = exscan_default(x, axis, op=op)
    if op == "add":
        return ex + x
    if op == "max":
        return torch.maximum(ex, x)
    raise ValueError(f"unsupported scan op {op!r}")


# ---------------------------------------------------------------------------
# MPI_Scatter mock-ups
# ---------------------------------------------------------------------------


def scatter_as_bcast(x, axis: StackedAxis, *, root: int = 0, **_):
    """(GL21) Bcast the whole buffer + local slice."""
    n = _n_rows(x) // axis.size
    return _take(bcast_as_psum(x, axis, root=root), axis, axis.index(), n)


def scatter_as_scatterv(x, axis: StackedAxis, *, root: int = 0, **_):
    """(GL22) irregular emulation: metadata + scatter."""
    _v_metadata(x, axis)
    return scatter_as_alltoall(x, axis, root=root)


def scatter_as_tree(x, axis: StackedAxis, *, root: int = 0, **_):
    """(⊕) binomial-tree scatter: root halves its range every round."""
    p = axis.size
    if not _is_pow2(p):
        raise ValueError("tree scatter needs a power-of-two axis")
    n = _n_rows(x) // p
    idx = axis.index()
    rel = _rel(idx, root, p)
    # rotate into relative-rank layout so tree ranges stay contiguous;
    # rank rel r finally reads chunk (r+root)%p == its absolute chunk.
    y = torch.roll(x, -root * n, dims=1)
    y = _where_rank(idx == root, y)
    d = p // 2
    while d >= 1:
        rel_pairs = [(r, r + d) for r in range(0, p, 2 * d)]
        send = _take(y, axis, (rel + d) % p, n, d)
        recv = axis.pshift(send, _abs_perm(rel_pairs, root, p))
        keep = _take(y, axis, rel, n, d)
        _put(y, axis, rel, keep + recv, n)
        d //= 2
    return _take(y, axis, rel, n)


# ---------------------------------------------------------------------------
# fused collective matmul (latency-hiding mock-up, kernels/)
# ---------------------------------------------------------------------------


def allgather_matmul_default(x, axis: StackedAxis, *, w,
                             return_gathered: bool = False, **_):
    """Unfused composition: all-gather then one dense matmul."""
    g = axis.all_gather(x)
    out = torch.matmul(g, w)
    return (out, g) if return_gathered else out


def allgather_matmul_fused_ring(x, axis: StackedAxis, *, w,
                                return_gathered: bool = False, **_):
    """(⊕) ring allgather-matmul: chunk s+1 moves while chunk s is
    multiplied.  The backend check lives here, not at the callsites: a
    CUDA operand runs the one-kernel ring, a CPU one the ppermute ring."""
    if x.is_cuda:
        from repro_torch.kernels import collective_matmul_rdma as rdma
        return rdma.ring_allgather_matmul_rdma(
            x, w, axis, return_gathered=return_gathered)
    from repro_torch.kernels import collective_matmul as cmm
    return cmm.ring_allgather_matmul(x, w, axis,
                                     return_gathered=return_gathered)


def matmul_reducescatter_default(x, axis: StackedAxis, *, w, **_):
    """Unfused composition: one dense matmul then reduce-scatter."""
    return axis.psum_scatter(torch.matmul(x, w))


def matmul_reducescatter_fused_ring(x, axis: StackedAxis, *, w, **_):
    """(⊕) ring matmul-reducescatter: the travelling accumulator moves
    while the next block's contribution is computed (block-matmul kernel
    on CUDA)."""
    from repro_torch.kernels import collective_matmul as cmm
    return cmm.ring_matmul_reducescatter(x, w, axis)


def matmul_accumulate_default(w, axis: StackedAxis, *, x,
                              return_gathered: bool = False, **_):
    """Unfused composition: all-gather the K-dim weight blocks, then one
    dense matmul over the full contraction."""
    full = axis.all_gather(w)
    out = torch.matmul(x, full)
    return (out, full) if return_gathered else out


def matmul_accumulate_fused_ring(w, axis: StackedAxis, *, x,
                                 return_gathered: bool = False, **_):
    """(⊕) accumulate ring: weight block s+1 moves while block s's partial
    product accumulates (block-matmul kernel on CUDA)."""
    from repro_torch.kernels import collective_matmul as cmm
    return cmm.ring_matmul_accumulate(x, w, axis,
                                      return_gathered=return_gathered)


def matmul_reducescatter_2d_default(w, axis: StackedAxis, *, x,
                                    rs_axis: StackedAxis,
                                    xpose: bool = False,
                                    return_gathered: bool = False, **_):
    """Unfused 2-D composition: gather the streamed operand over ``axis``
    (the outer axis the dispatcher keys on), one dense matmul, then
    reduce-scatter the output rows over ``rs_axis``.

    ``xpose=False``: w ``[K, m_loc]`` gathered by columns ->
    ``psum_scatter(x @ W)``.  ``xpose=True``: the payload is the cotangent
    shard g ``[t_loc, M]``, gathered by rows and CONTRACTED ->
    ``psum_scatter(Gᵀ @ x)``, the transpose schedule of the paired
    backward."""
    if xpose:
        full = axis.all_gather(w)
        return rs_axis.psum_scatter(torch.matmul(full.transpose(1, 2), x))
    full = axis.all_gather(w.transpose(1, 2)).transpose(1, 2)
    out = rs_axis.psum_scatter(torch.matmul(x, full))
    return (out, full) if return_gathered else out


def matmul_reducescatter_2d_fused_ring(w, axis: StackedAxis, *, x,
                                       rs_axis: StackedAxis,
                                       xpose: bool = False,
                                       return_gathered: bool = False, **_):
    """(⊕) nested 2-D ring: the weight (or cotangent) streams over
    ``axis``, an inner matmul-reducescatter (or contract stream) runs over
    ``rs_axis``, issue-before-consume on both (every chunk product is one
    ``block_matmul`` launch on CUDA)."""
    from repro_torch.kernels import collective_matmul as cmm
    if xpose:
        return cmm.ring_matmul_reducescatter_2d_t(w, x, rs_axis, axis)
    return cmm.ring_matmul_reducescatter_2d(
        x, w, rs_axis, axis, return_gathered=return_gathered)


# ---------------------------------------------------------------------------
# quantized-wire mock-ups (wire_q8 / wire_fp8): the ring schedules with the
# travelling operand compressed to an 8-bit wire dtype plus per-block
# scales (kernels/quant.py: the quant_pack / dequant_unpack kernels on
# CUDA, their plain versions on the CPU).  Quantize on send, dequantize on
# receive, and reductions add in float32 after the dequantization.  These
# are APPROXIMATE impls: selfcheck's tolerance gate demotes one that breaks
# its wire tolerance.
# ---------------------------------------------------------------------------


def allgather_wire(x, axis: StackedAxis, *, wire_dtype: str = "int8", **_):
    """(⊕) ring allgather over the quantized wire: each rank's chunk is
    quantized ONCE at its origin and the (values, scales) pair travels
    unchanged; the own chunk never crosses the wire and stays exact."""
    p = axis.size
    if p == 1:
        return x
    n = _n_rows(x)
    idx = axis.index()
    out = x.new_zeros((x.shape[0], p * n) + tuple(x.shape[2:]))
    _put(out, axis, idx, x, n)
    q, sc = Q.quantize(x, wire_dtype)
    for s in range(1, p):
        q, sc = Q.wire_shift(axis, q, sc, ring_perm(p, 1))
        _put(out, axis, (idx - s) % p, Q.dequantize(q, sc, x.dtype), n)
    return out


def reducescatter_wire(x, axis: StackedAxis, *, wire_dtype: str = "int8",
                       **_):
    """(⊕) ring reduce-scatter over the quantized wire: the travelling
    accumulator is requantized before every hop, and local contributions
    are added to the DEQUANTIZED float32 accumulator."""
    p = axis.size
    if p == 1:
        return x
    n = _n_rows(x) // p
    idx = axis.index()
    acc = None
    for s in range(p):
        contrib = _take(x, axis, (idx + (p - 1 - s)) % p, n).to(
            torch.float32)
        acc = contrib if acc is None else acc + contrib
        if s < p - 1:
            q, sc = Q.wire_shift(axis, *Q.quantize(acc, wire_dtype),
                               ring_perm(p, 1))
            acc = Q.dequantize(q, sc, torch.float32)
    return acc.to(x.dtype)


def allreduce_wire(x, axis: StackedAxis, *, wire_dtype: str = "int8", **_):
    """(⊕) quantized-wire allreduce = padded wire reduce-scatter + wire
    allgather (the GL6 decomposition with both phases on the wire)."""
    p = axis.size
    if p == 1:
        return x
    n = _n_rows(x)
    xp = _pad_rows(x, -(-n // p) * p)
    red = reducescatter_wire(xp, axis, wire_dtype=wire_dtype)
    return allgather_wire(red, axis, wire_dtype=wire_dtype)[:, :n]


def allgather_matmul_wire(x, axis: StackedAxis, *, w,
                          wire_dtype: str = "int8",
                          return_gathered: bool = False, **_):
    """(⊕) ring allgather-matmul with the activation chunk on the
    quantized wire."""
    from repro_torch.kernels import collective_matmul as cmm
    return cmm.ring_allgather_matmul_wire(
        x, w, axis, wire_dtype=wire_dtype, return_gathered=return_gathered)


def matmul_reducescatter_wire(x, axis: StackedAxis, *, w,
                              wire_dtype: str = "int8", **_):
    """(⊕) ring matmul-reducescatter with the travelling accumulator on
    the quantized wire (requantized per hop, float32 accumulation)."""
    from repro_torch.kernels import collective_matmul as cmm
    return cmm.ring_matmul_reducescatter_wire(x, w, axis,
                                              wire_dtype=wire_dtype)


def matmul_accumulate_wire(w, axis: StackedAxis, *, x,
                           wire_dtype: str = "int8",
                           return_gathered: bool = False, **_):
    """(⊕) accumulate ring with the weight block on the quantized wire."""
    from repro_torch.kernels import collective_matmul as cmm
    return cmm.ring_matmul_accumulate_wire(
        x, w, axis, wire_dtype=wire_dtype, return_gathered=return_gathered)


# ---------------------------------------------------------------------------
# hierarchical (two-tier) mock-ups, the MPIX_* family: ``axis`` is the
# OUTER (inter-tier, slow) axis and ``inner_axis`` the INNER (intra-tier,
# fast) one.  They decompose a joint-group collective into per-tier ring
# stages (kernels/hierarchical.py) so that most bytes stay on the fast
# tier.  ``Impl.hier`` gates them: a flat mock-up is never offered a
# two-axis cell (it would reduce over one axis only), and a hierarchical
# one never a flat cell.
# ---------------------------------------------------------------------------


def _need_inner(name: str, inner_axis) -> None:
    if inner_axis is None:
        raise ValueError(
            f"{name} is a hierarchical mock-up: it needs inner_axis= "
            "(the intra-tier axis) in addition to the outer axis")


def allreduce_hier(x, axis: StackedAxis, *,
                   inner_axis: StackedAxis | None = None, **_):
    """(⊕ MPIX_rs_ar_ag) RS-intra -> AR-inter -> AG-intra."""
    _need_inner("MPIX_rs_ar_ag", inner_axis)
    from repro_torch.kernels import hierarchical as H
    return H.hier_allreduce(x, axis, inner_axis)


def allgather_hier(x, axis: StackedAxis, *,
                   inner_axis: StackedAxis | None = None, **_):
    """(⊕ MPIX_ag_ag) AG-intra -> AG-inter (outer-major block order)."""
    _need_inner("MPIX_ag_ag", inner_axis)
    from repro_torch.kernels import hierarchical as H
    return H.hier_allgather(x, axis, inner_axis)


def reducescatter_hier(x, axis: StackedAxis, *,
                       inner_axis: StackedAxis | None = None, **_):
    """(⊕ MPIX_rs_rs) RS-inter -> RS-intra (the MPIX_ag_ag dual)."""
    _need_inner("MPIX_rs_rs", inner_axis)
    from repro_torch.kernels import hierarchical as H
    return H.hier_reduce_scatter(x, axis, inner_axis)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Impl:
    """One algorithm for one logical collective."""
    name: str
    op: str
    fn: Callable
    guideline: str | None  # "GL<k>", "EXT" (⊕), or None for the default
    # extra scratch bytes(payload_bytes, p) — the Table-1 memory model.
    extra_bytes: Callable[[int, int], int]
    requires_pow2: bool = False
    desc: str = ""
    # wire dtype of a quantized-wire mock-up ("int8" / "float8_e4m3fn");
    # None = the wire carries the compute dtype.  Non-None marks the impl
    # accuracy-conditional: selfcheck's tolerance gate may demote it.
    wire_dtype: str | None = None
    # True for the two-axis (hierarchical) mock-ups: the impl REQUIRES
    # ``inner_axis=`` and is admissible only on hierarchical cells
    # (``OpCell.hier``); flat impls only on flat cells.  The default impl
    # handles both.
    hier: bool = False

    def __call__(self, x, axis, **kw):
        return self.fn(x, axis, **kw)


_I = 4  # extent of an int32 "MPI_INT" (Table 1's I)


def _nb0(nbytes: int, p: int) -> int:  # no extra memory
    del nbytes, p
    return 0


def _reg() -> dict[str, dict[str, Impl]]:
    def mk(name, op, fn, gl, extra, pow2=False, desc="", wire=None,
           hier=False):
        return Impl(name, op, fn, gl, extra, pow2, desc, wire, hier)

    # the quantized-wire family: one impl per wire dtype, the dtype bound
    # with partial and recorded on the Impl for the cost model and the gate
    def mk_wire(op, fn, extra, desc):
        return [mk(nm, op, partial(fn, wire_dtype=wd), "EXT", extra,
                   desc=f"MPIX_{op}_{nm[5:]}: {desc}", wire=wd)
                for nm, wd in Q.WIRE_IMPLS]

    r: dict[str, dict[str, Impl]] = {}

    r["allgather"] = {i.name: i for i in [
        mk("default", "allgather", allgather_default, None, _nb0,
           desc="stacked all-gather"),
        mk("allgather_as_gather_bcast", "allgather", allgather_as_gather_bcast,
           "GL1", _nb0),
        mk("allgather_as_alltoall", "allgather", allgather_as_alltoall,
           "GL2", lambda n, p: p * n, desc="p× larger send buffer"),
        mk("allgather_as_allreduce", "allgather", allgather_as_allreduce,
           "GL3", lambda n, p: p * n, desc="p× larger send buffer"),
        mk("allgather_as_allgatherv", "allgather", allgather_as_allgatherv,
           "GL4", lambda n, p: 2 * p * _I, desc="displs+recvcounts"),
        mk("allgather_as_ring", "allgather", allgather_as_ring,
           "EXT", lambda n, p: p * n),
        mk("allgather_as_doubling", "allgather", allgather_as_doubling,
           "EXT", lambda n, p: p * n, pow2=True),
        mk("MPIX_ag_ag", "allgather", allgather_hier, "EXT",
           lambda n, p: p * n, hier=True,
           desc="hierarchical AG-intra -> AG-inter: node block assembled "
                "on the fast tier, streamed across the slow tier once"),
        *mk_wire("allgather", allgather_wire,
                 lambda n, p: p * n + n // 2,
                 desc="ring with the chunk on the 8-bit wire "
                      "(quantized once at origin)"),
    ]}

    r["allreduce"] = {i.name: i for i in [
        mk("default", "allreduce", allreduce_default, None, _nb0,
           desc="stacked sum"),
        mk("allreduce_as_reduce_bcast", "allreduce", allreduce_as_reduce_bcast,
           "GL5", _nb0),
        mk("allreduce_as_tree_reduce_bcast", "allreduce",
           allreduce_as_tree_reduce_bcast, "EXT", _nb0,
           desc="binomial reduce+bcast ('nonoverlapping')"),
        mk("allreduce_as_rsb_allgather", "allreduce",
           allreduce_as_rsb_allgather, "GL6",
           lambda n, p: (n + p) + (n + p) // p, desc="padded RS + AG"),
        mk("allreduce_as_rs_allgatherv", "allreduce",
           allreduce_as_rs_allgatherv, "GL7",
           lambda n, p: max(n // p + 1, 1) + 2 * p * _I,
           desc="chunked RS + AGv (Fig.7 winner)"),
        mk("allreduce_as_doubling", "allreduce", allreduce_as_doubling,
           "EXT", _nb0, pow2=True, desc="recursive doubling (latency-opt)"),
        mk("MPIX_rs_ar_ag", "allreduce", allreduce_hier, "EXT",
           lambda n, p: n + max(n // p, 1), hier=True,
           desc="hierarchical RS-intra -> AR-inter -> AG-intra: full "
                "buffer only moves on the fast tier; 1/q of it crosses "
                "the slow tier"),
        *mk_wire("allreduce", allreduce_wire,
                 lambda n, p: (n + p) + (n + p) // p,
                 desc="padded wire RS + wire AG (GL6 shape, 8-bit wire)"),
    ]}

    r["alltoall"] = {i.name: i for i in [
        mk("default", "alltoall", alltoall_default, None, _nb0,
           desc="stacked all-to-all"),
        mk("alltoall_as_alltoallv", "alltoall", alltoall_as_alltoallv,
           "GL8", lambda n, p: 2 * p * _I),
        mk("alltoall_as_ppermute", "alltoall", alltoall_as_ppermute,
           "EXT", lambda n, p: n),
    ]}

    r["bcast"] = {i.name: i for i in [
        mk("default", "bcast", bcast_as_psum, None, _nb0,
           desc="select + all-reduce"),
        mk("bcast_as_allgatherv", "bcast", bcast_as_allgatherv,
           "GL9", lambda n, p: 2 * p * _I + n),
        mk("bcast_as_scatter_allgather", "bcast", bcast_as_scatter_allgather,
           "GL10", lambda n, p: (n + p) + (n + p) // p,
           desc="van de Geijn"),
        mk("bcast_as_tree", "bcast", bcast_as_tree, "EXT", _nb0,
           desc="binomial tree"),
    ]}

    r["gather"] = {i.name: i for i in [
        mk("default", "gather", gather_as_allgather, None,
           lambda n, p: p * n, desc="all-gather; non-roots superset"),
        mk("gather_as_allgather", "gather", gather_as_allgather,
           "GL11", lambda n, p: p * n),
        mk("gather_as_gatherv", "gather", gather_as_gatherv,
           "GL12", lambda n, p: 2 * p * _I),
        mk("gather_as_reduce", "gather", gather_as_reduce,
           "GL13", lambda n, p: p * n, desc="one-hot + reduce"),
        mk("gather_as_tree", "gather", gather_as_tree,
           "EXT", lambda n, p: p * n),
    ]}

    r["reduce"] = {i.name: i for i in [
        mk("default", "reduce", reduce_as_allreduce, None,
           lambda n, p: n, desc="psum; non-roots superset"),
        mk("reduce_as_allreduce", "reduce", reduce_as_allreduce,
           "GL14", lambda n, p: n),
        mk("reduce_as_rsb_gather", "reduce", reduce_as_rsb_gather,
           "GL15", lambda n, p: (n + p) + (n + p) // p),
        mk("reduce_as_rs_gatherv", "reduce", reduce_as_rs_gatherv,
           "GL16", lambda n, p: max(n // p + 1, 1) + 2 * p * _I),
        mk("reduce_as_tree", "reduce", reduce_as_tree, "EXT", _nb0),
    ]}

    r["reducescatter"] = {i.name: i for i in [
        mk("default", "reducescatter", reducescatter_default, None, _nb0,
           desc="stacked sum + scatter"),
        mk("rsb_as_reduce_scatter", "reducescatter", rsb_as_reduce_scatter,
           "GL17", lambda n, p: n, desc="reduce + scatter"),
        mk("rsb_as_reduce_scatter_irr", "reducescatter",
           rsb_as_reduce_scatter_irr, "GL18", lambda n, p: p * _I),
        mk("rsb_as_allreduce", "reducescatter", rsb_as_allreduce,
           "GL19", lambda n, p: n),
        mk("MPIX_rs_rs", "reducescatter", reducescatter_hier, "EXT",
           lambda n, p: 2 * max(n // p, 1), hier=True,
           desc="hierarchical RS-inter -> RS-intra (MPIX_ag_ag dual): "
                "slow tier reduces node blocks, fast tier finishes"),
        *mk_wire("reducescatter", reducescatter_wire,
                 lambda n, p: 2 * max(n // p, 1),
                 desc="ring with the travelling accumulator requantized "
                      "per hop (f32 accumulate)"),
    ]}

    r["scan"] = {i.name: i for i in [
        mk("default", "scan", scan_default, None, _nb0,
           desc="Hillis-Steele over shifts"),
        mk("scan_as_exscan_reducelocal", "scan", scan_as_exscan_reducelocal,
           "GL20", _nb0),
    ]}

    r["exscan"] = {i.name: i for i in [
        mk("default", "exscan", exscan_default, None, _nb0),
    ]}

    r["allgather_matmul"] = {i.name: i for i in [
        mk("default", "allgather_matmul", allgather_matmul_default, None,
           lambda n, p: p * n, desc="all_gather then dense matmul (unfused)"),
        mk("fused_ring", "allgather_matmul", allgather_matmul_fused_ring,
           "EXT", lambda n, p: p * n + 2 * n,
           desc="ring overlap: chunk matmul while next chunk in flight"),
        *mk_wire("allgather_matmul", allgather_matmul_wire,
                 lambda n, p: p * n + 2 * n + n // 2,
                 desc="fused ring, activation chunk on the 8-bit wire"),
    ]}

    r["matmul_reducescatter"] = {i.name: i for i in [
        mk("default", "matmul_reducescatter", matmul_reducescatter_default,
           None, lambda n, p: n, desc="dense matmul then psum_scatter"),
        mk("fused_ring", "matmul_reducescatter",
           matmul_reducescatter_fused_ring, "EXT",
           lambda n, p: 2 * max(n // p, 1),
           desc="ring overlap: travelling accumulator hides matmul"),
        *mk_wire("matmul_reducescatter", matmul_reducescatter_wire,
                 lambda n, p: 2 * max(n // p, 1),
                 desc="fused ring, partial-product accumulator on the "
                      "8-bit wire (requantized per hop)"),
    ]}

    r["matmul_accumulate"] = {i.name: i for i in [
        mk("default", "matmul_accumulate", matmul_accumulate_default, None,
           lambda n, p: p * n,
           desc="all_gather K-dim weight then dense matmul (unfused)"),
        mk("fused_ring", "matmul_accumulate", matmul_accumulate_fused_ring,
           "EXT", lambda n, p: p * n + 2 * n,
           desc="ring overlap: weight block in flight while partials "
                "accumulate"),
        *mk_wire("matmul_accumulate", matmul_accumulate_wire,
                 lambda n, p: p * n + 2 * n + n // 2,
                 desc="fused ring, weight block on the 8-bit wire "
                      "(quantized once at origin)"),
    ]}

    r["matmul_reducescatter_2d"] = {i.name: i for i in [
        mk("default", "matmul_reducescatter_2d",
           matmul_reducescatter_2d_default, None,
           lambda n, p: p * n,
           desc="all-gather weight cols then dense matmul then "
                "psum_scatter (unfused 2-D composition)"),
        mk("fused_ring2d", "matmul_reducescatter_2d",
           matmul_reducescatter_2d_fused_ring, "EXT",
           lambda n, p: p * n + 2 * n,
           desc="nested rings: outer weight stream over the gather axis, "
                "inner matmul-reducescatter over the scatter axis"),
    ]}

    r["scatter"] = {i.name: i for i in [
        mk("default", "scatter", scatter_as_alltoall, None, _nb0,
           desc="masked all-to-all + segment select"),
        mk("scatter_as_bcast", "scatter", scatter_as_bcast,
           "GL21", lambda n, p: n, desc="bcast + local slice"),
        mk("scatter_as_scatterv", "scatter", scatter_as_scatterv,
           "GL22", lambda n, p: 2 * p * _I),
        mk("scatter_as_tree", "scatter", scatter_as_tree,
           "EXT", _nb0, pow2=True),
    ]}

    return r


REGISTRY: dict[str, dict[str, Impl]] = _reg()

OPS = tuple(REGISTRY.keys())

#: the fused collective-matmul ops (their cells carry a GEMM geometry)
FUSED_OPS = tuple(op for op in OPS if op in OP_MM_ROLE)

#: the plain (non-fused) collectives
FLAT_OPS = tuple(op for op in OPS if op not in FUSED_OPS)

# ---------------------------------------------------------------------------
# demotion ledger: impls removed from the admissible set at runtime
# (dispatch falls back to the default, the tuner skips them).  State of
# this process, keyed (op, impl name).
# ---------------------------------------------------------------------------

_DEMOTED: dict[tuple[str, str], str] = {}


def demote(op: str, name: str, reason: str = "tolerance") -> None:
    """Remove ``(op, name)`` from the admissible set for this process."""
    if name == "default":
        raise ValueError("the default impl cannot be demoted")
    if name not in REGISTRY[op]:
        raise KeyError(f"unknown impl {op}.{name}")
    _DEMOTED[(op, name)] = reason


def is_demoted(op: str, name: str) -> bool:
    return (op, name) in _DEMOTED


def demotions() -> dict[tuple[str, str], str]:
    """Snapshot of the current demotion ledger (copy)."""
    return dict(_DEMOTED)


def clear_demotions() -> None:
    _DEMOTED.clear()


def impl_names(op: str) -> list[str]:
    """The registered impls of ``op``, ``default`` first."""
    return list(REGISTRY[op])

