"""The one-kernel ring all-gather-matmul, and its per-rank block tier.

``ring_allgather_matmul_rdma`` is the Hopper counterpart of the TPU kernel
``repro/kernels/collective_matmul_rdma.py:ring_allgather_matmul_rdma``: one
launch runs the whole ring.  At step s rank r sends its resident chunk to
its right neighbour's double-buffered slot ``(s+1) % 2`` while it
multiplies the chunk into output rows ``ring_step_src(r, s, p) * n``, and
the flow control follows ``ring_schedule`` (arrival waits, buffer-reuse
credits).  On the stacked axis all ranks share one card's memory, so the
"remote copy" is a copy into the right neighbour's slot of a scratch
buffer in the same device memory, and the semaphores are counters there;
the name is kept only to find the counterpart.  The CUDA source, with the
bound it works against and the protocol step by step, is
``csrc/agmm_ring.cu``.  It holds two kernels, and the launch takes one by
the dtype and the alignment (``agmm_ring_path``), counted in
``ring_allgather_matmul_rdma.launches_by_path`` (and the same on
``ring_allgather_matmul_blocks``):

* ``"wgmma"``: bf16/fp16 whose k and m are multiples of 8 and whose base
  pointers are 16-byte aligned: warp-specialized CTAs on the wgmma/TMA
  mainloop of ``csrc/hopper_gemm.cuh``, the ring's copies on warps of
  their own;
* ``"wmma"``: other bf16/fp16 shapes, WMMA tiles (``csrc/mm_tile.cuh``);
* ``"f32"``: float32, FMA tiles.

The wrapper reads the error words back after every ring launch (a host
round trip), so that a timed-out flag wait raises where it happened.

``ring_allgather_matmul_blocks`` is the counterpart of the TPU kernel's
interpret-mode tier: rank ``my``'s p-step schedule over the full chunk
array, the same CUDA kernel launched for one rank with its counters off.

``ring_step_src``, ``ring_step_slots`` and ``ring_schedule`` are copies of
the JAX package's schedule helpers, on Python ints.

CPU tensors take the ``*_plain`` versions (the step loop in torch, float32
accumulation, cast to ``promote_types(x, w)``); CUDA tensors launch the
kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core._axis import StackedAxis
from repro_torch.kernels import _build
from repro_torch.kernels.collective_matmul import (_DTYPE_CODE, block_matmul,
                                                   block_matmul_plain)

__all__ = ["ring_allgather_matmul_rdma", "ring_allgather_matmul_rdma_plain",
           "ring_allgather_matmul_blocks",
           "ring_allgather_matmul_blocks_plain", "ring_step_src",
           "ring_step_slots", "ring_schedule"]


def ring_step_src(my: int, s: int, p: int) -> int:
    """Originating rank of the chunk resident at ring step ``s`` on rank
    ``my``: the output-row placement index."""
    return (my - s + p) % p


def ring_step_slots(s: int) -> tuple[int, int]:
    """(consume, send-target) double-buffer slots of ring step ``s``."""
    return s % 2, (s + 1) % 2


def ring_schedule(p: int) -> list[dict]:
    """The ring's per-step flow-control protocol as data, one dict per
    step: ``slot``/``nxt`` (consume / send-target slots), ``send`` (copy
    to the right neighbour, s < p-1), ``wait_credit`` (the right neighbour
    has consumed the target slot, 1 <= s < p-1), ``wait_dma`` (this
    step's arrival is complete, s < p-1) and ``grant_credit`` (tell the
    left neighbour our slot is consumed, s < p-2)."""
    steps = []
    for s in range(p):
        slot, nxt = ring_step_slots(s)
        steps.append({"s": s, "slot": slot, "nxt": nxt,
                      "send": s < p - 1,
                      "wait_credit": 1 <= s < p - 1,
                      "wait_dma": s < p - 1,
                      "grant_credit": s < p - 2})
    return steps


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def ring_allgather_matmul_blocks_plain(x_all: torch.Tensor, w: torch.Tensor,
                                       my: int):
    """Rank ``my``'s p steps over ``x_all [p, n, K]`` with ``w [K, M]``:
    the double buffer is seeded with chunk ``my``, step s stores the chunk
    of step s+1 in slot ``(s+1) % 2`` and multiplies slot ``s % 2`` into
    rows ``ring_step_src(my, s, p) * n``.  Returns
    ``(out [p*n, M], gathered [p*n, K])``."""
    p, n, k = x_all.shape
    out_dtype = torch.promote_types(x_all.dtype, w.dtype)
    out = torch.empty((p * n, w.shape[-1]), dtype=out_dtype,
                      device=x_all.device)
    gath = torch.empty((p * n, k), dtype=x_all.dtype, device=x_all.device)
    comm = [x_all[my], None]
    for s in range(p):
        slot, nxt = ring_step_slots(s)
        if s < p - 1:
            comm[nxt] = x_all[ring_step_src(my, s + 1, p)]
        src = ring_step_src(my, s, p)
        blk = comm[slot]
        out[src * n:(src + 1) * n] = block_matmul_plain(blk, w)
        gath[src * n:(src + 1) * n] = blk
    return out, gath


def ring_allgather_matmul_rdma_plain(x: torch.Tensor, w: torch.Tensor, *,
                                     return_gathered: bool = False):
    """The ring's step loop over all ranks at once: at step s rank r
    multiplies chunk ``ring_step_src(r, s, p)`` by ``w[r]`` (or the shared
    ``w``).  ``x [p, n, K]`` -> ``[p, p*n, M]`` (and ``[p, p*n, K]``)."""
    p, n, k = x.shape
    out_dtype = torch.promote_types(x.dtype, w.dtype)
    ranks = torch.arange(p, device=x.device)
    out = torch.empty((p, p, n, w.shape[-1]), dtype=out_dtype,
                      device=x.device)
    gath = torch.empty((p, p, n, k), dtype=x.dtype, device=x.device)
    for s in range(p):
        src = (ranks - s) % p
        chunk = x[src]
        out[ranks, src] = block_matmul_plain(chunk, w)
        gath[ranks, src] = chunk
    out = out.view(p, p * n, -1)
    return (out, gath.view(p, p * n, k)) if return_gathered else out


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = _build.cuda_library("agmm_ring", ["agmm_ring.cu"])
    fn = lib.agmm_ring
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        bpr = lib.agmm_ring_blocks_per_rank
        bpr.restype = ctypes.c_int
        bpr.argtypes = [ctypes.c_int] * 4
        path = lib.agmm_ring_path
        path.restype = ctypes.c_int
        path.argtypes = [ctypes.c_int] * 3
    return lib


def build() -> None:
    """Compile (once) and load the CUDA library."""
    _lib()


def blocks_per_rank(dtype: torch.dtype, p: int, n: int, m: int) -> int:
    """Blocks each of p ranks gets in a launch at this shape (for logs)."""
    return _lib().agmm_ring_blocks_per_rank(_DTYPE_CODE[dtype], p, n, m)


_WAIT_KIND = {1: "credit", 2: "arrival"}
PATHS = ("f32", "wmma", "wgmma")      # agmm_ring_path


def _launch(x, w, out, gath, p, my, blocks_mode) -> str:
    """Check the operands, launch, and raise on a launch error or on a
    flag wait that timed out.  Returns the path the launch took."""
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"agmm_ring: x on {x.device}, w on {w.device}")
    if x.dtype != w.dtype or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"agmm_ring takes float32/bfloat16/float16 "
                         f"operands of one dtype, got {x.dtype}, {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("agmm_ring needs contiguous operands")
    _, n, k = x.shape
    m = w.shape[-1]
    if w.shape[-2] != k:
        raise ValueError(f"agmm_ring: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} do not chain")
    ptrs = [t.data_ptr() for t in (x, w, out, gath) if t is not None]
    if blocks_mode:
        slots = flags = None
    else:
        slots = torch.empty((p, 2, n, k), dtype=x.dtype, device=x.device)
        # the tile kernel's counters [2p], the error words [3], the wgmma
        # kernel's per-step counters [2p^2]
        flags = torch.zeros(2 * p + 3 + 2 * p * p, dtype=torch.int32,
                            device=x.device)
        ptrs.append(slots.data_ptr())
    vec_ok = int(k % 8 == 0 and m % 8 == 0 and all(a % 16 == 0
                                                   for a in ptrs))
    swb = k * m if w.dim() == 3 else 0
    stream = torch.cuda.current_stream(x.device).cuda_stream
    path = PATHS[_lib().agmm_ring_path(_DTYPE_CODE[x.dtype], k, vec_ok)]
    rc = _lib().agmm_ring(
        _DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(), out.data_ptr(),
        None if gath is None else gath.data_ptr(),
        None if slots is None else slots.data_ptr(),
        None if flags is None else flags.data_ptr(), p, n, k, m, swb,
        int(blocks_mode), my, vec_ok, stream)
    if rc != 0:
        raise RuntimeError(f"agmm_ring launch failed: CUDA error {rc}")
    if flags is not None:
        kind, rank, step = flags[2 * p:2 * p + 3].tolist()
        if kind:
            raise RuntimeError(
                f"agmm_ring: flag wait timed out ({_WAIT_KIND[kind]} wait "
                f"of rank {rank} at step {step}, p={p}, x "
                f"{tuple(x.shape)}, w {tuple(w.shape)})")
    return path


def ring_allgather_matmul_rdma(x: torch.Tensor, w: torch.Tensor,
                               axis: StackedAxis, *,
                               return_gathered: bool = False):
    """``all_gather(x, rows) @ w`` as one kernel.

    x ``[p, n, K]`` stacked, w shared ``[K, M]`` or per-rank
    ``[p, K, M]`` -> ``[p, p*n, M]``, with ``return_gathered`` also
    ``all_gather(x)`` ``[p, p*n, K]``.  At p == 1 it is ``block_matmul``.
    On an axis of a ``StackedMesh`` (``[L, ...]`` operands, L lanes in
    groups of p) each group is one ring: one launch per group.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    p = axis.size
    if axis.lanes != p:
        return _per_group(x, w, axis, return_gathered)
    if x.dim() != 3 or x.shape[0] != p:
        raise ValueError(f"x must be [p={p}, n, K], got {tuple(x.shape)}")
    if w.dim() not in (2, 3) or (w.dim() == 3 and w.shape[0] != p):
        raise ValueError(f"w must be [K, M] or [p={p}, K, M], got "
                         f"{tuple(w.shape)}")
    if p == 1:
        out = block_matmul(x, w)
        return (out, x) if return_gathered else out
    if x.device.type == "cpu" and w.device.type == "cpu":
        return ring_allgather_matmul_rdma_plain(
            x, w, return_gathered=return_gathered)
    _, n, k = x.shape
    out = torch.empty((p, p * n, w.shape[-1]),
                      dtype=torch.promote_types(x.dtype, w.dtype),
                      device=x.device)
    gath = (torch.empty((p, p * n, k), dtype=x.dtype, device=x.device)
            if return_gathered else None)
    if out.numel() or (gath is not None and gath.numel()):
        path = _launch(x, w, out, gath, p, 0, False)
        ring_allgather_matmul_rdma.launches += 1
        ring_allgather_matmul_rdma.launches_by_path[path] += 1
    return (out, gath) if return_gathered else out


ring_allgather_matmul_rdma.launches = 0
ring_allgather_matmul_rdma.launches_by_path = dict.fromkeys(PATHS, 0)


def _per_group(x, w, axis: StackedAxis, return_gathered: bool):
    """The ring on each group of lanes of a mesh axis, one launch each:
    the kernel runs one ring over the p ranks it is given."""
    ring = StackedAxis(axis.size, x.device)
    lanes = x.shape[0]
    if w.dim() == 3 and w.shape[0] != lanes:
        raise ValueError(f"w must be [K, M] or [L={lanes}, K, M], got "
                         f"{tuple(w.shape)}")
    groups = axis.groups()
    outs, gaths = [], []
    for grp in groups:
        wg = w.index_select(0, grp) if w.dim() == 3 else w
        r = ring_allgather_matmul_rdma(x.index_select(0, grp), wg, ring,
                                       return_gathered=return_gathered)
        o, gg = r if return_gathered else (r, None)
        outs.append(o)
        gaths.append(gg)

    def place(parts):
        """The groups' results, each row back at its own lane."""
        y = torch.cat(parts)
        return torch.empty_like(y).index_copy_(0, groups.flatten(), y)

    out = place(outs)
    gath = place(gaths) if return_gathered else None
    return (out, gath) if return_gathered else out


def ring_allgather_matmul_blocks(x_all: torch.Tensor, w: torch.Tensor,
                                 my: int):
    """Rank ``my``'s ring schedule over ``x_all [p, n, K]`` with
    ``w [K, M]``: ``(out [p*n, M], gathered [p*n, K])``, as the ring
    kernel returns it for that rank.  CPU tensors take the plain version;
    CUDA tensors launch the kernel for the one rank."""
    if x_all.dim() != 3 or w.dim() != 2:
        raise ValueError(f"x_all must be [p, n, K] and w [K, M], got "
                         f"{tuple(x_all.shape)}, {tuple(w.shape)}")
    p, n, k = x_all.shape
    if not 0 <= my < p:
        raise ValueError(f"rank {my} outside 0..{p - 1}")
    if x_all.device.type == "cpu" and w.device.type == "cpu":
        return ring_allgather_matmul_blocks_plain(x_all, w, my)
    out = torch.empty((p * n, w.shape[-1]),
                      dtype=torch.promote_types(x_all.dtype, w.dtype),
                      device=x_all.device)
    gath = torch.empty((p * n, k), dtype=x_all.dtype, device=x_all.device)
    if out.numel() or gath.numel():
        path = _launch(x_all, w, out, gath, p, my, True)
        ring_allgather_matmul_blocks.launches += 1
        ring_allgather_matmul_blocks.launches_by_path[path] += 1
    return out, gath


ring_allgather_matmul_blocks.launches = 0
ring_allgather_matmul_blocks.launches_by_path = dict.fromkeys(PATHS, 0)
