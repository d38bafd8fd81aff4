"""Collective matmul on the stacked axis: the block-matmul kernel and the
ppermute rings of allgather-matmul, matmul-reducescatter and
matmul-accumulate, with and without the quantized wire.

``block_matmul`` is the Hopper counterpart of the TPU kernel
``repro/kernels/collective_matmul.py:pallas_matmul``: ``x @ w`` with a
float32 accumulator, output dtype ``promote_types(x, w)``.  Its CUDA
source, with the bound it works against, is ``csrc/block_matmul.cu``.
It takes an optional leading batch dim, so one launch covers every
stacked rank of a ring step (a 2-D ``w`` is shared by the whole batch).
The C source decides which of its kernels a call takes
(``block_matmul_path``): ``wgmma`` (the persistent wgmma/TMA kernel) for
bf16/fp16 with k and n multiples of 8 and 16-byte aligned operands, else
``wmma`` (the tile loops of ``mm_tile.cuh``), ``f32`` for float32;
``block_matmul.launches_by_path`` counts them.

``ring_allgather_matmul`` is the JAX package's tier-1 ring: chunk s+1 is
shifted one rank on while chunk s is multiplied.  It is the CPU path of
``allgather_matmul``'s ``fused_ring``; on CUDA that impl runs the
one-kernel ring of ``collective_matmul_rdma``.

``ring_matmul_reducescatter`` is the ``fused_ring`` mock-up of
``matmul_reducescatter``: the travelling accumulator picks up one row
block's partial product per step, and each step's local product is one
``block_matmul`` launch over all ranks.  On one GPU the hop is a
device-memory copy, so the ring measures on-chip data movement and launch
overhead, not a link.

``ring_matmul_accumulate`` streams the weight's K-blocks past a
stationary x and adds the partial products; the ``*_wire`` rings are the
``wire_q8`` / ``wire_fp8`` mock-ups, with the travelling operand on the
8-bit wire of ``kernels/quant.py``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core._axis import StackedAxis, ring_perm
from repro_torch.kernels import _build
from repro_torch.kernels import quant as Q

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _lib() -> ctypes.CDLL:
    lib = _build.cuda_library("block_matmul", ["block_matmul.cu"])
    fn = lib.block_matmul
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        lib.block_matmul_path.restype = ctypes.c_int
        lib.block_matmul_path.argtypes = [ctypes.c_int] * 3
        lib.block_matmul_tile_n.restype = ctypes.c_int
        lib.block_matmul_tile_n.argtypes = [ctypes.c_int] * 3
    return lib


def build() -> None:
    """Compile (once) and load the CUDA library."""
    _lib()


PATHS = ("f32", "wmma", "wgmma")      # block_matmul_path


def block_matmul_path(dtype: torch.dtype, k: int, vec_ok: bool) -> str:
    """The kernel a launch of this dtype, depth and alignment takes (the
    C source's ``block_matmul_path``)."""
    return PATHS[_lib().block_matmul_path(_DTYPE_CODE[dtype], k,
                                          int(vec_ok))]


def block_matmul_tile_n(batch: int, m: int, n: int) -> int:
    """The tile width (128 or 256) of a ``wgmma`` launch at this shape on
    the current card (for logs)."""
    return _lib().block_matmul_tile_n(batch, m, n)


def block_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: float32 accumulation for float inputs,
    cast to ``promote_types(x, w)``."""
    out_dtype = torch.promote_types(x.dtype, w.dtype)
    if out_dtype.is_floating_point:
        return torch.matmul(x.float(), w.float()).to(out_dtype)
    return torch.matmul(x.to(out_dtype), w.to(out_dtype))


def block_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [m, k] @ w [k, n]``, or batched ``x [B, m, k] @ w [B, k, n]``
    (``w`` may stay ``[k, n]``, shared by the batch).  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return block_matmul_plain(x, w)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"block_matmul: x on {x.device}, w on {w.device}")
    if x.dtype != w.dtype or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"block_matmul takes float32/bfloat16/float16 "
                         f"operands of one dtype, got {x.dtype}, {w.dtype}")
    if x.dim() not in (2, 3) or w.dim() not in (2, 3) or (
            x.dim() == 2 and w.dim() == 3):
        raise ValueError(f"block_matmul: unsupported ranks {tuple(x.shape)} "
                         f"@ {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("block_matmul needs contiguous operands")
    batch = x.shape[0] if x.dim() == 3 else 1
    m, k = x.shape[-2:]
    k2, n = w.shape[-2:]
    if k != k2 or (w.dim() == 3 and w.shape[0] != batch):
        raise ValueError(f"block_matmul: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} do not chain")
    out = torch.empty(tuple(x.shape[:-1]) + (n,), dtype=x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    if k == 0:
        return out.zero_()
    swb = k * n if w.dim() == 3 else 0
    vec_ok = int(k % 8 == 0 and n % 8 == 0 and x.data_ptr() % 16 == 0
                 and w.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    path = block_matmul_path(x.dtype, k, vec_ok)
    rc = _lib().block_matmul(_DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(),
                             out.data_ptr(), batch, m, n, k, m * k, swb,
                             vec_ok, stream)
    if rc != 0:
        raise RuntimeError(f"block_matmul launch failed: CUDA error {rc}")
    block_matmul.launches += 1
    block_matmul.launches_by_path[path] += 1
    return out


block_matmul.launches = 0
block_matmul.launches_by_path = dict.fromkeys(PATHS, 0)


def _local_mm(x: torch.Tensor, w: torch.Tensor, mm: str) -> torch.Tensor:
    """The per-chunk product: ``"matmul"`` is ``torch.matmul`` in the input
    dtype (the JAX package's ``"jnp"``), ``"kernel"`` is ``block_matmul``
    (its ``"pallas"``), ``"auto"`` picks the kernel for CUDA tensors and
    ``torch.matmul`` for CPU ones."""
    if mm == "auto":
        mm = "kernel" if x.is_cuda else "matmul"
    if mm == "kernel":
        return block_matmul(x, w)
    if mm == "matmul":
        return torch.matmul(x, w)
    raise ValueError(f"unknown mm {mm!r}")


def ring_allgather_matmul(x: torch.Tensor, w: torch.Tensor,
                          axis: StackedAxis, *,
                          return_gathered: bool = False, mm: str = "auto"):
    """``all_gather(x, rows) @ w`` as a ring.

    x: ``[p, n, K]``, w: ``[p, K, M]`` or a shared ``[K, M]`` ->
    ``[p, p*n, M]`` (and, with ``return_gathered``, ``all_gather(x)``
    ``[p, p*n, K]``).  At step s rank r multiplies the chunk that
    originated on rank ``r - s`` into its rows, and the shift that brings
    chunk s+1 is issued before chunk s is consumed."""
    p = axis.size
    out_dtype = torch.promote_types(x.dtype, w.dtype)
    if p == 1:
        out = _local_mm(x, w, mm).to(out_dtype)
        return (out, x) if return_gathered else out
    n = x.shape[1]
    idx = axis.index()
    out = torch.zeros((p, p, n, w.shape[-1]), dtype=out_dtype,
                      device=x.device)
    gath = (torch.zeros((p, p) + tuple(x.shape[1:]), dtype=x.dtype,
                        device=x.device) if return_gathered else None)
    cur = x
    for s in range(p):
        nxt = axis.pshift(cur, ring_perm(p, 1)) if s < p - 1 else None
        src = (idx - s) % p                # originating rank of `cur`
        out[idx, src] = _local_mm(cur, w, mm).to(out_dtype)
        if return_gathered:
            gath[idx, src] = cur
        cur = nxt
    out = out.view(p, p * n, -1)
    if return_gathered:
        return out, gath.view((p, p * n) + tuple(x.shape[2:]))
    return out


def ring_matmul_reducescatter(x: torch.Tensor, w: torch.Tensor,
                              axis: StackedAxis, *,
                              mm: str = "auto") -> torch.Tensor:
    """``reduce_scatter(x @ w, rows)`` as a ring.

    x: ``[p, p*n, K]`` (each rank holds a different K-slice of the logical
    operand), w: ``[p, K, M]`` or a shared ``[K, M]`` -> ``[p, n, M]``
    summed over ranks.  At step s rank r adds its contribution to row
    block ``(r + p-1-s) % p`` into the accumulator it received, then
    passes the accumulator one rank on."""
    p = axis.size
    out_dtype = torch.promote_types(x.dtype, w.dtype)
    if p == 1:
        return _local_mm(x, w, mm).to(out_dtype)
    rows = x.shape[1]
    if rows % p:
        raise ValueError(f"rows {rows} not divisible by axis size {p}")
    n = rows // p
    idx = axis.index()
    lanes = x.reshape((p, p, n) + tuple(x.shape[2:]))
    acc = None
    for s in range(p):
        blk = lanes[idx, (idx + (p - 1 - s)) % p]
        contrib = _local_mm(blk, w, mm).to(out_dtype)
        acc = contrib if acc is None else acc + contrib
        if s < p - 1:
            acc = axis.pshift(acc, ring_perm(p, 1))
    return acc


def _k_slices(x: torch.Tensor, p: int, k_loc: int) -> torch.Tensor:
    """``x [R, T, p*k_loc]`` viewed as its p contraction slices
    ``[R, T, p, k_loc]`` (a shared ``[T, K]`` x gets R = 1)."""
    if x.shape[-1] != p * k_loc:
        raise ValueError(f"x {tuple(x.shape)} does not contract with p={p} "
                         f"weight blocks of {k_loc} rows")
    x3 = x if x.dim() == 3 else x.unsqueeze(0)
    return x3.reshape(x3.shape[0], x3.shape[1], p, k_loc)


def _take_k(xk: torch.Tensor, lane: torch.Tensor,
            src: torch.Tensor) -> torch.Tensor:
    """Per rank r, the contraction slice ``src[r]`` of its x: ``[p, T,
    k_loc]``, contiguous (the block matmul's operand)."""
    if xk.shape[0] == 1:                 # one x shared by every rank
        return xk[0].index_select(1, src).transpose(0, 1).contiguous()
    return xk[lane, :, src].contiguous()


def ring_matmul_accumulate(x: torch.Tensor, w: torch.Tensor,
                           axis: StackedAxis, *,
                           return_gathered: bool = False, mm: str = "auto"):
    """``x @ all_gather(w, rows)`` as a ring: the contraction-dim ring.

    w: ``[p, k_loc, M]`` (each rank's K-block of the weight, the payload),
    x: ``[p, T, p*k_loc]`` or a shared ``[T, p*k_loc]`` -> ``[p, T, M]``
    (and, with ``return_gathered``, ``all_gather(w)`` ``[p, p*k_loc, M]``).
    The WEIGHT blocks travel: at step s rank r multiplies the K-slice of
    its x that matches the block originated by rank ``r - s``, and the
    shift that brings block s+1 is issued before block s is consumed.
    Partial products are added in the output dtype, as the JAX package
    adds them."""
    p = axis.size
    out_dtype = torch.promote_types(x.dtype, w.dtype)
    if p == 1:
        out = _local_mm(x if x.dim() == 3 else x.unsqueeze(0), w,
                        mm).to(out_dtype)
        return (out, w) if return_gathered else out
    k_loc = w.shape[1]
    xk = _k_slices(x, p, k_loc)
    idx = axis.index()
    gath = (w.new_zeros((p, p) + tuple(w.shape[1:]))
            if return_gathered else None)
    acc = None
    cur = w
    for s in range(p):
        nxt = axis.pshift(cur, ring_perm(p, 1)) if s < p - 1 else None
        src = (idx - s) % p                # originating rank of `cur`
        contrib = _local_mm(_take_k(xk, idx, src), cur, mm).to(out_dtype)
        acc = contrib if acc is None else acc + contrib
        if return_gathered:
            gath[idx, src] = cur
        cur = nxt
    if return_gathered:
        return acc, gath.view((p, p * k_loc) + tuple(w.shape[2:]))
    return acc


# ---------------------------------------------------------------------------
# quantized-wire rings (the wire_q8 / wire_fp8 mock-ups): the same
# issue-before-consume schedules with the TRAVELLING operand sent as an
# 8-bit wire pair (kernels/quant.py).  A gather-style ring quantizes each
# payload once at its origin (one quant_pack launch covers every stacked
# rank) and dequantizes what arrives (one dequant_unpack per step); the
# travelling accumulator is requantized before every hop and dequantized
# after it, and its partial sums are added in float32.
# ---------------------------------------------------------------------------


def ring_allgather_matmul_wire(x: torch.Tensor, w: torch.Tensor,
                               axis: StackedAxis, *,
                               wire_dtype: str = "int8",
                               return_gathered: bool = False,
                               mm: str = "auto"):
    """``ring_allgather_matmul`` with the travelling activation chunk sent
    as (8-bit values, per-block scales); the dequantized chunk feeds the
    step's product.  ``return_gathered`` gives the wire-approximate
    gathered operand (own chunk exact)."""
    p = axis.size
    out_dtype = torch.promote_types(x.dtype, w.dtype)
    if p == 1:
        out = _local_mm(x, w, mm).to(out_dtype)
        return (out, x) if return_gathered else out
    n = x.shape[1]
    idx = axis.index()
    out = torch.zeros((p, p, n, w.shape[-1]), dtype=out_dtype,
                      device=x.device)
    gath = (x.new_zeros((p, p) + tuple(x.shape[1:]))
            if return_gathered else None)
    q, sc = Q.quantize(x, wire_dtype)
    cur = x                                # resident chunk: never on the wire
    for s in range(p):
        nxt = (Q.wire_shift(axis, q, sc, ring_perm(p, 1)) if s < p - 1
               else None)
        src = (idx - s) % p
        out[idx, src] = _local_mm(cur, w, mm).to(out_dtype)
        if return_gathered:
            gath[idx, src] = cur
        if nxt is not None:
            q, sc = nxt
            cur = Q.dequantize(q, sc, x.dtype)
    out = out.view(p, p * n, -1)
    if return_gathered:
        return out, gath.view((p, p * n) + tuple(x.shape[2:]))
    return out


def ring_matmul_reducescatter_wire(x: torch.Tensor, w: torch.Tensor,
                                   axis: StackedAxis, *,
                                   wire_dtype: str = "int8",
                                   mm: str = "auto") -> torch.Tensor:
    """``ring_matmul_reducescatter`` with the travelling accumulator
    requantized per hop; contributions are added in float32 after the
    dequantization and the sum is cast once at the end."""
    p = axis.size
    out_dtype = torch.promote_types(x.dtype, w.dtype)
    if p == 1:
        return _local_mm(x, w, mm).to(out_dtype)
    rows = x.shape[1]
    if rows % p:
        raise ValueError(f"rows {rows} not divisible by axis size {p}")
    n = rows // p
    idx = axis.index()
    lanes = x.reshape((p, p, n) + tuple(x.shape[2:]))
    acc = None
    for s in range(p):
        blk = lanes[idx, (idx + (p - 1 - s)) % p]
        contrib = _local_mm(blk, w, mm).to(torch.float32)
        acc = contrib if acc is None else acc + contrib
        if s < p - 1:
            q, sc = Q.wire_shift(axis, *Q.quantize(acc, wire_dtype),
                               ring_perm(p, 1))
            acc = Q.dequantize(q, sc, torch.float32)
    return acc.to(out_dtype)


def ring_matmul_accumulate_wire(x: torch.Tensor, w: torch.Tensor,
                                axis: StackedAxis, *,
                                wire_dtype: str = "int8",
                                return_gathered: bool = False,
                                mm: str = "auto"):
    """``ring_matmul_accumulate`` with the travelling weight block sent as
    a wire pair quantized once at its origin; partial products are added
    in float32 after the dequantization and cast once at the end."""
    p = axis.size
    out_dtype = torch.promote_types(x.dtype, w.dtype)
    if p == 1:
        out = _local_mm(x if x.dim() == 3 else x.unsqueeze(0), w,
                        mm).to(out_dtype)
        return (out, w) if return_gathered else out
    k_loc = w.shape[1]
    xk = _k_slices(x, p, k_loc)
    idx = axis.index()
    gath = (w.new_zeros((p, p) + tuple(w.shape[1:]))
            if return_gathered else None)
    q, sc = Q.quantize(w, wire_dtype)
    cur = w                                # resident block: never on the wire
    acc = None
    for s in range(p):
        nxt = (Q.wire_shift(axis, q, sc, ring_perm(p, 1)) if s < p - 1
               else None)
        src = (idx - s) % p
        contrib = _local_mm(_take_k(xk, idx, src), cur, mm).to(
            torch.float32)
        acc = contrib if acc is None else acc + contrib
        if return_gathered:
            gath[idx, src] = cur
        if nxt is not None:
            q, sc = nxt
            cur = Q.dequantize(q, sc, w.dtype)
    out = acc.to(out_dtype)
    if return_gathered:
        return out, gath.view((p, p * k_loc) + tuple(w.shape[2:]))
    return out
