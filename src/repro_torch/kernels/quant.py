"""The quantized wire format, and its quantize/dequantize Triton kernels.

The ``wire_q8`` / ``wire_fp8`` mock-ups (``core/collectives.py``) send the
TRAVELLING operand of a ring in an 8-bit wire dtype with per-block f32
scales.  A payload ``[n, ...]`` is cut into blocks of ``BLOCK_ROWS``
leading rows (the last block may be short), and each block carries one
symmetric scale::

    scale_b = max(max|x_b|, 1e-30) / QMAX[wire_dtype]
    q_b     = clip(round_half_even(x_b / scale_b), -127, 127) as int8
            = (x_b / scale_b) as float8_e4m3fn (round to nearest even)

Dequantization is ``q.to(float32) * scale``; reductions add the float32
result before any cast.  One round trip errs by at most half a step
(``max|x_b| / 254`` for int8, ``|x| * 2**-4`` for e4m3), so a gather-style
ring (quantized once at the origin) stays within ``BASE_TOL`` and a
travelling accumulator (requantized per hop) within ``hops`` times it:
``wire_tol``.

Operands are STACKED, ``[R, n, ...]``: one payload per rank, and scale
blocks never cross a rank (a ragged ``n`` gives each rank a short last
block of its own).  Trailing dims flatten into one width ``d``.  Scales
come back as ``[R, ceil(n/8), 1]``.

Tiers:

* ``quant_pack`` / ``dequant_unpack`` are the Hopper counterparts of the
  TPU kernels ``repro/kernels/quant.py:quant_pack`` and ``:dequant_unpack``.
  A CUDA tensor launches the Triton kernel; a CPU tensor takes the
  ``*_plain`` version.  ``quantize`` / ``dequantize`` / ``wire_roundtrip``
  take any trailing shape and go through them.
* The kernels are bit-equal with the plain versions (and with the JAX
  package's jnp tier): the amax is exact in any order, both divisions are
  IEEE round-to-nearest (``div_rn``, not Triton's approximate ``/``),
  int8 rounds half to even (libdevice ``rint``) and clips before the cast,
  and e4m3 is one saturating round-to-nearest-even conversion.  Out of the
  format's range (``|x/scale| > 448``, which the scale rules out) torch
  and ml_dtypes disagree (448 vs NaN); nothing here relies on either.

Bound on an H100: both kernels are one streaming pass, so bytes bound
them.  ``quant_pack`` reads x once and writes q and the scales once:
``(R*n*d*(itemsize + 1) + 4*R*nb) / 3.35 TB/s`` (x ``[8, 512, 3072]``
bf16: 37.8 MB, 11.3 µs; the float32 accumulator of the same shape:
62.9 MB, 18.8 µs); ``dequant_unpack`` the same with the roles swapped.
Design: one program per (rank, scale block), a 1-D grid of ``R*nb``
programs, so no axis limit of 65535 applies.  A program loads its <= 8
rows in column tiles of ``BLOCK_D`` with masked edges, takes the amax,
writes the scale, and a second pass over the same tiles (from L2 when the
block spans more than one tile) writes q.  Masked rows load 0 and never
raise the amax, which replaces the TPU kernel's zero-padding: no pad copy,
no slice copy.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

__all__ = ["WIRE_IMPLS", "WIRE_DTYPES", "WIRE_ITEMSIZE", "QMAX", "BLOCK_ROWS",
           "BASE_TOL", "wire_tol", "quantize", "dequantize", "wire_roundtrip",
           "wire_shift", "quant_pack", "quant_pack_plain", "dequant_unpack",
           "dequant_unpack_plain"]

#: the quantized mock-up families: (impl name, wire dtype)
WIRE_IMPLS = (("wire_q8", "int8"), ("wire_fp8", "float8_e4m3fn"))

#: wire dtypes of the quantized mock-up families
WIRE_DTYPES = tuple(wd for _, wd in WIRE_IMPLS)

#: bytes per wire element
WIRE_ITEMSIZE = {"int8": 1, "float8_e4m3fn": 1}

#: largest representable magnitude per wire dtype (e4m3 max finite = 448)
QMAX = {"int8": 127.0, "float8_e4m3fn": 448.0}

#: rows per scale block
BLOCK_ROWS = 8

#: single-roundtrip max-norm relative error bound per wire dtype, ~4x the
#: analytic half-step (1/254 for int8, 2**-4 for the 3-bit e4m3 mantissa)
BASE_TOL = {"int8": 4.0 / 254.0, "float8_e4m3fn": 4.0 * 2.0 ** -4}

_SCALE_FLOOR = 1e-30

_TORCH_WIRE = {"int8": torch.int8, "float8_e4m3fn": torch.float8_e4m3fn}

NUM_WARPS = 4
MAX_BLOCK_D = 1024


def wire_tol(wire_dtype: str, hops: int = 1) -> float:
    """Max-norm relative error bound of a wire impl whose travelling data
    is (re)quantized ``hops`` times (errors add per hop)."""
    return BASE_TOL[wire_dtype] * max(int(hops), 1)


def _nblocks(n: int) -> int:
    return -(-n // BLOCK_ROWS)


def _wire(wire_dtype: str) -> torch.dtype:
    if wire_dtype not in _TORCH_WIRE:
        raise ValueError(f"unknown wire dtype {wire_dtype!r}; one of "
                         f"{WIRE_DTYPES}")
    return _TORCH_WIRE[wire_dtype]


def _as3(x: torch.Tensor, what: str) -> tuple[torch.Tensor, bool]:
    """``[R, n, d]`` view of a wrapper operand (``[n, d]`` is R = 1)."""
    if x.dim() == 2:
        return x.unsqueeze(0), True
    if x.dim() != 3:
        raise ValueError(f"{what} takes [R, n, d] or [n, d], got "
                         f"{tuple(x.shape)}")
    return x, False


# ---------------------------------------------------------------------------
# the Triton kernels (built at first launch, never at import)
# ---------------------------------------------------------------------------

_KERNELS = None


def _triton_kernels():
    global _KERNELS
    if _KERNELS is None:
        _build.triton_setup()
        import triton
        import triton.language as tl
        try:
            from triton.language.extra import libdevice
        except ImportError:          # older Triton keeps it under cuda/
            from triton.language.extra.cuda import libdevice

        @triton.jit
        def _quant_kernel(x_ptr, q_ptr, s_ptr, n, d, nb,
                          QMAX: tl.constexpr, IS_INT8: tl.constexpr,
                          ROWS: tl.constexpr, BLOCK_D: tl.constexpr):
            pid = tl.program_id(0)          # r * nb + b
            r = pid // nb
            b = pid - r * nb
            rows = b * ROWS + tl.arange(0, ROWS)
            rmask = rows < n
            base = (r.to(tl.int64) * n + rows.to(tl.int64)) * d
            cols = tl.arange(0, BLOCK_D)
            amax = tl.zeros((ROWS, BLOCK_D), dtype=tl.float32)
            for c0 in range(0, d, BLOCK_D):
                cm = (c0 + cols) < d
                m = rmask[:, None] & cm[None, :]
                v = tl.load(x_ptr + base[:, None] + (c0 + cols)[None, :],
                            mask=m, other=0.0).to(tl.float32)
                amax = tl.maximum(amax, tl.abs(v))
            a = tl.max(tl.max(amax, axis=1), axis=0)
            scale = tl.math.div_rn(tl.maximum(a, 1e-30), QMAX)
            tl.store(s_ptr + pid, scale)
            for c0 in range(0, d, BLOCK_D):
                cm = (c0 + cols) < d
                m = rmask[:, None] & cm[None, :]
                offs = base[:, None] + (c0 + cols)[None, :]
                v = tl.load(x_ptr + offs, mask=m, other=0.0).to(tl.float32)
                y = tl.math.div_rn(v, scale)
                if IS_INT8:
                    y = tl.minimum(tl.maximum(libdevice.rint(y), -127.0),
                                   127.0)
                    tl.store(q_ptr + offs, y.to(tl.int8), mask=m)
                else:
                    tl.store(q_ptr + offs, y.to(tl.float8e4nv), mask=m)

        @triton.jit
        def _dequant_kernel(q_ptr, s_ptr, o_ptr, n, d, nb,
                            ROWS: tl.constexpr, BLOCK_D: tl.constexpr):
            pid = tl.program_id(0)
            r = pid // nb
            b = pid - r * nb
            rows = b * ROWS + tl.arange(0, ROWS)
            rmask = rows < n
            base = (r.to(tl.int64) * n + rows.to(tl.int64)) * d
            cols = tl.arange(0, BLOCK_D)
            scale = tl.load(s_ptr + pid)
            for c0 in range(0, d, BLOCK_D):
                cm = (c0 + cols) < d
                m = rmask[:, None] & cm[None, :]
                offs = base[:, None] + (c0 + cols)[None, :]
                v = tl.load(q_ptr + offs, mask=m).to(tl.float32)
                tl.store(o_ptr + offs,
                         (v * scale).to(o_ptr.dtype.element_ty), mask=m)

        _KERNELS = (triton, _quant_kernel, _dequant_kernel)
    return _KERNELS


def _block_d(triton, d: int) -> int:
    """Column tile: the row width's power of two, in [16, MAX_BLOCK_D]."""
    return min(MAX_BLOCK_D, max(16, triton.next_power_of_2(d)))


def build() -> None:
    """Compile the two kernels for every wire dtype on a tiny payload
    (Triton builds one binary per dtype combination at first launch)."""
    x = torch.ones((1, 3, 5), device="cuda")
    for wd in WIRE_DTYPES:
        q, s = quant_pack(x, wd)
        dequant_unpack(q, s, torch.bfloat16)
        dequant_unpack(q, s, torch.float32)


# ---------------------------------------------------------------------------
# quant_pack: quantize-on-send
# ---------------------------------------------------------------------------


def _row_scales(scales: torch.Tensor, n: int) -> torch.Tensor:
    """Per-row scales ``[R, n, 1]`` from the per-block ``[R, nb, 1]``."""
    idx = torch.arange(n, device=scales.device) // BLOCK_ROWS
    return scales.index_select(1, idx)


def quant_pack_plain(x: torch.Tensor, wire_dtype: str = "int8"):
    """The plain PyTorch version: ``x [R, n, d]`` -> ``(q [R, n, d]`` in
    the wire dtype, ``scales [R, nb, 1]`` float32)."""
    qmax = QMAX[wire_dtype]
    R, n, d = x.shape
    nb = _nblocks(n)
    xf = x.to(torch.float32)
    pad = nb * BLOCK_ROWS - n
    xp = torch.cat([xf, xf.new_zeros(R, pad, d)], 1) if pad else xf
    amax = xp.abs().reshape(R, nb, BLOCK_ROWS * d).amax(-1) if d else \
        xf.new_zeros(R, nb)
    # divide by a tensor: torch on CUDA turns a division by a Python
    # scalar into a product with its reciprocal, which is not IEEE division
    scales = (amax.clamp_min(_SCALE_FLOOR)
              / torch.full_like(amax, qmax)).unsqueeze(-1)
    y = xf / _row_scales(scales, n)
    if wire_dtype == "int8":
        q = torch.clamp(torch.round(y), -qmax, qmax).to(torch.int8)
    else:
        q = y.to(_wire(wire_dtype))
    return q, scales


def quant_pack(x: torch.Tensor, wire_dtype: str = "int8"):
    """Quantize-on-send: ``x [R, n, d]`` (or ``[n, d]``) bfloat16, float16
    or float32 -> ``(q, scales [R, nb, 1])`` (``[nb, 1]`` for 2-D x).  A
    CPU tensor takes the plain version; a CUDA tensor launches the
    kernel."""
    wt = _wire(wire_dtype)
    x3, squeeze = _as3(x, "quant_pack")
    if x.device.type == "cpu":
        q, s = quant_pack_plain(x3, wire_dtype)
    elif x.device.type == "cuda":
        if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
            raise ValueError(f"quant_pack takes float32/bfloat16/float16, "
                             f"got {x.dtype}")
        if not x3.is_contiguous():
            raise ValueError("quant_pack needs a contiguous x")
        R, n, d = x3.shape
        nb = _nblocks(n)
        q = torch.empty((R, n, d), dtype=wt, device=x.device)
        s = torch.empty((R, nb, 1), dtype=torch.float32, device=x.device)
        if R * nb:
            triton, kern, _ = _triton_kernels()
            kern[(R * nb,)](x3, q, s, n, d, nb, QMAX=QMAX[wire_dtype],
                            IS_INT8=wire_dtype == "int8", ROWS=BLOCK_ROWS,
                            BLOCK_D=_block_d(triton, d), num_warps=NUM_WARPS)
            quant_pack.launches += 1
    else:
        raise ValueError(f"unsupported device {x.device}")
    return (q[0], s[0]) if squeeze else (q, s)


quant_pack.launches = 0


# ---------------------------------------------------------------------------
# dequant_unpack: dequantize-on-receive
# ---------------------------------------------------------------------------


def dequant_unpack_plain(q: torch.Tensor, scales: torch.Tensor,
                         out_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """The plain PyTorch version: ``q.to(float32) * scale`` per block, cast
    to ``out_dtype``."""
    n = q.shape[1]
    return (q.to(torch.float32) * _row_scales(scales, n)).to(out_dtype)


def dequant_unpack(q: torch.Tensor, scales: torch.Tensor,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of ``quant_pack``: ``q [R, n, d]`` (or ``[n, d]``) int8 or
    float8_e4m3fn and ``scales [R, nb, 1]`` float32 -> ``[R, n, d]``
    ``out_dtype``.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel."""
    q3, squeeze = _as3(q, "dequant_unpack")
    s3 = scales.unsqueeze(0) if squeeze else scales
    R, n, d = q3.shape
    nb = _nblocks(n)
    if q.dtype not in _TORCH_WIRE.values():
        raise ValueError(f"dequant_unpack takes int8/float8_e4m3fn, got "
                         f"{q.dtype}")
    if tuple(s3.shape) != (R, nb, 1) or s3.dtype != torch.float32:
        raise ValueError(f"scales must be float32 of shape {(R, nb, 1)}, "
                         f"got {s3.dtype} {tuple(s3.shape)}")
    if s3.device != q.device:
        raise ValueError(f"scales on {s3.device}, q on {q.device}")
    if q.device.type == "cpu":
        out = dequant_unpack_plain(q3, s3, out_dtype)
    elif q.device.type == "cuda":
        if out_dtype not in (torch.float32, torch.bfloat16, torch.float16):
            raise ValueError(f"dequant_unpack writes float32/bfloat16/"
                             f"float16, not {out_dtype}")
        if not (q3.is_contiguous() and s3.is_contiguous()):
            raise ValueError("dequant_unpack needs contiguous operands")
        out = torch.empty((R, n, d), dtype=out_dtype, device=q.device)
        if R * nb:
            triton, _, kern = _triton_kernels()
            kern[(R * nb,)](q3, s3, out, n, d, nb, ROWS=BLOCK_ROWS,
                            BLOCK_D=_block_d(triton, d), num_warps=NUM_WARPS)
            dequant_unpack.launches += 1
    else:
        raise ValueError(f"unsupported device {q.device}")
    return out[0] if squeeze else out


dequant_unpack.launches = 0


# ---------------------------------------------------------------------------
# any trailing shape
# ---------------------------------------------------------------------------


def quantize(x: torch.Tensor, wire_dtype: str = "int8"):
    """Per-block symmetric quantization of a stacked ``x [R, n, ...]``:
    ``(q`` of x's shape in the wire dtype, ``scales [R, nb, 1]`` float32).
    The pair is the wire format a ring step shifts."""
    R, n = x.shape[:2]
    d = math.prod(x.shape[2:])
    q, s = quant_pack(x.reshape(R, n, d).contiguous(), wire_dtype)
    return q.view(x.shape), s


def dequantize(q: torch.Tensor, scales: torch.Tensor,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of ``quantize``.  Reductions must add the float32 result
    before any cast to a narrower ``out_dtype``."""
    R, n = q.shape[:2]
    d = math.prod(q.shape[2:])
    out = dequant_unpack(q.reshape(R, n, d).contiguous(), scales, out_dtype)
    return out.view(q.shape)


def wire_roundtrip(x: torch.Tensor, wire_dtype: str = "int8"
                   ) -> torch.Tensor:
    """One quantize/dequantize round trip: what one wire hop does to the
    payload values."""
    q, s = quantize(x, wire_dtype)
    return dequantize(q, s, x.dtype)


def wire_shift(axis, q: torch.Tensor, sc: torch.Tensor,
               pairs) -> tuple[torch.Tensor, torch.Tensor]:
    """One hop of a wire pair over a stacked axis (``axis.pshift``).  The
    values travel as their bytes: torch has no float8 kernel for some
    index ops on the CPU."""
    qb = axis.pshift(q.view(torch.uint8), pairs).view(q.dtype)
    return qb, axis.pshift(sc, pairs)
