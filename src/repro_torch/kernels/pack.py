"""Guideline pack: the mock-ups' one-hot placement, as a Triton kernel.

Replaces the TPU kernel ``repro/kernels/pack.py:guideline_pack``
(``_kernel``): GL3/GL13 place each rank's payload at block ``idx`` of a
p-times larger zero buffer before the collective.  Output block j of lane
r is ``x[r]`` when ``j == idx[r]`` and zeros otherwise.

Bound on an H100: a pure copy-or-zero pass with no arithmetic, so it is
bound by device-memory bytes, ``(R*p*n*d + R*n*d) * itemsize / 3.35 TB/s``
(every input byte read once, every output byte written once).  The
design meets the byte floor: one program per (output block, rank-block
pair) whose load is masked off entirely unless the block is the hit, so
x is read once, the output is written once, and no pass zero-fills the
buffer first.  ``idx`` is loaded on the device, so there is no host sync.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

BLOCK = 4096
NUM_WARPS = 8

_KERNEL = None


def _triton_kernel():
    global _KERNEL
    if _KERNEL is None:
        _build.triton_setup()
        import triton
        import triton.language as tl

        @triton.jit
        def _pack_kernel(x_ptr, idx_ptr, o_ptr, p, nd,
                         BLOCK: tl.constexpr):
            blk = tl.program_id(0)          # BLOCK-sized tile of one block
            rj = tl.program_id(1)           # r * p + j
            r = rj // p
            j = rj - r * p
            hit = tl.load(idx_ptr + r) == j
            offs = blk.to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
            inb = offs < nd
            v = tl.load(x_ptr + r.to(tl.int64) * nd + offs,
                        mask=inb & hit, other=0)
            tl.store(o_ptr + rj.to(tl.int64) * nd + offs, v, mask=inb)

        _KERNEL = (triton, _pack_kernel)
    return _KERNEL


def guideline_pack_plain(x: torch.Tensor, idx: torch.Tensor,
                         p: int) -> torch.Tensor:
    """The plain PyTorch version: ``x [R, n, d]``, ``idx [R]`` ->
    ``[R, p*n, d]``."""
    R, n, d = x.shape
    hit = torch.arange(p, device=x.device)[None, :] == idx.long()[:, None]
    out = torch.where(hit[:, :, None, None], x[:, None],
                      torch.zeros((), dtype=x.dtype, device=x.device))
    return out.reshape(R, p * n, d)


def guideline_pack(x: torch.Tensor, idx: torch.Tensor, p: int) -> torch.Tensor:
    """One-hot placement: ``x [R, n, d]`` (or ``[n, d]``, R = 1) and an
    int32 ``idx [R]`` on the same device -> ``[R, p*n, d]`` (or
    ``[p*n, d]``).  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel."""
    squeeze = x.dim() == 2
    x3 = x.unsqueeze(0) if squeeze else x
    if x3.dim() != 3:
        raise ValueError(f"guideline_pack takes [R, n, d] or [n, d], "
                         f"got {tuple(x.shape)}")
    R, n, d = x3.shape
    if idx.dtype != torch.int32 or tuple(idx.shape) != (R,):
        raise ValueError(f"idx must be int32 of shape ({R},), got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    if idx.device != x.device:
        raise ValueError(f"idx on {idx.device}, x on {x.device}")
    if p < 1:
        raise ValueError(f"p must be >= 1, got {p}")
    if x.device.type == "cpu":
        out = guideline_pack_plain(x3, idx, p)
    elif x.device.type == "cuda":
        if not x3.is_contiguous():
            raise ValueError("guideline_pack needs a contiguous x")
        out = torch.empty((R, p * n, d), dtype=x.dtype, device=x.device)
        nd = n * d
        if nd and R:
            triton, kern = _triton_kernel()
            grid = (triton.cdiv(nd, BLOCK), R * p)
            kern[grid](x3, idx, out, p, nd, BLOCK=BLOCK,
                       num_warps=NUM_WARPS)
            guideline_pack.launches += 1
    else:
        raise ValueError(f"unsupported device {x.device}")
    return out[0] if squeeze else out


guideline_pack.launches = 0
