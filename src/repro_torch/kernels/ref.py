"""Plain PyTorch oracles for every kernel (the counterpart of the JAX
package's ``kernels/ref.py``): the allclose targets, in the TPU kernels'
layouts.

The model kernels' oracles live beside their kernels and are re-exported
here; ``pack_ref`` and ``quant_roundtrip_ref`` are the oracles of the
guideline pack and of the quantized wire format.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.rwkv6_scan import rwkv6_ref
from repro_torch.kernels.ssd_mamba2 import ssd_ref

__all__ = ["flash_attention_ref", "rwkv6_ref", "ssd_ref", "pack_ref",
           "quant_roundtrip_ref"]


def pack_ref(x: torch.Tensor, idx: int, p: int) -> torch.Tensor:
    """GL3/GL13 one-hot placement: ``[n, d]`` -> ``[p*n, d]``, zeros
    except block ``idx``."""
    n, d = x.shape
    buf = x.new_zeros(p * n, d)
    buf[int(idx) * n:(int(idx) + 1) * n] = x
    return buf


def quant_roundtrip_ref(x: torch.Tensor, qmax: float, block_rows: int = 8):
    """Per-block symmetric quantize/dequantize (the wire format of
    ``kernels/quant.py``), as an explicit loop over scale blocks: scale =
    max(|block|)/qmax (taken in double, then float32), q =
    clip(round_half_even(x/scale)), roundtrip = q*scale.  Returns
    ``(roundtrip [n, d] float32, scales [nblocks] float32)``."""
    xf = torch.as_tensor(x).float()
    out = torch.empty_like(xf)
    scales = []
    for b in range(0, xf.shape[0], block_rows):
        blk = xf[b:b + block_rows]
        s = torch.tensor(max(float(blk.abs().max()), 1e-30) / qmax,
                         dtype=torch.float32)
        scales.append(s)
        out[b:b + block_rows] = torch.clamp(torch.round(blk / s),
                                            -qmax, qmax) * s
    return out, torch.stack(scales) if scales else torch.zeros(0)
