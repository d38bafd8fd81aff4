"""Public wrappers for the model kernels and the guideline pack, under
the JAX package's names and in its layouts (its ``kernels/ops.py``).

A CUDA tensor launches the Hopper kernel, a CPU tensor takes the kernel's
plain version; nothing picks a device for the caller.  The JAX package's
``bq``/``bkv``/``chunk`` tile sizes and its ``interpret`` switch have no
counterpart: the CUDA kernels choose their own tiles and paths
(``flash_attention_plan``, ``rwkv6_scan_path``, ``ssd_scan_path``).  The
models call the kernels in their own layout (``kernels.flash_attention.
flash_attention`` and the scans), not through these.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention_bhsd
from repro_torch.kernels.pack import guideline_pack as _pack
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_bhsd
from repro_torch.kernels.ssd_mamba2 import ssd_scan_bhsd


#: ``q [B, Hq, Sq, dh]``, ``k, v [B, Hkv, Skv, dh]`` -> ``[B, Hq, Sq, dh]``
#: in q's dtype
flash_attention = flash_attention_bhsd
#: ``r, k, v, w [BH, S, hd]``, ``u [BH, hd]`` -> ``(y [BH, S, hd], s_fin
#: [BH, hd, hd])`` float32, from a zero state
rwkv6_scan = rwkv6_scan_bhsd
#: ``x [BH, S, P]``, ``dt [BH, S]``, ``a [BH]``, ``B, C [BH, S, N]`` ->
#: ``(y [BH, S, P], s_fin [BH, N, P])`` float32, from a zero state
ssd_scan = ssd_scan_bhsd


def guideline_pack(x: torch.Tensor, idx, p: int) -> torch.Tensor:
    """``x [n, d]`` and a shard index -> ``[p*n, d]``, x in block idx."""
    i = torch.as_tensor(idx, dtype=torch.int32, device=x.device).reshape(1)
    return _pack(x, i, p)
