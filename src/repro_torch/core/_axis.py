"""The rank axis every mock-up is written against.

The JAX package runs p ranks under ``vmap(axis_name=)`` or ``shard_map``
and reaches them through ``lax`` collectives on a named axis.  Eager
PyTorch has no named axes, so the port passes an explicit axis object.
``StackedAxis`` keeps all p ranks on one device: ranks are the LEADING
dimension of every tensor, so a per-rank ``[n, ...]`` operand is a
``[p, n, ...]`` tensor, and a collective is a reduction, broadcast or
index copy along that dimension.  On a GPU a ring hop is therefore a
device-memory copy, not a link transfer.

Per-rank integers (``index()``, ring source ranks, rooted masks) are
``[p]`` tensors on the axis device, so the same mock-up code would run
unchanged on a process-group axis that holds one rank per process.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU.  With no GPU the caller must ask for the CPU
    explicitly (``device="cpu"``); nothing falls back to it quietly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is "
                               "unavailable")
        if dev.index is None:       # the index tensors report theirs
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def ring_perm(p: int, shift: int = 1) -> list[tuple[int, int]]:
    """Permutation sending rank i -> rank (i + shift) % p (a ring hop)."""
    return [(i, (i + shift) % p) for i in range(p)]


def shift_perm(p: int, shift: int) -> list[tuple[int, int]]:
    """Non-wrapping shift: rank i -> i + shift (ranks without a source
    receive zeros)."""
    if shift >= 0:
        return [(i, i + shift) for i in range(p - shift)]
    return [(i, i + shift) for i in range(-shift, p)]


def tree_rounds(p: int) -> int:
    """Number of rounds of a binomial tree over p ranks."""
    r = 0
    while (1 << r) < p:
        r += 1
    return r


class StackedAxis:
    """p ranks stacked along dim 0 of every tensor, on one device."""

    def __init__(self, p: int, device=None):
        if p < 1:
            raise ValueError(f"axis size must be >= 1, got {p}")
        self.p = int(p)
        self.device = resolve_device(device)
        self._index: dict[torch.dtype, torch.Tensor] = {}
        self._perms: dict[tuple, tuple] = {}

    def __repr__(self) -> str:
        return f"StackedAxis(p={self.p}, device={self.device})"

    @property
    def size(self) -> int:
        return self.p

    def index(self, dtype: torch.dtype = torch.int64) -> torch.Tensor:
        """Rank of each lane: a ``[p]`` tensor ``0..p-1`` on the device."""
        t = self._index.get(dtype)
        if t is None:
            t = torch.arange(self.p, dtype=dtype, device=self.device)
            self._index[dtype] = t
        return t

    def _check(self, x: torch.Tensor) -> None:
        if x.shape[0] != self.p:
            raise ValueError(f"leading dim {x.shape[0]} != axis size {self.p}")

    # -- collectives ---------------------------------------------------------
    def all_gather(self, x: torch.Tensor, tiled: bool = True) -> torch.Tensor:
        """``[p, n, ...]`` -> ``[p, p*n, ...]`` (tiled) or ``[p, p, n, ...]``:
        every rank holds every rank's block, in rank order."""
        self._check(x)
        full = x.unsqueeze(0).expand((self.p,) + tuple(x.shape))
        out = full.contiguous()
        if tiled:
            return out.view((self.p, self.p * x.shape[1]) + tuple(x.shape[2:]))
        return out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over ranks; every rank holds the sum."""
        self._check(x)
        s = x.sum(0, keepdim=True, dtype=x.dtype)
        return s.expand(x.shape).contiguous()

    def psum_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """``[p, p*n, ...]`` -> ``[p, n, ...]``: rank r holds block r of the
        sum over ranks."""
        self._check(x)
        rows = x.shape[1]
        if rows % self.p:
            raise ValueError(f"rows {rows} not divisible by axis size {self.p}")
        s = x.sum(0, dtype=x.dtype)
        return s.view((self.p, rows // self.p) + tuple(x.shape[2:]))

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``[p, p*n, ...]`` -> ``[p, p*n, ...]``: rank r's block j is rank
        j's block r."""
        self._check(x)
        rows = x.shape[1]
        if rows % self.p:
            raise ValueError(f"rows {rows} not divisible by axis size {self.p}")
        rest = tuple(x.shape[2:])
        y = x.reshape((self.p, self.p, rows // self.p) + rest).transpose(0, 1)
        return y.contiguous().view((self.p, rows) + rest)

    def _perm(self, pairs) -> tuple:
        key = tuple((int(s), int(d)) for s, d in pairs)
        hit = self._perms.get(key)
        if hit is None:
            src_of = [-1] * self.p
            for s, d in key:
                if not (0 <= s < self.p and 0 <= d < self.p):
                    raise ValueError(f"pair {(s, d)} outside axis {self.p}")
                if src_of[d] >= 0:
                    raise ValueError(f"rank {d} has two sources")
                src_of[d] = s
            if min(src_of) >= 0:
                hit = (True, torch.tensor(src_of, device=self.device), None)
            else:
                dst = [d for d in range(self.p) if src_of[d] >= 0]
                hit = (False,
                       torch.tensor([src_of[d] for d in dst],
                                    device=self.device),
                       torch.tensor(dst, device=self.device))
            self._perms[key] = hit
        return hit

    def pshift(self, x: torch.Tensor, pairs) -> torch.Tensor:
        """``ppermute`` over (src, dst) pairs; partial permutations are
        legal and a rank with no source receives zeros."""
        self._check(x)
        full, src, dst = self._perm(pairs)
        if full:
            return x.index_select(0, src)
        out = torch.zeros_like(x)
        if src.numel():
            out.index_copy_(0, dst, x.index_select(0, src))
        return out


# ---------------------------------------------------------------------------
# carrying per-rank operands between numpy and the stacked layout
# ---------------------------------------------------------------------------


def stack_shards(shards, device=None, dtype: torch.dtype | None = None
                 ) -> torch.Tensor:
    """Stack per-rank numpy arrays into one ``[p, ...]`` tensor.

    numpy has no bfloat16 of its own; arrays of the ``ml_dtypes`` bfloat16
    type (what the JAX package hands out) are carried bit for bit."""
    arr = np.stack([np.asarray(s) for s in shards])
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(resolve_device(device))


def unstack(t: torch.Tensor) -> list[np.ndarray]:
    """``[p, ...]`` tensor -> list of per-rank numpy arrays (bfloat16 comes
    back as float32, which holds every bfloat16 value exactly)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return list(t.numpy())
