"""The tuning cell: one communication problem, with its full geometry.

The paper compares a collective against its mock-ups on the actual
communication problem: type of communication, message size, number of
processes.  ``OpCell`` is that record, plus the GEMM a fused
collective-matmul op carries.  Every layer keys on it: the dispatcher
records one per call, traces aggregate them, profiles partition on
``OpCell.geom()``, the measured backend replays the recorded GEMM, and
the cost model prices the overlap from the true flops.

Geometry convention for fused matmul ops (the full logical GEMM is always
``[mm_m, mm_k] @ [mm_k, mm_n]``):

=======================  =========================  =======================
op                       collective operand         ``mm_role``
=======================  =========================  =======================
allgather_matmul         x ``[mm_m/p, mm_k]``       ``gather``
matmul_reducescatter     x ``[mm_m, mm_k]``         ``scatter``
matmul_accumulate        w ``[mm_k/p, mm_n]``       ``contract``
matmul_reducescatter_2d  w ``[mm_k, mm_n/p]``       ``2d`` / ``2dT``
=======================  =========================  =======================

``p2`` is the second axis size of a two-axis cell and ``tier`` the
interconnect-tier token; both stay 0 / ``""`` for the one-axis cells this
package dispatches today, but they are part of the key so that cells,
traces and profiles written by the JAX package load here unchanged.
Payload bytes are always PER RANK: on a stacked axis that is the stacked
tensor's bytes divided by p.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

#: roles a fused matmul operand can play in its collective
MM_ROLES = ("gather", "scatter", "contract", "2d", "2dT")

#: dispatcher op -> role of its fused matmul (None for plain collectives)
OP_MM_ROLE = {
    "allgather_matmul": "gather",
    "matmul_reducescatter": "scatter",
    "matmul_accumulate": "contract",
    "matmul_reducescatter_2d": "2d",
}

#: mm_role -> fused dispatcher op (the inverse of ``OP_MM_ROLE``; both
#: 2-D roles fold onto the one 2-D op)
ROLE_TO_OP = {
    "gather": "allgather_matmul",
    "scatter": "matmul_reducescatter",
    "contract": "matmul_accumulate",
    "2d": "matmul_reducescatter_2d",
    "2dT": "matmul_reducescatter_2d",
}

#: collective class -> dispatcher op name, under the JAX package's HLO
#: class names (``analysis.graph`` normalises every c10d op to these, so
#: the two packages' sites compare field by field).  collective-permute has
#: no dispatcher registry entry (no mock-ups) but still gets a cell, so a
#: graph scan maps EVERY collective.
HLO_TO_OP = {
    "all-gather": "allgather",
    "all-reduce": "allreduce",
    "reduce-scatter": "reducescatter",
    "all-to-all": "alltoall",
    "collective-permute": "collective_permute",
}

#: element sizes of the dtypes numpy does not know by name
_ITEMSIZE = {"bfloat16": 2, "float8_e4m3fn": 1, "float8_e5m2": 1}


def dtype_name(dtype) -> str:
    """The dtype string cells carry (``torch.bfloat16`` -> ``"bfloat16"``),
    the same spelling the JAX package records."""
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True, order=True)
class Geom:
    """The matmul geometry of a fused cell — the profile partition key."""
    dtype: str
    mm_k: int
    mm_m: int
    mm_n: int
    mm_role: str
    p2: int = 0

    def distance(self, other: "Geom") -> float:
        """Log-space shape distance for the nearest-cell profile fallback
        (same role/dtype/p2 assumed; see ``ProfileStore.lookup_cell``)."""
        d = 0.0
        for a, b in ((self.mm_k, other.mm_k), (self.mm_m, other.mm_m),
                     (self.mm_n, other.mm_n)):
            d += abs(math.log2(max(a, 1)) - math.log2(max(b, 1)))
        return d


@dataclasses.dataclass(frozen=True, order=True)
class OpCell:
    """One tuning cell: collective type, scale, payload, and geometry."""
    op: str
    p: int                      # axis size the payload streams over
    nbytes: int                 # per-rank payload bytes of the operand
    dtype: str = "float32"
    mm_k: int = 0               # contraction dim of the fused GEMM
    mm_m: int = 0               # output rows of the fused GEMM
    mm_n: int = 0               # output cols of the fused GEMM
    mm_role: str = ""           # one of MM_ROLES or "" (plain)
    p2: int = 0                 # inner axis size (2-D / hierarchical cells)
    tier: str = ""              # interconnect-tier token ("" = flat)

    #: plain ops that may carry a second (intra) axis
    HIER_OPS = ("allreduce", "allgather", "reducescatter")

    def __post_init__(self):
        if self.mm_role and self.mm_role not in MM_ROLES:
            raise ValueError(f"unknown mm_role {self.mm_role!r}")
        if self.p2 and self.mm_role not in ("2d", "2dT"):
            if self.mm_role or self.op not in self.HIER_OPS:
                raise ValueError(
                    f"p2={self.p2} only valid for 2-D roles or the "
                    f"hierarchical plain ops {self.HIER_OPS}, not "
                    f"op={self.op!r} role={self.mm_role!r}")

    # -- views ---------------------------------------------------------------
    @property
    def fused(self) -> bool:
        """True when the cell carries a recorded GEMM geometry."""
        return self.mm_k > 0

    @property
    def hier(self) -> bool:
        """True for a two-axis plain cell (no fused GEMM)."""
        return self.p2 > 0 and not self.fused

    def profile_tier(self) -> str:
        """The tier token profiles partition on (hierarchical plain cells
        fold the inner axis size in)."""
        if self.hier:
            return f"{self.tier or 'hier'}@q{self.p2}"
        return self.tier

    def world(self) -> int:
        """Rank count the cell spans: ``p``, or ``p * p2`` for 2-D cells."""
        return self.p * self.p2 if self.p2 else self.p

    @property
    def itemsize(self) -> int:
        if self.dtype in _ITEMSIZE:
            return _ITEMSIZE[self.dtype]
        try:
            return int(np.dtype(self.dtype).itemsize)
        except TypeError:
            return 4

    def geom(self) -> Geom | None:
        """Geometry partition key, or None for plain / unknown-geometry
        cells (v1 traces carry fused ops with no recorded dims)."""
        if not self.fused:
            return None
        return Geom(self.dtype, self.mm_k, self.mm_m, self.mm_n,
                    self.mm_role, self.p2)

    @classmethod
    def plain(cls, op: str, p: int, nbytes: int,
              dtype: str = "float32") -> "OpCell":
        return cls(op=op, p=p, nbytes=nbytes, dtype=dtype)

    @classmethod
    def from_hlo(cls, base_op: str, p: int, nbytes: int,
                 dtype: str = "float32", *,
                 gemm: "tuple[int, int, int] | None" = None,
                 mm_role: str = "") -> "OpCell":
        """The tuning cell of one collective site of a captured program.

        ``base_op`` is the collective class (``"all-gather"``,
        ``"reduce-scatter"``, ...; ``HLO_TO_OP``).  A site adjacent to a
        matmul (an all-gather feeding it, or a matmul feeding a
        reduce-scatter) passes ``gemm=(mm_k, mm_m, mm_n)`` and ``mm_role``
        and maps to the FUSED dispatcher op, so the cost model prices the
        fused-ring mock-ups against what the program ran.  Raises
        ``KeyError`` for a class with no dispatcher op (callers report it
        as unmapped, never skip it)."""
        if gemm is not None and mm_role:
            mm_k, mm_m, mm_n = gemm
            return cls(op=ROLE_TO_OP[mm_role], p=p, nbytes=nbytes,
                       dtype=dtype, mm_k=mm_k, mm_m=mm_m, mm_n=mm_n,
                       mm_role=mm_role)
        op = HLO_TO_OP.get(base_op)
        if op is None:
            raise KeyError(f"no dispatcher op for collective {base_op!r}")
        return cls.plain(op, p, nbytes, dtype)

    # -- derived cells -------------------------------------------------------
    def scaled_to(self, nbytes: int) -> "OpCell":
        """The same problem at a different payload size (NREP probes).

        For fused cells the dimension tied to the collective operand is
        rescaled so the replayed GEMM stays consistent with the payload
        (``gather``/``scatter`` scale ``mm_m``, ``contract`` and ``2dT``
        scale ``mm_k``, ``2d`` scales ``mm_n``).  The returned nbytes is
        re-derived from the integral dims and never falls below one
        row/block, so a fused cell's "1-byte" anchor is its minimal GEMM.
        """
        if not self.fused:
            return dataclasses.replace(self, nbytes=max(int(nbytes), 1))
        it = self.itemsize
        if self.mm_role == "gather":
            n = max(1, int(nbytes) // (self.mm_k * it))
            return dataclasses.replace(self, nbytes=n * self.mm_k * it,
                                       mm_m=self.p * n)
        if self.mm_role == "scatter":
            rows = max(self.p,
                       (int(nbytes) // (self.mm_k * it) // self.p) * self.p)
            return dataclasses.replace(self, nbytes=rows * self.mm_k * it,
                                       mm_m=rows)
        if self.mm_role == "2d":
            cols = max(1, int(nbytes) // (self.mm_k * it))
            return dataclasses.replace(self, nbytes=cols * self.mm_k * it,
                                       mm_n=self.p * cols)
        if self.mm_role == "2dT":
            rows = max(1, int(nbytes) // (self.mm_m * it))
            return dataclasses.replace(self, nbytes=rows * self.mm_m * it,
                                       mm_k=self.p * rows)
        k_loc = max(1, int(nbytes) // (self.mm_n * it))
        return dataclasses.replace(self, nbytes=k_loc * self.mm_n * it,
                                   mm_k=self.p * k_loc)

