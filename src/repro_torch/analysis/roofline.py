"""Roofline terms of a captured program on a chip given as a record.

    compute    = dot_flops_per_device / peak FLOP/s (by dtype)
    memory     = bytes_per_device / HBM bytes/s
    collective = collective_bytes_per_device / link bytes/s

The JAX package's module fixes TPU v5e constants; here the chip is an
explicit ``Chip`` record, and the one preset, ``H100_SXM``, holds data
sheet values of an NVIDIA H100 80GB HBM3 at 700 W (none is measured).
On ranks stacked on one device (``StackedAxis``/``StackedMesh``) a
"collective" is a device copy: its bytes go to the memory term and the
collective term is 0.  Across processes the collective term is the
sites' payload bytes over the link rate.  ``model_flops`` is 6·N·D
(dense) or 6·N_active·D (MoE) for training, 2·N·D for one forward.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Chip:
    """The peak rates a roofline divides by."""
    name: str
    peak_flops: dict            # dtype name -> FLOP/s
    hbm_bytes_per_s: float
    link_bytes_per_s: float     # one direction
    source: str = ""

    def flops(self, dtype: str = "bfloat16") -> float:
        return self.peak_flops[dtype]


#: data sheet, NVIDIA H100 80GB HBM3, 700 W: dense bf16/f16 989 TFLOP/s,
#: f32 67 TFLOP/s, HBM3 3.35 TB/s, NVLink 4 450 GB/s in each direction
H100_SXM = Chip(
    "NVIDIA H100 80GB HBM3",
    {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12},
    3.35e12, 450e9,
    source="data sheet, NVIDIA H100 80GB HBM3, 700 W")

#: the two rates every kernel bound of ``chip_smoke.py`` divides by
H100_FLOPS = H100_SXM.peak_flops
H100_BYTES_PER_S = H100_SXM.hbm_bytes_per_s


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    model_flops_per_device: float
    chip: Chip = H100_SXM
    dtype: str = "bfloat16"
    #: ranks stacked on one device: collectives are device copies
    stacked: bool = False
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    bottleneck: str = ""
    useful_ratio: float = 0.0

    def finish(self) -> "Roofline":
        peak = self.chip.flops(self.dtype)
        self.t_compute = self.flops_per_device / peak
        byts = self.bytes_per_device
        if self.stacked:
            byts += self.collective_bytes_per_device
            self.t_collective = 0.0
        else:
            self.t_collective = (self.collective_bytes_per_device /
                                 self.chip.link_bytes_per_s)
        self.t_memory = byts / self.chip.hbm_bytes_per_s
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        self.bottleneck = max(terms, key=terms.get)
        self.useful_ratio = (self.model_flops_per_device /
                             self.flops_per_device
                             if self.flops_per_device else 0.0)
        return self

    @property
    def step_time_bound(self) -> float:
        """Lower bound on step time (no overlap assumption: max of terms)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline the USEFUL model flops achieve
        if the dominant term is fully utilized."""
        if self.step_time_bound == 0:
            return 0.0
        return (self.model_flops_per_device / self.chip.flops(self.dtype)
                ) / self.step_time_bound

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "flops/dev": f"{self.flops_per_device:.3e}",
            "bytes/dev": f"{self.bytes_per_device:.3e}",
            "coll_bytes/dev": f"{self.collective_bytes_per_device:.3e}",
            "t_compute": f"{self.t_compute*1e3:.2f}ms",
            "t_memory": f"{self.t_memory*1e3:.2f}ms",
            "t_collective": f"{self.t_collective*1e3:.2f}ms",
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": f"{self.useful_ratio:.3f}",
            "roofline_fraction": f"{self.roofline_fraction:.3f}",
        }


def model_flops(cfg, cell, n_devices: int) -> float:
    """6·N_active·D training / 2·N_active·D forward, per device."""
    n_active = cfg.active_param_count()
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        total = 6.0 * n_active * tokens
    elif cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        total = 2.0 * n_active * tokens
    else:  # decode: one token per sequence
        total = 2.0 * n_active * cell.global_batch
    return total / n_devices


def roofline_terms(arch: str, shape: str, mesh_name: str, *, cost: dict,
                   coll: dict, cfg, cell, n_devices: int, chip: Chip,
                   flops_override: float | None = None,
                   bytes_override: float | None = None,
                   dtype: str = "bfloat16",
                   stacked: bool = False) -> Roofline:
    """The roofline of one program: ``cost`` with the ``"flops"`` and
    ``"bytes accessed"`` keys (or the overrides, e.g. ``graph.
    program_costs``'s ``dot_flops`` and ``bytes``), ``coll`` a
    ``collective_bytes`` dict, ``chip`` the rates (required)."""
    flops = float(flops_override if flops_override
                  else cost.get("flops", 0.0))
    byts = float(bytes_override if bytes_override
                 else cost.get("bytes accessed", 0.0))
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name,
        flops_per_device=flops,
        bytes_per_device=byts,
        collective_bytes_per_device=float(coll.get("total_bytes", 0)),
        model_flops_per_device=model_flops(cfg, cell, n_devices),
        chip=chip, dtype=dtype, stacked=stacked,
    ).finish()
