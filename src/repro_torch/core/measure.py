"""Measured-latency backend: ReproMPI's Algorithm 1 on the stacked axis.

Timing procedure (paper Algorithm 1): synchronize, t = now, run the
collective, record t' - t.  The barrier is a 1-element stacked all-reduce
followed by ``torch.cuda.synchronize()``; on the GPU each sample is timed
with a pair of ``torch.cuda.Event``s around the call, on the CPU with
``perf_counter``.

The p ranks of a cell are stacked on ONE device (``core._axis``), so a
sample measures the on-chip data movement and launch overhead of the
mock-up, not a link between GPUs.  The measured axis size is a parameter
(default 8), not a device count.

Replay is keyed on the full ``OpCell``: a fused collective-matmul cell is
re-executed with the RECORDED GEMM — dtype and ``(mm_k, mm_m, mm_n)``
exactly as the callsite issued them.  Fused cells without recorded
geometry (v1 traces) cannot be replayed; the tuner note-skips them.

A two-axis cell (hierarchical, or 2-D) replays on a ``StackedMesh`` of
shape ``(p, p2)`` over the bench's lanes, the counterpart of the JAX
package's ``_mesh2``: the payload streams over the outer axis and the
impl gets the inner axis as ``inner_axis=`` or ``rs_axis=``, as at
dispatch.  Its world ``p * p2`` must equal the bench's lane count.
"""
from __future__ import annotations

import collections
import statistics
import time

import torch

from repro_torch.core import collectives as C
from repro_torch.core._axis import StackedAxis, StackedMesh
from repro_torch.core.cell import OpCell

#: ops whose cells carry a fused-matmul geometry the replay must honor
MATMUL_OPS = C.FUSED_OPS


def problem_shapes(cell: OpCell) -> dict[str, tuple[int, ...]]:
    """Per-rank operand shapes the replay builds for ``cell``.

    ``x`` is the collective payload, ``w`` the second operand of the fused
    op (absent for plain collectives; for ``matmul_accumulate`` the
    stationary x).  Fused shapes come from the RECORDED GEMM dims.
    """
    p = cell.p
    if cell.op in MATMUL_OPS:
        if not cell.fused:
            raise ValueError(
                f"cell {cell} has no recorded matmul geometry; a fused op "
                "cannot be replayed without it (v1 trace?)")
        if cell.op == "matmul_reducescatter_2d":
            q = max(cell.p2, 1)
            if cell.mm_role == "2dT":
                # payload = the cotangent row block [mm_k/p, mm_m], its
                # cols dividing the rs axis; x [p*t_loc, mm_n]
                t_loc = max(1, cell.mm_k // p)
                m_pad = max(q, (cell.mm_m // q) * q)
                return {"x": (t_loc, m_pad), "w": (p * t_loc, cell.mm_n)}
            # payload = the weight column block [mm_k, mm_n/p]; the
            # stationary x's rows divide the rs axis
            rows = max(q, (cell.mm_m // q) * q)
            return {"x": (cell.mm_k, max(1, cell.mm_n // p)),
                    "w": (rows, cell.mm_k)}
        if cell.op == "allgather_matmul":
            return {"x": (max(1, cell.mm_m // p), cell.mm_k),
                    "w": (cell.mm_k, cell.mm_n)}
        if cell.op == "matmul_reducescatter":
            rows = max(p, (cell.mm_m // p) * p)   # the scatter must divide
            return {"x": (rows, cell.mm_k), "w": (cell.mm_k, cell.mm_n)}
        # matmul_accumulate: the payload is the K-dim weight block, the
        # second operand the stationary x [mm_m, p*k_loc]
        k_loc = max(1, cell.mm_k // p)
        return {"x": (k_loc, cell.mm_n), "w": (cell.mm_m, p * k_loc)}
    itemsize = cell.itemsize
    n_rows = max(1, cell.nbytes // itemsize)
    if cell.op in ("alltoall", "reducescatter", "scatter"):
        # nbytes is the per-chunk payload: one chunk per rank
        n_rows *= cell.world()
    return {"x": (n_rows, 1)}


class Bench:
    """Replays tuning cells on a stacked axis of ``p`` ranks.

    Built operands are kept for the ``MAX_CASES`` most recent cells, so the
    NREP estimator's repeated sampling reuses them."""

    MAX_CASES = 8

    def __init__(self, p: int = 8, device=None):
        self.axis = StackedAxis(p, device)
        self._cases: collections.OrderedDict = collections.OrderedDict()
        self._bar = torch.ones((p, 1), device=self.axis.device)

    @property
    def p(self) -> int:
        return self.axis.size

    @property
    def device(self) -> torch.device:
        return self.axis.device

    def case(self, cell: OpCell, impl: str):
        """The zero-argument callable that runs ``impl`` on ``cell``."""
        key = (cell, impl)
        run = self._cases.get(key)
        if run is not None:
            self._cases.move_to_end(key)
            return run
        fn = C.REGISTRY[cell.op][impl].fn
        shapes = problem_shapes(cell)
        dt = getattr(torch, cell.dtype or "float32")
        if cell.p2:
            run = self._case2(cell, fn, shapes, dt)
        else:
            run = self._case1(cell, fn, shapes, dt)
        self._cases[key] = run
        while len(self._cases) > self.MAX_CASES:
            self._cases.popitem(last=False)
        return run

    def _case2(self, cell: OpCell, fn, shapes, dt):
        """A two-axis cell on a ``(p, p2)`` mesh of the bench's lanes."""
        if cell.world() != self.p:
            raise ValueError(f"bench runs {self.p} lanes, not the "
                             f"{cell.p}x{cell.p2} mesh of {cell}")
        mesh = StackedMesh((cell.p, cell.p2), ("bench", "bench2"),
                           self.device)
        outer, inner = mesh["bench"], mesh["bench2"]
        x = torch.ones((self.p,) + shapes["x"], dtype=dt, device=self.device)
        if cell.op == "matmul_reducescatter_2d":
            stat = torch.ones((self.p,) + shapes["w"], dtype=dt,
                              device=self.device)
            xpose = cell.mm_role == "2dT"

            def run():
                return fn(x, outer, x=stat, rs_axis=inner, xpose=xpose)
            return run

        def run():
            return fn(x, outer, inner_axis=inner)
        return run

    def _case1(self, cell: OpCell, fn, shapes, dt):
        if cell.p != self.p:
            raise ValueError(f"bench runs at p={self.p}, not {cell.p}")
        axis = self.axis
        x = torch.ones((self.p,) + shapes["x"], dtype=dt, device=self.device)
        if cell.op == "matmul_accumulate":
            # the payload is the weight block; every rank holds its own
            # stationary x [mm_m, mm_k]
            stat = torch.ones((self.p,) + shapes["w"], dtype=dt,
                              device=self.device)

            def run():
                return fn(x, axis, x=stat)
        elif cell.op in MATMUL_OPS:
            w = torch.ones(shapes["w"], dtype=dt, device=self.device)

            def run():
                return fn(x, axis, w=w)
        else:
            def run():
                return fn(x, axis)
        return run

    def barrier(self) -> None:
        """1-element stacked all-reduce, then wait for the device."""
        self.axis.psum(self._bar)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def sample_latency(self, cell: OpCell, impl: str, count: int,
                       *, barrier: bool = True) -> list[float]:
        """``count`` barrier-synced samples of one cell (seconds)."""
        run = self.case(cell, impl)
        run()          # warm: first-run allocation noise stays out
        self.barrier()
        out = []
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            for _ in range(count):
                if barrier:
                    self.barrier()
                start.record()
                run()
                end.record()
                end.synchronize()
                out.append(start.elapsed_time(end) / 1e3)
        else:
            for _ in range(count):
                if barrier:
                    self.barrier()
                t0 = time.perf_counter()
                run()
                out.append(time.perf_counter() - t0)
        return out

    def sweep_axis(self, op: str, sizes, *, impl: str = "default",
                   count: int = 5,
                   dtype: str = "float32") -> list[tuple[int, float]]:
        """Measured ``(payload_bytes, median_seconds)`` points of one op on
        the stacked axis — the input ``costmodel.fit_topo`` turns into
        alpha/beta/gamma."""
        out = []
        for nbytes in sizes:
            cell = OpCell(op, self.p, int(nbytes), dtype)
            out.append((int(nbytes),
                        statistics.median(self.sample_latency(cell, impl,
                                                              count))))
        return out

    def make_sampler(self, cell: OpCell, impl: str):
        """Adapter to the NREP estimator's ``(msize, count) -> latencies``;
        the probe size rescales the cell via ``OpCell.scaled_to``."""
        def sampler(msize: int, count: int):
            return self.sample_latency(cell.scaled_to(msize), impl, count)
        return sampler

