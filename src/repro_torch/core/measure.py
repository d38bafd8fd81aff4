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

On a process axis (``Bench(axis=GroupAxis)``, one rank a process) the
barrier is the 1-element all-reduce over the axis' group, then the
device synchronize, and each sample's elapsed time is reduced with a
max all-reduce over the group after the timed window: every rank holds
the slowest rank's times, the same samples, so the NREP estimator takes
the same branch on every rank (ranks that disagreed on a count would
call different numbers of collectives and hang).  A two-axis cell there
replays on a ``GroupMesh`` of its ``(p, p2)``.

Replay is keyed on the full ``OpCell``: a fused collective-matmul cell is
re-executed with the RECORDED GEMM — dtype and ``(mm_k, mm_m, mm_n)``
exactly as the callsite issued them.  Fused cells without recorded
geometry (v1 traces) cannot be replayed; the tuner note-skips them.

A two-axis cell (hierarchical, or 2-D) replays on a ``StackedMesh`` of
shape ``(p, p2)`` over the bench's lanes, the counterpart of the JAX
package's ``_mesh2``: the payload streams over the outer axis and the
impl gets the inner axis as ``inner_axis=`` or ``rs_axis=``, as at
dispatch.  Its world ``p * p2`` must equal the bench's axis size.
"""
from __future__ import annotations

import collections
import statistics
import time

import torch

from repro_torch.core import collectives as C
from repro_torch.core._axis import (GroupMesh, StackedAxis, StackedMesh,
                                    spans_processes)
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
    """Replays tuning cells on a stacked axis of ``p`` ranks, or on
    ``axis``, a process axis (a ``GroupAxis`` or one axis of a
    ``GroupMesh``; ``p`` is then its size).

    Built operands are kept for the ``MAX_CASES`` most recent cells, so the
    NREP estimator's repeated sampling reuses them; the impls of one cell
    share one set of operands (they only read them)."""

    MAX_CASES = 8

    def __init__(self, p: int = 8, device=None, *, axis=None):
        self.axis = StackedAxis(p, device) if axis is None else axis
        self._cases: collections.OrderedDict = collections.OrderedDict()
        self._operands: collections.OrderedDict = collections.OrderedDict()
        self._meshes: dict[tuple, GroupMesh] = {}
        self._bar = torch.ones((self.axis.lanes, 1), device=self.axis.device)

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
        if cell.p2:
            run = self._case2(cell, fn)
        else:
            run = self._case1(cell, fn)
        self._cases[key] = run
        while len(self._cases) > self.MAX_CASES:
            self._cases.popitem(last=False)
        return run

    def _inputs(self, cell: OpCell) -> dict:
        """The cell's operands, built once for all its impls: ``x`` the
        payload on every lane; ``w`` the second operand, on every lane for
        ``matmul_accumulate`` and the 2-D op (the stationary x), else
        one."""
        got = self._operands.get(cell)
        if got is not None:
            self._operands.move_to_end(cell)
            return got
        shapes = problem_shapes(cell)
        dt = getattr(torch, cell.dtype or "float32")
        lanes = self.axis.lanes
        got = {"x": torch.ones((lanes,) + shapes["x"], dtype=dt,
                               device=self.device)}
        if "w" in shapes:
            stacked = (cell.op in ("matmul_accumulate",
                                   "matmul_reducescatter_2d"))
            got["w"] = torch.ones(((lanes,) if stacked else ())
                                  + shapes["w"], dtype=dt,
                                  device=self.device)
        self._operands[cell] = got
        while len(self._operands) > self.MAX_CASES:
            self._operands.popitem(last=False)
        return got

    def _case2(self, cell: OpCell, fn):
        """A two-axis cell on a ``(p, p2)`` mesh of the bench's lanes."""
        if cell.world() != self.p:
            raise ValueError(f"bench runs {self.p} lanes, not the "
                             f"{cell.p}x{cell.p2} mesh of {cell}")
        mesh = self._mesh2(cell.p, cell.p2)
        outer, inner = mesh["bench"], mesh["bench2"]
        ins = self._inputs(cell)
        x = ins["x"]
        if cell.op == "matmul_reducescatter_2d":
            stat = ins["w"]
            xpose = cell.mm_role == "2dT"

            def run():
                return fn(x, outer, x=stat, rs_axis=inner, xpose=xpose)
            return run

        def run():
            return fn(x, outer, inner_axis=inner)
        return run

    def _mesh2(self, p: int, p2: int):
        """The ``(p, p2)`` mesh of the bench's ranks: stacked lanes, or
        (on a process axis, which must span every process) a
        ``GroupMesh``, built once: every rank builds it at the same
        cell."""
        if not spans_processes(self.axis):
            return StackedMesh((p, p2), ("bench", "bench2"), self.device)
        if (p, p2) not in self._meshes:
            self._meshes[(p, p2)] = GroupMesh((p, p2), ("bench", "bench2"),
                                              self.device)
        return self._meshes[(p, p2)]

    def _case1(self, cell: OpCell, fn):
        if cell.p != self.p:
            raise ValueError(f"bench runs at p={self.p}, not {cell.p}")
        axis = self.axis
        ins = self._inputs(cell)
        x = ins["x"]
        if cell.op == "matmul_accumulate":
            # the payload is the weight block; every rank holds its own
            # stationary x [mm_m, mm_k]
            stat = ins["w"]

            def run():
                return fn(x, axis, x=stat)
        elif cell.op in MATMUL_OPS:
            w = ins["w"]

            def run():
                return fn(x, axis, w=w)
        else:
            def run():
                return fn(x, axis)
        return run

    def barrier(self) -> None:
        """1-element all-reduce over the axis, then wait for the device."""
        self.axis.psum(self._bar)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _slowest(self, out: list[float]) -> list[float]:
        """On a process axis, each sample's maximum over the group (after
        the timed window): every rank then holds the same samples."""
        if not spans_processes(self.axis):
            return out
        t = torch.tensor([out], dtype=torch.float64, device=self.device)
        return self.axis.pmax(t)[0].tolist()

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
        return self._slowest(out)

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

