"""Offline tuning pass (paper §4.2): benchmark → detect violations → profile.

Workflow, faithful to the paper's three steps:

1. NREP estimation per (op, msize)   — measured backend only (Alg. 1, Eq. 1).
2. Benchmark default + every mock-up; a *violation* is a mock-up at least
   ``min_win`` (paper: 10%) faster than the default.  Among violating
   mock-ups the fastest is selected; one range per message size is written
   (degenerate [s, s] ranges exactly like Listing 1), then adjacent equal
   selections are coalesced.
3. The resulting ``ProfileStore`` drives ``api.tuned(profiles=...)`` — the
   PGMPITuneD online phase.

Two interchangeable backends, always passed explicitly:

* ``CostModelBackend(topo)``  — the α-β-γ model of ``core.costmodel``.
* ``MeasuredBackend(p, device)`` — device time on the stacked axis with
  barrier + NREP (``core.measure``).

The tuner also verifies the other two guideline classes (monotony and
split-robustness) and reports — but does not repair — those.
"""
from __future__ import annotations

import dataclasses
import math
import pathlib
import statistics
from typing import Sequence

from repro_torch.core import costmodel, measure, nrep
from repro_torch.core.cell import OpCell
from repro_torch.core.collectives import REGISTRY, is_demoted
from repro_torch.core.profiles import Profile, ProfileStore, Range

DEFAULT_SIZES = (1, 8, 32, 64, 100, 512, 1024, 4096, 8192, 32768,
                 100_000, 1_048_576, 16_777_216)


@dataclasses.dataclass(frozen=True)
class Measurement:
    cell: OpCell
    impl: str
    latency: float          # seconds (median for the measured backend)
    nrep: int = 1

    @property
    def op(self) -> str:
        return self.cell.op

    @property
    def axis_size(self) -> int:
        return self.cell.p

    @property
    def nbytes(self) -> int:
        return self.cell.nbytes


@dataclasses.dataclass(frozen=True)
class Violation:
    gl_kind: str            # "pattern" | "monotony" | "split_robustness"
    op: str
    axis_size: int
    nbytes: int
    detail: str
    speedup: float          # default / best  (>1 means violation)
    best_impl: str | None = None


@dataclasses.dataclass
class TuneReport:
    measurements: list[Measurement]
    violations: list[Violation]
    profiles: ProfileStore
    notes: list[str] = dataclasses.field(default_factory=list)

    def summary(self) -> str:
        pat = [v for v in self.violations if v.gl_kind == "pattern"]
        lines = [f"measurements: {len(self.measurements)}",
                 f"pattern violations: {len(pat)}",
                 f"other violations: {len(self.violations) - len(pat)}",
                 f"profiles written: {len(self.profiles)}"]
        lines += [f"note: {n}" for n in self.notes]
        return "\n".join(lines)


class CostModelBackend:
    """Latency = analytic model; deterministic, any axis size.  A cell with
    recorded matmul geometry is priced from its true flops
    (``costmodel.latency_cell``)."""

    name = "costmodel"
    supported_axis_size: int | None = None      # any p

    def __init__(self, topo: costmodel.Topo, *, chunk_bytes: int = 0):
        self.topo = topo
        self.chunk_bytes = chunk_bytes

    def latency(self, cell: OpCell, impl: str) -> float:
        return costmodel.latency_cell(cell, impl, self.topo,
                                      chunk_bytes=self.chunk_bytes)

    def nrep_for(self, cell: OpCell, impl: str) -> int:
        return 1


class MeasuredBackend:
    """Device time on ``p`` stacked lanes; NREP via the paper's estimator.
    Replays each cell's RECORDED problem — for fused cells the callsite's
    actual GEMM, for two-axis cells its ``p x p2`` mesh.  Fused cells
    without geometry (v1 traces) are unmeasurable (``inf``), which the
    tuner note-skips.  ``p=None`` replays every cell at its own world
    (``OpCell.world()``): the ranks are stacked on one device, so no
    device count ties the replay to one axis size."""

    name = "measured"

    def __init__(self, p: int | None = 8, device=None, *,
                 rse_1byte: float = 0.05, rse_large: float = 0.10,
                 K: int = 5, max_nrep: int = 50):
        self.p = p
        self._device = device
        self._benches: dict[int, measure.Bench] = {}
        self.rse_1byte = rse_1byte
        self.rse_large = rse_large
        self.K = K
        self.max_nrep = max_nrep
        self._one_byte: dict[tuple, nrep.OneByteEstimate] = {}
        self._nrep: dict[tuple, int] = {}

    @property
    def supported_axis_size(self) -> int | None:
        """Only cells whose world is ``p`` can be replayed; the tuners skip
        (and note) every other cell.  None: any world."""
        return self.p

    def _bench(self, cell: OpCell) -> measure.Bench:
        """The bench of ``p`` lanes, or (``p=None``) of the cell's world."""
        w = cell.world() if self.p is None else self.p
        if w not in self._benches:
            self._benches[w] = measure.Bench(w, self._device)
        return self._benches[w]

    @staticmethod
    def _measurable(cell: OpCell) -> bool:
        return cell.op not in measure.MATMUL_OPS or cell.fused

    def _ob(self, cell: OpCell, impl: str) -> nrep.OneByteEstimate:
        # for fused cells scaled_to(1) floors at ONE GEMM row block, so the
        # anchor is the minimal fused problem; max_nrep bounds the reps
        key = (cell.scaled_to(1), impl)
        if key not in self._one_byte:
            self._one_byte[key] = nrep.estimate_1byte(
                self._bench(cell).make_sampler(cell, impl),
                rse_threshold=self.rse_1byte, batch0=5, max_samples=60)
        return self._one_byte[key]

    def nrep_for(self, cell: OpCell, impl: str) -> int:
        if not self._measurable(cell):
            return 1
        key = (cell, impl)
        if key not in self._nrep:
            n = nrep.estimate_nrep(self._bench(cell).make_sampler(cell,
                                                                  impl),
                                   cell.nbytes, self._ob(cell, impl),
                                   rse_threshold=self.rse_large, K=self.K)
            self._nrep[key] = min(n, self.max_nrep)
        return self._nrep[key]

    def latency(self, cell: OpCell, impl: str) -> float:
        bench = self._bench(cell)
        if cell.world() != bench.p:
            raise ValueError(
                f"measured backend runs at p={bench.p}, not "
                f"{cell.world()}")
        if not self._measurable(cell):
            return math.inf
        count = self.nrep_for(cell, impl)
        return statistics.median(bench.sample_latency(cell, impl, count))


def tune(ops: Sequence[str] | None = None,
         sizes: Sequence[int] = DEFAULT_SIZES,
         axis_size: int = 16,
         backend=None,
         *, min_win: float = 0.10,
         scratch_budget_bytes: int | None = None,
         coalesce: bool = True) -> TuneReport:
    """Run the full offline pass and build profiles.

    ``backend`` is required: there is no default fabric.  ``min_win`` is
    the paper's "only replace if the mock-up is at least 10% faster";
    ``scratch_budget_bytes`` enforces Table-1 extra memory."""
    if backend is None:
        raise ValueError("tune needs an explicit backend (CostModelBackend "
                         "with a fitted Topo, or MeasuredBackend)")
    ops = list(ops or REGISTRY.keys())
    p = axis_size
    ms: list[Measurement] = []
    vios: list[Violation] = []
    notes: list[str] = []
    store = ProfileStore()

    sup = getattr(backend, "supported_axis_size", None)
    if sup is not None and p != sup:
        notes.append(f"axis_size {p} != backend's axis size {sup}; "
                     "nothing measured")
        return TuneReport(measurements=ms, violations=vios, profiles=store,
                          notes=notes)

    for op in ops:
        picks: list[tuple[int, str]] = []   # (nbytes, winning impl)
        lat_by_size: dict[int, dict[str, float]] = {}
        for nbytes in sizes:
            lats = _measure_cell(OpCell(op, p, nbytes), backend,
                                 scratch_budget_bytes, ms)
            t_def = lats.get("default")
            if t_def is None:
                notes.append(f"{op} p={p} {nbytes}B: default impl "
                             "unmeasurable; size skipped")
                continue
            lat_by_size[nbytes] = lats
            cands = {k: v for k, v in lats.items() if k != "default"}
            if not cands:
                continue
            best = min(cands, key=cands.get)
            if cands[best] < t_def * (1.0 - min_win):
                gl = REGISTRY[op][best].guideline or "EXT"
                vios.append(Violation(
                    "pattern", op, p, nbytes,
                    f"{gl}: {op} default {t_def:.3e}s > {best} "
                    f"{cands[best]:.3e}s", t_def / cands[best], best))
                picks.append((nbytes, best))

        # monotony: T(n1) <= T(n2) for n1 < n2 (default impl)
        sorted_sizes = sorted(lat_by_size)
        for a, b in zip(sorted_sizes, sorted_sizes[1:]):
            ta, tb = lat_by_size[a]["default"], lat_by_size[b]["default"]
            if ta > tb * (1.0 + min_win):
                vios.append(Violation(
                    "monotony", op, p, b,
                    f"T({a}B)={ta:.3e} > T({b}B)={tb:.3e}", ta / tb))
        # split-robustness: k chunks of n/k not faster than one op on n
        for nbytes in sorted_sizes:
            if nbytes < 8:
                continue
            for k in (2, 4):
                part = nbytes // k
                if part in lat_by_size:
                    t_whole = lat_by_size[nbytes]["default"]
                    t_split = k * lat_by_size[part]["default"]
                    if t_split < t_whole * (1.0 - min_win):
                        vios.append(Violation(
                            "split_robustness", op, p, nbytes,
                            f"{k}x{part}B = {t_split:.3e} < {t_whole:.3e}",
                            t_whole / t_split))

        if picks:
            ranges = [Range(nb, nb, impl) for nb, impl in sorted(picks)]
            if coalesce:
                ranges = _coalesce(ranges)
            store.add(Profile(op=op, axis_size=p, ranges=ranges,
                              meta={"backend": backend.name,
                                    "min_win": min_win}))

    return TuneReport(measurements=ms, violations=vios, profiles=store,
                      notes=notes)


def _measure_cell(cell: OpCell, backend,
                  scratch_budget_bytes: int | None,
                  ms: list[Measurement]) -> dict[str, float]:
    """Benchmark every admissible impl of one tuning cell — the §4.2
    admission rules (pow2 guard, demotion ledger, Table-1 scratch budget,
    inf filter) shared by ``tune`` and ``tune_trace``.  Appends to ``ms``
    and returns ``{impl: latency}``."""
    lats: dict[str, float] = {}
    p, nbytes = cell.p, cell.nbytes
    for impl_name, impl in REGISTRY[cell.op].items():
        if impl.requires_pow2 and ((p & (p - 1)) != 0
                                   or (cell.p2 & (cell.p2 - 1)) != 0):
            continue
        # hierarchical impls fit only hierarchical cells and vice versa:
        # the cost model prices a mismatch inf, the measured replay would
        # fail on it
        if impl_name != "default" and impl.hier != cell.hier:
            continue
        if impl_name != "default" and is_demoted(cell.op, impl_name):
            continue
        if (scratch_budget_bytes is not None
                and impl_name != "default"
                and impl.extra_bytes(nbytes, p) > scratch_budget_bytes):
            continue
        t = backend.latency(cell, impl_name)
        if math.isinf(t):
            continue
        lats[impl_name] = t
        ms.append(Measurement(cell, impl_name, t,
                              backend.nrep_for(cell, impl_name)))
    return lats


# ---------------------------------------------------------------------------
# trace replay (PGMPI-style per-callsite tuning, arXiv:1606.00215)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TraceTuneReport:
    """Result of tuning against a recorded workload trace.

    ``phase_profiles`` maps each phase tag of the trace to the
    ``ProfileStore`` built from the cells that phase issued — feed it to
    ``api.tuned(phase_profiles=...)``.  ``est_default_s`` / ``est_tuned_s``
    are the backend's frequency-weighted total collective latency per
    phase with defaults vs with the emitted profiles.
    """
    phase_profiles: dict[str, ProfileStore]
    measurements: list[Measurement]
    est_default_s: dict[str, float]
    est_tuned_s: dict[str, float]
    notes: list[str] = dataclasses.field(default_factory=list)

    def summary(self) -> str:
        lines = []
        for ph in sorted(self.est_default_s):
            d, t = self.est_default_s[ph], self.est_tuned_s[ph]
            n = len(self.phase_profiles.get(ph, ()))
            sp = d / t if t > 0 else 1.0
            lines.append(f"{ph}: {n} profiles, modeled {d*1e6:.1f}us -> "
                         f"{t*1e6:.1f}us ({sp:.2f}x)")
        lines += [f"note: {n}" for n in self.notes]
        return "\n".join(lines) or "empty trace"

    def save(self, directory, *, fmt: str = "text") -> None:
        """One subdirectory per phase (``<dir>/<phase>/<op>_p<P>.pgtune``),
        the layout ``profiles.load_stores`` reads back."""
        d = pathlib.Path(directory)
        d.mkdir(parents=True, exist_ok=True)
        for ph, store in sorted(self.phase_profiles.items()):
            store.save(d / ph, fmt=fmt)


def tune_trace(trace, backend=None, *, min_win: float = 0.10,
               scratch_budget_bytes: int | None = None,
               coalesce: bool = True) -> TraceTuneReport:
    """Tune against a recorded op mix instead of a synthetic size sweep.

    For every phase and every cell that phase recorded, benchmark the
    default and every admissible mock-up on ``backend`` (required) and
    select the fastest mock-up that beats the default by at least
    ``min_win``, weighted by how often the workload issued the cell.
    Emits one ``ProfileStore`` per phase; fused cells produce one geometry
    profile per ``(op, p, Geom)``.  Cells the backend cannot replay (other
    axis size, fused cells without geometry) are skipped with a note.
    """
    if backend is None:
        raise ValueError("tune_trace needs an explicit backend")
    sup = getattr(backend, "supported_axis_size", None)
    ms: list[Measurement] = []
    notes: list[str] = []
    phase_profiles: dict[str, ProfileStore] = {}
    est_default: dict[str, float] = {}
    est_tuned: dict[str, float] = {}
    # phases often share cells; measure each OpCell once
    lat_cache: dict[OpCell, dict[str, float]] = {}

    for ph in trace.phases():
        picks: dict[tuple, list[tuple[int, str]]] = {}
        t_d = t_t = 0.0
        for cell, weight in sorted(trace.cells(phase=ph).items()):
            op, p, nbytes = cell.op, cell.p, cell.nbytes
            if op not in REGISTRY:
                notes.append(f"{ph}: unknown op {op!r}; cell skipped")
                continue
            if sup is not None and cell.world() != sup:
                wd = (f"world={cell.world()} (p={p}, p2={cell.p2})"
                      if cell.p2 else f"p={p}")
                notes.append(f"{ph}: {op} {nbytes}B: {wd} != axis "
                             f"size {sup}; cell skipped")
                continue
            if cell not in lat_cache:
                lat_cache[cell] = _measure_cell(cell, backend,
                                                scratch_budget_bytes, ms)
            lats = lat_cache[cell]
            t_def = lats.get("default")
            if t_def is None:
                if op in measure.MATMUL_OPS and not cell.fused:
                    notes.append(
                        f"{ph}: {op} p={p} {nbytes}B: fused cell has no "
                        "recorded GEMM geometry (v1 trace?); unmeasurable, "
                        "cell skipped — re-record the trace with schema v2")
                else:
                    notes.append(f"{ph}: {op} p={p} {nbytes}B: default impl "
                                 "unmeasurable; cell skipped")
                continue
            t_d += weight * t_def
            cands = {k: v for k, v in lats.items() if k != "default"}
            best = min(cands, key=cands.get) if cands else None
            if best is not None and cands[best] < t_def * (1.0 - min_win):
                picks.setdefault(
                    (op, p, cell.geom(), cell.profile_tier()), []).append(
                    (nbytes, best))
                t_t += weight * cands[best]
            else:
                t_t += weight * t_def

        for (op, p, geom, tier), pk in sorted(
                picks.items(), key=lambda kv: (kv[0][0], kv[0][1],
                                               str(kv[0][2]), kv[0][3])):
            ranges = [Range(nb, nb, impl) for nb, impl in sorted(pk)]
            if coalesce:
                ranges = _coalesce(ranges)
            meta = {"backend": backend.name, "min_win": min_win,
                    "phase": ph, "source": "trace"}
            phase_profiles.setdefault(ph, ProfileStore()).add(
                Profile(op=op, axis_size=p, ranges=ranges, meta=meta,
                        geom=geom, tier=tier))
        est_default[ph] = t_d
        est_tuned[ph] = t_t

    return TraceTuneReport(phase_profiles=phase_profiles, measurements=ms,
                           est_default_s=est_default, est_tuned_s=est_tuned,
                           notes=notes)


def _coalesce(ranges: list[Range]) -> list[Range]:
    """Merge adjacent measured sizes that picked the same impl into one
    closed range (covers the gap between the discrete sizes)."""
    out: list[Range] = []
    for r in ranges:
        if out and out[-1].impl == r.impl:
            out[-1] = Range(out[-1].lo, r.hi, r.impl)
        else:
            out.append(r)
    return out
