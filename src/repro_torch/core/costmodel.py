"""α-β-γ latency model for collective algorithms.

Model: a mesh axis is a 1-D bidirectional ring.  Per-message cost α + B·β
per hop, reduction γ per byte.  Formulas are the textbook schedules (Chan
et al. 2007, the paper's [3]):

  ring all-gather      (p-1)·α + (p-1)·B·β                  (B = per-shard bytes)
  recursive doubling   log2(p)·α + (p-1)·B·β
  ring reduce-scatter  (p-1)·α + (p-1)/p·Bt·(β+γ)           (Bt = total bytes)
  ring all-reduce      2(p-1)·α + 2(p-1)/p·Bt·β + (p-1)/p·Bt·γ
  binomial tree        ceil(log2 p)·(α + B·β) (+γ for reduce)
  ring all-to-all      (p-1)·α + p·Bt·β/8      (bisection-limited, bidir ring)

``default_pricing`` selects what the untuned library is assumed to emit:
``"optimal"`` (defaults already use the best ring schedules) or
``"naive"`` (tree-based defaults, the paper's JUQUEEN situation).
``hw_bcast`` models hardware broadcast acceleration.

A ``MeshTopo`` maps each named mesh axis to its own ``Topo``; a cell's
``tier`` token selects them, and the two-axis cells (the hierarchical
``MPIX_*`` cells and the 2-D ``matmul_reducescatter_2d`` cells) price
their outer and inner axes on separate fabrics.  An unreachable tier is
derived from a fitted one with ``Topo.scaled`` and published ratios.

The presets below (``V5E_ICI``, ``BGQ_LIKE``) are the JAX
package's TPU v5e and BlueGene/Q constants, kept only as data for parity
checks: nothing here defaults to them, and no number they give describes
a GPU (their ``quant_bw`` is the v5e HBM rate).  A ``Topo`` for the card
is fitted from its own sweeps (``fit_topo`` over
``measure.Bench.sweep_axis``), and its ``quant_bw`` is the measured rate
of the quantize kernel.
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial

from repro_torch.core.collectives import FUSED_OPS, REGISTRY, impl_names
from repro_torch.kernels.quant import WIRE_IMPLS, WIRE_ITEMSIZE


@dataclasses.dataclass(frozen=True)
class Topo:
    """One mesh-axis fabric."""
    name: str
    alpha: float            # per-message latency (s)
    link_bw: float          # per-link bandwidth (B/s), one direction
    gamma: float            # reduction cost (s/B)
    bidir: bool = True      # ring usable in both directions
    default_pricing: str = "optimal"   # "optimal" | "naive"
    hw_bcast: bool = False
    hw_bcast_speedup: float = 5.0
    # fused collective-matmul terms: peak matmul throughput, the canonical
    # output width the geometry-less table assumes, and the per-ring-step
    # overhead of the fused schedule (kernel issue), which makes fusion
    # LOSE on small messages.
    matmul_flops: float = 2.0e14
    fused_mm_cols: int = 8192
    fused_step_overhead: float = 1.5e-6
    # quantize / dequantize rate of the wire_q8 / wire_fp8 mock-ups (B/s):
    # bytes one pass reads plus writes, over its time.  No default: a card's
    # rate is measured (``chip_smoke.py`` times the quant_pack kernel), and
    # pricing a wire impl without it raises.
    quant_bw: float | None = None

    @property
    def beta(self) -> float:
        return 1.0 / self.link_bw

    def scaled(self, *, name: str | None = None, alpha_mult: float = 1.0,
               bw_mult: float = 1.0, gamma_mult: float = 1.0) -> "Topo":
        """A derived tier: this fabric with its link parameters scaled
        (how a slow tier that cannot be measured is anchored to a FITTED
        base: published relative gaps applied to measured absolutes)."""
        return dataclasses.replace(
            self, name=name or f"{self.name}-scaled",
            alpha=self.alpha * alpha_mult, link_bw=self.link_bw * bw_mult,
            gamma=self.gamma * gamma_mult)


# The JAX package's presets (TPU v5e ICI and DCN, a BlueGene/Q-like vendor
# library): parity data only.
V5E_ICI = Topo("v5e-ici", alpha=1.0e-6, link_bw=50e9, gamma=2.5e-12,
               quant_bw=819e9)
V5E_DCN = Topo("v5e-dcn", alpha=10.0e-6, link_bw=12.5e9, gamma=2.5e-12,
               quant_bw=819e9)
BGQ_LIKE = Topo("bgq-like", alpha=2.0e-6, link_bw=2e9, gamma=4e-12,
                default_pricing="naive", hw_bcast=True, quant_bw=819e9)

#: the JAX package's published v5e DCN-vs-ICI link gaps (the RATIOS are
#: what is assumed; ``fit_topo`` anchors the absolutes in measured sweeps)
DCN_ALPHA_MULT = 10.0
DCN_BW_MULT = 12.5e9 / 50e9


@dataclasses.dataclass(frozen=True)
class MeshTopo:
    """Per-axis fabric map of a hierarchical mesh: axis name -> ``Topo``.

    ``latency_cell`` and ``sweep_cell`` take a ``MeshTopo`` wherever they
    take a ``Topo`` and resolve each cell's ``tier`` token (``""``,
    ``"<tier>"`` or ``"<outer>/<inner>"``) to the per-axis fabrics; a
    plain ``Topo`` keeps the flat pricing."""
    axes: tuple[tuple[str, Topo], ...]

    @classmethod
    def of(cls, **axes: Topo) -> "MeshTopo":
        """``MeshTopo.of(data=slow, model=fast)``."""
        return cls(tuple(axes.items()))

    @classmethod
    def fit(cls, axis_points: dict, *, base: Topo | None = None
            ) -> "MeshTopo":
        """Per-axis tiers FIT from measured sweeps: ``axis_points[name] =
        (p, allgather_points, allreduce_points or None)`` with points as
        ``(payload_bytes, seconds)`` (``measure.Bench.sweep_axis``)."""
        return cls(tuple(
            (name, fit_topo(p, ag, ar, name=name, base=base))
            for name, (p, ag, ar) in axis_points.items()))

    def topo(self, axis: str) -> Topo:
        """The fabric of one mesh axis (KeyError for unknown axes)."""
        for name, t in self.axes:
            if name == axis:
                return t
        raise KeyError(f"MeshTopo has no axis {axis!r} "
                       f"(axes: {[n for n, _ in self.axes]})")

    def by_tier(self, token: str) -> Topo | None:
        """A tier by its ``Topo.name`` token (None when unknown)."""
        for _, t in self.axes:
            if t.name == token:
                return t
        return None

    @property
    def flat(self) -> Topo:
        """The tier untiered (``tier == ""``) cells price on: the fastest
        axis (min beta), the flat model's assumption."""
        return min((t for _, t in self.axes), key=lambda t: (t.beta, t.alpha))

    @property
    def slowest(self) -> Topo:
        return max((t for _, t in self.axes), key=lambda t: (t.beta, t.alpha))

    def tier_token(self, axis: str, inner_axis: str | None = None) -> str:
        """The ``OpCell.tier`` token of a dispatch over ``axis`` (and, for
        two-axis cells, ``inner_axis``).  Unknown axes give ``""`` (the
        flat behaviour) rather than raising."""
        try:
            tok = self.topo(axis).name
        except KeyError:
            return ""
        if inner_axis is None:
            return tok
        try:
            return f"{tok}/{self.topo(inner_axis).name}"
        except KeyError:
            return ""

    def resolve(self, tier: str) -> tuple[Topo, Topo]:
        """``(outer, inner)`` fabrics of a tier token: ``""`` and unknown
        tokens price flat; a single token prices both slots on it."""
        if not tier:
            return self.flat, self.flat
        out_tok, _, in_tok = tier.partition("/")
        t_out = self.by_tier(out_tok) or self.flat
        t_in = (self.by_tier(in_tok) or self.flat) if in_tok else t_out
        return t_out, t_in


def _tiers_for(cell, topo) -> tuple[Topo, Topo]:
    """``(outer, inner)`` fabrics for one cell under either topology."""
    if isinstance(topo, MeshTopo):
        return topo.resolve(getattr(cell, "tier", ""))
    return topo, topo


def _lstsq_line(points) -> tuple[float, float]:
    """Closed-form least squares of ``t = intercept + slope·B`` over
    ``[(B, t), ...]`` (>= 2 distinct sizes required)."""
    pts = [(float(b), float(t)) for b, t in points]
    n = len(pts)
    if n < 2 or len({b for b, _ in pts}) < 2:
        raise ValueError("fit_topo needs >= 2 distinct payload sizes")
    mx = sum(b for b, _ in pts) / n
    my = sum(t for _, t in pts) / n
    sxx = sum((b - mx) ** 2 for b, _ in pts)
    sxy = sum((b - mx) * (t - my) for b, t in pts)
    slope = sxy / sxx
    return slope, my - slope * mx


def fit_topo(p: int, allgather_points, allreduce_points=None, *,
             name: str = "fit", base: Topo | None = None) -> Topo:
    """α-β(-γ) of one axis from measured ring sweeps.

    ``allgather_points``: ``(per-shard payload bytes B, seconds)`` of an
    all-gather on a ``p``-rank axis, fit to ``t = (p-1)·α + (p-1)·β·B``.
    With ``allreduce_points`` (total-buffer bytes vs seconds) γ is fit
    from the slope surplus over β; otherwise γ comes from ``base``.
    Non-link fields (overheads, matmul rate) come from ``base`` when
    given, else from the ``Topo`` field defaults.
    """
    if p < 2:
        raise ValueError("fit_topo needs an axis of size >= 2")
    slope, icept = _lstsq_line(allgather_points)
    alpha = max(icept / (p - 1), 1e-12)
    beta = max(slope / (p - 1), 1e-16)
    gamma = base.gamma if base is not None else 0.0
    if allreduce_points is not None:
        s2, _ = _lstsq_line(allreduce_points)
        gamma = max((s2 - 2.0 * (p - 1) / p * beta) * p / (p - 1), 0.0)
    if base is None:
        return Topo(name, alpha=alpha, link_bw=1.0 / beta, gamma=gamma)
    return dataclasses.replace(base, name=name, alpha=alpha,
                               link_bw=1.0 / beta, gamma=gamma)


def _log2c(p: int) -> int:
    return max(1, math.ceil(math.log2(max(p, 2))))


def _is_pow2(p: int) -> bool:
    return p & (p - 1) == 0


# ---------------------------------------------------------------------------
# primitive schedule costs.  B = bytes "per shard sent" in the op's natural
# convention (documented per formula).
# ---------------------------------------------------------------------------


def t_ring_allgather(p, B, t: Topo):
    """B = per-shard contribution bytes; output p·B."""
    return (p - 1) * t.alpha + (p - 1) * B * t.beta


def t_doubling_allgather(p, B, t: Topo):
    return _log2c(p) * t.alpha + (p - 1) * B * t.beta


def t_ring_reduce_scatter(p, Bt, t: Topo):
    """Bt = total buffer bytes (p·chunk)."""
    return (p - 1) * t.alpha + (p - 1) / p * Bt * (t.beta + t.gamma)


def t_ring_allreduce(p, Bt, t: Topo):
    return (2 * (p - 1) * t.alpha
            + 2 * (p - 1) / p * Bt * t.beta
            + (p - 1) / p * Bt * t.gamma)


def t_doubling_allreduce(p, Bt, t: Topo):
    return _log2c(p) * (t.alpha + Bt * t.beta + Bt * t.gamma)


def t_tree(p, B, t: Topo, *, reduce: bool = False, bcast: bool = False):
    """Binomial tree; B bytes move each round."""
    a = t.alpha
    if bcast and t.hw_bcast:
        a = a / t.hw_bcast_speedup
    per = a + B * t.beta + (B * t.gamma if reduce else 0.0)
    return _log2c(p) * per


def t_tree_scatter_gather(p, Bt, t: Topo):
    """Binomial scatter/gather: log p rounds, halving/doubling payload;
    total bytes ≈ Bt·(p-1)/p."""
    return _log2c(p) * t.alpha + (p - 1) / p * Bt * t.beta


def t_ring_alltoall(p, Bt, t: Topo):
    """Bt = per-shard buffer (p chunks).  Bisection-limited on a
    bidirectional ring: byte-hops ≈ Bt·p/4, 2 links per node."""
    div = 8.0 if t.bidir else 4.0
    return (p - 1) * t.alpha + p * Bt * t.beta / div


def t_fused_matmul(elems: float, t: Topo):
    """Matmul time of a fused op whose reduced operand has ``elems``
    elements: 2 MACs per element per output column (canonical width)."""
    return 2.0 * elems * t.fused_mm_cols / t.matmul_flops


def t_overlapped_ring(p, step_comm: float, mm_total: float, t: Topo):
    """The overlap law of the fused collective-matmul rings: the first
    chunk's matmul is exposed, every later step costs max(transfer,
    chunk-matmul) instead of their sum, plus ``fused_step_overhead`` per
    step."""
    chunk = mm_total / p + t.fused_step_overhead
    return chunk + (p - 1) * max(chunk, step_comm)


def t_overlapped_ring2d(p_out: int, q_in: int, outer_step_comm: float,
                        inner_step_comm: float, mm_total: float, t: Topo,
                        t_inner: Topo | None = None):
    """The nested overlap law of the 2-D ring:
    ``max(outer_comm, per-step max(inner_comm, compute))``.  Each of the
    ``p_out`` outer steps runs a whole inner ring (``t_overlapped_ring``
    over ``q_in`` steps) on ``1/p_out`` of the compute; the outer
    transfer hides behind it, the first outer block's inner ring is
    exposed, and each outer step pays ``fused_step_overhead``.  ``t``
    prices the outer stream, ``t_inner`` (default ``t``) the inner ring."""
    ti = t if t_inner is None else t_inner
    inner = t_overlapped_ring(q_in, inner_step_comm, mm_total / p_out, ti)
    return inner + (p_out - 1) * max(
        inner, outer_step_comm + t.fused_step_overhead)


def t_meta(p, t: Topo):
    """The 2p·I count/displacement exchange of the 'v' emulations."""
    return t_ring_allgather(p, 8, t)


def t_linear_rooted(p, B, t: Topo, *, reduce: bool = False):
    """Naive rooted gather/scatter/reduce: root talks to p-1 peers serially."""
    per = t.alpha + B * t.beta + (B * t.gamma if reduce else 0.0)
    return (p - 1) * per


# ---------------------------------------------------------------------------
# quantized-wire pricing (wire_q8 / wire_fp8 mock-ups, kernels/quant.py)
# ---------------------------------------------------------------------------

#: on-wire overhead of the per-block scales (one float32 per 8 rows), at
#: its bound for rows of >= 32 bytes: 4 / (8 * 32) * 4 = 1/16
SCALE_FRAC = 1.0 / 16.0


def wire_factor(wire_dtype: str, itemsize: int) -> float:
    """Bytes-on-wire ratio vs the compute dtype (never > 1: quantizing an
    8-bit payload does not shrink it)."""
    return min(1.0, WIRE_ITEMSIZE[wire_dtype] / float(max(itemsize, 1)))


def wire_bytes(B: float, itemsize: int, wire_dtype: str) -> float:
    """Bytes a ``B``-byte compute-dtype payload occupies on the wire."""
    return B * wire_factor(wire_dtype, itemsize) * (1.0 + SCALE_FRAC)


def t_quant(B: float, t: Topo) -> float:
    """One quantize (or dequantize) pass over ``B`` payload bytes: a
    streaming read plus write at ``quant_bw``."""
    if t.quant_bw is None:
        raise ValueError(f"Topo {t.name!r} has no quant_bw: measure the "
                         "quantize kernel's rate before pricing a wire impl")
    return 2.0 * B / t.quant_bw


def _pad(B: float, p: int, chunk_bytes: int) -> float:
    """GL7/GL16 chunk-aligned padding of the buffer."""
    c = max(float(chunk_bytes), 1.0)
    k = math.ceil(math.ceil(B / c) / p)
    return p * k * c


# ---------------------------------------------------------------------------
# per-impl latency.  ``nbytes`` is the byte size of the op's per-rank input
# (the same key the dispatcher uses).
# ---------------------------------------------------------------------------


def latency(op: str, impl: str, p: int, nbytes: int, topo: Topo,
            *, chunk_bytes: int = 0, tier: str = "") -> float:
    """Modeled latency (seconds) of one ``impl`` of ``op`` on an axis of
    size ``p``.  Compositions are priced as the sum of the sub-impls they
    actually run (see collectives.py).  A ``MeshTopo`` is resolved through
    ``tier`` (one axis: the first slot of the token)."""
    if isinstance(topo, MeshTopo):
        topo = topo.resolve(tier)[0]
    if p <= 1:
        return 0.0
    B = float(max(nbytes, 1))
    naive = topo.default_pricing == "naive"

    def ag(Bv):
        if naive:
            # linear gather + tree bcast of the full buffer
            return (t_linear_rooted(p, Bv, topo)
                    + t_tree(p, p * Bv, topo, bcast=True))
        return t_ring_allgather(p, Bv, topo)

    def ar(Bv):
        if naive:
            return (t_tree(p, Bv, topo, reduce=True)
                    + t_tree(p, Bv, topo, bcast=True))
        return t_ring_allreduce(p, Bv, topo)

    def rs(Bt):
        if naive:
            return (t_tree(p, Bt, topo, reduce=True)
                    + t_linear_rooted(p, Bt / p, topo))
        return t_ring_reduce_scatter(p, Bt, topo)

    def a2a(Bt):
        if naive:
            return t_linear_rooted(p, Bt / p, topo) * 2
        return t_ring_alltoall(p, Bt, topo)

    def dflt_bcast(Bv):
        return ar(Bv)                      # default bcast is select+psum

    def dflt_gather(Bv):
        if naive:
            return t_linear_rooted(p, Bv, topo)
        return ag(Bv)                      # gather served by all-gather

    def dflt_scatter(Bt):
        if naive:
            return t_linear_rooted(p, Bt / p, topo)
        return a2a(Bt)                     # scatter served by all-to-all

    def dflt_reduce(Bv):
        if naive:
            return t_linear_rooted(p, Bv, topo, reduce=True)
        return ar(Bv)                      # reduce served by psum

    def scan_cost(Bv):
        return _log2c(p) * (topo.alpha + Bv * topo.beta + Bv * topo.gamma)

    table = {
        # ---- allgather (B = per-shard contribution) ----
        ("allgather", "default"): lambda: ag(B),
        ("allgather", "allgather_as_gather_bcast"):
            lambda: dflt_gather(B) + dflt_bcast(p * B),
        ("allgather", "allgather_as_alltoall"): lambda: a2a(p * B),
        ("allgather", "allgather_as_allreduce"): lambda: ar(p * B),
        ("allgather", "allgather_as_allgatherv"):
            lambda: ag(B) + t_meta(p, topo),
        ("allgather", "allgather_as_ring"):
            lambda: t_ring_allgather(p, B, topo),
        ("allgather", "allgather_as_doubling"):
            lambda: t_doubling_allgather(p, B, topo),
        # ---- allreduce (B = buffer bytes) ----
        ("allreduce", "default"): lambda: ar(B),
        ("allreduce", "allreduce_as_reduce_bcast"):
            lambda: dflt_reduce(B) + dflt_bcast(B),
        ("allreduce", "allreduce_as_tree_reduce_bcast"):
            lambda: (t_tree(p, B, topo, reduce=True)
                     + t_tree(p, B, topo, bcast=True)),
        ("allreduce", "allreduce_as_rsb_allgather"):
            lambda: (t_ring_reduce_scatter(p, B, topo)
                     + t_ring_allgather(p, B / p, topo)),
        ("allreduce", "allreduce_as_rs_allgatherv"):
            lambda: (t_ring_reduce_scatter(p, _pad(B, p, chunk_bytes), topo)
                     + t_ring_allgather(p, _pad(B, p, chunk_bytes) / p, topo)
                     + t_meta(p, topo)),
        ("allreduce", "allreduce_as_doubling"):
            lambda: t_doubling_allreduce(p, B, topo),
        # ---- alltoall (B = per-shard buffer, p chunks) ----
        ("alltoall", "default"): lambda: a2a(B),
        ("alltoall", "alltoall_as_alltoallv"):
            lambda: a2a(B) + t_meta(p, topo),
        ("alltoall", "alltoall_as_ppermute"):
            lambda: (p - 1) * topo.alpha + p * B * topo.beta / (
                8.0 if topo.bidir else 4.0),
        # ---- bcast (B = payload) ----
        ("bcast", "default"): lambda: dflt_bcast(B),
        ("bcast", "bcast_as_allgatherv"):
            lambda: ag(B) + t_meta(p, topo),
        ("bcast", "bcast_as_scatter_allgather"):
            lambda: (t_tree_scatter_gather(p, B, topo)
                     + t_ring_allgather(p, B / p, topo)),
        ("bcast", "bcast_as_tree"):
            lambda: t_tree(p, B, topo, bcast=True),
        # ---- gather (B = per-shard contribution) ----
        ("gather", "default"): lambda: dflt_gather(B),
        ("gather", "gather_as_allgather"): lambda: t_ring_allgather(p, B, topo),
        ("gather", "gather_as_gatherv"):
            lambda: dflt_gather(B) + t_meta(p, topo),
        ("gather", "gather_as_reduce"): lambda: dflt_reduce(p * B),
        ("gather", "gather_as_tree"):
            lambda: t_tree_scatter_gather(p, p * B, topo),
        # ---- reduce (B = buffer bytes) ----
        ("reduce", "default"): lambda: dflt_reduce(B),
        ("reduce", "reduce_as_allreduce"): lambda: t_ring_allreduce(p, B, topo),
        ("reduce", "reduce_as_rsb_gather"):
            lambda: (t_ring_reduce_scatter(p, B, topo)
                     + t_ring_allgather(p, B / p, topo)),
        ("reduce", "reduce_as_rs_gatherv"):
            lambda: (t_ring_reduce_scatter(p, _pad(B, p, chunk_bytes), topo)
                     + t_ring_allgather(p, _pad(B, p, chunk_bytes) / p, topo)
                     + t_meta(p, topo)),
        ("reduce", "reduce_as_tree"):
            lambda: t_tree(p, B, topo, reduce=True),
        # ---- reducescatter (B = total buffer bytes, p chunks) ----
        ("reducescatter", "default"): lambda: rs(B),
        ("reducescatter", "rsb_as_reduce_scatter"):
            lambda: dflt_reduce(B) + dflt_scatter(B),
        ("reducescatter", "rsb_as_reduce_scatter_irr"):
            lambda: t_ring_reduce_scatter(p, B, topo) + t_meta(p, topo),
        ("reducescatter", "rsb_as_allreduce"): lambda: dflt_reduce(B),
        # ---- scan ----
        ("scan", "default"): lambda: scan_cost(B),
        ("scan", "scan_as_exscan_reducelocal"):
            lambda: scan_cost(B) + topo.alpha + B * (topo.beta + topo.gamma),
        ("exscan", "default"): lambda: scan_cost(B) + topo.alpha + B * topo.beta,
        # ---- allgather_matmul (B = per-shard contribution bytes of x;
        # the matmul touches p·B/4 gathered elements): unfused =
        # collective PLUS matmul, fused = per-step max ----
        ("allgather_matmul", "default"):
            lambda: ag(B) + t_fused_matmul(p * B / 4.0, topo),
        ("allgather_matmul", "fused_ring"):
            lambda: t_overlapped_ring(
                p, topo.alpha + B * topo.beta,
                t_fused_matmul(p * B / 4.0, topo), topo),
        # ---- matmul_reducescatter (B = total input-buffer bytes of x, p
        # row blocks); geometry-less: each ring step moves one reduced
        # output block (~B/p, canonical square-ish K≈M) and reduces it ----
        ("matmul_reducescatter", "default"):
            lambda: t_fused_matmul(B / 4.0, topo) + rs(B),
        ("matmul_reducescatter", "fused_ring"):
            lambda: t_overlapped_ring(
                p, topo.alpha + (B / p) * (topo.beta + topo.gamma),
                t_fused_matmul(B / 4.0, topo), topo),
        # ---- matmul_accumulate (B = per-rank K-dim weight-block bytes, the
        # streamed operand; the contraction touches p·B/4 gathered weight
        # elements): unfused = weight all-gather PLUS matmul, fused = the
        # weight block in flight while the partial products accumulate ----
        ("matmul_accumulate", "default"):
            lambda: ag(B) + t_fused_matmul(p * B / 4.0, topo),
        ("matmul_accumulate", "fused_ring"):
            lambda: t_overlapped_ring(
                p, topo.alpha + B * topo.beta,
                t_fused_matmul(p * B / 4.0, topo), topo),
        # ---- matmul_reducescatter_2d (B = the streamed weight-block
        # bytes over the OUTER axis).  Geometry-less: the inner axis is
        # taken equal to the outer (a square mesh), the matmul touches
        # p·B/4 gathered weight elements, the output is the gathered
        # weight's size p·B and the inner ring's accumulator block is
        # B/p.  Unfused = weight all-gather PLUS matmul PLUS output
        # reduce-scatter; fused = the nested overlap law ----
        ("matmul_reducescatter_2d", "default"):
            lambda: (ag(B) + t_fused_matmul(p * B / 4.0, topo)
                     + rs(p * B)),
        ("matmul_reducescatter_2d", "fused_ring2d"):
            lambda: t_overlapped_ring2d(
                p, p, topo.alpha + B * topo.beta,
                topo.alpha + (B / p) * (topo.beta + topo.gamma),
                t_fused_matmul(p * B / 4.0, topo), topo),
        # ---- scatter (B = total buffer bytes, p chunks) ----
        ("scatter", "default"): lambda: dflt_scatter(B),
        ("scatter", "scatter_as_bcast"): lambda: dflt_bcast(B),
        ("scatter", "scatter_as_scatterv"):
            lambda: dflt_scatter(B) + t_meta(p, topo),
        ("scatter", "scatter_as_tree"):
            lambda: t_tree_scatter_gather(p, B, topo),
    }
    # ---- quantized-wire mock-ups: the same ring schedules with the
    # travelling operand at wire width (+ scales) plus quantize/dequantize
    # passes at quant_bw.  The table carries no dtype (latency_cell does),
    # so the compute dtype is taken as float32, as the /4.0 element counts
    # above.  Gather-style wires quantize once and dequantize p-1 received
    # chunks (p passes of B); travelling accumulators requantize and
    # dequantize every hop (2(p-1) passes of B/p). ----
    it = 4
    for nm, wd in WIRE_IMPLS:
        Bw = wire_bytes(B, it, wd)
        Bwp = wire_bytes(B / p, it, wd)

        def rs_wire(Bt, Btw):
            # bytes move at wire width, the float32 accumulate (γ) is
            # full-width, two quant passes per hop
            return ((p - 1) * topo.alpha
                    + (p - 1) / p * Btw * topo.beta
                    + (p - 1) / p * Bt * topo.gamma
                    + 2 * (p - 1) / p * t_quant(Bt, topo))

        def ag_wire(Bc, Bcw):
            # one quant + (p-1) dequant passes
            return t_ring_allgather(p, Bcw, topo) + p * t_quant(Bc, topo)

        def gather_mm(Bw=Bw):
            return t_overlapped_ring(
                p, topo.alpha + Bw * topo.beta,
                t_fused_matmul(p * B / 4.0, topo) + p * t_quant(B, topo),
                topo)

        table.update({
            ("allgather", nm): partial(ag_wire, B, Bw),
            ("reducescatter", nm): partial(rs_wire, B, Bw),
            ("allreduce", nm):
                lambda rs=partial(rs_wire, B, Bw),
                       ag=partial(ag_wire, B / p, Bwp): rs() + ag(),
            ("allgather_matmul", nm): gather_mm,
            ("matmul_accumulate", nm): gather_mm,
            ("matmul_reducescatter", nm):
                lambda Bwp=Bwp: t_overlapped_ring(
                    p, topo.alpha + Bwp * topo.beta + (B / p) * topo.gamma,
                    t_fused_matmul(B / 4.0, topo)
                    + 2 * p * t_quant(B / p, topo), topo),
        })
    key = (op, impl)
    if key not in table:
        if REGISTRY.get(op, {}).get(impl) is not None and \
                REGISTRY[op][impl].hier:
            # two-axis mock-ups are inadmissible on a one-axis problem
            return math.inf
        raise KeyError(f"no cost model for {key}")
    if REGISTRY[op][impl].requires_pow2 and not _is_pow2(p):
        return math.inf
    return float(table[key]())


def latency_hier(cell, impl: str, t_out: Topo, t_in: Topo) -> float:
    """Modeled latency of a HIERARCHICAL plain cell: ``cell.p`` outer
    (inter-tier) ranks x ``cell.p2`` inner (intra-tier) ranks.

    ``default`` is one collective over the joint ``p·p2`` group: a ring
    through all ranks crosses the outer tier, and ring steps are
    synchronous, so every step runs at the slowest link's rate.  The
    ``MPIX_*`` mock-ups are the composed tier-aware schedules: most bytes
    move on the fast intra tier, a ``1/p2`` share crosses the slow one.
    Flat mock-ups are inadmissible here and price to ``inf``."""
    p, q = cell.p, cell.p2
    B = float(max(cell.nbytes, 1))
    imp = REGISTRY[cell.op][impl]
    if imp.requires_pow2 and not (_is_pow2(p) and _is_pow2(q)):
        return math.inf
    if p * q <= 1:
        return 0.0
    slow = t_out if (t_out.beta, t_out.alpha) >= (t_in.beta, t_in.alpha) \
        else t_in
    if impl == "default":
        if cell.op == "allreduce":
            return t_ring_allreduce(p * q, B, slow)
        if cell.op == "allgather":
            return t_ring_allgather(p * q, B, slow)
        if cell.op == "reducescatter":
            return t_ring_reduce_scatter(p * q, B, slow)
    if cell.op == "allreduce" and impl == "MPIX_rs_ar_ag":
        # RS-intra -> AR-inter -> AG-intra (B = buffer bytes)
        return (t_ring_reduce_scatter(q, B, t_in)
                + t_ring_allreduce(p, B / q, t_out)
                + t_ring_allgather(q, B / q, t_in))
    if cell.op == "allgather" and impl == "MPIX_ag_ag":
        # AG-intra -> AG-inter (B = per-shard contribution; the inter
        # stage moves the q·B intra-gathered block)
        return (t_ring_allgather(q, B, t_in)
                + t_ring_allgather(p, q * B, t_out))
    if cell.op == "reducescatter" and impl == "MPIX_rs_rs":
        # RS-inter -> RS-intra (B = total buffer, p·q chunks)
        return (t_ring_reduce_scatter(p, B, t_out)
                + t_ring_reduce_scatter(q, B / p, t_in))
    return math.inf


def _latency_2d(cell, impl: str, mm: float, t_out: Topo,
                t_in: Topo) -> float:
    """A 2-D cell: ``p`` = the stream (gather) axis on ``t_out``, ``p2`` =
    the reduce-scatter axis on ``t_in``; the dims are the PER-RANK GEMM,
    so ``mm`` is one rank's compute and the output product is
    ``mm_m x mm_n``."""
    p, q = cell.p, max(cell.p2, 1)
    it = cell.itemsize
    bt_out = float(cell.mm_m * cell.mm_n * it)
    if impl == "default":
        return (latency("allgather", "default", p, cell.nbytes, t_out)
                + mm + t_ring_reduce_scatter(q, bt_out, t_in))
    if cell.mm_role == "2dT":
        # outer = the travelling accumulator over the rs axis (q steps,
        # [mm_m/q, mm_n] blocks, t_in); inner = the cotangent column
        # slice streamed over the gather axis (p steps, t_out)
        acc_blk = bt_out / q
        slice_blk = (float(cell.mm_k) / p) * (float(cell.mm_m) / q) * it
        return t_overlapped_ring2d(
            q, p, t_in.alpha + acc_blk * (t_in.beta + t_in.gamma),
            t_out.alpha + slice_blk * t_out.beta, mm, t_in, t_out)
    # "2d": outer = the weight column-block stream over the gather axis
    # (p steps of B bytes, t_out); inner = the matmul-reducescatter ring
    # over the rs axis (q steps, [mm_m/q, mm_n/p] blocks, t_in)
    inner_blk = (float(cell.mm_m) / q) * (float(cell.mm_n) / p) * it
    return t_overlapped_ring2d(
        p, q, t_out.alpha + float(max(cell.nbytes, 1)) * t_out.beta,
        t_in.alpha + inner_blk * (t_in.beta + t_in.gamma), mm, t_out, t_in)


def latency_cell(cell, impl: str, topo, *, chunk_bytes: int = 0) -> float:
    """Modeled latency of one ``OpCell``.  Plain cells (and fused cells
    without recorded geometry) use the canonical ``latency`` table; a
    fused cell with a recorded GEMM is priced from its true flops
    ``2·K·M·N``: the allgather-matmul and matmul-accumulate rings' steps
    move the per-rank payload, the matmul-reducescatter ring's its true
    output blocks; a wire impl moves wire bytes and adds its quantize and
    dequantize passes.  ``topo`` is a ``Topo`` (every axis on it) or a
    ``MeshTopo``, resolved through ``cell.tier``: the outer fabric prices
    the ``p`` axis, the inner one the ``p2`` axis; hierarchical cells go
    to ``latency_hier``, 2-D cells to the nested law."""
    t_out, t_in = _tiers_for(cell, topo)
    if cell.hier:
        return latency_hier(cell, impl, t_out, t_in)
    if not cell.fused:
        return latency(cell.op, impl, cell.p, cell.nbytes, t_out,
                       chunk_bytes=chunk_bytes)
    p = cell.p
    if p <= 1 and cell.p2 <= 1:
        return 0.0
    if cell.op not in FUSED_OPS:
        raise KeyError(f"no geometry cost model for {cell.op!r}")
    imp = REGISTRY[cell.op][impl]
    if imp.hier:
        return math.inf
    if imp.requires_pow2 and not _is_pow2(p):
        return math.inf
    topo = t_out
    mm = 2.0 * cell.mm_k * cell.mm_m * cell.mm_n / topo.matmul_flops
    if cell.op == "matmul_reducescatter_2d":
        return _latency_2d(cell, impl, mm, t_out, t_in)
    if cell.op in ("allgather_matmul", "matmul_accumulate"):
        # the streamed operand is all-gathered over the axis; steps move
        # its bytes
        if impl == "default":
            return latency("allgather", "default", p, cell.nbytes, topo) + mm
        B = float(max(cell.nbytes, 1))
        step_b = B
        if imp.wire_dtype:
            # gather-style wire: steps move wire bytes; 1 quant + (p-1)
            # dequant passes fold into the overlappable compute
            step_b = wire_bytes(B, cell.itemsize, imp.wire_dtype)
            mm = mm + p * t_quant(B, topo)
        return t_overlapped_ring(p, topo.alpha + step_b * topo.beta, mm,
                                 topo)
    bt_out = float(cell.mm_m * cell.mm_n * cell.itemsize)
    if impl == "default":
        return mm + latency("reducescatter", "default", p, int(bt_out), topo)
    blk = bt_out / p
    step = topo.alpha + blk * (topo.beta + topo.gamma)
    if imp.wire_dtype:
        # travelling accumulator on the wire: block bytes shrink, the
        # float32 accumulate (γ) stays full-width, requantize + dequantize
        # per hop fold into the overlappable compute
        step = (topo.alpha
                + wire_bytes(blk, cell.itemsize, imp.wire_dtype) * topo.beta
                + blk * topo.gamma)
        mm = mm + 2 * p * t_quant(blk, topo)
    return t_overlapped_ring(p, step, mm, topo)


def sweep(op: str, p: int, nbytes: int, topo: Topo, *,
          chunk_bytes: int = 0) -> dict[str, float]:
    """Latency of every registered impl of ``op`` at one (p, nbytes)."""
    return {name: latency(op, name, p, nbytes, topo, chunk_bytes=chunk_bytes)
            for name in impl_names(op)}


def sweep_cell(cell, topo, *, chunk_bytes: int = 0) -> dict[str, float]:
    """Latency of every registered impl for one ``OpCell``."""
    return {name: latency_cell(cell, name, topo, chunk_bytes=chunk_bytes)
            for name in impl_names(cell.op)}


def best_impl_cell(cell, topo, *,
                   chunk_bytes: int = 0) -> tuple[str, float]:
    """``(impl, latency)`` of the fastest modeled implementation."""
    sw = sweep_cell(cell, topo, chunk_bytes=chunk_bytes)
    name = min(sw, key=sw.get)
    return name, sw[name]
