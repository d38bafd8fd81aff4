"""Transparent interposition at the graph layer.

PGMPITuneLib's pitch is intercepting collectives without touching user
code.  The dispatcher (``repro_torch.core.api``) only sees the call sites
that go through ``repro_torch.dist``, but the captured graph of ANY eager
program names every ``torch.distributed`` collective it issued, whoever
wrote it (``analysis.graph``).  This module is the JAX package's
``analysis/interpose.py`` on those graphs, in two modes:

**report-only**: ``tuning_potential`` captures a program, maps every
collective site to an ``OpCell`` (an all-gather feeding a matmul prices as
the fused ``allgather_matmul`` cell), and prices each cell's default
against its best mock-up with the cost model on a GIVEN topology ("this
program's collectives vs. their best mock-ups: X.Yx on the table").
There is no default topology: the JAX package defaults to its TPU v5e
preset, and the port prices only on a ``Topo`` the caller fitted or
chose.

**rewrite**: ``rewrite`` captures a ``repro_torch.dist``-shaped program
under a recording default context and under tuned mock-ups (profiles or
a force table), matches the dispatch records to the baseline graph's
collective sites (proof that the interposition touched the sites it
claims), runs both on the same real inputs, and compares them leaf by
leaf, bit for bit.

Adjacency follows the JAX package's ``_map_one``: a matmul reached from
an all-gather's value decides gather (the gathered dim not contracted)
or contract; a reduce-scatter whose payload a matmul produced is the
fused ``matmul_reducescatter`` cell (payload: the matmul's lhs); an
all-reduce after a matmul stays plain but is flagged.  Eager code puts
view ops between a collective and its matmul (``getitem``, ``view``,
``expand``, ``t``/``transpose``/``permute``, ``select``/``squeeze``/
``unsqueeze`` of a size-1 dim, the wait of a functional op) and copies
(``clone``, a dtype cast); the walk looks through them, replaying each
view on a meta tensor with the gathered buffer's strides, so the gathered
dim is known at the matmul.
"""
from __future__ import annotations

import dataclasses
import operator

import torch
from torch.utils import _pytree as pytree

from repro_torch.analysis.graph import (CollectiveSite, GraphParseError,
                                        _ns_name, _tensor_nodes, _val,
                                        capture, collective_sites,
                                        module_world)
from repro_torch.core import costmodel
from repro_torch.core.cell import HLO_TO_OP, OpCell
from repro_torch.core.costmodel import Topo
from repro_torch.core.profiles import ProfileStore

__all__ = [
    "SiteCell", "SiteRow", "PotentialReport", "RewriteResult", "map_sites",
    "scan_potential", "tuning_potential", "rewrite", "assert_bitexact",
    "compile_zoo_graph", "GraphParseError", "OP_TO_HLO_CLASS",
]


# ---------------------------------------------------------------------------
# site -> OpCell mapping (with adjacent-matmul detection)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SiteCell:
    """One collective site resolved to its tuning cell."""
    site: CollectiveSite
    cell: OpCell
    adjacent_dot: str = ""      # matmul node name, when one is adjacent
    #: True when the adjacency mapped the site onto a FUSED dispatcher op
    #: (allgather_matmul / matmul_accumulate / matmul_reducescatter); an
    #: all-reduce fed by a matmul stays a plain cell but keeps
    #: ``adjacent_dot`` as the fused-matmul-candidate marker
    fused: bool = False


#: matmul op -> index of its lhs argument (rhs is the next one)
_MATMULS = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1}
#: view ops replayed on the meta tensor that tracks the gathered dim
_VIEWS = {"view", "_unsafe_view", "expand", "t", "transpose", "permute",
          "alias", "detach"}
#: ops that drop or add a dim: followed only where that dim has size 1
_UNIT = {"select", "squeeze", "unsqueeze"}
#: copies: the same logical tensor (values, or values cast)
_COPIES = {"clone", "_to_copy", "wait_tensor"}


def _matmul(node) -> int | None:
    if node.op != "call_function":
        return None
    ns, name = _ns_name(node.target)
    return _MATMULS.get(name) if ns == "aten" else None


def _unit_ok(node, name: str, src) -> bool:
    """A select/squeeze/unsqueeze that removes or adds a size-1 dim."""
    shape = tuple(_val(src).shape)
    if name == "unsqueeze":
        return True
    dims = node.args[1] if len(node.args) > 1 else None
    if dims is None:
        return True
    dims = dims if isinstance(dims, (list, tuple)) else [dims]
    return all(shape[d] == 1 for d in dims)


def _step(node, src, meta):
    """``node`` applied to the tracked meta tensor ``meta`` (``node``'s
    input ``src``), or None where the walk stops."""
    if node.op != "call_function":
        return None
    if node.target is operator.getitem:
        return meta
    ns, name = _ns_name(node.target)
    if name in _COPIES:
        return meta
    if name in _UNIT and not _unit_ok(node, name, src):
        return None
    if name not in _VIEWS and name not in _UNIT:
        return None
    if any(isinstance(a, torch.fx.Node) for a in node.args[1:]):
        return None
    try:
        return node.target(meta, *node.args[1:], **node.kwargs)
    except RuntimeError:            # a reshape that needs a copy
        return None


def _gather_dot(site: CollectiveSite, order: dict):
    """The first matmul (in node order) that reads the all-gather's value
    through views and copies: ``(matmul node, operand index, meta
    tensor, elements of the gathered buffer)``, the meta tensor carrying
    the gathered buffer's strides."""
    start = site.value
    if start is None:
        return None
    buf = _val(start)
    if not isinstance(buf, torch.Tensor):
        return None
    meta = torch.empty(tuple(buf.shape), dtype=buf.dtype, device="meta")
    frontier = [(start, meta)]
    hits = []
    seen = set()
    while frontier:
        node, m = frontier.pop()
        if node in seen:
            continue
        seen.add(node)
        for u in node.users:
            k = _matmul(u)
            if k is not None:
                for i in (k, k + 1):
                    if u.args[i] is node:
                        hits.append((u, i - k, m))
                continue
            nxt = _step(u, node, m)
            if nxt is not None:
                frontier.append((u, nxt))
    if not hits:
        return None
    dot, which, m = min(hits, key=lambda h: (order[h[0]], h[1]))
    return dot, which, m, buf.numel()


def _producer_dot(site: CollectiveSite):
    """The matmul whose output is the site's payload, through views and
    copies walked backwards (the all-reduce's defensive ``clone`` of a
    process axis included)."""
    if not site.inputs:
        return None
    node = site.inputs[0]
    for _ in range(64):
        if _matmul(node) is not None:
            return node
        if node.op != "call_function":
            return None
        ns, name = _ns_name(node.target)
        if not (node.target is operator.getitem or name in _COPIES
                or name in _VIEWS or name in _UNIT):
            return None
        srcs = _tensor_nodes(node.args[:1])
        if not srcs:
            return None
        node = srcs[0]
    return None


def _carries_rank(size: int, stride: int, block: int) -> bool:
    """Does a dim of this size and stride (in elements of the gathered
    buffer) cross from one rank's block into another's?"""
    return size > 1 and stride > 0 and stride * (size - 1) >= block


def _geometry(dot):
    """``(mm_k, mm_m, mm_n, lhs node, rhs node)`` of a matmul: the full
    logical ``[mm_m, mm_k] @ [mm_k, mm_n]`` with batch dims folded into
    mm_m (the JAX package's ``_dot_geometry``)."""
    k0 = _matmul(dot)
    lhs, rhs = dot.args[k0], dot.args[k0 + 1]
    ls, rs = tuple(_val(lhs).shape), tuple(_val(rhs).shape)
    mm_k = ls[-1]
    batch = 1
    for s in ls[:-2]:
        batch *= s
    return mm_k, batch * ls[-2], rs[-1], lhs, rhs


def _map_one(site: CollectiveSite, default_p: int, order: dict) -> SiteCell:
    """Resolve one site to its cell (``KeyError`` for a collective class
    with no dispatcher counterpart)."""
    p = site.group_size or default_p or 1
    if site.base_op == "all-gather":
        hit = _gather_dot(site, order)
        if hit is not None:
            dot, which, meta, numel = hit
            mm_k, mm_m, mm_n, lhs, rhs = _geometry(dot)
            block = max(numel // p, 1)
            c_dim = -1 if which == 0 else -2
            role = ("contract" if _carries_rank(
                meta.shape[c_dim], meta.stride(c_dim), block) else "gather")
            gemm = (mm_k, mm_m, mm_n) if which == 0 else (mm_k, mm_n, mm_m)
            return SiteCell(site, OpCell.from_hlo(
                site.base_op, p, site.operand_bytes, site.dtype, gemm=gemm,
                mm_role=role), adjacent_dot=dot.name, fused=True)
    elif site.base_op in ("reduce-scatter", "all-reduce"):
        dot = _producer_dot(site)
        if dot is not None:
            mm_k, mm_m, mm_n, lhs, _ = _geometry(dot)
            if site.base_op == "reduce-scatter":
                # matmul_reducescatter's payload is the full-row local
                # input x [mm_m, mm_k]: the matmul's lhs
                x = _val(lhs)
                return SiteCell(site, OpCell.from_hlo(
                    site.base_op, p, x.numel() * x.element_size(),
                    site.dtype, gemm=(mm_k, mm_m, mm_n),
                    mm_role="scatter"), adjacent_dot=dot.name, fused=True)
            # matmul -> all-reduce: the monolithic all-reduce the fused
            # ops replace; no fused dispatcher op takes this shape, so it
            # stays plain, flagged as a fused-matmul candidate
            return SiteCell(site, OpCell.from_hlo(
                site.base_op, p, site.operand_bytes, site.dtype),
                adjacent_dot=dot.name, fused=False)
    return SiteCell(site, OpCell.from_hlo(site.base_op, p,
                                          site.operand_bytes, site.dtype))


def map_sites(gm: torch.fx.GraphModule, *,
              default_world: int | None = None
              ) -> tuple[list[SiteCell], list[CollectiveSite]]:
    """Map every collective site of a captured graph to an ``OpCell``:
    ``(mapped, unmapped)``.  A nonempty ``unmapped`` is a collective class
    this layer cannot express, which report consumers treat as a hard
    failure."""
    world = default_world if default_world is not None else \
        module_world(gm)
    order = {n: i for i, n in enumerate(gm.graph.nodes)}
    mapped: list[SiteCell] = []
    unmapped: list[CollectiveSite] = []
    for site in collective_sites(gm):
        try:
            mapped.append(_map_one(site, world, order))
        except KeyError:
            unmapped.append(site)
    return mapped, unmapped


# ---------------------------------------------------------------------------
# report-only mode: the tuning-potential table
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SiteRow:
    """One priced site of the tuning-potential report."""
    sc: SiteCell
    t_default: float            # modeled seconds, one execution
    best_impl: str
    t_best: float
    tuned_impl: str | None      # profile-selected impl (None: no profiles)
    t_tuned: float

    @property
    def speedup(self) -> float:
        return self.t_default / self.t_best if self.t_best > 0 else 1.0


@dataclasses.dataclass
class PotentialReport:
    """The per-program "collectives vs. best mock-ups" report."""
    label: str
    world: int
    topo: str
    rows: list[SiteRow]
    unmapped: list[CollectiveSite]

    @property
    def ok(self) -> bool:
        """True when every collective site mapped to a cell."""
        return not self.unmapped

    def total_default(self) -> float:
        return sum(r.t_default * r.sc.site.mult for r in self.rows)

    def total_best(self) -> float:
        return sum(r.t_best * r.sc.site.mult for r in self.rows)

    def total_tuned(self) -> float:
        return sum(r.t_tuned * r.sc.site.mult for r in self.rows)

    def potential(self) -> float:
        tb = self.total_best()
        return self.total_default() / tb if tb > 0 else 1.0

    def table(self) -> str:
        hdr = (f"{'site':34} {'op':22} {'p':>4} {'bytes':>12} {'x':>5} "
               f"{'default_us':>11} {'best impl':26} {'best_us':>9} "
               f"{'speedup':>8}")
        lines = [f"# {self.label}: world={self.world} topo={self.topo}",
                 hdr, "-" * len(hdr)]
        for r in sorted(self.rows,
                        key=lambda r: -r.t_default * r.sc.site.mult):
            s = r.sc.site
            name = s.name if len(s.name) <= 34 else s.name[:31] + "..."
            star = "*" if r.sc.fused else (
                "+" if r.sc.adjacent_dot else " ")
            lines.append(
                f"{name:34} {r.sc.cell.op + star:22} {r.sc.cell.p:>4} "
                f"{r.sc.cell.nbytes:>12} {s.mult:>5} "
                f"{r.t_default * 1e6:>11.2f} {r.best_impl:26} "
                f"{r.t_best * 1e6:>9.2f} {r.speedup:>7.2f}x")
        lines.append("-" * len(hdr))
        lines.append(
            f"collectives vs. best mock-ups: {self.potential():.2f}x on "
            f"the table ({self.total_default() * 1e6:.1f}us default vs "
            f"{self.total_best() * 1e6:.1f}us best, {len(self.rows)} "
            f"sites)")
        if any(r.tuned_impl is not None for r in self.rows):
            lines.append(
                f"profile-tuned total: {self.total_tuned() * 1e6:.1f}us "
                f"({self.total_default() / max(self.total_tuned(), 1e-30):.2f}x"
                " vs default)")
        if self.unmapped:
            lines.append(f"UNMAPPED ({len(self.unmapped)}):")
            lines += [f"  {s.graph_op} {s.name} ({s.operand_bytes} B)"
                      for s in self.unmapped]
        return "\n".join(lines)

    def to_json(self) -> dict:
        return {
            "label": self.label, "world": self.world, "topo": self.topo,
            "ok": self.ok,
            "potential": self.potential(),
            "total_default_s": self.total_default(),
            "total_best_s": self.total_best(),
            "total_tuned_s": self.total_tuned(),
            "n_sites": len(self.rows),
            "n_unmapped": len(self.unmapped),
            "unmapped": [s.graph_op for s in self.unmapped],
            "rows": [{
                "site": r.sc.site.name,
                "computation": r.sc.site.computation,
                "hlo_op": r.sc.site.graph_op,
                "op": r.sc.cell.op, "p": r.sc.cell.p,
                "nbytes": r.sc.cell.nbytes, "dtype": r.sc.cell.dtype,
                "mult": r.sc.site.mult,
                "fused": r.sc.fused, "adjacent_dot": r.sc.adjacent_dot,
                "mm": [r.sc.cell.mm_k, r.sc.cell.mm_m, r.sc.cell.mm_n],
                "t_default_s": r.t_default,
                "best_impl": r.best_impl, "t_best_s": r.t_best,
                "tuned_impl": r.tuned_impl, "t_tuned_s": r.t_tuned,
                "speedup": r.speedup,
            } for r in self.rows],
        }


def _require_topo(topo) -> Topo:
    if not isinstance(topo, Topo):
        raise ValueError(
            "pricing needs a Topo: a fitted one (costmodel.fit_topo, "
            f"chip_smoke.py phase 5) or one the caller chose, not {topo!r}")
    return topo


def scan_potential(gm: torch.fx.GraphModule, *, topo: Topo,
                   profiles: ProfileStore | None = None,
                   default_world: int | None = None,
                   chunk_bytes: int = 0, label: str = "") -> PotentialReport:
    """Price every collective site of a captured graph against its best
    mock-up on ``topo`` (required: no preset is assumed) and, given
    ``profiles``, against the profile-selected impl (what ``rewrite``
    would substitute)."""
    topo = _require_topo(topo)
    mapped, unmapped = map_sites(gm, default_world=default_world)
    rows = []
    for sc in mapped:
        sw = costmodel.sweep_cell(sc.cell, topo, chunk_bytes=chunk_bytes)
        t_default = sw.get("default", 0.0)
        best = min(sw, key=sw.get)
        tuned_impl = None
        t_tuned = t_default
        if profiles is not None:
            tuned_impl = profiles.lookup_cell(sc.cell) or "default"
            t_tuned = sw.get(tuned_impl, t_default)
        rows.append(SiteRow(sc, t_default, best, sw[best], tuned_impl,
                            t_tuned))
    return PotentialReport(label=label,
                           world=default_world or module_world(gm),
                           topo=topo.name, rows=rows, unmapped=unmapped)


def tuning_potential(fn, *args, topo: Topo,
                     profiles: ProfileStore | None = None,
                     chunk_bytes: int = 0, label: str = "") \
        -> PotentialReport:
    """Report-only interposition: capture ``fn(*args)`` on fake tensors
    (``args`` real, or fake from ``launch.shapes.local_args``), scan the
    graph, price every collective on ``topo`` (required)."""
    topo = _require_topo(topo)
    gm = capture(fn, *args)
    return scan_potential(gm, topo=topo, profiles=profiles,
                          chunk_bytes=chunk_bytes,
                          label=label or getattr(fn, "__name__", "fn"))


# ---------------------------------------------------------------------------
# rewrite mode: re-capture with tuned mock-ups + bit-exactness check
# ---------------------------------------------------------------------------

#: dispatcher op -> the collective class its DEFAULT anchors on (a fused
#: op in default mode runs its primary collective and a matmul)
OP_TO_HLO_CLASS = {v: k for k, v in HLO_TO_OP.items()} | {
    "allgather_matmul": "all-gather",
    "matmul_accumulate": "all-gather",
    "matmul_reducescatter": "reduce-scatter",
    "matmul_reducescatter_2d": "all-gather",
}


@dataclasses.dataclass
class RewriteResult:
    """Outcome of one transparent rewrite (``rewrite``)."""
    baseline_out: object
    tuned_out: object
    matched: list               # (DispatchRecord, CollectiveSite) pairs
    unmatched_records: list     # dispatches with no baseline graph site
    extra_sites: list           # graph collectives with no dispatch record
    changed: list               # tuned records with impl != default
    bitexact: bool
    diffs: list                 # per-leaf mismatch lines

    @property
    def n_rewritten(self) -> int:
        return len(self.changed)


def _match_records_to_sites(records, sites):
    """Greedy (class, p, nbytes) matching of dispatch records onto graph
    collective sites: the evidence that the dispatcher's sites ARE the
    program's collectives."""
    free = list(sites)
    matched, unmatched = [], []
    for r in records:
        if r.cell.p <= 1:
            continue            # axis size 1: no collective is issued
        klass = OP_TO_HLO_CLASS.get(r.cell.op)
        hit = next(
            (s for s in free if s.base_op == klass
             and s.group_size in (0, r.cell.p)
             and s.operand_bytes == r.cell.nbytes), None)
        if hit is not None:
            free.remove(hit)
            matched.append((r, hit))
        else:
            unmatched.append(r)
    return matched, unmatched, free


def rewrite(fn, *args, profiles: ProfileStore | None = None,
            force: dict | None = None, phase_profiles: dict | None = None,
            chunk_bytes: int = 0) -> RewriteResult:
    """Re-capture ``fn`` with tuned mock-ups substituted and compare.

    Baseline: capture ``fn(*args)`` under a recording default context
    (``api.tuned(record=)``), map the graph's collective sites and match
    every dispatch record to one; run ``fn`` on ``args``.  Tuned: capture
    and run under ``api.tuned(profiles=, force=, phase_profiles=)``, where
    the dispatcher sends each matched site to its tuned mock-up.  Then the
    two outputs are compared leaf by leaf, bit for bit.  ``args`` are
    real tensors (both programs run); on a process axis every rank calls
    this together."""
    from repro_torch.core import api

    rec0: list = []
    with api.tuned(record=rec0):
        gm0 = capture(fn, *args)
    with api.tuned():
        out0 = fn(*args)
    tuned = dict(profiles=profiles, force=force,
                 phase_profiles=phase_profiles, chunk_bytes=chunk_bytes)
    rec1: list = []
    with api.tuned(**tuned, record=rec1):
        capture(fn, *args)
    with api.tuned(**tuned):
        out1 = fn(*args)

    mapped, _un = map_sites(gm0)
    matched, unmatched, extra = _match_records_to_sites(
        rec0, [sc.site for sc in mapped])
    changed = [r for r in rec1 if r.impl != "default"]

    l0, t0 = pytree.tree_flatten(out0)
    l1, t1 = pytree.tree_flatten(out1)
    diffs: list[str] = []
    if t0 != t1:
        diffs.append(f"output trees differ: {t0} vs {t1}")
    else:
        for i, (a, b) in enumerate(zip(l0, l1)):
            if not isinstance(a, torch.Tensor):
                if a != b:
                    diffs.append(f"leaf {i}: {a!r} vs {b!r}")
                continue
            a, b = a.detach().cpu(), b.detach().cpu()
            if a.shape != b.shape or a.dtype != b.dtype:
                diffs.append(f"leaf {i}: {a.dtype}{tuple(a.shape)} vs "
                             f"{b.dtype}{tuple(b.shape)}")
            elif not torch.equal(_bits(a), _bits(b)):
                d = (a.double() - b.double()).abs().max().item()
                diffs.append(f"leaf {i}: max |delta| = {d}")
    return RewriteResult(out0, out1, matched, unmatched, extra, changed,
                         bitexact=not diffs, diffs=diffs)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def assert_bitexact(res: RewriteResult) -> None:
    if not res.bitexact:
        raise AssertionError(
            "rewritten program is not bit-exact vs baseline:\n  "
            + "\n  ".join(res.diffs))


# ---------------------------------------------------------------------------
# zoo integration: capture one model-zoo program on a process mesh
# ---------------------------------------------------------------------------


def compile_zoo_graph(arch: str, *, kind: str = "train",
                      mesh_shape: tuple[int, ...] = (2, 4),
                      smoke: bool = True, seq_len: int = 32,
                      global_batch: int = 8, n_micro: int = 1
                      ) -> tuple[torch.fx.GraphModule, dict]:
    """The captured graph of one ``configs/`` zoo program on a (data,
    model) ``GroupMesh`` over the initialized world (a fake world,
    ``launch.mesh.init_fake_world``, or a real one of that size), on the
    fake local arguments of ``launch.shapes.local_args``: the counterpart
    of the JAX package's ``compile_zoo_hlo``.  Returns ``(graph, info)``;
    ``info["records"]`` holds the dispatch records of the capture and
    ``info["arg_bytes"]`` the local bytes of each argument tree."""
    from repro_torch.analysis.graph import tensor_bytes
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_group_mesh
    from repro_torch.launch.shapes import ShapeCell

    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    names = ("data", "model") if len(mesh_shape) == 2 else (
        "pod", "data", "model")
    mesh = make_group_mesh(mesh_shape, names, "cpu")
    cell = ShapeCell(f"{kind}_graph", seq_len, global_batch, kind,
                     n_micro=n_micro)
    gm, records, args = dryrun.trace_cell(cfg, cell, mesh)
    info = {"arch": arch, "kind": kind,
            "mesh": "x".join(map(str, mesh_shape)), "smoke": smoke,
            "seq_len": seq_len, "global_batch": global_batch,
            "records": records,
            "arg_bytes": [tensor_bytes(a) for a in args]}
    return gm, info

