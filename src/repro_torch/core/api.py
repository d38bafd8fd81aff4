"""The dispatching collective API — the PGMPITuneLib "PMPI layer".

Framework code calls these entry points instead of a collective directly.
Selection order per call:

1. explicit ``impl=`` argument              (unit tests, hillclimbing)
2. context ``force`` table                  (PGMPITuneCLI ``--module=op:alg=x``)
3. ``PGTUNE_MODULE`` environment variable   (same syntax as the paper's CLI)
4. phase-specific performance profiles      (trace-replay tuning; the store
   matching the active ``api.phase`` tag)
5. loaded performance profiles              (PGMPITuneD online redirection)
7. the default implementation

(Step 6 of the JAX package, the hot-swappable fleet ``store_ref``, is not
ported.)  The JAX package chooses at trace time, so its compiled program
holds only the winner.  Eager PyTorch chooses on every call, so the
choice is cached per (cell, phase) inside the active context and a
repeated call costs one dict lookup after the cell is built.

The context carries the scratch budget (the paper's
``size_msg_buffer_bytes``): a mock-up whose Table-1 extra memory exceeds
it is not applied.  Every dispatch is recorded; ``format_footer()`` emits
the paper's Listing-2 ``#@pgmpi alg <op> <bytes> <impl>`` trailer.

Operands are stacked (``[L, ...]``, one lane per rank, see
``core._axis``); cells carry the PER-RANK payload bytes, so records,
traces and profiles are the same as the JAX package's for the same
per-rank problem.  The two-axis entry points take a second axis object:
``inner_axis=`` on allgather / allreduce / reducescatter (a hierarchical
cell: ``p`` the outer axis, ``p2`` the inner one) and the ``rs_axis`` of
``matmul_reducescatter_2d`` (``p`` the stream axis, ``p2`` the
reduce-scatter axis).  A ``costmodel.MeshTopo`` installed with
``set_mesh_topo`` (or ``tuned(mesh_topo=...)``) stamps each cell's tier
token from the axes' names.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import threading

import torch

from repro_torch.core import collectives as C
from repro_torch.core._axis import StackedAxis
from repro_torch.core.cell import OP_MM_ROLE, OpCell, dtype_name
from repro_torch.core.profiles import OP_TO_MPI, ProfileStore

_TLS = threading.local()

DEFAULT_PHASE = "fwd"


@dataclasses.dataclass(frozen=True)
class DispatchRecord:
    """One dispatched collective: the full problem cell, the impl the
    dispatcher chose, and the workload phase tag.  Destructures as the
    ``(op, p, nbytes, impl, phase)`` 5-tuple."""
    cell: OpCell
    impl: str
    phase: str

    def __iter__(self):
        yield from (self.cell.op, self.cell.p, self.cell.nbytes, self.impl,
                    self.phase)


@dataclasses.dataclass
class TuneContext:
    profiles: ProfileStore | None = None
    force: dict[str, str] = dataclasses.field(default_factory=dict)
    scratch_budget_bytes: int | None = None
    record: list[DispatchRecord] = dataclasses.field(default_factory=list)
    chunk_bytes: int = 0
    phase_profiles: dict[str, ProfileStore] | None = None
    # per-axis interconnect map (costmodel.MeshTopo): stamps each
    # dispatched cell's tier token
    mesh_topo: object | None = None
    # (cell, phase, PGTUNE_MODULE spec) -> impl named by steps 2-7
    choices: dict = dataclasses.field(default_factory=dict, repr=False)


def _ctx() -> TuneContext | None:
    return getattr(_TLS, "ctx", None)


def current_context() -> TuneContext | None:
    """The context opened by the innermost ``tuned`` of this thread."""
    return _ctx()


_GLOBAL_MESH_TOPO = None


def set_mesh_topo(topo) -> None:
    """Install a process-wide ``costmodel.MeshTopo`` that says which
    interconnect tier each named axis runs on; dispatch stamps every
    cell's ``tier`` from it (a ``tuned(mesh_topo=...)`` context overrides
    it).  ``None`` uninstalls."""
    global _GLOBAL_MESH_TOPO
    _GLOBAL_MESH_TOPO = topo


def current_mesh_topo():
    ctx = _ctx()
    if ctx is not None and ctx.mesh_topo is not None:
        return ctx.mesh_topo
    return _GLOBAL_MESH_TOPO


@contextlib.contextmanager
def within(ctx: TuneContext | None):
    """Dispatch the calls inside under ``ctx``, a context that ``tuned``
    opened, possibly on another thread.  Autograd runs the backward of
    CUDA tensors on a thread of its own, where this thread's context is
    not active; ``dist.ops`` keeps each forward's context and issues its
    backward collectives within it, so they are tuned and recorded as the
    forward's are."""
    prev = _ctx()
    _TLS.ctx = ctx
    try:
        yield ctx
    finally:
        _TLS.ctx = prev


def current_phase() -> str:
    """The active workload phase tag (see ``phase``); default ``"fwd"``."""
    return getattr(_TLS, "phase", DEFAULT_PHASE)


@contextlib.contextmanager
def phase(name: str):
    """Tag every dispatch issued inside with workload phase ``name``
    (``fwd``, ``bwd``, ``prefill``, ``decode``); the tag is recorded and
    selects the matching store from ``tuned(phase_profiles=...)``."""
    prev = current_phase()
    _TLS.phase = name
    try:
        yield
    finally:
        _TLS.phase = prev


@contextlib.contextmanager
def tuned(profiles: ProfileStore | None = None,
          force: dict[str, str] | None = None,
          scratch_budget_bytes: int | None = None,
          chunk_bytes: int = 0,
          phase_profiles: dict[str, ProfileStore] | None = None,
          record: list | None = None,
          mesh_topo=None):
    """Activate tuning for every collective of this module issued inside.

    ``force`` maps op name -> impl name (the CLI library's static
    selection); ``profiles`` is the PGMPITuneD mode; ``phase_profiles``
    maps a phase tag to a store consulted before ``profiles`` (what
    ``tuner.tune_trace`` emits).  ``record`` lets the caller supply the
    list dispatches are appended to.  Without any of these, defaults are
    used but calls are still recorded.  ``mesh_topo`` (a
    ``costmodel.MeshTopo``) stamps the cells' tier tokens."""
    prev = _ctx()
    ctx = TuneContext(profiles=profiles, force=dict(force or {}),
                      scratch_budget_bytes=scratch_budget_bytes,
                      chunk_bytes=chunk_bytes,
                      phase_profiles=(dict(phase_profiles)
                                      if phase_profiles else None),
                      record=record if record is not None else [],
                      mesh_topo=mesh_topo)
    _TLS.ctx = ctx
    try:
        yield ctx
    finally:
        _TLS.ctx = prev


def parse_module_spec(spec: str) -> dict[str, str]:
    """Parse the paper's ``--module=allgather:alg=allgather_as_gather_bcast``
    syntax (';'-separated for multiple ops)."""
    out: dict[str, str] = {}
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        op, _, alg = part.partition(":")
        key, _, val = alg.partition("=")
        if key != "alg" or not val:
            raise ValueError(f"bad module spec {part!r}")
        out[op.strip()] = val.strip()
    return out


_ENV_FORCE_CACHE: tuple[str, dict[str, str]] = ("", {})


def _env_force() -> tuple[str, dict[str, str]]:
    """``(raw spec, parsed)`` of ``PGTUNE_MODULE``, parsed once per value."""
    global _ENV_FORCE_CACHE
    spec = os.environ.get("PGTUNE_MODULE", "")
    if spec != _ENV_FORCE_CACHE[0]:
        _ENV_FORCE_CACHE = (spec, parse_module_spec(spec) if spec else {})
    return _ENV_FORCE_CACHE


def _tier(axis: StackedAxis, inner: StackedAxis | None = None) -> str:
    mt = current_mesh_topo()
    if mt is None:
        return ""
    return mt.tier_token(axis.name, None if inner is None else inner.name)


def _make_cell(op: str, payload: torch.Tensor, axis: StackedAxis,
               kw) -> OpCell:
    """The dispatch-time tuning cell: per-rank payload bytes (stacked bytes
    / lanes) plus, for fused ops, the per-rank GEMM read off the
    operands."""
    p = axis.size
    nbytes = payload.numel() * payload.element_size() // axis.lanes
    dtype = dtype_name(payload.dtype)
    role = OP_MM_ROLE.get(op)
    if role is None:
        inner = kw.get("inner_axis")
        if inner is not None:
            # hierarchical plain cell: p = outer (slow) axis, p2 = inner
            return OpCell(op, p, nbytes, dtype, p2=inner.size,
                          tier=_tier(axis, inner))
        return OpCell(op, p, nbytes, dtype, tier=_tier(axis))
    if role == "2d":
        # p = the stream axis, p2 = the reduce-scatter axis; the dims are
        # the PER-RANK GEMM.  The tier token is always (stream / rs); the
        # cost model swaps them for the transpose schedule.
        rs = kw["rs_axis"]
        tier = _tier(axis, rs)
        if kw.get("xpose"):  # payload g [T/p, M] streamed and contracted
            mm_k, mm_m = p * payload.shape[1], payload.shape[-1]
            mm_n = kw["x"].shape[-1]
            return OpCell(op, p, nbytes, dtype, mm_k, mm_m, mm_n, "2dT",
                          rs.size, tier)
        # payload w [K, M/p], a column block streamed over the axis
        mm_k, mm_m = payload.shape[1], kw["x"].shape[-2]
        mm_n = p * payload.shape[-1]
        return OpCell(op, p, nbytes, dtype, mm_k, mm_m, mm_n, "2d",
                      rs.size, tier)
    tier = _tier(axis)
    if role == "gather":     # payload x [n, K] per rank, rows gathered
        mm_k, mm_m = payload.shape[-1], p * payload.shape[1]
        mm_n = kw["w"].shape[-1]   # w [K, M]
    elif role == "scatter":  # payload x [p*n, K] per rank, rows scattered
        mm_k, mm_m = payload.shape[-1], payload.shape[1]
        mm_n = kw["w"].shape[-1]
    elif role == "contract":  # payload: the streamed w block [K/p, M]
        mm_k, mm_m = p * payload.shape[1], kw["x"].shape[-2]
        mm_n = payload.shape[-1]
    else:
        raise KeyError(f"op {op!r} is not ported")
    return OpCell(op, p, nbytes, dtype, mm_k, mm_m, mm_n, role, tier=tier)


def _admit(op: str, name: str, cell: OpCell, ctx: TuneContext | None) -> str:
    """The pow2 guard, the world guard (a hierarchical impl needs a
    two-axis cell, a flat one a flat cell), the demotion ledger and the
    scratch budget: an inadmissible choice falls back to the default."""
    cand = C.REGISTRY[op].get(name)
    if cand is None:
        raise KeyError(f"unknown impl {name!r} for op {op!r}")
    if name == "default":
        return name
    p = cell.p
    if cand.requires_pow2 and ((p & (p - 1)) != 0
                               or (cell.p2 & (cell.p2 - 1)) != 0):
        return "default"
    if cand.hier != cell.hier:
        return "default"
    if C.is_demoted(op, name):
        return "default"
    if (ctx is not None and ctx.scratch_budget_bytes is not None
            and cand.extra_bytes(cell.nbytes, p) > ctx.scratch_budget_bytes):
        return "default"
    return name


def _lookup(op: str, cell: OpCell, ph: str, ctx: TuneContext | None,
            env: dict[str, str]) -> str:
    """Selection steps 2-7: force table, ``PGTUNE_MODULE``, phase
    profiles, profiles, default."""
    name = None
    if ctx is not None and op in ctx.force:
        name = ctx.force[op]
    if name is None and op in env:
        name = env[op]
    if name is None and ctx is not None:
        if ctx.phase_profiles is not None:
            store = ctx.phase_profiles.get(ph)
            if store is not None:
                name = store.lookup_cell(cell)
        if name is None and ctx.profiles is not None:
            name = ctx.profiles.lookup_cell(cell)
    return name or "default"


def _select(op: str, payload: torch.Tensor, axis: StackedAxis,
            impl: str | None, kw) -> str:
    ctx = _ctx()
    cell = _make_cell(op, payload, axis, kw)
    ph = current_phase()
    name = impl
    if name is None:
        spec, env = _env_force()
        if ctx is None:
            name = _lookup(op, cell, ph, None, env)
        else:
            # the lookup is cached; admission is not, so a demotion made
            # while the context is open takes effect on the next call
            key = (cell, ph, spec)
            name = ctx.choices.get(key)
            if name is None:
                name = ctx.choices[key] = _lookup(op, cell, ph, ctx, env)
    name = _admit(op, name, cell, ctx)
    if ctx is not None:
        ctx.record.append(DispatchRecord(cell, name, ph))
    return name


def _dispatch(op: str, payload: torch.Tensor, axis: StackedAxis,
              impl: str | None, /, **kw):
    if payload.device != axis.device:
        raise ValueError(f"{op}: operand on {payload.device}, axis on "
                         f"{axis.device}")
    for other in (kw.get("inner_axis"), kw.get("rs_axis")):
        if other is not None and (other.shape != axis.shape
                                  or other.dim == axis.dim):
            raise ValueError(f"{op}: {axis!r} and {other!r} are not two "
                             "axes of one StackedMesh")
    ctx = _ctx()
    if ctx is not None and ctx.chunk_bytes and "chunk" not in kw:
        kw["chunk"] = max(1, ctx.chunk_bytes // payload.element_size())
    name = _select(op, payload, axis, impl, kw)
    return C.REGISTRY[op][name].fn(payload, axis, **kw)


# -- public entry points -----------------------------------------------------
# Every operand is stacked: dim 0 is the rank (see core._axis).


def allgather(x, axis: StackedAxis, *,
              inner_axis: StackedAxis | None = None,
              impl: str | None = None):
    """With ``inner_axis`` the gather runs over the joint ``(axis,
    inner_axis)`` group in outer-major block order (``axis`` the OUTER,
    slow tier) and the cell records ``p2`` and the tier token, which makes
    the hierarchical ``MPIX_*`` mock-ups admissible."""
    if inner_axis is None:
        return _dispatch("allgather", x, axis, impl)
    return _dispatch("allgather", x, axis, impl, inner_axis=inner_axis)


def allreduce(x, axis: StackedAxis, *,
              inner_axis: StackedAxis | None = None,
              impl: str | None = None, **kw):
    """With ``inner_axis`` the sum runs over the joint group (see
    ``allgather``)."""
    if inner_axis is not None:
        kw["inner_axis"] = inner_axis
    return _dispatch("allreduce", x, axis, impl, **kw)


def reducescatter(x, axis: StackedAxis, *,
                  inner_axis: StackedAxis | None = None,
                  impl: str | None = None):
    """With ``inner_axis`` the scatter runs over the joint group: rank
    ``(i, j)`` receives joint-sum block ``i*q + j`` (outer-major)."""
    if inner_axis is None:
        return _dispatch("reducescatter", x, axis, impl)
    return _dispatch("reducescatter", x, axis, impl, inner_axis=inner_axis)


def alltoall(x, axis: StackedAxis, *, impl: str | None = None):
    return _dispatch("alltoall", x, axis, impl)


def bcast(x, axis: StackedAxis, *, root: int = 0, impl: str | None = None):
    return _dispatch("bcast", x, axis, impl, root=root)


def gather(x, axis: StackedAxis, *, root: int = 0, impl: str | None = None):
    return _dispatch("gather", x, axis, impl, root=root)


def scatter(x, axis: StackedAxis, *, root: int = 0, impl: str | None = None):
    return _dispatch("scatter", x, axis, impl, root=root)


def reduce(x, axis: StackedAxis, *, root: int = 0, impl: str | None = None,
           **kw):
    return _dispatch("reduce", x, axis, impl, root=root, **kw)


def scan(x, axis: StackedAxis, *, op: str = "add", impl: str | None = None):
    return _dispatch("scan", x, axis, impl, op=op)


def exscan(x, axis: StackedAxis, *, op: str = "add", impl: str | None = None):
    return _dispatch("exscan", x, axis, impl, op=op)


def allgather_matmul(x, w, axis: StackedAxis, *, impl: str | None = None,
                     return_gathered: bool = False):
    """``all_gather(x, rows) @ w``: ``x [p, n, K]``, ``w [p, K, M]`` or a
    shared ``[K, M]`` -> ``[p, p*n, M]``; with ``return_gathered`` also
    ``all_gather(x)`` ``[p, p*n, K]``.  Fused-vs-unfused is a tuner
    decision; the dispatch key is the per-rank bytes of ``x``."""
    return _dispatch("allgather_matmul", x, axis, impl, w=w,
                     return_gathered=return_gathered)


def matmul_reducescatter(x, w, axis: StackedAxis, *,
                         impl: str | None = None):
    """``reduce_scatter(x @ w, rows)``: ``x [p, p*n, K]``, ``w [p, K, M]``
    or a shared ``[K, M]`` -> ``[p, n, M]``; partial products are summed
    over ranks and row block i lands on rank i."""
    return _dispatch("matmul_reducescatter", x, axis, impl, w=w)


def matmul_accumulate(x, w, axis: StackedAxis, *, impl: str | None = None,
                      return_gathered: bool = False):
    """``x @ all_gather(w, rows)``, the contraction-dim collective matmul:
    ``w [p, K/p, M]`` (each rank's K-block of the weight; its bytes are the
    dispatch key, since the collective streams them), ``x [p, T, K]`` or a
    shared ``[T, K]`` -> ``[p, T, M]``; with ``return_gathered`` also
    ``all_gather(w)`` ``[p, K, M]``."""
    return _dispatch("matmul_accumulate", w, axis, impl, x=x,
                     return_gathered=return_gathered)


def matmul_reducescatter_2d(x, w, rs_axis: StackedAxis,
                            ag_axis: StackedAxis, *,
                            impl: str | None = None,
                            return_gathered: bool = False):
    """``reduce_scatter(x @ all_gather(w, cols over ag_axis), rows over
    rs_axis)``: the weight-stationary 2-D collective matmul over two axes
    of one ``StackedMesh``.

    ``w [L, K, M/d]`` (each lane's data-axis column block of a
    row-parallel weight; its bytes are the dispatch key, since the OUTER
    ring streams them), ``x [L, T, K]`` -> ``[L, T/q, M]`` summed over
    ``rs_axis``.  The cell records ``p`` = the gather axis and ``p2`` =
    the scatter axis.  ``return_gathered`` also returns the assembled
    weight ``[L, K, M]`` (the paired backward reuses it for dx)."""
    return _dispatch("matmul_reducescatter_2d", w, ag_axis, impl, x=x,
                     rs_axis=rs_axis, return_gathered=return_gathered)


def matmul_reducescatter_2d_t(g, x, rs_axis: StackedAxis,
                              ag_axis: StackedAxis, *,
                              impl: str | None = None):
    """``reduce_scatter(all_gather(g, rows over ag_axis)ᵀ @ x, rows over
    rs_axis)``: the TRANSPOSE 2-D schedule (the dw of the paired
    backward).  ``g [L, T/q, M]`` (the cotangent's gather-axis row block,
    the dispatch payload, contracted away), ``x [L, T, K]`` ->
    ``[L, M/d, K]`` summed over ``rs_axis``.  It dispatches through the
    same op as the forward; its cells record role ``2dT``."""
    return _dispatch("matmul_reducescatter_2d", g, ag_axis, impl, x=x,
                     rs_axis=rs_axis, xpose=True)


def format_footer(ctx: TuneContext) -> str:
    """The paper's Listing-2 footer: which algorithm served each call."""
    lines = []
    seen = set()
    for op, p, nbytes, name, *_phase in ctx.record:
        key = (op, p, nbytes, name)
        if key in seen:
            continue
        seen.add(key)
        mpi = OP_TO_MPI.get(op, op)
        label = "default" if name == "default" else name
        lines.append(f"#@pgmpi alg {mpi} {nbytes} {label}")
    if ctx.scratch_budget_bytes is not None:
        lines.append(
            f"#@pgmpi config size_msg_buffer_bytes {ctx.scratch_budget_bytes}")
    return "\n".join(lines)
