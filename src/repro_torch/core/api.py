"""The dispatching collective API — the PGMPITuneLib "PMPI layer".

Framework code calls these entry points instead of a collective directly.
Selection order per call:

1. explicit ``impl=`` argument              (unit tests, hillclimbing)
2. context ``force`` table                  (PGMPITuneCLI ``--module=op:alg=x``)
3. ``PGTUNE_MODULE`` environment variable   (same syntax as the paper's CLI)
4. phase-specific performance profiles      (trace-replay tuning; the store
   matching the active ``api.phase`` tag)
5. loaded performance profiles              (PGMPITuneD online redirection)
6. the live fleet ``store_ref``             (hot-swappable epochal stores;
   see ``profiles.StoreRef``)
7. the default implementation

The JAX package chooses at trace time, so its compiled program holds only
the winner.  Eager PyTorch chooses on every call, so the choice is cached
per (cell, phase) inside the active context and a repeated call costs one
dict lookup after the cell is built.  A choice read through a
``store_ref`` is cached under the ref's live epoch, so a swapped or
rolled-back generation reaches a site that has already run.

Fleet hot-swap: under ``tuned(plan=Plan(), store_ref=ref)`` each eligible
site dispatches at RUN time: it holds a slot of the plan and runs the
admissible impl whose index the plan vector holds there.  The vector is a
host array (numpy, or a CPU ``torch.int32`` tensor) the step takes as its
trailing argument and exposes with ``plan_input``; a new profile epoch
changes its contents, and the step built once serves every epoch.  Plan
sites record ``PLAN_IMPL``.

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

The axis may be stacked (``StackedAxis``) or span processes
(``GroupAxis``, one lane a process): on a process axis of more than one
rank the one-kernel ring (``allgather_matmul``'s ``fused_ring`` on CUDA
operands) is not admissible (``collectives.off_process_axis``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import statistics
import threading

import numpy as np
import torch

from repro_torch.core import collectives as C
from repro_torch.core._axis import GroupAxis, StackedAxis
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
    # fleet retuning: live hot-swappable stores (profiles.StoreRef) and
    # the runtime-dispatch plan (api.Plan) — see module docstring
    store_ref: object | None = None
    plan: "Plan | None" = None
    # per-axis interconnect map (costmodel.MeshTopo): stamps each
    # dispatched cell's tier token
    mesh_topo: object | None = None
    # (cell, phase, PGTUNE_MODULE spec, store_ref epoch) -> impl named by
    # steps 2-7
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
          store_ref=None,
          plan: "Plan | None" = None,
          mesh_topo=None):
    """Activate tuning for every collective of this module issued inside.

    ``force`` maps op name -> impl name (the CLI library's static
    selection); ``profiles`` is the PGMPITuneD mode; ``phase_profiles``
    maps a phase tag to a store consulted before ``profiles`` (what
    ``tuner.tune_trace`` emits).  ``record`` lets the caller supply the
    sink dispatches are appended to (a list, or a
    ``trace.ShardRecorder``).  Without any of these, defaults are used but
    calls are still recorded.  ``mesh_topo`` (a ``costmodel.MeshTopo``)
    stamps the cells' tier tokens.

    Fleet mode: ``store_ref`` (a ``profiles.StoreRef``) is consulted after
    the explicit stores and read LIVE, so a swapped-in epoch changes what
    later calls select without a new context.  ``plan`` additionally
    switches eligible sites to runtime dispatch (the branch index read
    from the ``plan_input`` vector), so a swap takes effect in steps
    already built."""
    prev = _ctx()
    ctx = TuneContext(profiles=profiles, force=dict(force or {}),
                      scratch_budget_bytes=scratch_budget_bytes,
                      chunk_bytes=chunk_bytes,
                      phase_profiles=(dict(phase_profiles)
                                      if phase_profiles else None),
                      record=record if record is not None else [],
                      store_ref=store_ref, plan=plan, mesh_topo=mesh_topo)
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


def _admit(op: str, name: str, cell: OpCell, ctx: TuneContext | None,
           axis, device: torch.device) -> str:
    """The pow2 guard, the world guard (a hierarchical impl needs a
    two-axis cell, a flat one a flat cell), the process-axis guard (no
    one-kernel ring across processes), the demotion ledger and the
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
    if C.off_process_axis(op, name, axis, device):
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
    profiles, profiles, the live ``store_ref``, default."""
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
        if name is None and ctx.store_ref is not None:
            name = ctx.store_ref.lookup(cell, ph)
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
            # while the context is open takes effect on the next call.
            # A live store_ref's epoch is part of the key: a swap or a
            # rollback must reach sites that have already run.
            ref = ctx.store_ref
            key = (cell, ph, spec, None if ref is None else ref.epoch)
            name = ctx.choices.get(key)
            if name is None:
                name = ctx.choices[key] = _lookup(op, cell, ph, ctx, env)
    name = _admit(op, name, cell, ctx, axis, payload.device)
    if ctx is not None:
        ctx.record.append(DispatchRecord(cell, name, ph))
    return name


# ---------------------------------------------------------------------------
# runtime dispatch plans (fleet hot-swap)
# ---------------------------------------------------------------------------

#: recorded impl marker for sites dispatched through a runtime plan — the
#: branch taken is decided per call by the plan vector
PLAN_IMPL = "plan"


class Plan:
    """A runtime dispatch plan: the fixed-capacity impl-index vector that
    makes profile hot-swaps take effect without rebuilding a step.

    Under a Plan each eligible dispatch site holds a slot and runs the
    impl of its admissible list whose index the plan vector holds there
    (``plan_input``).  The vector's length is the fixed ``capacity``; its
    CONTENTS are re-derived from the live stores (``vector(ref)``)
    whenever an epoch lands.

    Sites are keyed ``(cell, phase)``: new cells take fresh slots from the
    spare capacity.  When capacity runs out, or a site's admissible set
    drifts from the one it registered with (a demotion), the site falls
    back to ordinary static dispatch — visible via ``len(plan)`` vs
    ``plan.capacity``.
    """

    def __init__(self, capacity: int = 128):
        self.capacity = int(capacity)
        self._sites: dict[tuple[OpCell, str],
                          tuple[int, tuple[str, ...]]] = {}
        # the admissible impls of a site, computed once: keyed by what
        # they depend on besides the cell (see ``_dispatch_plan``)
        self._admissible: dict[tuple, tuple[str, ...]] = {}

    def __len__(self) -> int:
        return len(self._sites)

    def slot(self, cell: OpCell, phase: str,
             impls: tuple[str, ...]) -> int | None:
        """Stable vector slot for a dispatch site (None = dispatch
        statically: capacity exhausted, or the admissible set drifted
        from what this site was registered with)."""
        key = (cell, phase)
        hit = self._sites.get(key)
        if hit is not None:
            s, known = hit
            return s if known == impls else None
        if len(self._sites) >= self.capacity:
            return None
        s = len(self._sites)
        self._sites[key] = (s, impls)
        return s

    def sites(self) -> list[tuple[OpCell, str, tuple[str, ...]]]:
        return [(cell, ph, impls) for (cell, ph), (_s, impls)
                in sorted(self._sites.items(), key=lambda kv: kv[1][0])]

    def _resolve(self, cell, ph, store_ref, base, phases):
        if store_ref is not None:
            return store_ref.lookup(cell, ph)
        store = (phases or {}).get(ph)
        name = store.lookup_cell(cell) if store is not None else None
        if name is None and base is not None:
            name = base.lookup_cell(cell)
        return name

    def vector(self, store_ref=None, *, base: ProfileStore | None = None,
               phases: dict[str, ProfileStore] | None = None) -> np.ndarray:
        """The plan vector for the CURRENT profile generation: slot i
        holds the index (into that site's admissible impl list, 0 =
        default) the live stores select.  Unregistered slots stay 0."""
        vec = np.zeros(self.capacity, dtype=np.int32)
        for (cell, ph), (s, impls) in self._sites.items():
            name = self._resolve(cell, ph, store_ref, base, phases)
            if name in impls:
                vec[s] = impls.index(name)
        return vec

    def explore(self, store_ref=None, *, eps: float, rng,
                base: ProfileStore | None = None,
                phases: dict[str, ProfileStore] | None = None):
        """The exploration-budget vector: start from ``vector(...)`` and,
        per site, with probability ``eps`` flip to the next entry of the
        site's admissible ring (profiles only store winners, so "next"
        stands in for second-best; for default-serving sites that is the
        first mock-up).  Returns ``(vec, explored)`` where ``explored``
        maps ``(cell, phase) -> impl`` for the flipped sites, so the serve
        loop can attribute the latencies it measures
        (``ShardRecorder.observe``) to what actually ran."""
        vec = self.vector(store_ref, base=base, phases=phases)
        explored: dict[tuple[OpCell, str], str] = {}
        for (cell, ph), (s, impls) in sorted(self._sites.items(),
                                             key=lambda kv: kv[1][0]):
            if len(impls) < 2 or float(rng.random()) >= eps:
                continue
            vec[s] = (int(vec[s]) + 1) % len(impls)
            explored[(cell, ph)] = impls[vec[s]]
        return vec, explored


@contextlib.contextmanager
def plan_input(vec):
    """Expose a step's plan-vector argument (a numpy array or a CPU
    integer tensor) to the dispatch sites inside; builders wrap the model
    call in this.  The vector is read once on entry, so a step reads the
    contents it was called with.  A CUDA vector is refused: every site
    would synchronize with the card to read its index."""
    if isinstance(vec, torch.Tensor) and vec.device.type != "cpu":
        raise ValueError(f"plan vector on {vec.device}: keep it on the "
                         "host (a numpy array or a CPU tensor)")
    prev = getattr(_TLS, "plan_vec", None)
    _TLS.plan_vec = vec.tolist()
    try:
        yield
    finally:
        _TLS.plan_vec = prev


class EpochTripwire:
    """Plan-level auto-rollback: revert a freshly adopted epoch whose
    OBSERVED cost regresses past the prior epoch's.

    The staleness and digest guards stop bad publishes; nothing on the
    read side stops a well-formed but wrong epoch.  The tripwire watches
    the one place regression is observable, the serve loop's per-step
    cost.  Feed it each step's observed cost via ``observe``; it buckets
    costs by the ``StoreRef``'s live epoch, takes the median of a
    finished epoch's window as the next epoch's baseline, and when the
    current epoch's windowed median exceeds ``threshold ×`` baseline it
    calls ``ref.rollback()`` — vector contents only, no step rebuilt, and
    the bad epoch is poisoned against re-adoption.

    The window is the last ``window`` costs; medians make a single
    exploration spike or latency outlier unable to trip it.
    """

    def __init__(self, ref, *, threshold: float = 1.5, window: int = 8,
                 min_samples: int = 4):
        self.ref = ref
        self.threshold = float(threshold)
        self.window = int(window)
        self.min_samples = int(min_samples)
        self._epoch = ref.epoch
        self._costs: list[float] = []
        self._baseline: float | None = None   # prior epoch's median cost
        self.fired: list[tuple[int, int]] = []  # (bad epoch, restored)

    @property
    def baseline(self) -> float | None:
        return self._baseline

    def observe(self, cost: float) -> bool:
        """Record one observed step cost under the CURRENT live epoch;
        returns True iff this observation fired a rollback."""
        epoch = self.ref.epoch
        if epoch != self._epoch:
            if epoch > self._epoch and len(self._costs) >= self.min_samples:
                # the finished epoch's steady-state cost becomes the new
                # epoch's yardstick
                self._baseline = statistics.median(self._costs)
            # on epoch < self._epoch (a rollback we didn't fire) the
            # baseline stays: it IS the restored epoch's own median
            self._costs = []
            self._epoch = epoch
        self._costs.append(float(cost))
        del self._costs[:-self.window]
        if self._baseline is None or len(self._costs) < self.min_samples:
            return False
        med = statistics.median(self._costs)
        if med <= self.threshold * self._baseline:
            return False
        restored = self.ref.rollback()
        if restored is None:
            return False   # nothing retained; keep serving + observing
        self.fired.append((epoch, restored))
        self._epoch = restored
        self._costs = []
        return True


def _admissible_impls(op: str, cell: OpCell, ctx: TuneContext | None,
                      axis=None, device: torch.device | None = None
                      ) -> tuple[str, ...]:
    """The impls a runtime plan may switch between for one site, default
    first and the rest sorted: exactly those static dispatch admits
    (``_admit``: pow2, world, process axis, demotions, scratch budget),
    which depend on the cell and the axis, never on the profile."""
    device = torch.device("cpu") if device is None else device
    names = ["default"] + sorted(n for n in C.REGISTRY[op] if n != "default")
    return tuple(n for n in names
                 if _admit(op, n, cell, ctx, axis, device) == n)


_NO_PLAN = object()


def _dispatch_plan(op: str, payload: torch.Tensor, axis, ctx: TuneContext,
                   plan_vec: list[int], kw):
    """Run one site through the plan: the admissible impl at the index
    its slot holds.  Returns ``_NO_PLAN`` when the site must dispatch
    statically."""
    cell = _make_cell(op, payload, axis, kw)
    plan = ctx.plan
    key = (cell, payload.device.type,
           isinstance(axis, GroupAxis) and axis.size > 1,
           C.demotion_version(), ctx.scratch_budget_bytes)
    impls = plan._admissible.get(key)
    if impls is None:
        impls = plan._admissible[key] = _admissible_impls(
            op, cell, ctx, axis, payload.device)
    if len(impls) < 2:
        return _NO_PLAN
    ph = current_phase()
    slot = plan.slot(cell, ph, impls)
    if slot is None:
        return _NO_PLAN
    ctx.record.append(DispatchRecord(cell, PLAN_IMPL, ph))
    idx = min(max(plan_vec[slot], 0), len(impls) - 1)
    return C.REGISTRY[op][impls[idx]].fn(payload, axis, **kw)



def _dispatch(op: str, payload: torch.Tensor, axis: StackedAxis,
              impl: str | None, /, **kw):
    if payload.device != axis.device:
        raise ValueError(f"{op}: operand on {payload.device}, axis on "
                         f"{axis.device}")
    for other in (kw.get("inner_axis"), kw.get("rs_axis")):
        if other is not None and (other.shape != axis.shape
                                  or other.dim == axis.dim):
            raise ValueError(f"{op}: {axis!r} and {other!r} are not two "
                             "axes of one StackedMesh (or of one GroupMesh)")
    ctx = _ctx()
    if ctx is not None and ctx.chunk_bytes and "chunk" not in kw:
        kw["chunk"] = max(1, ctx.chunk_bytes // payload.element_size())
    if impl is None and ctx is not None and ctx.plan is not None:
        plan_vec = getattr(_TLS, "plan_vec", None)
        if (plan_vec is not None and op not in ctx.force
                and op not in _env_force()[1]):
            out = _dispatch_plan(op, payload, axis, ctx, plan_vec, kw)
            if out is not _NO_PLAN:
                return out
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
