"""The tuning loop of the port against the reference: guidelines, profiles
and traces (both directions), the cost model, ``tune``, the dispatcher's
footer, and the whole slice on the CPU.

Parity rules: profile text, trace JSONL and footers are byte-equal; cost
model values agree to 1e-12 relative; model outputs are computed from
integer-valued float32 inputs, so they agree exactly.  The reference's
impls that the port does not carry are demoted (its own ledger) while a
reference ``tune`` runs, so both packages tune over the same impl set.
"""
import contextlib
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ref import RC, TC, StackedAxis, ported_impls, to_np

from repro.core import api as rapi
from repro.core import cell as rcell
from repro.core import costmodel as rcm
from repro.core import guidelines as RG
from repro.core import measure as rmeasure
from repro.core import profiles as rprof
from repro.core import trace as rtrace
from repro.core import tuner as rtuner
from repro_torch.core import api as tapi
from repro_torch.core import cell as tcell
from repro_torch.core import costmodel as tcm
from repro_torch.core import guidelines as TG
from repro_torch.core import measure as tmeasure
from repro_torch.core import profiles as tprof
from repro_torch.core import trace as ttrace
from repro_torch.core import tuner as ttuner


@contextlib.contextmanager
def reference_without_wire():
    """Demote the reference's impls that the port does not carry (the
    two-axis ones) for the duration, restoring its ledger afterwards.
    The quantized-wire impls are ported: both packages tune them."""
    saved = RC.demotions()
    ported = set(ported_impls())
    for op, impls in RC.REGISTRY.items():
        for nm in impls:
            if nm != "default" and (op, nm) not in ported:
                RC.demote(op, nm, "not ported")
    try:
        yield
    finally:
        RC.clear_demotions()
        for (op, nm), why in saved.items():
            RC.demote(op, nm, why)


@contextlib.contextmanager
def exact_impls_only():
    """Demote the quantized-wire impls in both packages for the duration
    (integer-valued inputs then give exact results in any summation
    order), restoring both ledgers afterwards."""
    saved = RC.demotions(), TC.demotions()
    for op, nm in ported_impls():
        if TC.REGISTRY[op][nm].wire_dtype is not None:
            RC.demote(op, nm, "exact comparison")
            TC.demote(op, nm, "exact comparison")
    try:
        yield
    finally:
        for mod, led in zip((RC, TC), saved):
            mod.clear_demotions()
            for (op, nm), why in led.items():
                mod.demote(op, nm, why)


def to_ref_cell(c):
    return rcell.OpCell(*dataclasses.astuple(c))


# ---------------------------------------------------------------------------
# cells and guidelines
# ---------------------------------------------------------------------------

CELLS = [
    tcell.OpCell("allgather", 8, 4096),
    tcell.OpCell("reducescatter", 6, 100, "bfloat16"),
    tcell.OpCell("matmul_reducescatter", 8, 3 << 20, "bfloat16",
                 384, 4096, 3072, "scatter"),
    tcell.OpCell("matmul_reducescatter", 4, 1 << 10, "float32",
                 64, 4, 256, "scatter"),
    tcell.OpCell("allreduce", 4, 64, "int32"),
]


@pytest.mark.parametrize("c", CELLS, ids=str)
def test_cell_views_match_reference(c):
    r = to_ref_cell(c)
    assert c.itemsize == r.itemsize and c.fused == r.fused
    g, rg = c.geom(), r.geom()
    assert (g is None) == (rg is None)
    if g is not None:
        assert dataclasses.astuple(g) == dataclasses.astuple(rg)
    for nb in (1, 77, 4096, 10 ** 6):
        assert dataclasses.astuple(c.scaled_to(nb)) == dataclasses.astuple(
            r.scaled_to(nb))


def test_guidelines_equal_reference_for_ported_impls():
    ported = set(ported_impls())
    ref = {(g.gl_id, g.op, g.mockup, g.statement) for g in RG.GUIDELINES
           if (g.op, g.mockup) in ported}
    port = {(g.gl_id, g.op, g.mockup, g.statement) for g in TG.GUIDELINES}
    assert port == ref
    assert TG.paper_coverage() == RG.paper_coverage()
    assert [g.gl_id for g in TG.PAPER_GUIDELINES] == [
        f"GL{k}" for k in range(1, 23)]


# ---------------------------------------------------------------------------
# profiles and traces, both directions
# ---------------------------------------------------------------------------


def _profiles(mod, cellmod):
    g = cellmod.Geom("bfloat16", 384, 4096, 3072, "scatter")
    g2 = cellmod.Geom("bfloat16", 1024, 4096, 3072, "scatter")
    R = mod.Range
    return [
        mod.Profile("allgather", 8, [R(1, 64, "allgather_as_doubling"),
                                     R(100, 1 << 20, "allgather_as_ring")],
                    meta={"backend": "measured"}),
        mod.Profile("allreduce", 8, [R(8, 8, "allreduce_as_doubling")],
                    tier="h100-stacked"),
        mod.Profile("matmul_reducescatter", 8,
                    [R(3 << 20, 3 << 20, "fused_ring")], geom=g),
        mod.Profile("matmul_reducescatter", 8,
                    [R(8 << 20, 8 << 20, "fused_ring")], geom=g2),
        mod.Profile("scatter", 4, [R(1, 10, "scatter_as_tree")]),
    ]


LOOKUPS = [
    tcell.OpCell("allgather", 8, 32),
    tcell.OpCell("allgather", 8, 80),
    tcell.OpCell("allgather", 8, 4096),
    tcell.OpCell("allreduce", 8, 8, tier="h100-stacked"),
    tcell.OpCell("allreduce", 8, 8),
    tcell.OpCell("matmul_reducescatter", 8, 3 << 20, "bfloat16",
                 384, 4096, 3072, "scatter"),
    tcell.OpCell("matmul_reducescatter", 8, 5 << 20, "bfloat16",
                 640, 4096, 3072, "scatter"),
    tcell.OpCell("matmul_reducescatter", 8, 5 << 20, "float32",
                 640, 4096, 3072, "scatter"),
    tcell.OpCell("scatter", 4, 5),
]


@pytest.mark.parametrize("fmt", ["text", "json"])
def test_profiles_port_writes_reference_reads(tmp_path, fmt):
    store = tprof.ProfileStore(_profiles(tprof, tcell))
    store.save(tmp_path, fmt=fmt)
    ref = rprof.ProfileStore.load(tmp_path)
    assert len(ref) == len(store)
    for c in LOOKUPS:
        assert ref.lookup_cell(to_ref_cell(c)) == store.lookup_cell(c), c


@pytest.mark.parametrize("fmt", ["text", "json"])
def test_profiles_reference_writes_port_reads(tmp_path, fmt):
    ref = rprof.ProfileStore(_profiles(rprof, rcell))
    ref.save(tmp_path, fmt=fmt)
    store = tprof.ProfileStore.load(tmp_path)
    assert len(store) == len(ref)
    for c in LOOKUPS:
        assert store.lookup_cell(c) == ref.lookup_cell(to_ref_cell(c)), c


def test_profile_text_and_json_are_byte_equal():
    for a, b in zip(_profiles(tprof, tcell), _profiles(rprof, rcell)):
        assert a.to_text() == b.to_text()
        assert a.to_json() == b.to_json()
        assert tprof.Profile.from_text(b.to_text()).to_text() == b.to_text()


def test_profile_v1_text_warns(tmp_path):
    text = _profiles(tprof, tcell)[0].to_text().replace(
        "# pgtune profile v2\n", "")
    (tmp_path / "allgather_p8.pgtune").write_text(text)
    with pytest.warns(DeprecationWarning, match="schema v1"):
        store = tprof.ProfileStore.load(tmp_path)
    assert store.lookup("allgather", 8, 32) == "allgather_as_doubling"


def _trace(mod, cellmod):
    E = mod.TraceEntry
    return mod.Trace([
        E(cellmod.OpCell("allgather", 8, 3 << 20, "bfloat16"), "fwd",
          "default", 2),
        E(cellmod.OpCell("matmul_reducescatter", 8, 3 << 20, "bfloat16",
                         384, 4096, 3072, "scatter"), "fwd", "fused_ring"),
        E(cellmod.OpCell("allreduce", 4, 64, "int32"), "bwd",
          "allreduce_as_doubling", 3),
    ])


def test_trace_jsonl_is_byte_equal_and_loads_both_ways(tmp_path):
    t, r = _trace(ttrace, tcell), _trace(rtrace, rcell)
    assert t.to_jsonl() == r.to_jsonl()
    t.save(tmp_path / "port.jsonl")
    r.save(tmp_path / "ref.jsonl")
    assert rtrace.Trace.load(tmp_path / "port.jsonl") == r
    back = ttrace.Trace.load(tmp_path / "ref.jsonl")
    assert back == t and back.to_jsonl() == r.to_jsonl()
    assert back.summary() == r.summary()
    assert {(k[0].op, k[1]): v for k, v in back.histogram().items()} == {
        (k[0].op, k[1]): v for k, v in r.histogram().items()}
    merged = t.merge(back)
    assert merged.total() == 2 * t.total()
    assert merged.filter(phase="bwd").total() == 6


def test_trace_v1_lines_warn_and_default_geometry():
    line = ('{"op": "matmul_reducescatter", "p": 8, "nbytes": 64, '
            '"phase": "fwd", "impl": "default", "count": 2}\n')
    with pytest.warns(DeprecationWarning, match="schema-v1"):
        t = ttrace.Trace.from_jsonl(line, source="v1.jsonl")
    (e,) = t.entries
    assert not e.cell.fused and e.count == 2 and e.cell.dtype == "float32"


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------

TOPOS = [(tcm.V5E_ICI, rcm.V5E_ICI), (tcm.BGQ_LIKE, rcm.BGQ_LIKE)]


def _close(a, b):
    if math.isinf(a) or math.isinf(b):
        return a == b
    return abs(a - b) <= 1e-12 * max(abs(a), abs(b), 1e-300)


@pytest.mark.parametrize("ti", [0, 1])
def test_latency_matches_reference(ti):
    tt, rt = TOPOS[ti]
    for op, nm in ported_impls():
        for p in (1, 2, 3, 4, 6, 8, 16, 64):
            for nb in ttuner.DEFAULT_SIZES:
                for chunk in (0, 4096):
                    a = tcm.latency(op, nm, p, nb, tt, chunk_bytes=chunk)
                    b = rcm.latency(op, nm, p, nb, rt, chunk_bytes=chunk)
                    assert _close(a, b), (op, nm, p, nb, chunk, a, b)


@pytest.mark.parametrize("ti", [0, 1])
def test_latency_cell_and_sweep_cell_match_reference(ti):
    tt, rt = TOPOS[ti]
    cells = [tcell.OpCell(op, p, nb) for op in TC.OPS for p in (3, 8)
             for nb in (1, 4096, 1 << 20)]
    cells += [c for c in CELLS if c.op == "matmul_reducescatter"]
    cells += [tcell.OpCell("matmul_reducescatter", 8, 8 << 20, "bfloat16",
                           1024, 4096, 3072, "scatter")]
    for c in cells:
        sw = tcm.sweep_cell(c, tt)
        rsw = rcm.sweep_cell(to_ref_cell(c), rt)
        assert set(sw) == set(TC.REGISTRY[c.op])
        for nm, v in sw.items():
            assert _close(v, rsw[nm]), (c, nm, v, rsw[nm])
            assert _close(tcm.latency_cell(c, nm, tt),
                          rcm.latency_cell(to_ref_cell(c), nm, rt))
        assert tcm.best_impl_cell(c, tt)[1] <= min(sw.values())


def test_fit_topo_matches_reference_with_an_explicit_base():
    p = 8
    ag = [(b, 7 * 2e-6 + 7 * b / 40e9) for b in (1, 1 << 10, 1 << 20)]
    ar = [(b, 14 * 2e-6 + 14 / 8 * b / 40e9 + 7 / 8 * b * 3e-12)
          for b in (1, 1 << 10, 1 << 20)]
    a = tcm.fit_topo(p, ag, ar, name="h", base=tcm.V5E_ICI)
    b = rcm.fit_topo(p, ag, ar, name="h", base=rcm.V5E_ICI)
    for f in ("alpha", "link_bw", "gamma", "matmul_flops"):
        assert _close(getattr(a, f), getattr(b, f)), f
    plain = tcm.fit_topo(p, ag)
    assert plain.gamma == 0.0 and _close(plain.alpha, a.alpha)


# ---------------------------------------------------------------------------
# tune: byte-equal profiles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ti,p", [(0, 16), (1, 16), (0, 6)])
def test_tune_costmodel_writes_byte_equal_profiles(tmp_path, ti, p):
    tt, rt = TOPOS[ti]
    ops = list(TC.OPS)
    with reference_without_wire():
        rrep = rtuner.tune(ops, axis_size=p,
                           backend=rtuner.CostModelBackend(rt))
    trep = ttuner.tune(ops, axis_size=p,
                       backend=ttuner.CostModelBackend(tt))
    assert len(trep.profiles) == len(rrep.profiles) > 0
    for prof in rrep.profiles:
        mine = trep.profiles.get(prof.op, prof.axis_size, prof.geom,
                                 prof.tier)
        assert mine is not None and mine.to_text() == prof.to_text()
    assert [(v.gl_kind, v.op, v.nbytes, v.best_impl)
            for v in trep.violations] == [
        (v.gl_kind, v.op, v.nbytes, v.best_impl) for v in rrep.violations]
    trep.profiles.save(tmp_path / "t")
    rrep.profiles.save(tmp_path / "r")
    for f in sorted((tmp_path / "r").iterdir()):
        assert (tmp_path / "t" / f.name).read_text() == f.read_text()


def test_tune_needs_an_explicit_backend():
    with pytest.raises(ValueError, match="backend"):
        ttuner.tune(["allgather"])
    with pytest.raises(ValueError, match="backend"):
        ttuner.tune_trace(ttrace.Trace())


# ---------------------------------------------------------------------------
# dispatch and the footer
# ---------------------------------------------------------------------------


def _calls_port(axis, xs):
    x, xb, xm, w = xs
    tapi.allgather(x, axis)
    tapi.allreduce(x, axis, impl="allreduce_as_doubling")
    tapi.reducescatter(xb, axis)
    tapi.alltoall(xb, axis)
    tapi.bcast(x, axis, root=1)
    tapi.gather(x, axis, root=2)
    tapi.scatter(xb, axis, root=1)
    tapi.reduce(x, axis, root=1)
    tapi.scan(x, axis)
    tapi.exscan(x, axis)
    tapi.allgather(x, axis)
    return tapi.matmul_reducescatter(xm, w, axis)


def _calls_ref(xs):
    x, xb, xm, w = xs
    wj = jnp.asarray(w)

    def body(x, xb, xm):
        rapi.allgather(x, "x")
        rapi.allreduce(x, "x", impl="allreduce_as_doubling")
        rapi.reducescatter(xb, "x")
        rapi.alltoall(xb, "x")
        rapi.bcast(x, "x", root=1)
        rapi.gather(x, "x", root=2)
        rapi.scatter(xb, "x", root=1)
        rapi.reduce(x, "x", root=1)
        rapi.scan(x, "x")
        rapi.exscan(x, "x")
        rapi.allgather(x, "x")
        return rapi.matmul_reducescatter(xm, wj, "x")
    return np.asarray(jax.vmap(body, axis_name="x")(
        jnp.asarray(x), jnp.asarray(xb), jnp.asarray(xm)))


@pytest.mark.parametrize("p", [3, 4])
def test_footer_lines_are_byte_equal(p):
    rng = np.random.default_rng(11)
    x = rng.integers(-5, 6, size=(p, 3, 2)).astype(np.float32)
    xb = rng.integers(-5, 6, size=(p, 2 * p, 2)).astype(np.float32)
    xm = rng.integers(-5, 6, size=(p, 2 * p, 3)).astype(np.float32)
    w = rng.integers(-2, 3, size=(3, 4)).astype(np.float32)
    force = {"allgather": "allgather_as_doubling", "bcast": "bcast_as_tree",
             "scatter": "scatter_as_tree",
             "matmul_reducescatter": "fused_ring"}
    axis = StackedAxis(p, device="cpu")
    with rapi.tuned(force=force, scratch_budget_bytes=1 << 12) as rctx:
        ref = _calls_ref((x, xb, xm, w))
    with tapi.tuned(force=force, scratch_budget_bytes=1 << 12) as tctx:
        got = _calls_port(axis, tuple(torch.from_numpy(a)
                                      for a in (x, xb, xm, w)))
    assert tapi.format_footer(tctx) == rapi.format_footer(rctx)
    assert [tuple(r) for r in tctx.record] == [tuple(r) for r in rctx.record]
    np.testing.assert_array_equal(to_np(got), ref)


def test_selection_order_guards_and_cache(monkeypatch):
    p = 3
    axis = StackedAxis(p, device="cpu")
    x = torch.ones(p, 4, 2)
    prof = tprof.Profile("allreduce", p, [tprof.Range(1, 10 ** 6,
                                                      "allreduce_as_tree_"
                                                      "reduce_bcast")])
    store = tprof.ProfileStore([prof])
    with tapi.tuned(profiles=store) as ctx:
        tapi.allreduce(x, axis)
        tapi.allreduce(x, axis)
        tapi.allreduce(x, axis, impl="allreduce_as_doubling")  # pow2 guard
        monkeypatch.setenv("PGTUNE_MODULE",
                           "allreduce:alg=allreduce_as_reduce_bcast")
        tapi.allreduce(x, axis)
    assert [r.impl for r in ctx.record] == [
        "allreduce_as_tree_reduce_bcast", "allreduce_as_tree_reduce_bcast",
        "default", "allreduce_as_reduce_bcast"]
    assert len(ctx.choices) == 2
    monkeypatch.delenv("PGTUNE_MODULE")
    with tapi.tuned(force={"allgather": "allgather_as_alltoall"},
                    scratch_budget_bytes=8) as ctx:
        tapi.allgather(x, axis)
    assert ctx.record[0].impl == "default"     # over the scratch budget
    try:
        with tapi.tuned(force={"allgather": "allgather_as_ring"}) as ctx:
            tapi.allgather(x, axis)
            TC.demote("allgather", "allgather_as_ring")
            tapi.allgather(x, axis)      # the cached choice is re-admitted
        assert [r.impl for r in ctx.record] == ["allgather_as_ring",
                                                "default"]
    finally:
        TC.clear_demotions()
    with pytest.raises(KeyError):
        tapi.allgather(x, axis, impl="nope")
    with pytest.raises(ValueError, match="default"):
        TC.demote("allgather", "default")


def test_dispatch_refuses_an_operand_on_another_device():
    axis = StackedAxis(2, device="cpu")
    x = torch.ones(2, 3, device="meta")
    with pytest.raises(ValueError, match="axis on cpu"):
        tapi.allgather(x, axis)


# ---------------------------------------------------------------------------
# measurement on the CPU (orderings only; device times come from the card)
# ---------------------------------------------------------------------------


def test_problem_shapes_match_reference():
    for c in CELLS + [tcell.OpCell("scatter", 4, 100),
                      tcell.OpCell("alltoall", 8, 1)]:
        assert tmeasure.problem_shapes(c) == rmeasure.problem_shapes(
            to_ref_cell(c))


def test_bench_samples_sweeps_and_fits_on_the_cpu():
    bench = tmeasure.Bench(4, "cpu")
    s = bench.sample_latency(tcell.OpCell("allgather", 4, 4096),
                             "allgather_as_ring", 3)
    assert len(s) == 3 and all(t > 0 for t in s)
    pts = bench.sweep_axis("allgather", (64, 1 << 16), count=3)
    assert [b for b, _ in pts] == [64, 1 << 16]
    topo = tcm.fit_topo(4, pts, name="cpu-stacked")
    assert topo.alpha > 0 and topo.link_bw > 0
    with pytest.raises(ValueError, match="p=4"):
        bench.case(tcell.OpCell("allgather", 8, 4), "default")


@pytest.mark.parametrize("op", ["alltoall", "allreduce", "allgather"])
def test_bench_impls_of_one_cell_share_its_operands(op):
    """Every impl of a cell replays on one set of operands, which none of
    them writes; the operands of the ``MAX_CASES`` latest cells are
    kept."""
    bench = tmeasure.Bench(4, "cpu")
    cell = tcell.OpCell(op, 4, 64)
    impls = sorted(nm for nm, im in tmeasure.C.REGISTRY[op].items()
                   if not im.hier)
    outs = [bench.case(cell, nm)() for nm in impls]
    assert len(impls) > 1 and len(bench._operands) == 1
    x = bench._inputs(cell)["x"]
    assert x.shape == (4,) + tmeasure.problem_shapes(cell)["x"]
    assert torch.equal(x, torch.ones_like(x))
    for nm, out in zip(impls, outs):
        assert torch.equal(out, outs[0]), nm
    for n in range(1, tmeasure.Bench.MAX_CASES + 2):
        bench.case(tcell.OpCell(op, 4, 64 * (n + 1)), "default")
    assert len(bench._operands) == tmeasure.Bench.MAX_CASES
    assert cell not in bench._operands


def test_measured_backend_tunes_and_skips_what_it_cannot_replay():
    be = ttuner.MeasuredBackend(4, "cpu", max_nrep=5)
    rep = ttuner.tune(["reducescatter", "matmul_reducescatter"],
                      sizes=(64, 4096), axis_size=4, backend=be)
    assert {m.op for m in rep.measurements} == {"reducescatter"}
    assert any("matmul_reducescatter" in n for n in rep.notes)
    other = ttuner.tune(["allgather"], sizes=(64,), axis_size=8, backend=be)
    assert not other.measurements and other.notes


# ---------------------------------------------------------------------------
# the whole slice on the CPU: tune -> profiles -> trace -> tune_trace ->
# dispatch, against the reference's composition under vmap
# ---------------------------------------------------------------------------

P, N, D = 4, 2, 16          # ranks, per-rank rows, model width


def _weights(rng):
    x = rng.integers(-3, 4, size=(P, N, D)).astype(np.float32)
    wv = rng.integers(-1, 2, size=(P, D, D // P)).astype(np.float32)
    wo = rng.integers(-1, 2, size=(P, D // P, D)).astype(np.float32)
    wgu = rng.integers(-1, 2, size=(P, D, 4 * D // P)).astype(np.float32)
    wd = rng.integers(-1, 2, size=(P, 2 * D // P, D)).astype(np.float32)
    return x, wv, wo, wgu, wd


def block_port(axis, x, wv, wo, wgu, wd):
    """One sequence-parallel block: all-gather, a stand-in attention
    projection, matmul-reducescatter, the gate/up allgather-matmul, a
    gated linear unit (relu keeps integer values exact), and the
    MLP-down matmul-reducescatter."""
    h = tapi.allgather(x, axis)
    o = tapi.matmul_reducescatter(torch.matmul(h, wv), wo, axis)
    x2 = x + o
    g, u = tapi.allgather_matmul(x2, wgu, axis).chunk(2, dim=-1)
    return x2 + tapi.matmul_reducescatter(torch.relu(g) * u, wd, axis)


def block_ref(x, wv, wo, wgu, wd):
    h = rapi.allgather(x, "x")
    o = rapi.matmul_reducescatter(jnp.matmul(h, wv), wo, "x")
    x2 = x + o
    g, u = jnp.split(rapi.allgather_matmul(x2, wgu, "x"), 2, axis=-1)
    return x2 + rapi.matmul_reducescatter(jax.nn.relu(g) * u, wd, "x")


def _run_ref(ws, **ctx):
    with rapi.tuned(**ctx) as c:
        out = jax.vmap(block_ref, axis_name="x")(*map(jnp.asarray, ws))
    return np.asarray(out), c


def _run_port(axis, ws, **ctx):
    with tapi.tuned(**ctx) as c:
        out = block_port(axis, *(torch.from_numpy(a) for a in ws))
    return to_np(out), c


def test_whole_slice_on_cpu_matches_reference(tmp_path):
    ws = _weights(np.random.default_rng(12))
    axis = StackedAxis(P, device="cpu")
    sizes = (1, 64, 128, 512, 4096, 1 << 16)
    # 1. tune the flat ops on the cost model; save and reload the profiles
    # (the wire impls, which round, are compared in test_torch_wire.py)
    with reference_without_wire(), exact_impls_only():
        rrep = rtuner.tune(list(TC.FLAT_OPS), sizes, axis_size=P,
                           backend=rtuner.CostModelBackend(rcm.V5E_ICI))
        trep = ttuner.tune(list(TC.FLAT_OPS), sizes, axis_size=P,
                           backend=ttuner.CostModelBackend(tcm.V5E_ICI))
        trep.profiles.save(tmp_path / "base")
        store = tprof.ProfileStore.load(tmp_path / "base")
        assert sorted(p.to_text() for p in store) == sorted(
            p.to_text() for p in rrep.profiles)
        # 2. record the block under the tuned profiles as a trace
        ref_out, rctx = _run_ref(ws, profiles=rrep.profiles)
        got, tctx = _run_port(axis, ws, profiles=store)
        np.testing.assert_array_equal(got, ref_out)
        ttr, rtr = ttrace.Trace.from_context(tctx), rtrace.Trace.from_context(
            rctx)
        assert ttr.to_jsonl() == rtr.to_jsonl()
        assert ttr.ops() == ["allgather", "allgather_matmul",
                             "matmul_reducescatter"]
        # 3. replay the trace, then dispatch under the phase profiles
        for topo, rtopo in TOPOS:
            trr = ttuner.tune_trace(ttr, ttuner.CostModelBackend(topo))
            rrr = rtuner.tune_trace(rtr, rtuner.CostModelBackend(rtopo))
            assert trr.summary() == rrr.summary()
            trr.save(tmp_path / topo.name)
            _, phases = tprof.load_stores(tmp_path / topo.name)
            got2, tctx2 = _run_port(axis, ws, phase_profiles=phases,
                                    profiles=store)
            ref2, rctx2 = _run_ref(ws, phase_profiles=rrr.phase_profiles,
                                   profiles=rrep.profiles)
            np.testing.assert_array_equal(got2, ref2)
            np.testing.assert_array_equal(got2, got)
            assert tapi.format_footer(tctx2) == rapi.format_footer(rctx2)
    # 4. the measured backend replays the same trace on the stacked CPU axis
    mrep = ttuner.tune_trace(ttr, ttuner.MeasuredBackend(P, "cpu",
                                                         max_nrep=5))
    assert {m.op for m in mrep.measurements} == set(ttr.ops())
    with tapi.tuned(force={"matmul_reducescatter": "fused_ring",
                           "allgather_matmul": "fused_ring",
                           "allgather": "allgather_as_allreduce"}):
        forced = block_port(axis, *(torch.from_numpy(a) for a in ws))
    np.testing.assert_array_equal(to_np(forced), got)


def test_wire_held_out_demotes_the_wire_impls_and_restores_the_ledger():
    saved = TC.demotions()
    wire = {(op, nm) for op, impls in TC.REGISTRY.items()
            for nm, impl in impls.items() if impl.wire_dtype is not None}
    assert wire
    try:
        TC.demote("allreduce", "allreduce_as_doubling", "earlier")
        before = TC.demotions()
        with TC.wire_held_out("exact"):
            inside = TC.demotions()
            assert all(inside[k] == "exact" for k in wire)
            assert set(inside) == set(before) | wire
        assert TC.demotions() == before
        with pytest.raises(RuntimeError), TC.wire_held_out("exact"):
            raise RuntimeError
        assert TC.demotions() == before
    finally:
        TC.clear_demotions()
        for (op, nm), why in saved.items():
            TC.demote(op, nm, why)
