"""The hierarchical (two-tier) plumbing of the port against the reference
on the CPU: the counterparts of the 20 test functions of
``tests/test_hierarchy.py``.

``MeshTopo``, the tier-aware prices, the ``MPIX_*`` composed mock-ups
(on a ``StackedMesh`` of 2 outer x 4 inner ranks, against the flat numpy
oracle and the reference under nested ``jax.vmap``), dispatch with
``inner_axis=`` and a ``MeshTopo`` stamping ``p2`` and the tier token,
and the tier through traces, profiles and ``tune_trace``.

On one card both tiers are stacked axes: the slow tier's ``Topo`` is
derived (``Topo.scaled``), as in the reference.  Tolerances: the
mock-ups at atol 1e-5 against the oracle and the reference (float32
normals; the sums run in another order than numpy's); prices relative
1e-12; tokens, profiles and picks equal.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ref import RC, TC, StackedAxis, to_np

from repro.core import api as rapi
from repro.core import cell as rcell
from repro.core import costmodel as rcm
from repro.core import measure as rmeasure
from repro.core import tuner as rtuner
from repro.core.trace import Trace as RTrace
from repro.core.trace import TraceEntry as RTraceEntry
from repro_torch.core import api as tapi
from repro_torch.core import costmodel as cm
from repro_torch.core import measure, tuner
from repro_torch.core._axis import StackedMesh
from repro_torch.core.cell import OpCell
from repro_torch.core.profiles import Profile, ProfileStore, Range
from repro_torch.core.trace import Trace, TraceEntry

P_OUT, P_IN = 2, 4
MESH = cm.MeshTopo.of(o=cm.V5E_DCN, i=cm.V5E_ICI)
RMESH = rcm.MeshTopo.of(o=rcm.V5E_DCN, i=rcm.V5E_ICI)
TIER = "v5e-dcn/v5e-ici"

HIER_IMPL = {"allreduce": "MPIX_rs_ar_ag", "allgather": "MPIX_ag_ag",
             "reducescatter": "MPIX_rs_rs"}


def _mesh(p=P_OUT, q=P_IN):
    return StackedMesh((p, q), ("o", "i"), "cpu")


def _run_hier(op, name, x, p=P_OUT, q=P_IN):
    """``(port, reference)`` of one impl over the (outer, inner) mesh on a
    stacked payload ``x [p*q, ...]`` in outer-major rank order."""
    m = _mesh(p, q)
    got = to_np(TC.REGISTRY[op][name].fn(torch.from_numpy(x), m["o"],
                                         inner_axis=m["i"]))
    fn = RC.REGISTRY[op][name].fn
    nested = jnp.asarray(x).reshape((p, q) + x.shape[1:])
    ref = jax.vmap(jax.vmap(lambda s: fn(s, "o", inner_axis="i"),
                            axis_name="i"), axis_name="o")(nested)
    return got, np.asarray(ref).reshape((p * q,) + ref.shape[2:])


def _close(a, b):
    if math.isinf(a) or math.isinf(b):
        return a == b
    return abs(a - b) <= 1e-12 * max(abs(a), abs(b), 1e-300)


def _rcell(c):
    return rcell.OpCell(*dataclasses.astuple(c))


# ---------------------------------------------------------------------------
# semantics: composed mock-ups == flat oracle over the joint group
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["default", "MPIX_rs_ar_ag"])
@pytest.mark.parametrize("n", [8, 5])          # 5: not a multiple of q
def test_hier_allreduce_matches_oracle(name, n):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(P_OUT * P_IN, n, 3)).astype(np.float32)
    got, ref = _run_hier("allreduce", name, x)
    np.testing.assert_allclose(got, np.broadcast_to(x.sum(0), x.shape),
                               atol=1e-5)
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("name", ["default", "MPIX_ag_ag"])
def test_hier_allgather_matches_oracle(name):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(P_OUT * P_IN, 3, 2)).astype(np.float32)
    got, ref = _run_hier("allgather", name, x)
    full = x.reshape((-1,) + x.shape[2:])
    np.testing.assert_array_equal(
        got, np.broadcast_to(full, (P_OUT * P_IN,) + full.shape))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("name", ["default", "MPIX_rs_rs"])
def test_hier_reducescatter_matches_oracle(name):
    rng = np.random.default_rng(2)
    w = P_OUT * P_IN
    x = rng.normal(size=(w, w * 3, 2)).astype(np.float32)
    got, ref = _run_hier("reducescatter", name, x)
    np.testing.assert_allclose(got, x.sum(0).reshape(w, 3, 2), atol=1e-5)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_hier_impl_requires_inner_axis():
    for op, name in HIER_IMPL.items():
        with pytest.raises(ValueError, match="inner_axis"):
            TC.REGISTRY[op][name].fn(torch.ones(4, 2), StackedAxis(4, "cpu"))


# ---------------------------------------------------------------------------
# MeshTopo resolution + fitting
# ---------------------------------------------------------------------------


def test_mesh_topo_resolution():
    assert MESH.topo("o") is cm.V5E_DCN and MESH.topo("i") is cm.V5E_ICI
    with pytest.raises(KeyError):
        MESH.topo("nope")
    assert MESH.by_tier("v5e-ici") is cm.V5E_ICI
    assert MESH.by_tier("nope") is None
    assert MESH.flat is cm.V5E_ICI and MESH.slowest is cm.V5E_DCN
    for args in (("o",), ("o", "i"), ("z",), ("o", "z"), ("i", "o")):
        assert MESH.tier_token(*args) == RMESH.tier_token(*args)
    assert MESH.tier_token("o", "i") == TIER
    for tok in ("", "v5e-dcn", TIER, "bogus/unknown"):
        assert [t.name for t in MESH.resolve(tok)] == [
            t.name for t in RMESH.resolve(tok)]
    assert MESH.resolve(TIER) == (cm.V5E_DCN, cm.V5E_ICI)


def test_fit_topo_recovers_ring_parameters():
    true = cm.Topo("truth", alpha=3.0e-6, link_bw=25e9, gamma=4.0e-12)
    p = 8
    sizes = [1 << s for s in range(10, 24, 2)]
    ag = [(b, cm.t_ring_allgather(p, b, true)) for b in sizes]
    ar = [(b, cm.t_ring_allreduce(p, b, true)) for b in sizes]
    fit = cm.fit_topo(p, ag, ar, name="fit")
    assert fit.alpha == pytest.approx(true.alpha, rel=1e-6)
    assert fit.beta == pytest.approx(true.beta, rel=1e-6)
    assert fit.gamma == pytest.approx(true.gamma, rel=1e-6)
    assert cm.fit_topo(p, ag, base=true).gamma == true.gamma
    with pytest.raises(ValueError):
        cm.fit_topo(p, [(1024, 1e-4)])
    with pytest.raises(ValueError):
        cm.fit_topo(1, ag)


def test_scaled_tier_derives_from_fitted_absolutes():
    pts = [(b, cm.t_ring_allgather(4, b, cm.V5E_ICI))
           for b in (1 << 12, 1 << 16, 1 << 20)]
    base = cm.fit_topo(4, pts, name="fit-ici", base=cm.V5E_ICI)
    dcn = base.scaled(name="fit-dcn", alpha_mult=cm.DCN_ALPHA_MULT,
                      bw_mult=cm.DCN_BW_MULT)
    assert dcn.alpha == pytest.approx(base.alpha * 10.0)
    assert dcn.link_bw == pytest.approx(base.link_bw * 0.25)
    assert dcn.gamma == base.gamma
    assert (cm.DCN_ALPHA_MULT, cm.DCN_BW_MULT) == (rcm.DCN_ALPHA_MULT,
                                                   rcm.DCN_BW_MULT)
    rbase = rcm.fit_topo(4, pts, name="fit-ici")
    rdcn = rbase.scaled(name="fit-dcn", alpha_mult=rcm.DCN_ALPHA_MULT,
                        bw_mult=rcm.DCN_BW_MULT)
    assert (dcn.alpha, dcn.link_bw) == (rdcn.alpha, rdcn.link_bw)
    mt = cm.MeshTopo.of(i=base, o=dcn)
    assert mt.resolve("fit-dcn/fit-ici") == (dcn, base)


def test_mesh_topo_fit_builds_per_axis_tiers():
    pts = {
        "i": (4, [(b, cm.t_ring_allgather(4, b, cm.V5E_ICI))
                  for b in (1 << 12, 1 << 20)], None),
        "o": (2, [(b, cm.t_ring_allgather(2, b, cm.V5E_DCN))
                  for b in (1 << 12, 1 << 20)], None),
    }
    mt = cm.MeshTopo.fit(pts, base=cm.V5E_ICI)
    assert mt.topo("i").beta == pytest.approx(cm.V5E_ICI.beta, rel=1e-6)
    assert mt.topo("o").beta == pytest.approx(cm.V5E_DCN.beta, rel=1e-6)
    assert mt.tier_token("o", "i") == "o/i"


# ---------------------------------------------------------------------------
# pricing: composed schedules vs the flat joint ring; admissibility
# ---------------------------------------------------------------------------


def _hier_cell(op="allreduce", nbytes=4 << 20, tier=TIER):
    return OpCell(op, P_OUT, nbytes, p2=P_IN, tier=tier)


def test_hier_allreduce_priced_below_flat_joint_ring():
    cell = _hier_cell()
    B = float(cell.nbytes)
    t_def = cm.latency_cell(cell, "default", MESH)
    assert t_def == pytest.approx(
        cm.t_ring_allreduce(P_OUT * P_IN, B, cm.V5E_DCN))
    t_mpix = cm.latency_cell(cell, "MPIX_rs_ar_ag", MESH)
    assert t_mpix == pytest.approx(
        cm.t_ring_reduce_scatter(P_IN, B, cm.V5E_ICI)
        + cm.t_ring_allreduce(P_OUT, B / P_IN, cm.V5E_DCN)
        + cm.t_ring_allgather(P_IN, B / P_IN, cm.V5E_ICI))
    assert t_mpix < t_def / 2.0
    for nm in ("default", "MPIX_rs_ar_ag"):
        assert _close(cm.latency_cell(cell, nm, MESH),
                      rcm.latency_cell(_rcell(cell), nm, RMESH))


def test_hier_allgather_and_reducescatter_composed_prices():
    B = 1 << 20
    ag = _hier_cell("allgather", B)
    assert cm.latency_cell(ag, "MPIX_ag_ag", MESH) == pytest.approx(
        cm.t_ring_allgather(P_IN, B, cm.V5E_ICI)
        + cm.t_ring_allgather(P_OUT, P_IN * B, cm.V5E_DCN))
    rs = _hier_cell("reducescatter", 8 << 20)
    assert cm.latency_cell(rs, "MPIX_rs_rs", MESH) == pytest.approx(
        cm.t_ring_reduce_scatter(P_OUT, 8 << 20, cm.V5E_DCN)
        + cm.t_ring_reduce_scatter(P_IN, (8 << 20) / P_OUT, cm.V5E_ICI))
    for c in (ag, rs, _hier_cell(tier=""), _hier_cell(tier="v5e-ici")):
        for topo, rtopo in ((MESH, RMESH), (cm.V5E_ICI, rcm.V5E_ICI)):
            sw = cm.sweep_cell(c, topo)
            rsw = rcm.sweep_cell(_rcell(c), rtopo)
            assert list(sw) == list(rsw)
            for nm in sw:
                assert _close(sw[nm], rsw[nm]), (c, nm)


def test_hier_flat_admissibility_is_mutual():
    sw = cm.sweep_cell(_hier_cell(), MESH)
    assert math.isfinite(sw["default"]) and math.isfinite(sw["MPIX_rs_ar_ag"])
    for name, t in sw.items():
        if name not in ("default", "MPIX_rs_ar_ag"):
            assert t == math.inf, name
    flat = OpCell("allreduce", P_OUT * P_IN, 4 << 20)
    assert cm.latency_cell(flat, "MPIX_rs_ar_ag", MESH) == math.inf
    assert math.isfinite(cm.latency_cell(flat, "default", MESH))
    for op, nm in HIER_IMPL.items():
        assert cm.latency(op, nm, 8, 4096, cm.V5E_ICI) == math.inf


def test_hier_untiered_cell_prices_on_slowest_vs_flat():
    cell = _hier_cell(tier="")
    t_def = cm.latency_cell(cell, "default", MESH)
    assert t_def == pytest.approx(cm.t_ring_allreduce(
        P_OUT * P_IN, float(cell.nbytes), cm.V5E_ICI))


# ---------------------------------------------------------------------------
# api dispatch: inner_axis + MeshTopo -> tier-stamped cells
# ---------------------------------------------------------------------------


def _tier_profile(impl="MPIX_rs_ar_ag"):
    return ProfileStore([Profile(
        op="allreduce", axis_size=P_OUT,
        ranges=[Range(1, 1 << 30, impl)], tier=f"{TIER}@q{P_IN}")])


def _dispatch_hier(ctx_kw):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(P_OUT * P_IN, 6, 2)).astype(np.float32)
    m = _mesh()
    with tapi.tuned(**ctx_kw) as ctx:
        got = tapi.allreduce(torch.from_numpy(x), m["o"], inner_axis=m["i"])
    np.testing.assert_allclose(to_np(got), np.broadcast_to(x.sum(0), x.shape),
                               atol=1e-5)
    return ctx.record


def test_dispatch_stamps_tier_and_selects_hier_mockup():
    (rec,) = _dispatch_hier(dict(profiles=_tier_profile(), mesh_topo=MESH))
    assert rec.impl == "MPIX_rs_ar_ag"
    assert rec.cell.p == P_OUT and rec.cell.p2 == P_IN
    assert rec.cell.tier == TIER and rec.cell.hier
    assert rec.cell.profile_tier() == f"{TIER}@q{P_IN}"
    # the reference stamps the same cell
    x = jnp.ones((P_OUT, P_IN, 6, 2), jnp.float32)
    with rapi.tuned(mesh_topo=RMESH) as rctx:
        jax.vmap(jax.vmap(lambda s: rapi.allreduce(s, "o", inner_axis="i"),
                          axis_name="i"), axis_name="o")(x)
    assert dataclasses.astuple(rctx.record[0].cell) == dataclasses.astuple(
        rec.cell)


def test_dispatch_without_mesh_topo_stays_untiered():
    (rec,) = _dispatch_hier({})
    assert rec.impl == "default"
    assert rec.cell.tier == "" and rec.cell.p2 == P_IN
    assert rec.cell.profile_tier() == f"hier@q{P_IN}"


def test_dispatch_global_mesh_topo_registry():
    tapi.set_mesh_topo(MESH)
    try:
        (rec,) = _dispatch_hier({})
        assert rec.cell.tier == TIER
        assert tapi.current_mesh_topo() is MESH
    finally:
        tapi.set_mesh_topo(None)
    (rec,) = _dispatch_hier({})
    assert rec.cell.tier == ""


def test_dispatch_refuses_cross_world_forces():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(P_OUT * P_IN, 4, 2))
                         .astype(np.float32))
    with tapi.tuned(force={"allreduce": "MPIX_rs_ar_ag"}) as ctx:
        tapi.allreduce(x, StackedAxis(P_OUT * P_IN, "cpu"))
    assert [r.impl for r in ctx.record] == ["default"]
    recs = _dispatch_hier(dict(force={"allreduce": "allreduce_as_doubling"}))
    assert [r.impl for r in recs] == ["default"]


# ---------------------------------------------------------------------------
# persistence: tier through trace JSONL, profile text/JSON, disk
# ---------------------------------------------------------------------------


def test_trace_jsonl_roundtrips_tier():
    t = Trace([TraceEntry(OpCell("allreduce", P_OUT, 4096, p2=P_IN,
                                 tier=TIER), "fwd", "default", 3),
               TraceEntry(OpCell("allreduce", 8, 4096), "fwd", "default", 2)])
    back = Trace.from_jsonl(t.to_jsonl())
    assert back == t
    cells = sorted(back.cells(), key=lambda c: c.p)
    assert cells[0].tier == TIER and cells[0].p2 == P_IN
    assert cells[1].tier == "" and cells[1].p2 == 0
    # the reference reads the port's lines
    rback = RTrace.from_jsonl(t.to_jsonl())
    assert sorted(dataclasses.astuple(c) for c in rback.cells()) == sorted(
        dataclasses.astuple(c) for c in back.cells())


def test_profile_tier_text_json_disk_roundtrip(tmp_path):
    from repro.core.profiles import Profile as RProfile
    from repro.core.profiles import ProfileStore as RStore
    prof = Profile(op="allreduce", axis_size=P_OUT,
                   ranges=[Range(1, 1 << 20, "MPIX_rs_ar_ag")],
                   tier=f"{TIER}@q{P_IN}")
    assert "#@tier" in prof.to_text()
    for back in (Profile.from_text(prof.to_text()),
                 Profile.from_json(prof.to_json())):
        assert back.tier == prof.tier and back.ranges == prof.ranges
    assert RProfile.from_text(prof.to_text()).to_text() == prof.to_text()
    flat = Profile(op="allreduce", axis_size=8,
                   ranges=[Range(1, 1 << 20, "allreduce_as_doubling")])
    assert "#@tier" not in flat.to_text()
    ProfileStore([prof, flat]).save(tmp_path)
    names = sorted(f.name for f in tmp_path.glob("*.pgtune"))
    assert any("_t" in n for n in names)
    back = ProfileStore.load(tmp_path)
    assert len(back) == 2
    assert back.get("allreduce", P_OUT,
                    tier=f"{TIER}@q{P_IN}").tier == f"{TIER}@q{P_IN}"
    assert back.get("allreduce", 8).tier == ""
    rback = RStore.load(tmp_path)
    assert rback.get("allreduce", P_OUT,
                     tier=f"{TIER}@q{P_IN}").to_text() == prof.to_text()


# ---------------------------------------------------------------------------
# tuner: tier-keyed profiles from a mixed flat/hierarchical trace
# ---------------------------------------------------------------------------


def test_tune_trace_emits_tier_keyed_profiles():
    hier_cell = OpCell("allreduce", P_OUT, 4 << 20, p2=P_IN, tier=TIER)
    flat_cell = OpCell("allreduce", P_OUT * P_IN, 4 << 20)
    t = Trace([TraceEntry(hier_cell, "fwd", "default", 8),
               TraceEntry(flat_cell, "fwd", "default", 8)])
    rep = tuner.tune_trace(t, backend=tuner.CostModelBackend(MESH))
    store = rep.phase_profiles["fwd"]
    assert store.lookup_cell(hier_cell) == "MPIX_rs_ar_ag"
    assert store.lookup_cell(flat_cell) != "MPIX_rs_ar_ag"
    assert rep.est_tuned_s["fwd"] < rep.est_default_s["fwd"]
    rt = RTrace([RTraceEntry(_rcell(hier_cell), "fwd", "default", 8),
                 RTraceEntry(_rcell(flat_cell), "fwd", "default", 8)])
    rrep = rtuner.tune_trace(rt, backend=rtuner.CostModelBackend(RMESH))
    assert [p.to_text() for p in store] == [
        p.to_text() for p in rrep.phase_profiles["fwd"]]


def test_measure_problem_shapes_hier_uses_world():
    flat = OpCell("reducescatter", 8, 64)
    hier = OpCell("reducescatter", 2, 64, p2=4)
    assert measure.problem_shapes(flat)["x"][0] == \
        measure.problem_shapes(hier)["x"][0] == (64 // 4) * 8
    ar = OpCell("allreduce", 2, 64, p2=4)
    assert measure.problem_shapes(ar)["x"][0] == 64 // 4
    for c in (flat, hier, ar):
        assert measure.problem_shapes(c) == rmeasure.problem_shapes(
            _rcell(c))
    # the hierarchical replay runs on a (p, p2) mesh of the bench's lanes
    bench = measure.Bench(8, "cpu")
    for op, nm in HIER_IMPL.items():
        for name in ("default", nm):
            cell = OpCell(op, 2, 64, p2=4)
            assert len(bench.sample_latency(cell, name, 2)) == 2
