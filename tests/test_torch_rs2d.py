"""The weight-stationary 2-D collective matmul (``matmul_reducescatter_2d``)
of the port against the reference on the CPU: the counterparts of the
17 test functions of ``tests/test_matmul_rs2d.py``.

The port runs on a ``StackedMesh`` (lane ``i*q + j`` = outer rank i,
inner rank j), the reference under nested ``jax.vmap`` with the same
outer and inner axes, on the same inputs made from a numpy seed.

Tolerances: the nested ring against the dense oracle at atol 1e-4 in
float32 and 2e-2 in float16 (the reference's own); integer-valued
operands and the reference's integer cotangent (``_int_cot``) keep every
sum exact, so the dist-op cases are held bit for bit, to each other and
to the reference; tuner picks, ``latency_cell`` prices (relative 1e-12)
and the 2-D profile text equal the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ref import RC, TC, StackedAxis, to_np

from repro.core import api as rapi
from repro.core import cell as rcell
from repro.core import costmodel as rcm
from repro.core import trace as rtrace
from repro.core import tuner as rtuner
from repro.core.profiles import Profile as RProfile
from repro.core.profiles import ProfileStore as RStore
from repro.core.profiles import Range as RRange
from repro.dist import ops as rops
from repro.kernels import collective_matmul as rcmm
from repro_torch.core import api as tapi
from repro_torch.core import costmodel as tcm
from repro_torch.core import measure as tmeasure
from repro_torch.core import tuner as ttuner
from repro_torch.core._axis import StackedMesh
from repro_torch.core.cell import OpCell
from repro_torch.core.profiles import Profile, ProfileStore, Range
from repro_torch.core.trace import Trace, TraceEntry
from repro_torch.dist import axes as taxes
from repro_torch.dist import ops as tops
from repro_torch.kernels.collective_matmul import (
    ring_matmul_reducescatter_2d, ring_matmul_reducescatter_2d_t)

MESHES = ((2, 2), (2, 3), (4, 2))
OP = "matmul_reducescatter_2d"


@pytest.fixture()
def rng():
    return np.random.default_rng(20170701)


def _int_cot(shape) -> np.ndarray:
    """The reference's integer cotangent (``test_matmul_rs2d._int_cot``),
    computed by the same jax expression."""
    n = int(np.prod(shape))
    return np.array(jnp.round(jnp.cos(jnp.arange(n, dtype=jnp.float32))
                              .reshape(shape) * 4))


def _shard_fwd(rng, d, q, T, kl, ml, *, integer=False):
    """(x_sh [d,q,T,kl], w_sh [d,q,kl,ml], X, W): model rank j holds x's
    j-th K-slice (replicated over data) and the (j K-rows, i col-block)
    weight shard."""
    def draw(shape):
        a = rng.normal(size=shape)
        return (np.round(a * 2) if integer else a).astype(np.float32)
    X = draw((T, q * kl))
    W = draw((q * kl, d * ml))
    x_sh = np.stack([np.stack([X[:, j * kl:(j + 1) * kl] for j in range(q)])
                     for _ in range(d)])
    w_sh = np.stack([np.stack([W[j * kl:(j + 1) * kl, i * ml:(i + 1) * ml]
                               for j in range(q)]) for i in range(d)])
    return x_sh, w_sh, X, W


def _xpose_operands(rng, d, q, T=None, kl=3, M=None):
    T = T or 2 * q
    M = M or 2 * d
    tl = T // q
    G = rng.normal(size=(T, M)).astype(np.float32)
    Xs = [rng.normal(size=(T, kl)).astype(np.float32) for _ in range(d)]
    g_sh = np.stack([np.stack([G[j * tl:(j + 1) * tl] for j in range(q)])
                     for _ in range(d)])
    x_sh = np.stack([np.broadcast_to(Xs[i], (q, T, kl)).copy()
                     for i in range(d)])
    want = sum(G.T @ Xs[i] for i in range(d))
    return g_sh, x_sh, want, M // d


def flat(a) -> torch.Tensor:
    a = np.asarray(a)
    return torch.from_numpy(np.ascontiguousarray(
        a.reshape((-1,) + a.shape[2:])))


def unflat(t, d, q) -> np.ndarray:
    a = to_np(t)
    return a.reshape((d, q) + a.shape[1:])


def _vmap2(f, outer="ag", inner="rs"):
    return jax.vmap(jax.vmap(f, axis_name=inner), axis_name=outer)


def _mesh(d, q, names=("ag", "rs")):
    return StackedMesh((d, q), names, "cpu")


# ---------------------------------------------------------------------------
# the nested ring against the dense oracle and the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,q", MESHES)
@pytest.mark.parametrize("dtype,atol", [(np.float32, 1e-4),
                                        (np.float16, 2e-2)])
def test_ring_2d_matches_oracle(rng, d, q, dtype, atol):
    T, kl, ml = 2 * q, 3, 4
    x_sh, w_sh, X, W = _shard_fwd(rng, d, q, T, kl, ml)
    x_sh, w_sh = x_sh.astype(dtype), w_sh.astype(dtype)
    m = _mesh(d, q)
    got = unflat(ring_matmul_reducescatter_2d(flat(x_sh), flat(w_sh),
                                              m["rs"], m["ag"]), d, q)
    ref = np.asarray(_vmap2(lambda a, b: rcmm.ring_matmul_reducescatter_2d(
        a, b, "rs", "ag"))(jnp.asarray(x_sh), jnp.asarray(w_sh)), np.float32)
    want = X.astype(np.float32) @ W.astype(np.float32)
    tl = T // q
    for i in range(d):
        for j in range(q):
            np.testing.assert_allclose(got[i, j], want[j * tl:(j + 1) * tl],
                                       atol=atol)
    np.testing.assert_allclose(got, ref, atol=atol)


def test_ring_2d_returns_gathered(rng):
    d, q, T, kl, ml = 2, 2, 4, 3, 5
    x_sh, w_sh, X, W = _shard_fwd(rng, d, q, T, kl, ml)
    m = _mesh(d, q)
    _, gath = ring_matmul_reducescatter_2d(flat(x_sh), flat(w_sh), m["rs"],
                                           m["ag"], return_gathered=True)
    gath = unflat(gath, d, q)
    for i in range(d):
        for j in range(q):
            np.testing.assert_allclose(gath[i, j], W[j * kl:(j + 1) * kl],
                                       atol=1e-6)


def test_ring_2d_kernel_chunks_match_the_matmul_path(rng):
    """Every chunk product through ``block_matmul`` (``mm="kernel"``: its
    plain version on the CPU) gives the numbers of ``torch.matmul``, in
    both directions: the counterpart of the reference's interpret-mode
    Pallas blocks."""
    d, q, T, kl, ml = 2, 2, 4, 3, 4
    x_sh, w_sh, _, _ = _shard_fwd(rng, d, q, T, kl, ml)
    m = _mesh(d, q)
    a = ring_matmul_reducescatter_2d(flat(x_sh), flat(w_sh), m["rs"],
                                     m["ag"], mm="matmul")
    b = ring_matmul_reducescatter_2d(flat(x_sh), flat(w_sh), m["rs"],
                                     m["ag"], mm="kernel")
    np.testing.assert_allclose(to_np(b), to_np(a), atol=1e-5)
    g_sh, xg_sh, _, _ = _xpose_operands(rng, 2, 2)
    mt = _mesh(2, 2, ("rs", "ag"))
    gt = ring_matmul_reducescatter_2d_t(flat(g_sh), flat(xg_sh), mt["rs"],
                                        mt["ag"], mm="kernel")
    gm = ring_matmul_reducescatter_2d_t(flat(g_sh), flat(xg_sh), mt["rs"],
                                        mt["ag"], mm="matmul")
    assert np.isfinite(to_np(gt)).all()
    np.testing.assert_allclose(to_np(gt), to_np(gm), atol=1e-5)


@pytest.mark.parametrize("d,q", MESHES)
def test_ring_2d_transpose_matches_oracle(rng, d, q):
    """The dw schedule: the gather axis contracted, the scatter axis
    summing the per-data-rank contributions."""
    g_sh, x_sh, want, ml = _xpose_operands(rng, d, q)
    mt = _mesh(d, q, ("rs", "ag"))
    got = unflat(ring_matmul_reducescatter_2d_t(flat(g_sh), flat(x_sh),
                                                mt["rs"], mt["ag"]), d, q)
    ref = np.asarray(jax.vmap(jax.vmap(
        lambda g, b: rcmm.ring_matmul_reducescatter_2d_t(g, b, "rs", "ag"),
        axis_name="ag"), axis_name="rs")(jnp.asarray(g_sh),
                                         jnp.asarray(x_sh)))
    for i in range(d):
        for j in range(q):
            np.testing.assert_allclose(got[i, j], want[i * ml:(i + 1) * ml],
                                       atol=1e-4)
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_registry_impls_semantics(rng):
    """Every registered impl (both directions) against the dense oracle
    and the reference's impl: the streamed operand is the FIRST argument
    of the impl fn."""
    d, q, T, kl, ml = 2, 2, 4, 3, 4
    x_sh, w_sh, X, W = _shard_fwd(rng, d, q, T, kl, ml)
    want = X @ W
    tl = T // q
    m = _mesh(d, q)
    g_sh, xg_sh, wantT, mlT = _xpose_operands(rng, d, q)
    mt = _mesh(d, q, ("rs", "ag"))
    assert list(TC.REGISTRY[OP]) == list(RC.REGISTRY[OP]) == [
        "default", "fused_ring2d"]
    for name in TC.REGISTRY[OP]:
        fn, rfn = TC.REGISTRY[OP][name].fn, RC.REGISTRY[OP][name].fn
        got = unflat(fn(flat(w_sh), m["ag"], x=flat(x_sh), rs_axis=m["rs"]),
                     d, q)
        ref = np.asarray(_vmap2(lambda wb, xb: rfn(wb, "ag", x=xb,
                                                   rs_axis="rs"))(
            jnp.asarray(w_sh), jnp.asarray(x_sh)))
        np.testing.assert_allclose(got, ref, atol=1e-5, err_msg=name)
        for i in range(d):
            for j in range(q):
                np.testing.assert_allclose(got[i, j],
                                           want[j * tl:(j + 1) * tl],
                                           atol=1e-4, err_msg=name)
        got = unflat(fn(flat(g_sh), mt["ag"], x=flat(xg_sh),
                        rs_axis=mt["rs"], xpose=True), d, q)
        for i in range(d):
            for j in range(q):
                np.testing.assert_allclose(got[i, j],
                                           wantT[i * mlT:(i + 1) * mlT],
                                           atol=1e-4, err_msg=name)


# ---------------------------------------------------------------------------
# dist op: the paired backward (sharded cotangent), fused vs default
# ---------------------------------------------------------------------------


def _port_run(fun, x_sh, w_sh, force):
    """``fun(x, w)`` on the data x model mesh and its grads against the
    integer cotangent: ``(y, dx, dw, ctx)`` with ``[d, q, ...]`` arrays."""
    d, q = x_sh.shape[:2]
    m = StackedMesh((d, q), ("data", "model"), "cpu")
    x = flat(x_sh).requires_grad_(True)
    w = flat(w_sh).requires_grad_(True)
    with taxes.bind(data=m["data"], model=m["model"]), \
            tapi.tuned(force=force) as ctx:
        y = fun(x, w)
        cot = torch.from_numpy(_int_cot(tuple(y.shape[1:])))
        (y * cot).sum().backward()
    return (unflat(y, d, q), unflat(x.grad, d, q), unflat(w.grad, d, q),
            ctx)


def _ref_run(fun, x_sh, w_sh, force):
    def inner(a, b):
        y = fun(a, b)
        cot = jnp.asarray(_int_cot(y.shape))
        g = jax.grad(lambda aa, bb: jnp.sum(fun(aa, bb) * cot),
                     argnums=(0, 1))(a, b)
        return y, g
    with rapi.tuned(force=force) as ctx:
        y, g = jax.vmap(jax.vmap(inner, axis_name="model"),
                        axis_name="data")(jnp.asarray(x_sh),
                                          jnp.asarray(w_sh))
    return np.asarray(y), np.asarray(g[0]), np.asarray(g[1]), ctx


def _roles(ctx):
    return {(r.cell.op, r.cell.mm_role, r.phase) for r in ctx.record}


@pytest.mark.parametrize("impl", ["default", "fused_ring2d"])
def test_mm2d_dist_op_grads_fused_vs_default(rng, impl):
    d, q, T, kl, ml = 2, 2, 4, 3, 4
    x_sh, w_sh, X, W = _shard_fwd(rng, d, q, T, kl, ml, integer=True)
    force = {OP: impl, "allgather_matmul":
             "fused_ring" if impl != "default" else "default"}
    port = lambda a, b: tops.matmul_reducescatter_2d(a, b, "model", "data")
    ref = lambda a, b: rops.matmul_reducescatter_2d(a, b, "model", "data")
    yd, xd, wd, _ = _port_run(port, x_sh, w_sh, {})
    yf, xf, wf, ctx = _port_run(port, x_sh, w_sh, force)
    ry, rx, rw, rctx = _ref_run(ref, x_sh, w_sh, force)
    # integer-valued operands: every schedule is bit-exact
    for a, b, c in ((yd, yf, ry), (xd, xf, rx), (wd, wf, rw)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, c)
    assert _roles(ctx) == _roles(rctx)
    recs = _roles(ctx)
    assert (OP, "2d", "fwd") in recs and (OP, "2dT", "bwd") in recs
    assert ("allgather_matmul", "gather", "bwd") in recs
    cell = next(r.cell for r in ctx.record if r.cell.mm_role == "2d")
    assert cell.p == d and cell.p2 == q and cell.world() == d * q
    # the reference traces the forward twice (the value, then inside
    # grad), the port runs it once: the same cells, impls and phases
    assert {(dataclasses.astuple(r.cell), r.impl, r.phase)
            for r in ctx.record} == {
        (dataclasses.astuple(r.cell), r.impl, r.phase) for r in rctx.record}


def test_mm2d_grads_match_unfused_autodiff(rng):
    """The autograd Function against torch's own autograd THROUGH the
    unfused default composition (all-gather + matmul + psum_scatter), and
    against the reference's custom VJP."""
    d, q, T, kl, ml = 2, 3, 6, 2, 3
    x_sh, w_sh, X, W = _shard_fwd(rng, d, q, T, kl, ml)
    fn = TC.REGISTRY[OP]["default"].fn
    m = StackedMesh((d, q), ("data", "model"), "cpu")

    def raw(a, b):
        return fn(b, m["data"], x=a, rs_axis=m["model"])

    op2d = lambda a, b: tops.matmul_reducescatter_2d(a, b, "model", "data")
    _, gx, gw, _ = _port_run(op2d, x_sh, w_sh, {})
    _, rx, rw, _ = _port_run(raw, x_sh, w_sh, {})
    np.testing.assert_allclose(gx, rx, atol=1e-4)
    np.testing.assert_allclose(gw, rw, atol=1e-4)
    _, jx, jw, _ = _ref_run(
        lambda a, b: rops.matmul_reducescatter_2d(a, b, "model", "data"),
        x_sh, w_sh, {})
    np.testing.assert_allclose(gx, jx, atol=1e-4)
    np.testing.assert_allclose(gw, jw, atol=1e-4)


# ---------------------------------------------------------------------------
# the rewired row_matmul(fsdp_dim=1) site
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["default", "fused_ring2d"])
@pytest.mark.parametrize("d,q", MESHES)
def test_row_matmul_fsdp1_bit_exact_vs_legacy(rng, d, q, impl):
    """row_matmul(fsdp_dim=1) through the 2-D op, under default dispatch
    and fused_ring2d, matches the 1-D tp_allreduce(fsdp_matmul(...))
    composition and the reference BIT FOR BIT, forward and grads."""
    T, kl, ml = 2 * q, 3, 4
    x_sh, w_sh, X, W = _shard_fwd(rng, d, q, T, kl, ml, integer=True)
    new = lambda a, b: tops.row_matmul(a, b, "model", fsdp_dim=1)
    leg = lambda a, b: tops.tp_allreduce(tops.fsdp_matmul(a, b, "data"),
                                         "model")
    y0, gx0, gw0, ctx = _port_run(new, x_sh, w_sh, {OP: impl})
    yl, gxl, gwl, _ = _port_run(leg, x_sh, w_sh, {})
    ry, rx, rw, rctx = _ref_run(
        lambda a, b: rops.row_matmul(a, b, "model", fsdp_dim=1), x_sh, w_sh,
        {OP: impl})
    for a, b, c in ((y0, yl, ry), (gx0, gxl, rx), (gw0, gwl, rw)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    np.testing.assert_allclose(y0[0, 0], X @ W, atol=1e-4)
    recs = _roles(ctx)
    assert (OP, "2d", "fwd") in recs and ("allgather", "", "fwd") in recs
    assert (OP, "2dT", "bwd") in recs
    assert recs == _roles(rctx)


def test_row_matmul_fsdp1_records_no_monolithic_allreduce(rng):
    d, q = 2, 2
    x_sh, w_sh, _, _ = _shard_fwd(rng, d, q, 2 * q, 3, 4)
    _, _, _, ctx = _port_run(
        lambda a, b: tops.row_matmul(a, b, "model", fsdp_dim=1), x_sh, w_sh,
        {})
    fwd = [r for r in ctx.record if r.phase == "fwd"]
    assert not any(r.cell.op == "allreduce" for r in fwd)
    assert any(r.cell.op == OP for r in fwd)


def test_row_matmul_fsdp1_nondivisible_rows_falls_back(rng):
    """T=3 rows on a model axis of 2: the site keeps the 1-D composition,
    with the reference's values and records."""
    d, q, T, kl, ml = 2, 2, 3, 3, 4
    X = rng.normal(size=(T, q * kl)).astype(np.float32)
    W = rng.normal(size=(q * kl, d * ml)).astype(np.float32)
    x_sh = np.stack([np.stack([X[:, j * kl:(j + 1) * kl] for j in range(q)])
                     for _ in range(d)])
    w_sh = np.stack([np.stack([W[j * kl:(j + 1) * kl, i * ml:(i + 1) * ml]
                               for j in range(q)]) for i in range(d)])
    m = StackedMesh((d, q), ("data", "model"), "cpu")
    with taxes.bind(data=m["data"], model=m["model"]), tapi.tuned() as ctx:
        y = tops.row_matmul(flat(x_sh), flat(w_sh), "model", fsdp_dim=1)
    np.testing.assert_allclose(unflat(y, d, q)[0, 0], X @ W, atol=1e-4)
    assert not any(r.cell.op == OP for r in ctx.record)
    assert any(r.cell.op == "allreduce" for r in ctx.record)


def test_mm2d_no_axis_degrades(rng):
    x = torch.from_numpy(rng.normal(size=(1, 4, 6)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(1, 6, 3)).astype(np.float32))
    np.testing.assert_array_equal(
        to_np(tops.matmul_reducescatter_2d(x, w)), to_np(torch.matmul(x, w)))
    # only the rs axis bound: the 1-D matmul_reducescatter
    with taxes.bind(model=StackedAxis(2, "cpu")):
        got = tops.matmul_reducescatter_2d(x.expand(2, 4, 6), w[0], "model",
                                           "data")
    assert tuple(got.shape) == (2, 2, 3)
    # only the ag axis bound: fsdp_matmul
    with taxes.bind(data=StackedAxis(2, "cpu")):
        got = tops.matmul_reducescatter_2d(x.expand(2, 4, 6),
                                           w.expand(2, 6, 3), "model",
                                           "data")
    assert tuple(got.shape) == (2, 4, 6)


def test_mm2d_standalone_ragged_rows_clear_error(rng):
    d, q = 2, 2
    x = torch.from_numpy(rng.normal(size=(d * q, 3, 4)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(d * q, 4, 2)).astype(np.float32))
    m = StackedMesh((d, q), ("data", "model"), "cpu")
    with taxes.bind(data=m["data"], model=m["model"]):
        with pytest.raises(ValueError, match="row_matmul"):
            tops.matmul_reducescatter_2d(x, w, "model", "data")


# ---------------------------------------------------------------------------
# tuner, prices and profiles: equal to the reference's
# ---------------------------------------------------------------------------


def _rcell(c):
    return rcell.OpCell(*dataclasses.astuple(c))


BIG = OpCell(OP, 8, 4_194_304, "float32", mm_k=1024, mm_m=8192,
             mm_n=8 * 1024, mm_role="2d", p2=8)
SLIVER = OpCell(OP, 8, 4096, "float32", mm_k=16, mm_m=8, mm_n=8 * 8,
                mm_role="2d", p2=8)


def test_tuner_selects_fused2d_large_default_small():
    sizes = (64, 1024, 1_048_576, 16_777_216)
    rep = ttuner.tune(ops=[OP], sizes=sizes, axis_size=8,
                      backend=ttuner.CostModelBackend(tcm.V5E_ICI))
    rrep = rtuner.tune(ops=[OP], sizes=sizes, axis_size=8,
                       backend=rtuner.CostModelBackend(rcm.V5E_ICI))
    assert rep.profiles.lookup(OP, 8, 16_777_216) == "fused_ring2d"
    assert rep.profiles.lookup(OP, 8, 64) is None
    assert [p.to_text() for p in rep.profiles] == [
        p.to_text() for p in rrep.profiles]


def _close(a, b):
    return a == b or abs(a - b) <= 1e-12 * max(abs(a), abs(b))


MT = (tcm.MeshTopo.of(data=tcm.V5E_DCN, model=tcm.V5E_ICI),
      rcm.MeshTopo.of(data=rcm.V5E_DCN, model=rcm.V5E_ICI))


@pytest.mark.parametrize("tier", ["", "v5e-dcn/v5e-ici", "v5e-ici/v5e-dcn"])
def test_latency_cell_prices_nested_overlap(tier):
    """The nested law: a compute-heavy 2-D cell flips to fused_ring2d, a
    sliver keeps the default; every price of both roles, flat and tiered,
    equals the reference's."""
    assert tcm.latency_cell(BIG, "fused_ring2d", tcm.V5E_ICI) < \
        tcm.latency_cell(BIG, "default", tcm.V5E_ICI) * 0.9
    assert not (tcm.latency_cell(SLIVER, "fused_ring2d", tcm.V5E_ICI)
                < tcm.latency_cell(SLIVER, "default", tcm.V5E_ICI) * 0.9)
    for c in (BIG, SLIVER):
        for role in ("2d", "2dT"):
            cc = dataclasses.replace(c, mm_role=role, tier=tier)
            for nm in TC.REGISTRY[OP]:
                for tt, rt in ((tcm.V5E_ICI, rcm.V5E_ICI), MT):
                    a = tcm.latency_cell(cc, nm, tt)
                    b = rcm.latency_cell(_rcell(cc), nm, rt)
                    assert _close(a, b), (cc, nm, a, b)
    for nb in (1, 4096, 1 << 20):
        for nm in TC.REGISTRY[OP]:
            assert _close(tcm.latency(OP, nm, 8, nb, tcm.V5E_ICI),
                          rcm.latency(OP, nm, 8, nb, rcm.V5E_ICI))


def test_tune_trace_emits_2d_geometry_profiles():
    t = Trace([TraceEntry(BIG, "fwd", "default", 10),
               TraceEntry(SLIVER, "fwd", "default", 10)])
    rep = ttuner.tune_trace(t, backend=ttuner.CostModelBackend(tcm.V5E_ICI))
    store = rep.phase_profiles["fwd"]
    assert store.lookup_cell(BIG) == "fused_ring2d"
    assert store.get(OP, 8, SLIVER.geom()) is None
    assert store.get(OP, 8, BIG.geom()) is not None
    near = dataclasses.replace(BIG, mm_m=16384)
    assert store.lookup_cell(near) == "fused_ring2d"
    assert store.lookup_cell(dataclasses.replace(BIG, p2=4)) is None
    assert rep.est_tuned_s["fwd"] < rep.est_default_s["fwd"]
    rt = rtrace.Trace([rtrace.TraceEntry(_rcell(BIG), "fwd", "default", 10),
                       rtrace.TraceEntry(_rcell(SLIVER), "fwd", "default",
                                         10)])
    rrep = rtuner.tune_trace(rt,
                             backend=rtuner.CostModelBackend(rcm.V5E_ICI))
    assert [p.to_text() for p in store] == [
        p.to_text() for p in rrep.phase_profiles["fwd"]]


def test_measured_backend_skips_2d_world_mismatch():
    """A 2-D cell whose world p*p2 is not the bench's lane count is
    note-skipped, not crashed on; at a matching world (or with
    ``p=None``, any world) it is replayed on a stacked mesh."""
    cell = dataclasses.replace(SLIVER, mm_k=8, mm_n=16)
    assert cell.world() == 64
    t = Trace([TraceEntry(cell, "fwd", "default", 1)])
    rep = ttuner.tune_trace(t, backend=ttuner.MeasuredBackend(
        8, "cpu", K=2, max_nrep=3))
    assert any("world=64" in n for n in rep.notes)
    assert rep.measurements == []
    small = OpCell(OP, 2, 8 * 2 * 4, "float32", mm_k=8, mm_m=8, mm_n=4,
                   mm_role="2d", p2=2)
    rep = ttuner.tune_trace(Trace([TraceEntry(small, "fwd", "default", 1)]),
                            backend=ttuner.MeasuredBackend(
                                None, "cpu", K=2, max_nrep=3))
    assert {m.impl for m in rep.measurements} == {"default", "fused_ring2d"}


@pytest.mark.parametrize("role", ["2d", "2dT"])
def test_measured_replay_shapes_equal_the_reference(role):
    from repro.core import measure as rmeasure
    for c in (BIG, SLIVER):
        cc = dataclasses.replace(c, mm_role=role)
        assert tmeasure.problem_shapes(cc) == rmeasure.problem_shapes(
            _rcell(cc))
    cc = OpCell(OP, 2, 4 * 3 * 4, "float32", mm_k=4, mm_m=4, mm_n=6,
                mm_role=role, p2=2)
    bench = tmeasure.Bench(4, "cpu")
    for nm in TC.REGISTRY[OP]:
        assert len(bench.sample_latency(cc, nm, 2)) == 2


def test_dispatch_profile_routes_2d_cell(rng):
    d, q, T, kl, ml = 2, 2, 4, 3, 4
    x_sh, w_sh, _, _ = _shard_fwd(rng, d, q, T, kl, ml)
    geom = OpCell(OP, d, kl * ml * 4, "float32", mm_k=kl, mm_m=T,
                  mm_n=d * ml, mm_role="2d", p2=q).geom()
    store = ProfileStore([Profile(op=OP, axis_size=d,
                                  ranges=[Range(1, 10 ** 6, "fused_ring2d")],
                                  geom=geom)])
    m = _mesh(d, q)
    with tapi.tuned(profiles=store) as ctx:
        tapi.matmul_reducescatter_2d(flat(x_sh), flat(w_sh), m["rs"],
                                     m["ag"])
    assert [r.impl for r in ctx.record] == ["fused_ring2d"]
    assert ctx.record[0].cell.geom() == geom
    rstore = RStore([RProfile(op=OP, axis_size=d,
                              ranges=[RRange(1, 10 ** 6, "fused_ring2d")],
                              geom=rcell.Geom(*dataclasses.astuple(geom)))])
    with rapi.tuned(profiles=rstore) as rctx:
        _vmap2(lambda a, b: rapi.matmul_reducescatter_2d(a, b, "rs", "ag"))(
            jnp.asarray(x_sh), jnp.asarray(w_sh))
    assert dataclasses.astuple(rctx.record[0].cell) == dataclasses.astuple(
        ctx.record[0].cell)
