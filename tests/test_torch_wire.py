"""The quantized-wire impls (``wire_q8`` / ``wire_fp8`` on six ops) of the
port against the reference, and the tolerance gate that demotes them.

Operands are made from a numpy seed and go through the reference's
per-shard function under ``jax.vmap`` and through the port's impl on a
stacked CPU axis.  Tolerances, per impl:

* ``allgather``, ``reducescatter``, ``allreduce`` and
  ``matmul_reducescatter`` on the wire: bit-equal.  The quantization is
  bit-equal (``test_torch_quant.py``), every sum is a float32 addition in
  the same ring order, and the operands are small integers, so the
  reduce-scatter ring's per-step products are exact before they are
  requantized.
* ``allgather_matmul`` and ``matmul_accumulate`` on the wire multiply a
  DEQUANTIZED operand, whose values are no longer integers, so the two
  packages' matmuls round in another order.  A dot product of K terms
  errs by at most ``K * 2**-24 * sum|a_i b_i|`` in float32, so two orders
  differ by at most twice that: the bound is ``2 * (K + p) * 2**-24 *
  max(|x| @ |w|)`` (K products, p partial sums), plus one bfloat16 step
  (``2**-8`` of the output, each side) for a bfloat16 output.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from test_torch_ref import RC, TC, StackedAxis, ref_vmap, to_np

from repro.core import api as rapi
from repro.core import cell as rcell
from repro.core import costmodel as rcm
from repro.core import profiles as rprof
from repro.core import selfcheck as rsc
from repro_torch.core import api as tapi
from repro_torch.core import cell as tcell
from repro_torch.core import costmodel as tcm
from repro_torch.core import profiles as tprof
from repro_torch.core import selfcheck as tsc
from repro_torch.core import trace as ttrace
from repro_torch.core import tuner as ttuner
from repro_torch.kernels.quant import wire_tol

WIRE_OPS = ("allgather", "reducescatter", "allreduce", "allgather_matmul",
            "matmul_reducescatter", "matmul_accumulate")
WIRES = ("wire_q8", "wire_fp8")
EXACT = ("allgather", "reducescatter", "allreduce", "matmul_reducescatter")
U32 = 2.0 ** -24


@pytest.fixture(autouse=True)
def _clean_ledgers():
    TC.clear_demotions()
    RC.clear_demotions()
    yield
    TC.clear_demotions()
    RC.clear_demotions()


def _np_dtype(dtype):
    return ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32


def _t(a) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _operands(op, p, dtype, seed):
    """``(payload, second operand or None, kwarg name)`` per rank layout,
    small integers in the payload dtype."""
    rng = np.random.default_rng(seed)
    dt = _np_dtype(dtype)

    def ints(*shape, lo=-8):
        return rng.integers(lo, -lo + 1, size=shape).astype(np.float32
                                                            ).astype(dt)
    if op == "allgather":
        return ints(p, 11, 3), None, None
    if op == "allreduce":
        return ints(p, 13, 3), None, None
    if op == "reducescatter":
        return ints(p, p * 9, 3), None, None
    if op == "allgather_matmul":
        return ints(p, 11, 6), ints(6, 5, lo=-4), "w"
    if op == "matmul_reducescatter":
        return ints(p, p * 9, 6), ints(6, 5, lo=-4), "w"
    return ints(p, 9, 5), ints(7, p * 9, lo=-4), "x"   # w blocks, x [T, K]


def _both(op, nm, p, dtype, seed=0):
    x, second, kw = _operands(op, p, dtype, seed)
    ref_fn, port_fn = RC.REGISTRY[op][nm].fn, TC.REGISTRY[op][nm].fn
    axis = StackedAxis(p, device="cpu")
    if kw is None:
        ref = ref_vmap(ref_fn, jnp.asarray(x))
        got = port_fn(_t(x), axis)
    else:
        ref = ref_vmap(ref_fn, jnp.asarray(x), **{kw: jnp.asarray(second)})
        got = port_fn(_t(x), axis, **{kw: _t(second)})
    return x, second, np.asarray(ref, np.float64), to_np(got).astype(
        np.float64), got


def _dot_bound(op, x, second, p):
    """``max(|a| @ |b|)`` and the contraction length of the op's product."""
    xa = np.abs(np.asarray(x, np.float64))
    sa = np.abs(np.asarray(second, np.float64))
    if op == "allgather_matmul":
        return float((xa.reshape(-1, xa.shape[-1]) @ sa).max()), sa.shape[0]
    return float((sa @ xa.reshape(-1, xa.shape[-1])).max()), sa.shape[1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [2, 3, 4, 8])
@pytest.mark.parametrize("nm", WIRES)
@pytest.mark.parametrize("op", WIRE_OPS)
def test_wire_impl_matches_reference(op, nm, p, dtype):
    x, second, ref, got, gt = _both(op, nm, p, dtype, seed=p)
    assert gt.dtype == _t(x).dtype and got.shape == ref.shape
    if op in EXACT:
        np.testing.assert_array_equal(got, ref)
        return
    dots, k = _dot_bound(op, x, second, p)
    tol = 2 * (k + p) * U32 * dots
    if dtype == "bfloat16":
        tol += 2 * 2.0 ** -8 * float(np.abs(ref).max())
    assert float(np.abs(got - ref).max()) <= tol


@pytest.mark.parametrize("nm", WIRES)
@pytest.mark.parametrize("op", ["allgather_matmul", "matmul_accumulate"])
@pytest.mark.parametrize("p", [3, 8])
def test_wire_gathered_operand_matches_reference(op, nm, p):
    """``return_gathered``: the wire-approximate gathered operand, own
    block exact, is a gather of dequantized values: bit-equal."""
    x, second, kw = _operands(op, p, "float32", 40 + p)
    ref_fn, port_fn = RC.REGISTRY[op][nm].fn, TC.REGISTRY[op][nm].fn
    _, rg = jax.vmap(lambda a: ref_fn(a, "x", return_gathered=True,
                                      **{kw: jnp.asarray(second)}),
                     axis_name="x")(jnp.asarray(x))
    _, tg = port_fn(_t(x), StackedAxis(p, device="cpu"),
                    return_gathered=True, **{kw: _t(second)})
    np.testing.assert_array_equal(to_np(tg), np.asarray(rg))
    for r in range(p):      # each rank's own block never crossed the wire
        n = x.shape[1]
        np.testing.assert_array_equal(to_np(tg)[r, r * n:(r + 1) * n], x[r])


@pytest.mark.parametrize("nm", WIRES)
@pytest.mark.parametrize("op", WIRE_OPS)
def test_wire_impl_is_identity_at_p1(op, nm):
    x, second, ref, got, _ = _both(op, nm, 1, "float32")
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("op", ["allgather", "reducescatter"])
def test_fp8_payloads_travel_as_bytes(op):
    """The e4m3 values cross ``pshift`` as uint8 views; the result holds
    at p = 3 and 8 whatever the CPU's float8 index kernels support."""
    for p in (3, 8):
        _, _, ref, got, _ = _both(op, "wire_fp8", p, "float32", seed=9)
        np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# the tolerance gate (the reference's tests/test_wire_quant.py, on the
# stacked axis)
# ---------------------------------------------------------------------------

P = 4


def _cancellation_payload(p=P, n=16, d=4, scale=1e3):
    """Shards of magnitude ``scale`` that sum to O(1): every wire hop
    quantizes O(scale) values, so the error dwarfs the true result."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(p, n, d)).astype(np.float32)
    x[0] += scale
    x[1] -= scale
    return x


@pytest.mark.parametrize("name", WIRES)
def test_gate_demotes_wire_on_cancellation(name):
    x = _cancellation_payload()
    ok, rel, tol = tsc.run_gate("allreduce", name, x, device="cpu")
    rok, rrel, rtol = rsc.run_gate("allreduce", name, x)
    assert not ok and rel > tol and (ok, tol) == (rok, rtol)
    assert abs(rel - rrel) <= 1e-6 * rrel
    assert TC.is_demoted("allreduce", name)
    assert ("allreduce", name) in TC.demotions()


def test_gate_passes_wire_on_benign_payload():
    x = np.random.default_rng(3).normal(size=(P, 16, 4)).astype(np.float32)
    for op in ("allgather", "reducescatter", "allreduce"):
        xs = x if op != "reducescatter" else np.tile(x, (1, P, 1))
        for nm in WIRES:
            ok, rel, tol = tsc.run_gate(op, nm, xs, device="cpu")
            assert ok and rel <= tol == wire_tol(
                TC.REGISTRY[op][nm].wire_dtype, tsc.wire_hops(op, P))
            assert rel == pytest.approx(rsc.run_gate(op, nm, xs)[1],
                                        rel=1e-6)
    assert not TC.demotions()


def test_gate_demote_false_only_reports():
    ok, _, _ = tsc.run_gate("allreduce", "wire_q8", _cancellation_payload(),
                            demote=False, device="cpu")
    assert not ok and not TC.is_demoted("allreduce", "wire_q8")


def test_gate_defaults_to_the_gpu_and_raises_without_one(monkeypatch):
    """A host payload does not make the gate run on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.random.default_rng(3).normal(size=(P, 16, 4)).astype(np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsc.run_gate("allreduce", "wire_q8", x)
    assert not TC.demotions()


def test_gate_holds_non_wire_impls_to_1e5_and_never_demotes():
    x = _cancellation_payload()
    ok, rel, tol = tsc.run_gate("allreduce", "allreduce_as_rsb_allgather",
                                x, device="cpu")
    assert ok and tol == 1e-5 and not TC.demotions()


def test_default_impl_cannot_be_demoted():
    with pytest.raises(ValueError):
        TC.demote("allreduce", "default")
    with pytest.raises(KeyError):
        TC.demote("allreduce", "no_such_impl")


def test_demoted_impl_falls_back_to_default_in_dispatch():
    TC.demote("allreduce", "wire_q8", "tolerance")
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(P, 8, 4)).astype(np.float32))
    axis = StackedAxis(P, device="cpu")
    with tapi.tuned(force={"allreduce": "wire_q8"}) as ctx:
        got = tapi.allreduce(x, axis)
        fp8 = tapi.allreduce(x, axis, impl="wire_fp8")   # not demoted
    np.testing.assert_allclose(to_np(got), np.broadcast_to(
        x.numpy().sum(0), x.shape), atol=1e-5)
    assert [r.impl for r in ctx.record] == ["default", "wire_fp8"]
    assert not torch.equal(fp8, got)


DCN_LIKE = tcm.Topo("dcn-like", alpha=10.0e-6, link_bw=12.5e9,
                    gamma=2.5e-12, quant_bw=819e9)   # the reference's V5E_DCN


def test_tuner_never_selects_demoted_wire_impls():
    """On a link-bound cell the wire family wins by construction; after
    demoting both, neither tune_trace nor tune offers them."""
    t = ttrace.Trace([ttrace.TraceEntry(tcell.OpCell("allreduce", 8,
                                                     4 << 20))])
    backend = ttuner.CostModelBackend(DCN_LIKE)
    sel = ttuner.tune_trace(t, backend).phase_profiles["fwd"].lookup(
        "allreduce", 8, 4 << 20)
    assert sel in WIRES
    TC.demote("allreduce", "wire_q8", "tolerance")
    TC.demote("allreduce", "wire_fp8", "tolerance")
    rep = ttuner.tune_trace(t, backend)
    store = rep.phase_profiles.get("fwd")
    assert (store.lookup("allreduce", 8, 4 << 20) if store else None) \
        not in WIRES
    assert not {m.impl for m in rep.measurements} & set(WIRES)
    flat = ttuner.tune(["allreduce"], (4 << 20,), axis_size=8,
                       backend=backend)
    assert not {m.impl for m in flat.measurements} & set(WIRES)


def test_wire_hops_counts_as_the_reference():
    for op in WIRE_OPS:
        for p in (1, 2, 3, 4, 8, 16):
            assert tsc.wire_hops(op, p) == rsc.wire_hops(op, p), (op, p)
    assert tsc.wire_hops("allgather", 8) == 1
    assert tsc.wire_hops("matmul_accumulate", 8) == 7
    assert tsc.wire_hops("allreduce", 8) == 8
    assert tsc.rel_err([1.0, 2.0], [1.0, 4.0]) == rsc.rel_err(
        [1.0, 2.0], [1.0, 4.0]) == 0.5


PA, K_LOC, M_A, T_A = 8, 8, 16, 4


def _accumulate_payload(gamma, seed=11, p=PA):
    """Weight K-blocks ``[p, k_loc, m]`` near-constant per column with
    sub-step dither, and a stationary x ``[T, K]`` whose row sums are
    scaled by ``gamma``: the true output shrinks with gamma while the p-1
    blocks' errors add up (the reference's payload)."""
    rng = np.random.default_rng(seed)
    K = p * K_LOC
    c = rng.uniform(1.0, 2.0, size=(1, M_A))
    dither = rng.uniform(-0.004, 0.004, size=(K, M_A))
    wblocks = (np.broadcast_to(c, (K, M_A)) + dither).astype(
        np.float32).reshape(p, K_LOC, M_A)
    z = rng.normal(size=(T_A, K))
    xstat = (z - (1.0 - gamma) * z.mean(axis=1, keepdims=True)).astype(
        np.float32)
    return wblocks, xstat


def test_accumulate_error_adding_payload_needs_p_minus_1_events():
    wb, xs = _accumulate_payload(gamma=0.1)
    ok, rel, tol = tsc.run_gate("matmul_accumulate", "wire_q8", wb, w=xs,
                                device="cpu")
    assert rel > wire_tol("int8", 1)
    assert ok and rel <= tol == wire_tol("int8", PA - 1)
    assert rel == pytest.approx(rsc.run_gate("matmul_accumulate", "wire_q8",
                                             wb, w=xs)[1], rel=1e-4)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("name", WIRES)
def test_accumulate_benign_payloads_never_demote(name, seed):
    rng = np.random.default_rng(seed)
    wb = rng.normal(size=(PA, K_LOC, M_A)).astype(np.float32)
    xs = rng.normal(size=(T_A, PA * K_LOC)).astype(np.float32)
    ok, rel, tol = tsc.run_gate("matmul_accumulate", name, wb, w=xs,
                                device="cpu")
    assert ok and rel <= tol and not TC.demotions()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("name", WIRES)
def test_accumulate_adversarial_cancellation_always_fires(name, seed):
    wb, xs = _accumulate_payload(gamma=0.0, seed=seed)
    ok, rel, tol = tsc.run_gate("matmul_accumulate", name, wb, w=xs,
                                device="cpu")
    assert not ok and rel > tol
    assert TC.is_demoted("matmul_accumulate", name)


def test_selfcheck_reports_demotions_apart_from_failures(monkeypatch):
    """A wire impl that breaks its bound in ``run()`` is demoted and
    listed under "demoted", not under "failures"."""
    orig = TC.REGISTRY["allgather"]["wire_q8"]
    broken = dataclasses.replace(
        orig, fn=lambda x, axis, **kw: orig.fn(x, axis, **kw) * 1.5)
    monkeypatch.setitem(TC.REGISTRY["allgather"], "wire_q8", broken)
    rep = tsc.run(4, "cpu")
    assert rep["failures"] == [] and rep["demoted"] == ["allgather/wire_q8"]
    assert TC.is_demoted("allgather", "wire_q8")
    assert rep["total"] == 59


# ---------------------------------------------------------------------------
# cost model: the wire rows and latency_cell's wire branches
# ---------------------------------------------------------------------------


def _close(a, b):
    return abs(a - b) <= 1e-12 * max(abs(a), abs(b), 1e-300)


@pytest.mark.parametrize("op", WIRE_OPS)
def test_wire_latency_rows_match_reference(op):
    for nm in WIRES + ("default",) + (("fused_ring",) if op in TC.FUSED_OPS
                                      else ()):
        for p in (1, 2, 3, 8, 64):
            for nb in (1, 100, 4096, 1 << 20, 1 << 24):
                a = tcm.latency(op, nm, p, nb, tcm.V5E_ICI)
                b = rcm.latency(op, nm, p, nb, rcm.V5E_ICI)
                assert _close(a, b), (op, nm, p, nb, a, b)


FUSED_CELLS = [
    tcell.OpCell("allgather_matmul", 8, 3 << 20, "bfloat16", 3072, 4096,
                 2048, "gather"),
    tcell.OpCell("matmul_reducescatter", 8, 8 << 20, "bfloat16", 1024,
                 4096, 3072, "scatter"),
    tcell.OpCell("matmul_reducescatter", 6, 5 << 20, "float32", 640, 4096,
                 3072, "scatter"),
    tcell.OpCell("matmul_accumulate", 8, 384 * 1024 * 2, "bfloat16", 3072,
                 4096, 1024, "contract"),
    tcell.OpCell("matmul_accumulate", 3, 4 * 5 * 4, "float32", 12, 7, 5,
                 "contract"),
    tcell.OpCell("matmul_accumulate", 1, 64, "float32", 4, 4, 4,
                 "contract"),
]


@pytest.mark.parametrize("c", FUSED_CELLS, ids=str)
def test_latency_cell_wire_and_contract_branches_match_reference(c):
    r = rcell.OpCell(*dataclasses.astuple(c))
    sw = tcm.sweep_cell(c, tcm.V5E_ICI)
    assert set(sw) == set(TC.REGISTRY[c.op])
    for nm, v in sw.items():
        assert _close(v, rcm.latency_cell(r, nm, rcm.V5E_ICI)), (nm, v)


def test_card_topo_carries_no_tpu_rate():
    assert tcm.Topo("t", 1e-6, 1e9, 0.0).quant_bw is None
    fitted = tcm.fit_topo(8, [(1, 1e-5), (1 << 20, 1e-4)])
    assert fitted.quant_bw is None
    with pytest.raises(ValueError, match="quant_bw"):
        tcm.latency("allgather", "wire_q8", 8, 4096, fitted)
    assert tcm.latency("allgather", "default", 8, 4096, fitted) > 0
    measured = dataclasses.replace(fitted, quant_bw=2.0e12)
    assert tcm.t_quant(1e6, measured) == 2 * 1e6 / 2.0e12
    assert tcm.V5E_ICI.quant_bw == rcm.V5E_ICI.quant_bw == 819e9
    for wd in ("int8", "float8_e4m3fn"):
        for it in (1, 2, 4):
            assert tcm.wire_bytes(1000.0, it, wd) == rcm.wire_bytes(
                1000.0, it, wd)
    assert tcm.SCALE_FRAC == rcm.SCALE_FRAC


# ---------------------------------------------------------------------------
# profiles naming a wire impl, across the two packages
# ---------------------------------------------------------------------------


def _wire_profiles(mod, cellmod):
    R = mod.Range
    g = cellmod.Geom("float32", 12, 7, 5, "contract")
    return [
        mod.Profile("allreduce", 4, [R(1, 1 << 20, "wire_q8")]),
        mod.Profile("allgather", 4, [R(1, 1 << 20, "wire_fp8")]),
        mod.Profile("matmul_accumulate", 4, [R(1, 1 << 20, "wire_q8")],
                    geom=g),
    ]


def _dispatch_port(store):
    rng = np.random.default_rng(5)
    axis = StackedAxis(4, device="cpu")
    x = torch.from_numpy(rng.normal(size=(4, 6, 3)).astype(np.float32))
    wb = torch.from_numpy(rng.normal(size=(4, 3, 5)).astype(np.float32))
    xs = torch.from_numpy(rng.normal(size=(7, 12)).astype(np.float32))
    with tapi.tuned(profiles=store) as ctx:
        outs = (tapi.allreduce(x, axis), tapi.allgather(x, axis),
                tapi.matmul_accumulate(xs, wb, axis))
    want = (TC.REGISTRY["allreduce"]["wire_q8"].fn(x, axis),
            TC.REGISTRY["allgather"]["wire_fp8"].fn(x, axis),
            TC.REGISTRY["matmul_accumulate"]["wire_q8"].fn(wb, axis, x=xs))
    for a, b in zip(outs, want):
        assert torch.equal(a, b)
    return [r.impl for r in ctx.record], tapi.format_footer(ctx)


@pytest.mark.parametrize("fmt", ["text", "json"])
def test_wire_profile_written_by_the_reference_routes_the_port(tmp_path,
                                                              fmt):
    rprof.ProfileStore(_wire_profiles(rprof, rcell)).save(tmp_path, fmt=fmt)
    store = tprof.ProfileStore.load(tmp_path)
    impls, footer = _dispatch_port(store)
    assert impls == ["wire_q8", "wire_fp8", "wire_q8"]
    assert "MPIX_Matmul_accumulate 60 wire_q8" in footer


@pytest.mark.parametrize("fmt", ["text", "json"])
def test_wire_profile_written_by_the_port_routes_the_reference(tmp_path,
                                                              fmt):
    store = tprof.ProfileStore(_wire_profiles(tprof, tcell))
    store.save(tmp_path, fmt=fmt)
    for a, b in zip(_wire_profiles(tprof, tcell),
                    _wire_profiles(rprof, rcell)):
        assert a.to_text() == b.to_text() and a.to_json() == b.to_json()
    ref = rprof.ProfileStore.load(tmp_path)
    x = jnp.asarray(np.random.default_rng(5).normal(size=(4, 6, 3)),
                    jnp.float32)
    with rapi.tuned(profiles=ref) as ctx:
        jax.vmap(lambda a: (rapi.allreduce(a, "x"), rapi.allgather(a, "x")),
                 axis_name="x")(x)
    assert [r.impl for r in ctx.record] == ["wire_q8", "wire_fp8"]
    cell = tcell.OpCell("matmul_accumulate", 4, 60, "float32", 12, 7, 5,
                        "contract")
    assert ref.lookup_cell(rcell.OpCell(*dataclasses.astuple(cell))) == \
        store.lookup_cell(cell) == "wire_q8"
    assert _dispatch_port(tprof.ProfileStore.load(tmp_path))[0] == [
        "wire_q8", "wire_fp8", "wire_q8"]

