"""``matmul_accumulate`` (the contraction-dim collective matmul) in the
port against the reference: its impls under ``vmap``, the ring's kernel
tier, the dispatcher's ``contract`` cell, the replay shapes, the cost
model and a measured replay on the CPU.

Operands are made from a numpy seed.  Tolerances: float32 inputs hold
small integers, so every product and sum is exact in any order (0).  In
bfloat16 the ring adds its p partial products in bfloat16, as the
reference does, where the default rounds once: each partial sum may round
by one bfloat16 step, so the bound is ``p * 2**-8 * max|ref|``.
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
from repro.core import measure as rmeasure
from repro.core import trace as rtrace
from repro.kernels import collective_matmul as rcmm
from repro_torch.core import api as tapi
from repro_torch.core import cell as tcell
from repro_torch.core import costmodel as tcm
from repro_torch.core import measure as tmeasure
from repro_torch.core import trace as ttrace
from repro_torch.core import tuner as ttuner
from repro_torch.kernels import collective_matmul as tcmm

IMPLS = ("default", "fused_ring")


def _ints(rng, shape, lo, dtype=np.float32):
    return rng.integers(lo, -lo + 1, size=shape).astype(np.float32).astype(
        dtype)


def _t(a) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _ref(nm, wb, xs, per_rank_x, return_gathered=False):
    fn = RC.REGISTRY["matmul_accumulate"][nm].fn
    if per_rank_x:
        return jax.vmap(lambda w, x: fn(w, "x", x=x,
                                        return_gathered=return_gathered),
                        axis_name="x")(jnp.asarray(wb), jnp.asarray(xs))
    xj = jnp.asarray(xs)
    return jax.vmap(lambda w: fn(w, "x", x=xj,
                                 return_gathered=return_gathered),
                    axis_name="x")(jnp.asarray(wb))


@pytest.mark.parametrize("nm", IMPLS)
@pytest.mark.parametrize("p", [2, 3, 4, 8])
@pytest.mark.parametrize("per_rank_x", [False, True])
@pytest.mark.parametrize("return_gathered", [False, True])
def test_matmul_accumulate_matches_reference_exactly(nm, p, per_rank_x,
                                                     return_gathered):
    rng = np.random.default_rng(10 + p)
    k_loc, m, t = 3, 5, 7
    wb = _ints(rng, (p, k_loc, m), -4)
    xs = _ints(rng, ((p,) if per_rank_x else ()) + (t, p * k_loc), -8)
    ref = _ref(nm, wb, xs, per_rank_x, return_gathered)
    got = TC.REGISTRY["matmul_accumulate"][nm].fn(
        _t(wb), StackedAxis(p, device="cpu"), x=_t(xs),
        return_gathered=return_gathered)
    if return_gathered:
        (ref, ref_g), (got, got_g) = ref, got
        np.testing.assert_array_equal(to_np(got_g), np.asarray(ref_g))
        np.testing.assert_array_equal(
            to_np(got_g), np.broadcast_to(wb.reshape(p * k_loc, m),
                                          (p, p * k_loc, m)))
    np.testing.assert_array_equal(to_np(got), np.asarray(ref))
    full = wb.reshape(p * k_loc, m)
    want = np.stack([(xs[r] if per_rank_x else xs) @ full for r in range(p)])
    np.testing.assert_array_equal(to_np(got), want)


@pytest.mark.parametrize("nm", IMPLS)
@pytest.mark.parametrize("p", [2, 3, 4, 8])
def test_matmul_accumulate_bfloat16_within_one_step_per_partial_sum(nm, p):
    rng = np.random.default_rng(50 + p)
    wb = (rng.normal(size=(p, 4, 8)) / 2).astype(ml_dtypes.bfloat16)
    xs = rng.normal(size=(6, p * 4)).astype(ml_dtypes.bfloat16)
    ref = np.asarray(_ref(nm, wb, xs, False), np.float32)
    got = TC.REGISTRY["matmul_accumulate"][nm].fn(
        _t(wb), StackedAxis(p, device="cpu"), x=_t(xs))
    assert got.dtype == torch.bfloat16
    err = float(np.abs(to_np(got) - ref).max())
    assert err <= p * 2.0 ** -8 * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("p", [1, 4])
def test_ring_matmul_accumulate_kernel_mm_matches_reference_pallas(p):
    """The ring with ``mm="kernel"`` (the block-matmul plain version on the
    CPU) against the reference's ``"pallas"`` in interpret mode; integer
    operands, so exact."""
    rng = np.random.default_rng(70 + p)
    wb = _ints(rng, (p, 8, 6), -4)
    xs = _ints(rng, (4, p * 8), -4)
    xj = jnp.asarray(xs)
    ref = ref_vmap(lambda w, ax: rcmm.ring_matmul_accumulate(
        xj, w, ax, mm="pallas"), wb)
    got = tcmm.ring_matmul_accumulate(_t(xs), _t(wb),
                                      StackedAxis(p, device="cpu"),
                                      mm="kernel")
    np.testing.assert_array_equal(to_np(got), ref)


def test_ring_refuses_a_non_contracting_x():
    with pytest.raises(ValueError, match="does not contract"):
        tcmm.ring_matmul_accumulate(torch.ones(4, 7), torch.ones(3, 2, 5),
                                    StackedAxis(3, device="cpu"))


# ---------------------------------------------------------------------------
# the dispatcher's contract cell, the trace, the replay shapes
# ---------------------------------------------------------------------------


def _dispatch_both(dtype=np.float32):
    p, k_loc, m, t = 4, 6, 5, 9
    rng = np.random.default_rng(3)
    wb = _ints(rng, (p, k_loc, m), -4, dtype)
    xs = _ints(rng, (t, p * k_loc), -4, dtype)
    with tapi.tuned() as tctx:
        got = tapi.matmul_accumulate(_t(xs), _t(wb),
                                     StackedAxis(p, device="cpu"))
    xj = jnp.asarray(xs)
    with rapi.tuned() as rctx:
        ref = jax.vmap(lambda w: rapi.matmul_accumulate(xj, w, "x"),
                       axis_name="x")(jnp.asarray(wb))
    return got, ref, tctx, rctx


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_dispatch_records_the_reference_contract_cell(dtype):
    got, ref, tctx, rctx = _dispatch_both(dtype)
    np.testing.assert_array_equal(to_np(got), np.asarray(ref, np.float32))
    (tr,), (rr,) = tctx.record, rctx.record
    assert dataclasses.astuple(tr.cell) == dataclasses.astuple(rr.cell)
    assert tr.cell.mm_role == "contract" and tr.cell.mm_k == 24
    assert (tr.cell.mm_m, tr.cell.mm_n) == (9, 5)
    ttr, rtr = ttrace.Trace.from_context(tctx), rtrace.Trace.from_context(
        rctx)
    assert ttr.to_jsonl() == rtr.to_jsonl()
    assert tapi.format_footer(tctx) == rapi.format_footer(rctx)


def test_dispatch_with_per_rank_x_and_a_forced_ring():
    p = 3
    rng = np.random.default_rng(4)
    wb = _ints(rng, (p, 2, 4), -4)
    xs = _ints(rng, (p, 5, p * 2), -4)
    axis = StackedAxis(p, device="cpu")
    with tapi.tuned(force={"matmul_accumulate": "fused_ring"}) as ctx:
        got, full = tapi.matmul_accumulate(_t(xs), _t(wb), axis,
                                           return_gathered=True)
    assert [r.impl for r in ctx.record] == ["fused_ring"]
    assert ctx.record[0].cell.mm_m == 5
    np.testing.assert_array_equal(to_np(full), np.broadcast_to(
        wb.reshape(p * 2, 4), (p, p * 2, 4)))
    np.testing.assert_array_equal(
        to_np(got), np.stack([xs[r] @ wb.reshape(p * 2, 4)
                              for r in range(p)]))


ACC_CELLS = [
    tcell.OpCell("matmul_accumulate", 8, 384 * 1024 * 2, "bfloat16", 3072,
                 4096, 1024, "contract"),
    tcell.OpCell("matmul_accumulate", 8, 384 * 1024 * 2, "bfloat16", 3072,
                 512, 1024, "contract"),
    tcell.OpCell("matmul_accumulate", 3, 4 * 5 * 4, "float32", 12, 7, 5,
                 "contract"),
]


@pytest.mark.parametrize("c", ACC_CELLS, ids=str)
def test_contract_cell_shapes_scaling_and_latency_match_reference(c):
    r = rcell.OpCell(*dataclasses.astuple(c))
    assert tmeasure.problem_shapes(c) == rmeasure.problem_shapes(r)
    for nb in (1, 77, 4096, 10 ** 6):
        assert dataclasses.astuple(c.scaled_to(nb)) == dataclasses.astuple(
            r.scaled_to(nb))
    for tt, rt in ((tcm.V5E_ICI, rcm.V5E_ICI), (tcm.BGQ_LIKE, rcm.BGQ_LIKE)):
        for nm in TC.REGISTRY["matmul_accumulate"]:
            a, b = tcm.latency_cell(c, nm, tt), rcm.latency_cell(r, nm, rt)
            assert abs(a - b) <= 1e-12 * max(abs(a), abs(b)), (nm, a, b)


def test_measured_replay_of_a_contract_cell_on_the_cpu():
    c = tcell.OpCell("matmul_accumulate", 4, 6 * 5 * 4, "float32", 24, 9, 5,
                     "contract")
    t = ttrace.Trace([ttrace.TraceEntry(c, "fwd", "default", 3)])
    rep = ttuner.tune_trace(t, ttuner.MeasuredBackend(4, "cpu", max_nrep=5))
    got = {m.impl for m in rep.measurements}
    assert got == set(TC.REGISTRY["matmul_accumulate"])
    assert all(m.cell == c and m.latency > 0 for m in rep.measurements)
    bench = tmeasure.Bench(4, "cpu")
    out = bench.case(c, "fused_ring")()
    assert tuple(out.shape) == (4, 9, 5)
    torch.testing.assert_close(out, torch.full((4, 9, 5), 24.0))
