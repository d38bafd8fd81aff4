"""``allgather_matmul`` and the one-kernel ring's schedule and block tier:
the port against the reference, on the CPU.  The ring kernel itself runs
in ``test_torch_cuda.py``.

Tolerances: the gathered output is a copy, so it is bit-equal.  On
integer-valued operands every product and sum is exact in float32 (and in
float16 where the values stay small), so the products are bit-equal too.
On normal float32 operands the two packages sum in another order: held
to ``1e-5`` of the output's magnitude; float16 and bfloat16 outputs,
rounded once from float32 sums, to one rounding step of their type
(``2**-10`` and ``2**-7`` of the output's magnitude).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ref import RC, TC, StackedAxis, ref_vmap, to_np

from repro.core import api as rapi
from repro.core import cell as rcell
from repro.core import costmodel as rcm
from repro.core import measure as rmeasure
from repro.core import profiles as rprof
from repro.kernels import collective_matmul_rdma as rrdma
from repro_torch.core import api as tapi
from repro_torch.core import cell as tcell
from repro_torch.core import costmodel as tcm
from repro_torch.core import measure as tmeasure
from repro_torch.core import profiles as tprof
from repro_torch.kernels import collective_matmul as cmm
from repro_torch.kernels import collective_matmul_rdma as trdma

PS = (2, 3, 4, 8)


def _operands(rng, shape, dtype, integer):
    if integer:
        return rng.integers(-4, 5, size=shape).astype(dtype)
    return rng.normal(size=shape).astype(dtype)


def _assert_close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    if tol == 0:
        np.testing.assert_array_equal(got, want)
    else:
        err = float(np.abs(got - want).max())
        assert err <= tol * max(1.0, float(np.abs(want).max())), err


# ---------------------------------------------------------------------------
# (a) the schedule helpers and the protocol
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p", range(1, 10))
def test_schedule_helpers_equal_reference(p):
    assert trdma.ring_schedule(p) == rrdma.ring_schedule(p)
    for s in range(p + 2):
        assert trdma.ring_step_slots(s) == rrdma.ring_step_slots(s)
        for my in range(p):
            assert trdma.ring_step_src(my, s, p) == rrdma.ring_step_src(
                my, s, p)


@pytest.mark.parametrize("p", PS)
def test_ring_protocol_simulation_of_the_port_schedule(p):
    """The reference's protocol simulation, replayed on the port's
    ``ring_schedule``: p ranks step-locked; a send must target a slot its
    receiver has consumed, credits must balance to zero, and rank r must
    hold chunk ``r - s`` at step s."""
    sched = trdma.ring_schedule(p)
    assert len(sched) == p
    buffers = [[None, None] for _ in range(p)]
    consumed = [[True, True] for _ in range(p)]
    credits = [0] * p
    delivered = [[] for _ in range(p)]
    for my in range(p):
        buffers[my][0] = my
        consumed[my][0] = False
    for st in sched:
        s, slot, nxt = st["s"], st["slot"], st["nxt"]
        if st["wait_credit"]:
            for my in range(p):
                assert credits[my] > 0, (p, s, my, "credit deadlock")
                credits[my] -= 1
        if st["send"]:
            for my in range(p):
                assert consumed[(my + 1) % p][nxt], (p, s, my, "overwrite")
            for my in range(p):
                right = (my + 1) % p
                buffers[right][nxt] = buffers[my][slot]
                consumed[right][nxt] = False
        for my in range(p):
            origin = buffers[my][slot]
            assert origin == trdma.ring_step_src(my, s, p), (p, s, my)
            delivered[my].append(origin)
            consumed[my][slot] = True
        if st["grant_credit"]:
            for my in range(p):
                credits[(my - 1) % p] += 1
    assert all(c == 0 for c in credits), "credits did not drain"
    for my in range(p):
        assert sorted(delivered[my]) == list(range(p))


# ---------------------------------------------------------------------------
# (b) kernel 4's plain version against the reference's interpret-mode kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("dtype,integer,tol", [
    ("float32", True, 0), ("float32", False, 1e-5),
    ("float16", True, 0), ("float16", False, 2.0 ** -10)])
def test_blocks_plain_matches_reference_interpret_for_every_rank(
        p, dtype, integer, tol):
    rng = np.random.default_rng(100 + p)
    n, k, m = 3, 5, 4
    x_all = _operands(rng, (p, n, k), dtype, integer)
    w = _operands(rng, (k, m), dtype, integer)
    for my in range(p):
        ref_out, ref_gath = rrdma.ring_allgather_matmul_blocks(
            jnp.asarray(x_all), jnp.asarray(w), my, interpret=True)
        out, gath = trdma.ring_allgather_matmul_blocks(
            torch.from_numpy(x_all), torch.from_numpy(w), my)
        assert out.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(gath.numpy(), np.asarray(ref_gath))
        np.testing.assert_array_equal(gath.numpy(), x_all.reshape(p * n, k))
        _assert_close(out.numpy(), ref_out, tol)


@pytest.mark.parametrize("p", [1, 2, 3, 5])
@pytest.mark.parametrize("shared_w", [True, False])
def test_ring_plain_is_every_rank_of_the_blocks_tier(p, shared_w):
    """Kernel 3's plain version, rank by rank, is kernel 4's (integer
    operands: exact)."""
    rng = np.random.default_rng(7 + p)
    x = torch.from_numpy(_operands(rng, (p, 3, 5), np.float32, True))
    w = torch.from_numpy(_operands(
        rng, (() if shared_w else (p,)) + (5, 2), np.float32, True))
    out, gath = trdma.ring_allgather_matmul_rdma(
        x, w, StackedAxis(p, device="cpu"), return_gathered=True)
    for my in range(p):
        o, g = trdma.ring_allgather_matmul_blocks(
            x, w if shared_w else w[my], my)
        assert torch.equal(out[my], o) and torch.equal(gath[my], g)


def test_wrappers_check_their_arguments():
    axis = StackedAxis(3, device="cpu")
    with pytest.raises(ValueError, match="x must be"):
        trdma.ring_allgather_matmul_rdma(torch.ones(2, 4, 5),
                                         torch.ones(5, 2), axis)
    with pytest.raises(ValueError, match="w must be"):
        trdma.ring_allgather_matmul_rdma(torch.ones(3, 4, 5),
                                         torch.ones(2, 5, 2), axis)
    with pytest.raises(ValueError, match="rank 3"):
        trdma.ring_allgather_matmul_blocks(torch.ones(3, 4, 5),
                                           torch.ones(5, 2), 3)


# ---------------------------------------------------------------------------
# (c) allgather_matmul's impls against the reference under vmap
# ---------------------------------------------------------------------------


def _ref_agmm(nm, x, w, shared_w, return_gathered):
    fn = RC.REGISTRY["allgather_matmul"][nm].fn
    if shared_w:
        wj = jnp.asarray(w)
        res = jax.vmap(lambda a: fn(a, "x", w=wj,
                                    return_gathered=return_gathered),
                       axis_name="x")(jnp.asarray(x))
    else:
        res = jax.vmap(lambda a, b: fn(a, "x", w=b,
                                       return_gathered=return_gathered),
                       axis_name="x")(jnp.asarray(x), jnp.asarray(w))
    return res


def _to_np_any(a):
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("nm", ["default", "fused_ring"])
@pytest.mark.parametrize("p", [1, 3, 4, 8])
@pytest.mark.parametrize("shared_w", [True, False])
@pytest.mark.parametrize("return_gathered", [False, True])
def test_allgather_matmul_matches_reference_exactly(nm, p, shared_w,
                                                    return_gathered):
    rng = np.random.default_rng(20 + p)
    n, k, m = 3, 6, 5
    x = _operands(rng, (p, n, k), np.float32, True)
    w = _operands(rng, (() if shared_w else (p,)) + (k, m), np.float32,
                  True)
    ref = _ref_agmm(nm, x, w, shared_w, return_gathered)
    got = TC.REGISTRY["allgather_matmul"][nm].fn(
        torch.from_numpy(x), StackedAxis(p, device="cpu"),
        w=torch.from_numpy(w), return_gathered=return_gathered)
    if return_gathered:
        (ref, ref_g), (got, got_g) = ref, got
        np.testing.assert_array_equal(to_np(got_g), np.asarray(ref_g))
    np.testing.assert_array_equal(to_np(got), np.asarray(ref))
    want = np.stack([x.reshape(p * n, k) @ (w if shared_w else w[r])
                     for r in range(p)])
    np.testing.assert_array_equal(to_np(got), want)


@pytest.mark.parametrize("nm", ["default", "fused_ring"])
@pytest.mark.parametrize("p", [3, 8])
def test_allgather_matmul_bfloat16_within_one_step(nm, p):
    import ml_dtypes
    rng = np.random.default_rng(30 + p)
    x = rng.normal(size=(p, 4, 16)).astype(ml_dtypes.bfloat16)
    w = (rng.normal(size=(16, 8)) / 4).astype(ml_dtypes.bfloat16)
    ref = _ref_agmm(nm, x, w, True, False)
    got = TC.REGISTRY["allgather_matmul"][nm].fn(
        torch.from_numpy(x.view(np.int16)).view(torch.bfloat16),
        StackedAxis(p, device="cpu"),
        w=torch.from_numpy(w.view(np.int16)).view(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _assert_close(to_np(got), _to_np_any(ref), 2.0 ** -7)


@pytest.mark.parametrize("p", [1, 4])
def test_ring_allgather_matmul_kernel_mm_matches_reference_pallas(p):
    """The tier-1 ring with ``mm="kernel"`` (the block-matmul plain
    version on the CPU) against the reference's ``"pallas"`` in interpret
    mode; integer operands, so exact."""
    from repro.kernels.collective_matmul import ring_allgather_matmul
    rng = np.random.default_rng(40 + p)
    x = _operands(rng, (p, 4, 8), np.float32, True)
    w = _operands(rng, (8, 6), np.float32, True)
    ref = ref_vmap(lambda a, ax: ring_allgather_matmul(
        a, jnp.asarray(w), ax, mm="pallas"), x)
    got = cmm.ring_allgather_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                    StackedAxis(p, device="cpu"),
                                    mm="kernel")
    np.testing.assert_array_equal(to_np(got), ref)


# ---------------------------------------------------------------------------
# (d) cells, replay shapes, cost model and profiles of an allgather_matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p,dtype", [(4, "float32"), (8, "bfloat16")])
@pytest.mark.parametrize("shared_w", [True, False])
def test_dispatch_records_the_reference_cell(p, dtype, shared_w):
    n, k, m = 2, 6, 5
    x = np.ones((p, n, k), np.float32)
    w = np.ones((() if shared_w else (p,)) + (k, m), np.float32)
    with rapi.tuned() as rctx:
        if shared_w:
            wj = jnp.asarray(w, dtype)
            jax.vmap(lambda a: rapi.allgather_matmul(a, wj, "x"),
                     axis_name="x")(jnp.asarray(x, dtype))
        else:
            jax.vmap(lambda a, b: rapi.allgather_matmul(a, b, "x"),
                     axis_name="x")(jnp.asarray(x, dtype),
                                    jnp.asarray(w, dtype))
    td = getattr(torch, dtype)
    with tapi.tuned() as tctx:
        tapi.allgather_matmul(torch.from_numpy(x).to(td),
                              torch.from_numpy(w).to(td),
                              StackedAxis(p, device="cpu"))
    (rrec,), (trec,) = rctx.record, tctx.record
    assert dataclasses.astuple(trec.cell) == dataclasses.astuple(rrec.cell)
    assert tuple(trec) == tuple(rrec)
    assert trec.cell == tcell.OpCell("allgather_matmul", p,
                                     n * k * td.itemsize, dtype, k, p * n,
                                     m, "gather")


AGMM_CELLS = [
    tcell.OpCell("allgather_matmul", 8, 512 * 3072 * 2, "bfloat16", 3072,
                 4096, 2048, "gather"),
    tcell.OpCell("allgather_matmul", 8, 128 * 3072 * 2, "bfloat16", 3072,
                 1024, 2048, "gather"),
    tcell.OpCell("allgather_matmul", 3, 4 * 7 * 4, "float32", 7, 12, 5,
                 "gather"),
    tcell.OpCell("allgather_matmul", 1, 64, "float32", 4, 4, 4, "gather"),
]


@pytest.mark.parametrize("c", AGMM_CELLS, ids=str)
def test_cell_problem_shapes_and_latency_match_reference(c):
    r = rcell.OpCell(*dataclasses.astuple(c))
    assert tmeasure.problem_shapes(c) == rmeasure.problem_shapes(r)
    for nb in (1, 77, 4096, 10 ** 6):
        assert dataclasses.astuple(c.scaled_to(nb)) == dataclasses.astuple(
            r.scaled_to(nb))
    for tt, rt in ((tcm.V5E_ICI, rcm.V5E_ICI), (tcm.BGQ_LIKE, rcm.BGQ_LIKE)):
        sw = tcm.sweep_cell(c, tt)
        assert set(sw) == {"default", "fused_ring", "wire_q8", "wire_fp8"}
        for nm, v in sw.items():
            want = rcm.latency_cell(r, nm, rt)
            assert abs(v - want) <= 1e-12 * max(abs(v), abs(want)), (nm, v,
                                                                    want)


def test_profile_text_and_lookup_of_an_allgather_matmul_cell(tmp_path):
    def prof(mod, cellmod):
        g = cellmod.Geom("bfloat16", 3072, 4096, 2048, "gather")
        return mod.Profile("allgather_matmul", 8,
                           [mod.Range(3 << 20, 3 << 20, "fused_ring")],
                           meta={"backend": "measured"}, geom=g)
    t, r = prof(tprof, tcell), prof(rprof, rcell)
    assert t.to_text() == r.to_text() and t.to_json() == r.to_json()
    assert "MPIX_Allgather_matmul" in t.to_text()
    tprof.ProfileStore([t]).save(tmp_path)
    back = rprof.ProfileStore.load(tmp_path)
    c = AGMM_CELLS[0]
    assert back.lookup_cell(rcell.OpCell(*dataclasses.astuple(c))) == \
        tprof.ProfileStore([t]).lookup_cell(c) == "fused_ring"
