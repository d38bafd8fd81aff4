"""The port on a CUDA card: each kernel against its plain version, the
wrappers' checks, and the dispatcher's paths through the kernels.

Every test here needs the card (``needs_cuda``) and skips elsewhere; the
file imports only torch and the port, so it runs where JAX is absent:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: placement is a copy (exact), and so is the ring's gathered
output; the wire kernels' q bytes, scales and dequantized values are
bit-equal with their plain versions, and a wire impl is held to its
selfcheck bound ``wire_tol``.  The block matmul and the ring
accumulate in float32 like their plain versions but in another order:
float32 is held to ``1e-5`` of the output's magnitude, a 16-bit output to
one rounding step (``2**-7`` relative); the accumulate ring rounds p
partial sums, one step each.
"""
import numpy as np
import pytest
import torch

from _torch_cuda import cuda, needs_cuda  # noqa: F401

from repro_torch.core import api, selfcheck
from repro_torch.core._axis import StackedAxis
from repro_torch.kernels import collective_matmul as cmm
from repro_torch.kernels import collective_matmul_rdma as rdma
from repro_torch.kernels.pack import guideline_pack, guideline_pack_plain
from repro_torch.models.layers import _TakeRows

SHAPES = [(128, 128, 128), (192, 64, 96), (100, 33, 17), (5, 256, 128),
          (512, 1024, 3072)]


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8,
                                   torch.int32])
@pytest.mark.parametrize("R,n,d,p", [(4, 37, 11, 5), (1, 1, 1, 7),
                                     (8, 512, 3072, 8)])
def test_pack_kernel_matches_plain(cuda, dtype, R, n, d, p):
    g = torch.Generator(device="cpu").manual_seed(R + n + d)
    x = (torch.randn(R, n, d, generator=g) * 20).to(dtype).to(cuda)
    idx = torch.randint(0, p, (R,), generator=g).to(torch.int32).to(cuda)
    before = guideline_pack.launches
    got = guideline_pack(x, idx, p)
    torch.cuda.synchronize()
    assert guideline_pack.launches == before + 1
    assert torch.equal(got, guideline_pack_plain(x, idx, p))


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("shared_w", [False, True])
def test_block_matmul_kernel_matches_plain(cuda, dtype, m, k, n, shared_w):
    g = torch.Generator(device="cpu").manual_seed(m + k + n)
    x = torch.randn(2, m, k, generator=g).to(dtype).to(cuda)
    w = (torch.randn(*(() if shared_w else (2,)), k, n, generator=g)
         * k ** -0.5).to(dtype).to(cuda)
    before = cmm.block_matmul.launches
    got = cmm.block_matmul(x, w)
    torch.cuda.synchronize()
    assert cmm.block_matmul.launches == before + 1
    assert got.dtype == dtype and got.shape == (2, m, n)
    want = cmm.block_matmul_plain(x, w).float()
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    assert float((got.float() - want).abs().max()) <= tol * max(
        1.0, float(want.abs().max()))


@needs_cuda
def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.ones(4, 8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        cmm.block_matmul(x, x.T.contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        cmm.block_matmul(torch.ones(8, 4, device=cuda).T,
                         torch.ones(8, 2, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        guideline_pack(torch.ones(1, 8, 4, device=cuda).transpose(1, 2),
                       torch.zeros(1, dtype=torch.int32, device=cuda), 2)
    with pytest.raises(ValueError, match="idx on"):
        guideline_pack(torch.ones(1, 8, 4, device=cuda),
                       torch.zeros(1, dtype=torch.int32), 2)


@needs_cuda
@pytest.mark.parametrize("p", [8, 6, 3])
def test_selfcheck_on_card(cuda, p):
    rep = selfcheck.run(p, cuda)
    assert rep["failures"] == [] and rep["total"] >= 40


@needs_cuda
def test_dispatch_goes_through_both_kernels(cuda):
    p = 8
    axis = StackedAxis(p, cuda)
    x = torch.randn(p, 16, 64, device=cuda, dtype=torch.bfloat16)
    xm = torch.randn(p, p * 16, 32, device=cuda, dtype=torch.bfloat16)
    w = torch.randn(p, 32, 64, device=cuda, dtype=torch.bfloat16)
    pk, mm = guideline_pack.launches, cmm.block_matmul.launches
    with api.tuned(force={"allgather": "allgather_as_allreduce",
                          "matmul_reducescatter": "fused_ring"}) as ctx:
        got = api.allgather(x, axis)
        ring = api.matmul_reducescatter(xm, w, axis)
    torch.cuda.synchronize()
    assert guideline_pack.launches == pk + 1
    assert cmm.block_matmul.launches == mm + p
    assert torch.equal(got, api.allgather(x, axis, impl="default"))
    dflt = api.matmul_reducescatter(xm, w, axis, impl="default").float()
    assert float((ring.float() - dflt).abs().max()) <= 2.0 ** -4 * max(
        1.0, float(dflt.abs().max()))
    assert [r.impl for r in ctx.record] == ["allgather_as_allreduce",
                                            "fused_ring"]


def _mm_err_ok(got, want):
    want = want.float()
    tol = 1e-5 if got.dtype == torch.float32 else 2.0 ** -7
    return float((got.float() - want).abs().max()) <= tol * max(
        1.0, float(want.abs().max()))


def _agmm_operands(cuda, p, n, k, m, dtype, shared_w, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(p, n, k, generator=g).to(dtype).to(cuda)
    w = (torch.randn(*(() if shared_w else (p,)), k, m, generator=g)
         * k ** -0.5).to(dtype).to(cuda)
    return x, w


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("p,n,k,m", [(2, 5, 7, 9), (3, 100, 33, 17),
                                     (5, 64, 128, 136), (8, 129, 72, 200),
                                     (8, 512, 3072, 256)])
@pytest.mark.parametrize("shared_w", [False, True])
def test_agmm_ring_kernel_matches_plain(cuda, dtype, p, n, k, m, shared_w):
    x, w = _agmm_operands(cuda, p, n, k, m, dtype, shared_w, p + n + k + m)
    axis = StackedAxis(p, cuda)
    before = rdma.ring_allgather_matmul_rdma.launches
    out, gath = rdma.ring_allgather_matmul_rdma(x, w, axis,
                                                return_gathered=True)
    torch.cuda.synchronize()
    assert rdma.ring_allgather_matmul_rdma.launches == before + 1
    want, want_g = rdma.ring_allgather_matmul_rdma_plain(
        x, w, return_gathered=True)
    assert out.dtype == dtype and out.shape == (p, p * n, m)
    assert torch.equal(gath, want_g)
    assert torch.equal(gath, x.reshape(1, p * n, k).expand(p, -1, -1))
    assert _mm_err_ok(out, want)
    again = rdma.ring_allgather_matmul_rdma(x, w, axis)   # flags re-zeroed
    assert torch.equal(again, out)


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,n,k,m", [(4, 5, 7, 9), (3, 64, 256, 128)])
def test_agmm_blocks_kernel_matches_plain_for_every_rank(cuda, dtype, p, n,
                                                         k, m):
    x, w = _agmm_operands(cuda, p, n, k, m, dtype, True, 7)
    for my in range(p):
        before = rdma.ring_allgather_matmul_blocks.launches
        out, gath = rdma.ring_allgather_matmul_blocks(x, w, my)
        torch.cuda.synchronize()
        assert rdma.ring_allgather_matmul_blocks.launches == before + 1
        want, want_g = rdma.ring_allgather_matmul_blocks_plain(x, w, my)
        assert torch.equal(gath, want_g)
        assert _mm_err_ok(out, want)


@needs_cuda
def test_agmm_ring_at_p1_is_block_matmul(cuda):
    x, w = _agmm_operands(cuda, 1, 16, 32, 24, torch.bfloat16, True, 3)
    before = (rdma.ring_allgather_matmul_rdma.launches,
              cmm.block_matmul.launches)
    out, gath = rdma.ring_allgather_matmul_rdma(x, w, StackedAxis(1, cuda),
                                                return_gathered=True)
    assert (rdma.ring_allgather_matmul_rdma.launches,
            cmm.block_matmul.launches) == (before[0], before[1] + 1)
    assert gath is x and torch.equal(out, cmm.block_matmul(x, w))


@needs_cuda
def test_agmm_ring_refuses_what_it_does_not_take(cuda):
    axis = StackedAxis(2, cuda)
    x = torch.ones(2, 4, 8, device=cuda)
    with pytest.raises(ValueError, match="one dtype"):
        rdma.ring_allgather_matmul_rdma(x, torch.ones(8, 4, device=cuda,
                                                      dtype=torch.bfloat16),
                                        axis)
    with pytest.raises(ValueError, match="contiguous"):
        rdma.ring_allgather_matmul_rdma(x, torch.ones(4, 8, device=cuda).T,
                                        axis)
    with pytest.raises(ValueError, match="x must be"):
        rdma.ring_allgather_matmul_rdma(x[0], torch.ones(8, 4, device=cuda),
                                        axis)


@needs_cuda
def test_allgather_matmul_fused_ring_launches_the_ring_kernel(cuda):
    p = 8
    axis = StackedAxis(p, cuda)
    x, w = _agmm_operands(cuda, p, 64, 256, 128, torch.bfloat16, False, 5)
    ring, mm = rdma.ring_allgather_matmul_rdma.launches, \
        cmm.block_matmul.launches
    with api.tuned(force={"allgather_matmul": "fused_ring"}) as ctx:
        got, gath = api.allgather_matmul(x, w, axis, return_gathered=True)
    torch.cuda.synchronize()
    assert rdma.ring_allgather_matmul_rdma.launches == ring + 1
    assert cmm.block_matmul.launches == mm
    want, want_g = api.allgather_matmul(x, w, axis, impl="default",
                                        return_gathered=True)
    assert torch.equal(gath, want_g)
    assert _mm_err_ok(got, want)
    assert [r.impl for r in ctx.record] == ["fused_ring"]


# ---------------------------------------------------------------------------
# the quantized wire: quant_pack / dequant_unpack against their plain
# versions (q bytes, scales and the dequantized values all bit-equal)
# ---------------------------------------------------------------------------

C_WIRE = {"wire_q8": "int8", "wire_fp8": "float8_e4m3fn"}
QUANT_SHAPES = [(1, 13, 5), (3, 13, 7), (5, 3, 5), (3, 3, 7), (1, 8, 1),
                (8, 64, 3072), (2, 17, 1500)]


@needs_cuda
@pytest.mark.parametrize("wire", ["int8", "float8_e4m3fn"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("R,n,d", QUANT_SHAPES)
def test_quant_kernels_match_plain_bit_for_bit(cuda, wire, dtype, R, n, d):
    from repro_torch.kernels import quant as Q
    g = torch.Generator(device="cpu").manual_seed(R * 1000 + n * 10 + d)
    x = (torch.randn(R, n, d, generator=g)
         * torch.logspace(-3, 3, n).view(1, n, 1)).to(dtype)
    x[0, 0, 0] = 0.0
    if n > 8:
        x[-1, 8:16] = 0.0                 # an all-zero block: the floor
    xc = x.to(cuda)
    before = (Q.quant_pack.launches, Q.dequant_unpack.launches)
    q, s = Q.quant_pack(xc, wire)
    out = Q.dequant_unpack(q, s, dtype)
    torch.cuda.synchronize()
    assert (Q.quant_pack.launches, Q.dequant_unpack.launches) == (
        before[0] + 1, before[1] + 1)
    wq, ws = Q.quant_pack_plain(xc, wire)
    assert q.dtype == wq.dtype and s.shape == (R, -(-n // 8), 1)
    assert torch.equal(q.view(torch.uint8), wq.view(torch.uint8))
    assert torch.equal(s, ws)                  # 0 ulp
    assert torch.equal(out, Q.dequant_unpack_plain(q, s, dtype))
    # and the plain version on the CPU computes the same bytes
    cq, cs = Q.quant_pack_plain(x, wire)
    assert torch.equal(q.cpu().view(torch.uint8), cq.view(torch.uint8))
    assert torch.equal(s.cpu(), cs)


@needs_cuda
def test_quant_kernels_refuse_what_they_do_not_take(cuda):
    from repro_torch.kernels import quant as Q
    with pytest.raises(ValueError, match="float32"):
        Q.quant_pack(torch.ones(2, 8, 4, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        Q.quant_pack(torch.ones(1, 4, 8, device=cuda).transpose(1, 2))
    q, s = Q.quant_pack(torch.ones(2, 9, 4, device=cuda))
    with pytest.raises(ValueError, match="scales must be"):
        Q.dequant_unpack(q, s[:, :1])
    with pytest.raises(ValueError, match="scales on"):
        Q.dequant_unpack(q, s.cpu())


@needs_cuda
@pytest.mark.parametrize("p", [8, 3])
def test_wire_impls_on_card_launch_the_quant_kernels(cuda, p):
    from repro_torch.kernels import quant as Q
    axis = StackedAxis(p, cuda)
    g = torch.Generator(device="cpu").manual_seed(p)
    x = torch.randn(p, 16, 64, generator=g).to(cuda)
    for op, nm in (("allgather", "wire_q8"), ("allgather", "wire_fp8")):
        before = (Q.quant_pack.launches, Q.dequant_unpack.launches)
        with api.tuned(force={op: nm}) as ctx:
            got = api.allgather(x, axis)
        torch.cuda.synchronize()
        assert [r.impl for r in ctx.record] == [nm]
        assert (Q.quant_pack.launches, Q.dequant_unpack.launches) == (
            before[0] + 1, before[1] + p - 1)
        rel = selfcheck.rel_err(got.cpu().numpy(),
                                api.allgather(x, axis).cpu().numpy())
        assert rel <= Q.wire_tol(C_WIRE[nm], 1)


@needs_cuda
@pytest.mark.parametrize("name", sorted(C_WIRE))
def test_run_gate_on_a_numpy_payload_runs_on_the_card(cuda, name):
    """With no ``device`` the gate runs on the GPU even for a host payload,
    so it judges the kernels that CUDA dispatch would run."""
    from repro_torch.core import collectives as C
    from repro_torch.kernels import quant as Q
    p = 8
    x = np.random.default_rng(3).normal(size=(p, 16, 4)).astype(np.float32)
    before = (Q.quant_pack.launches, Q.dequant_unpack.launches)
    try:
        ok, rel, tol = selfcheck.run_gate("allreduce", name, x)
        assert not C.demotions()
    finally:
        C.clear_demotions()
    assert ok and rel <= tol
    assert Q.quant_pack.launches > before[0]
    assert Q.dequant_unpack.launches > before[1]


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_matmul_accumulate_rings_on_card(cuda, dtype):
    from repro_torch.kernels import quant as Q
    p, k_loc, T, M = 8, 48, 40, 96
    axis = StackedAxis(p, cuda)
    g = torch.Generator(device="cpu").manual_seed(11)
    x = torch.randn(p, T, p * k_loc, generator=g).to(dtype).to(cuda)
    w = (torch.randn(p, k_loc, M, generator=g) * (p * k_loc) ** -0.5).to(
        dtype).to(cuda)
    dflt, full = api.matmul_accumulate(x, w, axis, impl="default",
                                       return_gathered=True)
    scale = max(1.0, float(dflt.float().abs().max()))
    mm = cmm.block_matmul.launches
    ring, gath = api.matmul_accumulate(x, w, axis, impl="fused_ring",
                                       return_gathered=True)
    torch.cuda.synchronize()
    assert cmm.block_matmul.launches == mm + p
    assert torch.equal(gath, full)
    # p partial sums rounded in the output dtype: one step each
    step = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    assert float((ring.float() - dflt.float()).abs().max()) <= p * step * scale
    for nm, wd in C_WIRE.items():
        before = (Q.quant_pack.launches, Q.dequant_unpack.launches)
        got = api.matmul_accumulate(x, w, axis, impl=nm)
        torch.cuda.synchronize()
        assert (Q.quant_pack.launches, Q.dequant_unpack.launches) == (
            before[0] + 1, before[1] + p - 1)
        rel = selfcheck.rel_err(got.float().cpu().numpy(),
                                dflt.float().cpu().numpy())
        assert rel <= Q.wire_tol(wd, selfcheck.wire_hops(
            "matmul_accumulate", p)) + (0 if dtype == torch.float32
                                        else 2.0 ** -7)


# ---------------------------------------------------------------------------
# flash attention (kernels/flash_attention.py, csrc/flash_attention.cu)
# ---------------------------------------------------------------------------

# against the oracle: the reference test's bar (float32: summation order,
# 3e-5; bfloat16: p and the output rounded once each, 3e-2); against the
# plain version: the elementwise limit FA.tolerance
FLASH_TOL = {torch.float32: 3e-5, torch.bfloat16: 3e-2}


def _within_limit(FA, got, q, k, v, **kw) -> bool:
    want = FA.flash_attention_plain(q, k, v, **kw)
    return bool(((got.float() - want.float()).abs()
                 <= FA.tolerance(q, k, v, want, **kw)).all())

FLASH_CASES = [
    # (N, Sq, Skv, HK, G, dh, causal, window, softcap, q0, kv_len)
    (4, 100, 100, 2, 3, 128, True, 0, 0.0, 0, None),     # ragged prefill
    (2, 64, 64, 1, 1, 16, True, 0, 0.0, 0, None),
    (2, 130, 130, 2, 2, 32, True, 40, 0.0, 0, None),     # sliding window
    (2, 77, 77, 1, 4, 64, False, 0, 0.0, 0, None),       # full
    (3, 50, 50, 1, 2, 256, True, 0, 30.0, 0, None),      # wide head, cap
    (8, 1, 256, 1, 3, 128, True, 0, 0.0, 200, 201),      # decode
    (8, 1, 256, 1, 3, 128, True, 0, 0.0, 255, 256),      # decode, full
    (4, 3, 128, 2, 2, 64, True, 0, 0.0, 90, 93),         # 3-token step
    (2, 1, 32, 2, 2, 128, True, 32, 0.0, 31, 32),        # windowed decode
    (2, 33, 33, 1, 3, 40, True, 0, 0.0, 0, None),        # dh % 8 != 0
]


def _flash_inputs(cuda, case, dtype, seed=0):
    n, sq, skv, hk, g, dh = case[:6]
    gen = torch.Generator(device="cpu").manual_seed(seed + sum(case[:6]))
    q, k, v = (torch.randn(*s, generator=gen).to(dtype).to(cuda)
               for s in ((n, sq, hk, g, dh), (n, skv, hk, dh),
                         (n, skv, hk, dh)))
    return q, k, v


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain(cuda, dtype, case):
    from repro_torch.kernels import flash_attention as FA
    q, k, v = _flash_inputs(cuda, case, dtype)
    causal, window, softcap, q0, kv_len = case[6:]
    kw = dict(causal=causal, window=window, softcap=softcap, q0=q0,
              kv_len=kv_len)
    before = FA.flash_attention.launches
    got = FA.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + 1
    assert got.dtype == dtype and tuple(got.shape) == tuple(q.shape)
    assert bool(torch.isfinite(got.float()).all())
    assert _within_limit(FA, got, q, k, v, **kw)


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,s,d,window,softcap", [
    (1, 2, 2, 128, 64, 0, 0.0), (2, 4, 2, 256, 64, 0, 0.0),
    (1, 8, 1, 128, 128, 0, 0.0), (1, 2, 2, 192, 32, 0, 0.0),
    (1, 2, 2, 256, 64, 100, 0.0), (1, 2, 2, 128, 64, 0, 30.0)])
def test_flash_pallas_layout_matches_the_oracle(cuda, dtype, b, hq, hkv, s,
                                                d, window, softcap):
    """The TPU kernel's cases (``tests/test_kernels.py:22-70``) on strided
    views of the Pallas layout."""
    from repro_torch.kernels import flash_attention as FA
    gen = torch.Generator(device="cpu").manual_seed(s + d)
    scale = 4.0 if softcap else 1.0
    q = (torch.randn(b, hq, s, d, generator=gen) * scale).to(dtype).to(cuda)
    k = (torch.randn(b, hkv, s, d, generator=gen) * scale).to(dtype).to(
        cuda)
    v = torch.randn(b, hkv, s, d, generator=gen).to(dtype).to(cuda)
    got = FA.flash_attention_bhsd(q, k, v, window=window, softcap=softcap)
    want = FA.flash_attention_ref(q, k, v, window=window, softcap=softcap)
    assert float((got.float() - want.float()).abs().max()) <= FLASH_TOL[
        dtype]


@needs_cuda
@pytest.mark.parametrize("kv_len", [1024, 1025, 1056, 2048])
def test_flash_kernel_at_the_serve_shapes(cuda, kv_len):
    """llama3.2-3b at TP 8 stacked: 32 = 8 ranks x 4 requests, one KV head
    and 3 q heads per rank; prefill at 1024 tokens, decode in a 2048-slot
    cache."""
    from repro_torch.kernels import flash_attention as FA
    if kv_len == 1024:
        case = (32, 1024, 1024, 1, 3, 128, True, 0, 0.0, 0, None)
    else:
        case = (32, 1, 2048, 1, 3, 128, True, 0, 0.0, kv_len - 1, kv_len)
    q, k, v = _flash_inputs(cuda, case, torch.bfloat16)
    kw = dict(zip(("causal", "window", "softcap", "q0", "kv_len"),
                  case[6:]))
    assert _within_limit(FA, FA.flash_attention(q, k, v, **kw), q, k, v, **kw)


@needs_cuda
@pytest.mark.parametrize("case,bad", [
    ((32, 1024, 1024, 1, 3, 128, True, 0, 0.0, 0, None), dict(q0=1)),
    ((32, 1024, 1024, 1, 3, 128, True, 0, 0.0, 0, None),
     dict(window=1024 - 128)),
    ((32, 1, 2048, 1, 3, 128, True, 0, 0.0, 1024, 1025),
     dict(q0=1024, kv_len=1024)),
    ((32, 1, 2048, 1, 3, 128, True, 0, 0.0, 1055, 1056),
     dict(q0=1056, kv_len=1057))])
def test_flash_limit_rejects_planted_faults_at_the_serve_shapes(cuda, case,
                                                                bad):
    """The kernel run with a fault's arguments (the causal edge one key
    late, the first 128-key block dropped for the last rows, the last
    filled slot left out, one unfilled slot read) fails the limit that
    holds it to the plain version."""
    from repro_torch.kernels import flash_attention as FA
    q, k, v = _flash_inputs(cuda, case, torch.bfloat16)
    kw = dict(zip(("causal", "window", "softcap", "q0", "kv_len"),
                  case[6:]))
    assert not _within_limit(FA, FA.flash_attention(q, k, v, **bad), q, k, v,
                             **kw)


@needs_cuda
def test_flash_kernel_reads_no_key_beyond_kv_len(cuda):
    """Keys at or beyond kv_len, and blocks the causal mask hides, are
    never read: NaNs there change nothing."""
    from repro_torch.kernels import flash_attention as FA
    q, k, v = _flash_inputs(cuda, (2, 1, 512, 1, 3, 128), torch.bfloat16)
    want = FA.flash_attention(q, k, v, q0=99, kv_len=100)
    k[:, 100:] = float("nan")
    v[:, 100:] = float("nan")
    assert torch.equal(FA.flash_attention(q, k, v, q0=99, kv_len=100), want)


@needs_cuda
def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels import flash_attention as FA
    q, k, v = _flash_inputs(cuda, (1, 4, 4, 1, 1, 16), torch.bfloat16)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        FA.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous head dim"):
        FA.flash_attention(q, k.transpose(1, 3).contiguous().transpose(1, 3),
                           v)
    big = torch.zeros(1, 2, 1, 1, 264, dtype=torch.bfloat16, device=cuda)
    kb = torch.zeros(1, 2, 1, 264, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention(big, kb, kb)
    with pytest.raises(ValueError, match="q on"):
        FA.flash_attention(q.cpu(), k, v)


# ---------------------------------------------------------------------------
# the Hopper paths: the ring on wgmma/TMA, flash's wgmma prefill and its
# split-KV decode; each test asserts the path its calls took
# ---------------------------------------------------------------------------


def _paths(fn) -> dict:
    return dict(fn.launches_by_path)


def _took(fn, before: dict) -> dict:
    return {k: v - before[k] for k, v in fn.launches_by_path.items()
            if v != before[k]}


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("p,n,k,m", [(2, 61, 72, 200), (3, 129, 72, 200),
                                     (5, 61, 128, 200), (8, 129, 72, 136),
                                     (6, 1, 8, 8), (4, 128, 1000, 256)])
@pytest.mark.parametrize("shared_w", [False, True])
def test_agmm_ring_wgmma_path_matches_plain(cuda, dtype, p, n, k, m,
                                            shared_w):
    """Ragged n (61, 129), m (200, not a multiple of the 128-wide tile)
    and k (72, not a multiple of the 64-deep stage): TMA zero-fills and
    the epilogue masks."""
    x, w = _agmm_operands(cuda, p, n, k, m, dtype, shared_w, p * n + k + m)
    axis = StackedAxis(p, cuda)
    before = _paths(rdma.ring_allgather_matmul_rdma)
    out, gath = rdma.ring_allgather_matmul_rdma(x, w, axis,
                                                return_gathered=True)
    torch.cuda.synchronize()
    assert _took(rdma.ring_allgather_matmul_rdma, before) == {"wgmma": 1}
    want, want_g = rdma.ring_allgather_matmul_rdma_plain(
        x, w, return_gathered=True)
    assert torch.equal(gath, want_g)
    assert _mm_err_ok(out, want)


@needs_cuda
def test_agmm_ring_wgmma_repeats_are_bit_equal(cuda):
    """The gate/up shape (p = 8, x [512, 3072] per rank, w [8, 3072,
    2048]) 50 times in a row: a stale slot row (a missing proxy fence
    between the copy warps' stores and the TMA reads) would show as a run
    that differs."""
    p, n, k, m = 8, 512, 3072, 2048
    x, w = _agmm_operands(cuda, p, n, k, m, torch.bfloat16, False, 11)
    axis = StackedAxis(p, cuda)
    first, gath = rdma.ring_allgather_matmul_rdma(x, w, axis,
                                                  return_gathered=True)
    want, want_g = rdma.ring_allgather_matmul_rdma_plain(
        x, w, return_gathered=True)
    assert torch.equal(gath, want_g)
    assert _mm_err_ok(first, want)
    before = _paths(rdma.ring_allgather_matmul_rdma)
    for _ in range(49):
        out, again = rdma.ring_allgather_matmul_rdma(x, w, axis,
                                                     return_gathered=True)
        assert torch.equal(out, first) and torch.equal(again, gath)
    assert _took(rdma.ring_allgather_matmul_rdma, before) == {"wgmma": 49}


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_agmm_blocks_wgmma_path_for_every_rank(cuda, dtype):
    p, n, k, m = 5, 61, 72, 200
    x, w = _agmm_operands(cuda, p, n, k, m, dtype, True, 13)
    for my in range(p):
        before = _paths(rdma.ring_allgather_matmul_blocks)
        out, gath = rdma.ring_allgather_matmul_blocks(x, w, my)
        torch.cuda.synchronize()
        assert _took(rdma.ring_allgather_matmul_blocks, before) == {
            "wgmma": 1}
        want, want_g = rdma.ring_allgather_matmul_blocks_plain(x, w, my)
        assert torch.equal(gath, want_g)
        assert _mm_err_ok(out, want)


@needs_cuda
@pytest.mark.parametrize("dtype,k,m,offset,path", [
    (torch.float32, 72, 200, 0, "f32"),
    (torch.bfloat16, 33, 200, 0, "wmma"),      # k % 8 != 0
    (torch.float16, 72, 17, 0, "wmma"),        # m % 8 != 0
    (torch.bfloat16, 72, 200, 1, "wmma")])     # x not 16-byte aligned
def test_agmm_ring_takes_the_tile_kernel_where_tma_cannot(cuda, dtype, k,
                                                          m, offset, path):
    p, n = 4, 37
    x, w = _agmm_operands(cuda, p, n, k, m, dtype, False, 17)
    if offset:
        buf = torch.empty(x.numel() + offset, dtype=dtype, device=cuda)
        buf[offset:].copy_(x.flatten())
        x = buf[offset:].view(p, n, k)
    before = _paths(rdma.ring_allgather_matmul_rdma)
    out, gath = rdma.ring_allgather_matmul_rdma(x, w, StackedAxis(p, cuda),
                                                return_gathered=True)
    torch.cuda.synchronize()
    assert _took(rdma.ring_allgather_matmul_rdma, before) == {path: 1}
    want, want_g = rdma.ring_allgather_matmul_rdma_plain(
        x, w, return_gathered=True)
    assert torch.equal(gath, want_g)
    assert _mm_err_ok(out, want)


WGMMA_CASES = [
    # (N, Sq, Skv, HK, G, dh, causal, window, softcap, q0, kv_len)
    (2, 256, 256, 1, 3, 128, True, 0, 0.0, 0, None),      # G = 3 folded
    (2, 200, 200, 2, 1, 64, True, 0, 0.0, 0, None),       # dh 64, ragged
    (2, 192, 192, 1, 2, 128, True, 50, 0.0, 0, None),     # window
    (1, 160, 160, 2, 2, 64, True, 0, 30.0, 0, None),      # softcap
    (2, 96, 300, 1, 3, 128, True, 0, 0.0, 204, 300),      # a later chunk
    (2, 64, 256, 2, 1, 128, False, 0, 0.0, 0, 200),       # kv_len in a block
    (3, 77, 77, 1, 4, 64, False, 0, 0.0, 0, None),        # full attention
]


@needs_cuda
@pytest.mark.parametrize("case", WGMMA_CASES)
def test_flash_wgmma_prefill_matches_plain(cuda, case):
    from repro_torch.kernels import flash_attention as FA
    q, k, v = _flash_inputs(cuda, case, torch.bfloat16)
    kw = dict(zip(("causal", "window", "softcap", "q0", "kv_len"),
                  case[6:]))
    if case[8]:                    # scores large enough for the cap to bite
        q, k = q * 4, k * 4
    before = _paths(FA.flash_attention)
    got = FA.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert _took(FA.flash_attention, before) == {"wgmma": 1}
    assert bool(torch.isfinite(got.float()).all())
    assert _within_limit(FA, got, q, k, v, **kw)


@needs_cuda
@pytest.mark.parametrize("dh", [64, 128])
def test_flash_wgmma_reads_no_key_beyond_kv_len(cuda, dh):
    """A prefill chunk whose kv_len (200) ends inside the second 128-key
    block: NaNs beyond it change nothing."""
    from repro_torch.kernels import flash_attention as FA
    q, k, v = _flash_inputs(cuda, (2, 128, 512, 1, 1, dh), torch.bfloat16)
    kw = dict(q0=72, kv_len=200)
    before = _paths(FA.flash_attention)
    want = FA.flash_attention(q, k, v, **kw)
    assert _within_limit(FA, want, q, k, v, **kw)
    k[:, 200:] = float("nan")
    v[:, 200:] = float("nan")
    got = FA.flash_attention(q, k, v, **kw)
    assert _took(FA.flash_attention, before) == {"wgmma": 2}
    assert torch.equal(got, want)


@needs_cuda
@pytest.mark.parametrize("kv_len", [1, 100, 1025, 2048])
@pytest.mark.parametrize("hk,g,dh", [(1, 3, 128), (4, 1, 64)])
def test_flash_split_decode_matches_plain(cuda, kv_len, hk, g, dh):
    """One decode token per row against a 2048-slot cache (llama's and
    zamba2's heads per rank): the KV range split across CTAs, the last CTA
    of each head merging; slots beyond kv_len hold NaNs."""
    from repro_torch.kernels import flash_attention as FA
    case = (32, 1, 2048, hk, g, dh, True, 0, 0.0, kv_len - 1, kv_len)
    q, k, v = _flash_inputs(cuda, case, torch.bfloat16)
    k[:, kv_len:] = float("nan")
    v[:, kv_len:] = float("nan")
    kw = dict(q0=kv_len - 1, kv_len=kv_len)
    before = _paths(FA.flash_attention)
    got = FA.flash_attention(q, k, v, **kw)
    again = FA.flash_attention(q, k, v, **kw)    # the tickets re-armed
    torch.cuda.synchronize()
    assert _took(FA.flash_attention, before) == {"split_kv": 2}
    assert torch.equal(got, again)
    assert bool(torch.isfinite(got.float()).all())
    k[:, kv_len:] = 0
    v[:, kv_len:] = 0
    assert _within_limit(FA, got, q, k, v, **kw)


@needs_cuda
@pytest.mark.parametrize("case,dtype,strided,path", [
    ((2, 64, 64, 1, 2, 128, True, 0, 0.0, 0, None), torch.float32, False,
     "f32"),
    ((2, 33, 33, 1, 3, 40, True, 0, 0.0, 0, None), torch.bfloat16, False,
     "mma_sync"),                              # dh 40
    ((2, 20, 20, 1, 2, 128, True, 0, 0.0, 0, None), torch.bfloat16, False,
     "mma_sync"),                              # 40 folded rows
    ((2, 64, 64, 1, 2, 128, True, 0, 0.0, 0, None), torch.bfloat16, True,
     "mma_sync"),                              # a K stride TMA cannot use
    ((2, 3, 128, 2, 2, 64, True, 0, 0.0, 90, 93), torch.bfloat16, False,
     "split_kv")])                             # 6 folded rows
def test_flash_paths_by_dtype_shape_and_alignment(cuda, case, dtype, strided,
                                                  path):
    from repro_torch.kernels import flash_attention as FA
    q, k, v = _flash_inputs(cuda, case, dtype)
    if strided:    # rows of 132 elements: a stride not a multiple of 8
        wide = torch.zeros(*k.shape[:3], 132, dtype=dtype, device=cuda)
        wide[..., :128] = k
        k = wide[..., :128]
    kw = dict(zip(("causal", "window", "softcap", "q0", "kv_len"),
                  case[6:]))
    before = _paths(FA.flash_attention)
    got = FA.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert _took(FA.flash_attention, before) == {path: 1}
    assert _within_limit(FA, got, q, k, v, **kw)


def _smoke_serve_setup(cuda, tp=2):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.params import init_tree
    cfg = dataclasses.replace(get_config("llama3.2-3b").smoke(),
                              attn_impl="flash")
    axis = StackedAxis(tp, cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    params = init_tree(lm.model_specs(cfg, tp), gen, axis)
    prompts = torch.randint(0, cfg.vocab_size, (2, 24),
                            generator=torch.Generator().manual_seed(6)
                            ).to(cuda)
    return cfg, axis, params, prompts


@needs_cuda
def test_model_flash_branch_launches_the_kernel_not_the_plain_version(
        cuda, monkeypatch):
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import serve as tserve

    def refuse(*a, **kw):
        raise AssertionError("the plain version ran on the card")
    monkeypatch.setattr(FA, "flash_attention_plain", refuse)
    cfg, axis, params, prompts = _smoke_serve_setup(cuda)
    before = FA.flash_attention.launches
    res = tserve.serve(cfg, axis, params, prompts, 40, 5)
    torch.cuda.synchronize()
    assert FA.flash_attention.launches == before + cfg.n_layers * 5
    assert res.tokens.shape == (2, 5) and res.tokens.is_cuda


@needs_cuda
def test_serve_on_card_matches_the_cpu(cuda):
    """The smoke-size serve on the card against the same weights on the
    CPU (plain attention there): 2e-2 max-norm relative, the JAX
    package's bar for its two attention paths."""
    from repro_torch.launch import serve as tserve
    cfg, axis, params, prompts = _smoke_serve_setup(cuda)
    on_card = tserve.serve(cfg, axis, params, prompts, 40, 6)
    cpu_axis = StackedAxis(axis.size, "cpu")
    on_cpu = tserve.serve(cfg, cpu_axis, _to_cpu(params), prompts.cpu(), 40, 6)
    card_cpu = tserve.ServeResult(
        on_card.tokens.cpu(), [lg.cpu() for lg in on_card.logits],
        on_card.prefill_s, on_card.decode_s, on_card.ctx)
    report = tserve.check_serves(on_cpu, card_cpu, 2e-2)
    assert report["steps"] >= 1


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


# ---------------------------------------------------------------------------
# the SSM scans (rwkv6_scan, ssd_scan)
# ---------------------------------------------------------------------------

# (N, S, H, hd, Nu, with s0): the rwkv6-3b serve's prefill and decode at TP
# 8 stacked (32 = 8 ranks x 4 requests, 5 heads per rank), ragged lengths
RWKV_CASES = [(32, 1024, 5, 64, 8, False), (32, 1, 5, 64, 8, True),
              (32, 1023, 5, 64, 8, True), (4, 75, 3, 16, 2, True),
              (3, 33, 2, 40, 1, False)]
# (N, S, H, P, Ns, Na, with s0): zamba2-1.2b's (8 heads of 64 per rank,
# state 64), ragged lengths
SSD_CASES = [(32, 1024, 8, 64, 64, 8, False), (32, 1, 8, 64, 64, 8, True),
             (32, 1023, 8, 64, 64, 8, True), (4, 75, 3, 16, 8, 2, True),
             (3, 130, 2, 24, 40, 1, False)]


def _rwkv_in(cuda, case, dtype, seed=0, decay=None):
    n, s, h, hd, nu, with_s0 = case
    g = torch.Generator(device="cpu").manual_seed(seed)
    r, k, v = (torch.randn(n, s, h, hd, generator=g).to(dtype).to(cuda)
               for _ in range(3))
    w = (torch.full((n, s, h, hd), decay) if decay is not None else
         torch.rand(n, s, h, hd, generator=g) * 0.55 + 0.4).to(cuda)
    u = torch.randn(nu, h, hd, generator=g).to(cuda)
    s0 = torch.randn(n, h, hd, hd, generator=g).to(cuda) if with_s0 else None
    return r, k, v, w, u, s0


def _ssd_in(cuda, case, dtype, seed=0):
    n, s, h, p, ns, na, with_s0 = case
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(n, s, h, p, generator=g).to(dtype).to(cuda)
    dt = (torch.rand(n, s, h, generator=g) * 0.8 + 0.05).to(cuda)
    a = (torch.rand(na, h, generator=g) * 1.7 + 0.3).to(cuda)
    bc = torch.randn(n, s, 2 * ns, generator=g).to(dtype).to(cuda)
    s0 = (torch.randn(n, h, ns, p, generator=g).to(cuda) if with_s0
          else None)
    return x, dt, a, bc[..., :ns], bc[..., ns:], s0


def _share(got, want, lim) -> float:
    return float(((got - want).abs() / lim).max())


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", RWKV_CASES)
def test_rwkv6_kernel_matches_plain(cuda, dtype, case):
    from repro_torch.kernels import rwkv6_scan as RW
    ins = _rwkv_in(cuda, case, dtype)
    before = RW.rwkv6_scan.launches
    y, sf = RW.rwkv6_scan(*ins)
    torch.cuda.synchronize()
    assert RW.rwkv6_scan.launches == before + 1
    want, s_want = RW.rwkv6_scan_plain(*ins)
    y_lim, s_lim = RW.tolerance(*ins)
    assert _share(y, want, y_lim) <= 1.0 and _share(sf, s_want, s_lim) <= 1.0


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_kernel_matches_plain(cuda, dtype, case):
    from repro_torch.kernels import ssd_mamba2 as SSD
    ins = _ssd_in(cuda, case, dtype)
    before = SSD.ssd_scan.launches
    y, sf = SSD.ssd_scan(*ins)
    torch.cuda.synchronize()
    assert SSD.ssd_scan.launches == before + 1
    want, s_want = SSD.ssd_scan_plain(*ins)
    y_lim, s_lim = SSD.tolerance(*ins)
    assert _share(y, want, y_lim) <= 1.0 and _share(sf, s_want, s_lim) <= 1.0


@needs_cuda
@pytest.mark.parametrize("bh,s,hd,chunk", [
    (2, 64, 16, 16), (1, 128, 32, 32), (3, 96, 64, 16), (1, 32, 8, 32)])
def test_rwkv6_tpu_layout_matches_the_oracle(cuda, bh, s, hd, chunk):
    """The TPU kernel's test cases (``tests/test_kernels.py:78-92``) in its
    layout, against the oracle at the reference test's 2e-4."""
    from repro_torch.kernels import rwkv6_scan as RW
    r, k, v, w, u, _ = _rwkv_in(cuda, (bh, s, 1, hd, bh, False),
                                torch.float32)
    ins = (r[:, :, 0], k[:, :, 0], v[:, :, 0], w[:, :, 0], u[:, 0])
    y, sf = RW.rwkv6_scan_bhsd(*ins)
    yo, so = RW.rwkv6_ref(*ins)
    assert float((y - yo).abs().max()) <= 2e-4
    assert float((sf - so).abs().max()) <= 2e-4


@needs_cuda
def test_rwkv6_kernel_strong_decay(cuda):
    """w = 1e-3 everywhere (``tests/test_kernels.py:95-108``): finite and
    within the limit and the oracle's 2e-4."""
    from repro_torch.kernels import rwkv6_scan as RW
    ins = _rwkv_in(cuda, (1, 64, 1, 16, 1, False), torch.float32,
                   decay=1e-3)
    y, _ = RW.rwkv6_scan(*ins)
    assert bool(torch.isfinite(y).all())
    assert _share(y, RW.rwkv6_scan_plain(*ins)[0],
                  RW.tolerance(*ins)[0]) <= 1.0
    yo, _ = RW.rwkv6_ref(*(t[:, :, 0] for t in ins[:4]), ins[4][:, 0])
    assert float((y[:, :, 0] - yo).abs().max()) <= 2e-4


@needs_cuda
@pytest.mark.parametrize("bh,s,p,n", [(2, 64, 32, 16), (1, 128, 64, 64),
                                      (4, 96, 16, 8)])
def test_ssd_tpu_layout_matches_the_oracle(cuda, bh, s, p, n):
    from repro_torch.kernels import ssd_mamba2 as SSD
    x, dt, a, B, C, _ = _ssd_in(cuda, (bh, s, 1, p, n, bh, False),
                                torch.float32)
    ins = (x[:, :, 0], dt[:, :, 0], a[:, 0], B.contiguous(), C.contiguous())
    y, sf = SSD.ssd_scan_bhsd(*ins)
    yo, so = SSD.ssd_ref(*ins)
    assert float((y - yo).abs().max()) <= 3e-4
    assert float((sf - so).abs().max()) <= 3e-4


def rwkv_faults(RW, ins, got):
    """What a faulty kernel would return: the carried state dropped
    (each chunk scanned from zeros), the bonus u left out, the ragged
    last row not written."""
    r, k, v, w, u, s0 = ins
    L = RW.CHUNK
    per_chunk = torch.cat([RW.rwkv6_scan(
        r[:, c:c + L], k[:, c:c + L], v[:, c:c + L], w[:, c:c + L], u,
        s0 if c == 0 else None)[0] for c in range(0, r.shape[1], L)], 1)
    last = got.clone()
    last[:, -1] = 0
    return {"carried state dropped": per_chunk,
            "bonus u left out": RW.rwkv6_scan(r, k, v, w,
                                              torch.zeros_like(u), s0)[0],
            "ragged last row left out": last}


def ssd_faults(SSD, ins, got):
    """The carried state dropped, the mask's diagonal left out (each row
    without its own input's term), the ragged last row not written."""
    x, dt, a, B, C, s0 = ins
    L = SSD.CHUNK
    per_chunk = torch.cat([SSD.ssd_scan(
        x[:, c:c + L], dt[:, c:c + L], a, B[:, c:c + L], C[:, c:c + L],
        s0 if c == 0 else None)[0] for c in range(0, x.shape[1], L)], 1)
    diag = (C.float() * B.float()).sum(-1)[..., None, None] * \
        dt[..., None] * x.float()
    last = got.clone()
    last[:, -1] = 0
    return {"carried state dropped": per_chunk,
            "mask diagonal dropped": got - diag,
            "ragged last row left out": last}


@needs_cuda
@pytest.mark.parametrize("kind", ["rwkv", "ssd"])
def test_scan_limits_reject_planted_faults_at_the_serve_shapes(cuda, kind):
    from repro_torch.kernels import rwkv6_scan as RW
    from repro_torch.kernels import ssd_mamba2 as SSD
    if kind == "rwkv":
        ins = _rwkv_in(cuda, (32, 1023, 5, 64, 8, True), torch.bfloat16)
        mod, faults = RW, rwkv_faults
        scan, plain = RW.rwkv6_scan, RW.rwkv6_scan_plain
    else:
        ins = _ssd_in(cuda, (32, 1023, 8, 64, 64, 8, True), torch.bfloat16)
        mod, faults = SSD, ssd_faults
        scan, plain = SSD.ssd_scan, SSD.ssd_scan_plain
    got = scan(*ins)[0]
    want = plain(*ins)[0]
    y_lim = mod.tolerance(*ins)[0]
    assert _share(got, want, y_lim) <= 1.0
    for label, bad in faults(mod, ins, got).items():
        assert _share(bad, want, y_lim) > 1.0, label


@needs_cuda
@pytest.mark.parametrize("kind", ["rwkv", "ssd"])
def test_scans_write_the_final_state_in_place(cuda, kind):
    """out_state = s0: the kernel reads each (n, h)'s state before it
    writes it, so the in-place result equals the out-of-place one."""
    from repro_torch.kernels import rwkv6_scan as RW
    from repro_torch.kernels import ssd_mamba2 as SSD
    if kind == "rwkv":
        ins, scan = _rwkv_in(cuda, (8, 70, 5, 64, 2, True),
                             torch.bfloat16), RW.rwkv6_scan
    else:
        ins, scan = _ssd_in(cuda, (8, 70, 8, 64, 64, 2, True),
                            torch.bfloat16), SSD.ssd_scan
    y, sf = scan(*ins)
    st = ins[-1].clone()
    y2, out = scan(*ins[:-1], st, out_state=st)
    assert out is st
    assert torch.equal(y, y2) and torch.equal(sf, st)


@needs_cuda
@pytest.mark.parametrize("kind", ["rwkv", "ssd"])
def test_scans_read_nothing_beyond_s(cuda, kind):
    """Inputs are views of longer buffers whose tail beyond S is NaN: the
    ragged last chunk's masked rows must not leak into y or s_fin."""
    from repro_torch.kernels import rwkv6_scan as RW
    from repro_torch.kernels import ssd_mamba2 as SSD
    s = 45
    if kind == "rwkv":
        full = _rwkv_in(cuda, (4, 64, 3, 64, 2, True), torch.bfloat16)
        scan, idx = RW.rwkv6_scan, [0, 1, 2, 3]          # r, k, v, w
    else:
        full = _ssd_in(cuda, (4, 64, 3, 64, 64, 2, True), torch.bfloat16)
        scan, idx = SSD.ssd_scan, [0, 1, 3, 4]           # x, dt, B, C
    clean = [t[:, :s].contiguous() if i in idx else t
             for i, t in enumerate(full)]
    want = scan(*clean)
    for i in idx:
        full[i][:, s:] = float("nan")
    got = scan(*[t[:, :s] if i in idx else t for i, t in enumerate(full)])
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


@needs_cuda
def test_scans_refuse_what_they_do_not_take(cuda):
    from repro_torch.kernels import rwkv6_scan as RW
    from repro_torch.kernels import ssd_mamba2 as SSD
    r, k, v, w, u, s0 = _rwkv_in(cuda, (2, 5, 1, 16, 1, True),
                                 torch.bfloat16)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        RW.rwkv6_scan(r.half(), k.half(), v.half(), w, u)
    with pytest.raises(ValueError, match="w must be float32"):
        RW.rwkv6_scan(r, k, v, w.bfloat16(), u)
    strided = torch.zeros(*w.shape[:-1], 2 * w.shape[-1],
                          device=cuda)[..., ::2]          # head-dim stride 2
    with pytest.raises(ValueError, match="contiguous head dim"):
        RW.rwkv6_scan(r, k, v, strided, u)
    with pytest.raises(ValueError, match="tensors on"):
        RW.rwkv6_scan(r.cpu(), k, v, w, u)
    x, dt, a, B, C, t0 = _ssd_in(cuda, (2, 5, 1, 16, 8, 1, True),
                                 torch.bfloat16)
    with pytest.raises(ValueError, match="dt must be float32"):
        SSD.ssd_scan(x, dt.bfloat16(), a, B, C)
    with pytest.raises(ValueError, match="contiguous s0"):
        SSD.ssd_scan(x, dt, a, B, C,
                     t0.transpose(2, 3).contiguous().transpose(2, 3))


def _ssm_serve_setup(cuda, arch, tp=2):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.params import init_tree
    cfg = dataclasses.replace(get_config(arch).smoke(), attn_impl="flash",
                              dtype="float32")
    axis = StackedAxis(tp, cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    params = init_tree(lm.model_specs(cfg, tp), gen, axis)
    prompts = torch.randint(0, cfg.vocab_size, (2, 21),
                            generator=torch.Generator().manual_seed(6)
                            ).to(cuda)
    return cfg, axis, params, prompts


@needs_cuda
@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b"])
def test_ssm_serve_on_card_launches_the_kernels_and_matches_the_cpu(
        cuda, monkeypatch, arch):
    """The smoke-size float32 serve on the card goes through the scan
    kernels (the plain versions refuse to run) once per SSM layer and
    token, and through flash attention once per shared block and token;
    its logits equal the CPU serve's on the same weights within 1e-3 of
    their max-norm (float32 in another summation order: cuBLAS and the
    kernels' loops against the CPU's)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rwkv6_scan as RW
    from repro_torch.kernels import ssd_mamba2 as SSD
    from repro_torch.launch import serve as tserve
    from repro_torch.models import lm
    cfg, axis, params, prompts = _ssm_serve_setup(cuda, arch)
    on_cpu = tserve.serve(cfg, StackedAxis(axis.size, "cpu"),
                          _to_cpu(params), prompts.cpu(), 40, 5)

    def refuse(*a, **kw):
        raise AssertionError("the plain version ran on the card")
    for mod, name in ((RW, "rwkv6_scan_plain"), (SSD, "ssd_scan_plain"),
                      (FA, "flash_attention_plain")):
        monkeypatch.setattr(mod, name, refuse)
    kinds = [k for g in lm.stack_plan(cfg) for k in g.unit * g.n_rep]
    before = (RW.rwkv6_scan.launches, SSD.ssd_scan.launches,
              FA.flash_attention.launches)
    on_card = tserve.serve(cfg, axis, params, prompts, 40, 5)
    torch.cuda.synchronize()
    got = (RW.rwkv6_scan.launches - before[0],
           SSD.ssd_scan.launches - before[1],
           FA.flash_attention.launches - before[2])
    assert got == (5 * kinds.count("rwkv"), 5 * kinds.count("mamba"),
                   5 * kinds.count("shared_attn"))
    card_cpu = tserve.ServeResult(
        on_card.tokens.cpu(), [lg.cpu() for lg in on_card.logits],
        on_card.prefill_s, on_card.decode_s, on_card.ctx)
    report = tserve.check_serves(on_cpu, card_cpu, 1e-3)
    assert report["steps"] >= 1


# the persistent wgmma/TMA block matmul and the redesigned RWKV6 scan:
# each test asserts the path its calls took
# ---------------------------------------------------------------------------

# (B, m, k, n): MLP-down, attn-out and the K/V accumulate ring steps of the
# main path at p = 8, and the 512-row K/V cell
BM_MAIN_SHAPES = [(8, 512, 1024, 3072), (8, 512, 384, 3072),
                  (8, 4096, 384, 1024), (8, 512, 384, 1024)]


def _bm_operands(cuda, B, m, k, n, dtype, shared_w, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(B, m, k, generator=g).to(dtype).to(cuda)
    w = (torch.randn(*(() if shared_w else (B,)), k, n, generator=g)
         * k ** -0.5).to(dtype).to(cuda)
    return x, w


def _bm_check(x, w, path="wgmma"):
    before = _paths(cmm.block_matmul)
    got = cmm.block_matmul(x, w)
    torch.cuda.synchronize()
    assert _took(cmm.block_matmul, before) == {path: 1}
    assert got.shape == x.shape[:-1] + (w.shape[-1],)
    assert _mm_err_ok(got, cmm.block_matmul_plain(x, w))
    return got


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,m,k,n", BM_MAIN_SHAPES)
def test_block_matmul_wgmma_at_the_main_path_shapes(cuda, dtype, B, m, k, n):
    x, w = _bm_operands(cuda, B, m, k, n, dtype, False, m + k + n)
    _bm_check(x, w)


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("B,m,k,n,shared_w", [
    (2, 100, 72, 200, False),      # ragged m, n, k (k not a 64-multiple)
    (3, 129, 136, 264, False),
    (1, 1, 8, 8, False),
    (5, 61, 1000, 256, False),
    (3, 130, 72, 136, True),       # shared w, ragged k: no batch bleeds
    (3, 77, 200, 520, True)])
def test_block_matmul_wgmma_ragged_within_vec_ok(cuda, dtype, B, m, k, n,
                                                 shared_w):
    x, w = _bm_operands(cuda, B, m, k, n, dtype, shared_w, B * m + k + n)
    _bm_check(x, w)


@needs_cuda
def test_block_matmul_ragged_k_reads_nothing_of_the_next_batch(cuda):
    """Per-batch w [3, 72, 136] whose K rows beyond 72 would be the next
    batch's: poison every batch but one and the one batch's output must
    not move."""
    x, w = _bm_operands(cuda, 3, 130, 72, 136, torch.bfloat16, False, 5)
    want = _bm_check(x, w)[1]
    x2, w2 = x.clone(), w.clone()
    x2[0], x2[2] = float("nan"), float("nan")
    w2[0], w2[2] = float("nan"), float("nan")
    assert torch.equal(cmm.block_matmul(x2, w2)[1], want)


@needs_cuda
@pytest.mark.parametrize("case", ["128 below", "128 at", "256 below",
                                  "256 at", "256 above", "256 many"])
def test_block_matmul_wgmma_tile_counts_around_the_sm_count(cuda, case):
    """A persistent CTA walks tiles i, i + grid, ...: the producer and the
    consumers must agree at tile counts just below, at and just above
    the SM count, and at many times it (a disagreement hangs, then
    traps), for both tile widths.  x has ``rt`` row tiles (the last one
    ragged) and w 256 columns: two 128-wide or one 256-wide tile each."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    width, rt = {"128 below": (128, sms // 2 - 1), "128 at": (128, sms // 2),
                 "256 below": (256, sms - 1), "256 at": (256, sms),
                 "256 above": (256, sms + 1), "256 many": (256, 9 * sms)}[case]
    x, w = _bm_operands(cuda, 1, 128 * rt - 5, 192, 256, torch.bfloat16,
                        False, rt)
    assert cmm.block_matmul_tile_n(1, 128 * rt - 5, 256) == width
    _bm_check(x, w)


@needs_cuda
def test_block_matmul_tile_width_follows_the_tile_count(cuda):
    """128-wide tiles only where all of them fit in one wave."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for B, m, n in ((8, 512, 3072), (8, 512, 1024), (8, 4096, 1024),
                    (1, 512, 3072), (1, 128, 256)):
        wide = B * (-(-m // 128)) * (-(-n // 256))
        assert cmm.block_matmul_tile_n(B, m, n) == (
            256 if 2 * wide > sms else 128)


@needs_cuda
def test_block_matmul_wgmma_repeats_are_bit_equal(cuda):
    x, w = _bm_operands(cuda, 8, 512, 1024, 3072, torch.bfloat16, False, 23)
    first = _bm_check(x, w)
    before = _paths(cmm.block_matmul)
    for _ in range(49):
        assert torch.equal(cmm.block_matmul(x, w), first)
    assert _took(cmm.block_matmul, before) == {"wgmma": 49}


@needs_cuda
@pytest.mark.parametrize("dtype,k,n,offset,path", [
    (torch.float32, 72, 200, 0, "f32"),
    (torch.bfloat16, 33, 200, 0, "wmma"),      # k % 8 != 0
    (torch.float16, 72, 17, 0, "wmma"),        # n % 8 != 0
    (torch.bfloat16, 72, 200, 1, "wmma")])     # x not 16-byte aligned
def test_block_matmul_keeps_the_tile_kernel_where_tma_cannot(cuda, dtype, k,
                                                             n, offset,
                                                             path):
    x, w = _bm_operands(cuda, 3, 37, k, n, dtype, False, 29)
    if offset:
        buf = torch.empty(x.numel() + offset, dtype=dtype, device=cuda)
        buf[offset:].copy_(x.flatten())
        x = buf[offset:].view(x.shape)
    _bm_check(x, w, path)


@needs_cuda
@pytest.mark.parametrize("s", [1, 2, 31, 32, 33, 1024])
def test_rwkv6_kernel_at_the_serve_shape_for_every_length(cuda, s):
    """N = 32 rows (p = 8 x 4 requests), 5 heads of 64, from a non-zero
    state; S = 1 takes the decode kernel."""
    from repro_torch.kernels import rwkv6_scan as RW
    ins = _rwkv_in(cuda, (32, s, 5, 64, 8, True), torch.bfloat16, seed=s)
    before = _paths(RW.rwkv6_scan)
    y, sf = RW.rwkv6_scan(*ins)
    torch.cuda.synchronize()
    assert _took(RW.rwkv6_scan, before) == {
        "decode" if s == 1 else "chunked": 1}
    want, s_want = RW.rwkv6_scan_plain(*ins)
    y_lim, s_lim = RW.tolerance(*ins)
    assert _share(y, want, y_lim) <= 1.0 and _share(sf, s_want, s_lim) <= 1.0


@needs_cuda
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("s", [1, 75])
def test_rwkv6_kernel_head_dims(cuda, hd, s):
    from repro_torch.kernels import rwkv6_scan as RW
    ins = _rwkv_in(cuda, (6, s, 3, hd, 2, True), torch.bfloat16, seed=hd)
    y, sf = RW.rwkv6_scan(*ins)
    want, s_want = RW.rwkv6_scan_plain(*ins)
    y_lim, s_lim = RW.tolerance(*ins)
    assert _share(y, want, y_lim) <= 1.0 and _share(sf, s_want, s_lim) <= 1.0


@needs_cuda
def test_rwkv6_decode_in_place_carries_the_prefill(cuda):
    """The serve's carry: a prefill writes its state into the cache
    (out_state = s0), decode steps at S = 1 update it in place; each step
    equals the out-of-place call and the plain version within the
    limit."""
    from repro_torch.kernels import rwkv6_scan as RW
    r, k, v, w, u, s0 = _rwkv_in(cuda, (32, 70, 5, 64, 8, True),
                                 torch.bfloat16, seed=3)
    cache = s0.clone()
    RW.rwkv6_scan(r, k, v, w, u, cache, out_state=cache)
    for step in range(3):
        ins = _rwkv_in(cuda, (32, 1, 5, 64, 8, False), torch.bfloat16,
                       seed=10 + step)[:5]
        y_out, s_out = RW.rwkv6_scan(*ins, cache)
        want, s_want = RW.rwkv6_scan_plain(*ins, cache)
        y_lim, s_lim = RW.tolerance(*ins, cache)
        before = _paths(RW.rwkv6_scan)
        y_in, st = RW.rwkv6_scan(*ins, cache, out_state=cache)
        assert _took(RW.rwkv6_scan, before) == {"decode": 1}
        assert st is cache
        assert torch.equal(y_in, y_out) and torch.equal(cache, s_out)
        assert _share(y_in, want, y_lim) <= 1.0
        assert _share(cache, s_want, s_lim) <= 1.0


@needs_cuda
def test_rwkv6_strided_unaligned_inputs_take_scalar_loads(cuda):
    """Views whose strides are not multiples of four channels (hd 40 in
    rows of 43) load element by element and agree with contiguous
    copies."""
    from repro_torch.kernels import rwkv6_scan as RW
    g = torch.Generator(device="cpu").manual_seed(41)
    buf = torch.randn(4, 50, 2, 43, generator=g).to(cuda)
    r, k, v = (buf[..., i:i + 40] for i in range(3))
    w = torch.rand(4, 50, 2, 40, generator=g).to(cuda) * 0.5 + 0.45
    u = torch.randn(2, 2, 40, generator=g).to(cuda)
    got = RW.rwkv6_scan(r, k, v, w, u)
    want = RW.rwkv6_scan(*(t.contiguous() for t in (r, k, v)), w, u)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# the redesigned SSD scan (register-tiled chunk kernel, decode kernel, and
# the general kernel for other shapes): each test asserts the path its
# calls took
# ---------------------------------------------------------------------------


def _ssd_check(SSD, ins, path):
    before = _paths(SSD.ssd_scan)
    y, sf = SSD.ssd_scan(*ins)
    torch.cuda.synchronize()
    assert _took(SSD.ssd_scan, before) == {path: 1}
    want, s_want = SSD.ssd_scan_plain(*ins)
    y_lim, s_lim = SSD.tolerance(*ins)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(sf).all())
    assert _share(y, want, y_lim) <= 1.0 and _share(sf, s_want, s_lim) <= 1.0
    return y, sf


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 2, 63, 64, 65, 1023, 1024])
def test_ssd_kernel_at_the_serve_shape_for_every_length(cuda, dtype, s):
    """N = 32 rows (p = 8 x 4 requests), 8 heads of 64, state 64, from a
    non-zero state; S = 1 takes the decode kernel, longer the chunked
    one."""
    from repro_torch.kernels import ssd_mamba2 as SSD
    ins = _ssd_in(cuda, (32, s, 8, 64, 64, 8, True), dtype, seed=s)
    _ssd_check(SSD, ins, "decode" if s == 1 else "chunked")


@needs_cuda
def test_ssd_decode_in_place_carries_the_prefill(cuda):
    """The serve's carry: a prefill writes its state into the cache
    (out_state = s0), decode steps at S = 1 update it in place; each step
    equals the out-of-place call and the plain version within the
    limit."""
    from repro_torch.kernels import ssd_mamba2 as SSD
    x, dt, a, B, C, s0 = _ssd_in(cuda, (32, 70, 8, 64, 64, 8, True),
                                 torch.bfloat16, seed=3)
    cache = s0.clone()
    before = _paths(SSD.ssd_scan)
    SSD.ssd_scan(x, dt, a, B, C, cache, out_state=cache)
    assert _took(SSD.ssd_scan, before) == {"chunked": 1}
    for step in range(4):
        ins = _ssd_in(cuda, (32, 1, 8, 64, 64, 8, False), torch.bfloat16,
                      seed=10 + step)[:5]
        y_out, s_out = SSD.ssd_scan(*ins, cache)
        want, s_want = SSD.ssd_scan_plain(*ins, cache)
        y_lim, s_lim = SSD.tolerance(*ins, cache)
        before = _paths(SSD.ssd_scan)
        y_in, st = SSD.ssd_scan(*ins, cache, out_state=cache)
        assert _took(SSD.ssd_scan, before) == {"decode": 1}
        assert st is cache
        assert torch.equal(y_in, y_out) and torch.equal(cache, s_out)
        assert _share(y_in, want, y_lim) <= 1.0
        assert _share(cache, s_want, s_lim) <= 1.0


@needs_cuda
@pytest.mark.parametrize("s", [1, 130])
@pytest.mark.parametrize("offset,row", [(1, 128), (0, 130), (0, 129)])
def test_ssd_misaligned_bc_views_take_the_general_path(cuda, s, offset,
                                                       row):
    """B and C as views whose rows the 16-byte loads cannot take (a base
    pointer one element off, row strides of 130 and 129 bf16) take the
    general kernel, within the limit; the same values in aligned rows take
    the new kernels."""
    from repro_torch.kernels import ssd_mamba2 as SSD
    x, dt, a, B, C, s0 = _ssd_in(cuda, (8, s, 8, 64, 64, 2, True),
                                 torch.bfloat16, seed=row + offset)
    buf = torch.empty(8 * s * row + offset + 128, dtype=torch.bfloat16,
                      device=cuda)
    bc = buf[offset:offset + 8 * s * row].view(8, s, row)
    bc[..., :64], bc[..., 64:128] = B, C
    Bm, Cm = bc[..., :64], bc[..., 64:128]
    assert not SSD._vec_ok(x, Bm, Cm, s0)
    _ssd_check(SSD, (x, dt, a, Bm, Cm, s0), "general")
    _ssd_check(SSD, (x, dt, a, B, C, s0), "decode" if s == 1 else "chunked")


@needs_cuda
@pytest.mark.parametrize("h", [3, 5])
@pytest.mark.parametrize("s", [1, 130])
def test_ssd_kernel_head_counts(cuda, h, s):
    """H not a multiple of a head group, a shared by groups of rows."""
    from repro_torch.kernels import ssd_mamba2 as SSD
    ins = _ssd_in(cuda, (6, s, h, 64, 64, 3, True), torch.bfloat16,
                  seed=h + s)
    _ssd_check(SSD, ins, "decode" if s == 1 else "chunked")


@needs_cuda
@pytest.mark.parametrize("n,h", [(33, 2), (66, 2), (131, 1), (133, 1),
                                 (33, 8)])
def test_ssd_kernel_cta_counts_around_the_sm_count(cuda, n, h):
    """N x H chunk CTAs (one per (n, h)) from half the SM count to twice
    it: every CTA scheduled, every result within the limit."""
    from repro_torch.kernels import ssd_mamba2 as SSD
    ins = _ssd_in(cuda, (n, 70, h, 64, 64, 1, True), torch.bfloat16,
                  seed=n * h)
    _ssd_check(SSD, ins, "chunked")


@needs_cuda
@pytest.mark.parametrize("bh,s,p,n", [(2, 64, 32, 16), (4, 96, 16, 8),
                                      (3, 130, 24, 40)])
def test_ssd_general_path_at_the_tpu_test_shapes(cuda, bh, s, p, n):
    """The TPU kernel's test shapes (and the ragged P 24, Ns 40) take the
    general kernel, within the limit and the oracle's 3e-4."""
    from repro_torch.kernels import ssd_mamba2 as SSD
    x, dt, a, B, C, _ = _ssd_in(cuda, (bh, s, 1, p, n, bh, False),
                                torch.float32, seed=bh + s)
    _ssd_check(SSD, (x, dt, a, B, C, None), "general")
    ins = (x[:, :, 0], dt[:, :, 0], a[:, 0], B.contiguous(), C.contiguous())
    y, sf = SSD.ssd_scan_bhsd(*ins)
    yo, so = SSD.ssd_ref(*ins)
    assert float((y - yo).abs().max()) <= 3e-4
    assert float((sf - so).abs().max()) <= 3e-4


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 45, 64, 100])
def test_ssd_kernels_read_nothing_beyond_s(cuda, dtype, s):
    """x, dt, B and C are views of longer buffers whose tail beyond S is
    NaN: neither new kernel reads a row past S."""
    from repro_torch.kernels import ssd_mamba2 as SSD
    full = list(_ssd_in(cuda, (4, 128, 3, 64, 64, 2, True), dtype,
                        seed=s))
    idx = [0, 1, 3, 4]                                   # x, dt, B, C
    clean = [t[:, :s].contiguous() if i in idx else t
             for i, t in enumerate(full)]
    want = SSD.ssd_scan(*clean)
    for i in idx:
        full[i][:, s:] = float("nan")
    before = _paths(SSD.ssd_scan)
    got = SSD.ssd_scan(*[t[:, :s] if i in idx else t
                         for i, t in enumerate(full)])
    assert _took(SSD.ssd_scan, before) == {
        "decode" if s == 1 else "chunked": 1}
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# the backward through the fused rings (dist.ops' autograd Functions)
# ---------------------------------------------------------------------------


@needs_cuda
@pytest.mark.parametrize("op", ["col_matmul_fsdp0", "row_matmul_fsdp1"])
def test_forced_ring_gradients_match_the_default_on_the_card(cuda, op):
    """One forward and backward of an FSDP matmul over p = 4 stacked data
    ranks, bf16, with the fused rings forced against the defaults: the
    backward's matmul_reducescatter runs ``block_matmul`` on the card
    (its launch count rises during the backward, which autograd runs on
    its own thread) and is recorded under ``bwd``.  Gradients within p
    rounding steps (``p * 2**-7``) of their magnitude."""
    from repro_torch.dist import axes, ops
    p = 4
    g = torch.Generator(device="cpu").manual_seed(19)
    if op == "col_matmul_fsdp0":     # x [.., K=256], w [K/p, 128]
        x = torch.randn(p, 2, 64, 256, generator=g)
        w = torch.randn(p, 64, 128, generator=g) * 0.1
        fn = lambda a, b: ops.col_matmul(a, b, fsdp_dim=0)     # noqa: E731
    else:                            # x [.., K=128], w [K, M/p=64]
        x = torch.randn(p, 2, 64, 128, generator=g)
        w = torch.randn(p, 128, 64, generator=g) * 0.1
        fn = lambda a, b: ops.row_matmul(a, b, fsdp_dim=1)     # noqa: E731
    x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    force = {"allgather_matmul": "fused_ring",
             "matmul_reducescatter": "fused_ring",
             "matmul_accumulate": "fused_ring"}
    out = {}
    for label, f in (("default", None), ("forced", force)):
        xt = x.to(cuda).requires_grad_(True)
        wt = w.to(cuda).requires_grad_(True)
        with axes.bind(data=StackedAxis(p, cuda)), api.tuned(
                force=f or {}) as ctx:
            y = fn(xt, wt)
            before = cmm.block_matmul.launches
            (y.float() * 0.01).sum().backward()
            torch.cuda.synchronize()
            launched = cmm.block_matmul.launches - before
        out[label] = (y.detach().float(), xt.grad.float(), wt.grad.float(),
                      launched, [(r.cell.op, r.impl, r.phase)
                                 for r in ctx.record])
    assert out["default"][3] == 0 and out["forced"][3] > 0
    assert ("matmul_reducescatter", "fused_ring", "bwd") in out["forced"][4]
    for a, b in zip(out["forced"][:3], out["default"][:3]):
        assert float((a - b).abs().max()) <= p * 2 ** -7 * float(
            b.abs().max())


# ---------------------------------------------------------------------------
# the 2-D ring (fused_ring2d) on a (data 2, model 4) stacked mesh, at the
# data x model training step's row-parallel sites of llama3.2-3b: w_o (x
# [2048, 768] a lane against w [768, 1536]) and MLP-down (x [2048, 2048]
# against w [2048, 1536]); every chunk product is one block_matmul launch
# ---------------------------------------------------------------------------

RING2D_SITES = {"w_o": 768, "mlp-down": 2048}
D2, Q2, T2, M2 = 2, 4, 2048, 3072


def _mesh24(cuda):
    from repro_torch.core._axis import StackedMesh
    return StackedMesh((D2, Q2), ("data", "model"), cuda)


def _ring2d_tol(want: torch.Tensor, parts: int) -> float:
    """bf16: the ring adds ``parts`` partial products in bf16 where the
    default composition rounds once, one rounding step (2**-8) each, plus
    the output's own step."""
    return (parts + 1) * 2.0 ** -8 * max(1.0, float(want.float().abs().max()))


@needs_cuda
@pytest.mark.parametrize("site", list(RING2D_SITES))
def test_fused_ring2d_matches_default_and_the_cpu_on_the_card(cuda, site):
    from repro_torch.core import collectives as C
    from repro_torch.core._axis import StackedMesh
    k = RING2D_SITES[site]
    m = _mesh24(cuda)
    g = torch.Generator(device="cpu").manual_seed(k)
    x = torch.randn(D2 * Q2, T2, k, generator=g).to(torch.bfloat16)
    w = (torch.randn(D2 * Q2, k, M2 // D2, generator=g)
         * (Q2 * k) ** -0.5).to(torch.bfloat16)
    fns = C.REGISTRY["matmul_reducescatter_2d"]
    before = dict(cmm.block_matmul.launches_by_path)
    got = fns["fused_ring2d"].fn(w.to(cuda), m["data"], x=x.to(cuda),
                                 rs_axis=m["model"])
    torch.cuda.synchronize()
    launched = {p: n - before[p] for p, n in
                cmm.block_matmul.launches_by_path.items()}
    assert launched == {"f32": 0, "wmma": 0, "wgmma": D2 * Q2}
    want = fns["default"].fn(w.to(cuda), m["data"], x=x.to(cuda),
                             rs_axis=m["model"])
    assert got.shape == want.shape == (D2 * Q2, T2 // Q2, M2)
    err = float((got.float() - want.float()).abs().max())
    assert err <= _ring2d_tol(want, Q2), err
    # the port's CPU result, in float32
    mc = StackedMesh((D2, Q2), ("data", "model"), "cpu")
    cpu = fns["fused_ring2d"].fn(w.float(), mc["data"], x=x.float(),
                                 rs_axis=mc["model"])
    err = float((got.float().cpu() - cpu).abs().max())
    assert err <= _ring2d_tol(cpu, Q2), err


@needs_cuda
@pytest.mark.parametrize("site", list(RING2D_SITES))
def test_fused_ring2d_transpose_matches_default_and_the_cpu_on_the_card(
        cuda, site):
    """The dw schedule of the site: the cotangent's model-axis row block
    g [512, 3072] streamed over model (the gather axis), the accumulator
    over data (the scatter axis) -> [1536, K]."""
    from repro_torch.core import collectives as C
    from repro_torch.core._axis import StackedMesh
    k = RING2D_SITES[site]
    m = _mesh24(cuda)
    g = torch.Generator(device="cpu").manual_seed(k + 1)
    gs = torch.randn(D2 * Q2, T2 // Q2, M2, generator=g).to(torch.bfloat16)
    x = torch.randn(D2 * Q2, T2, k, generator=g).to(torch.bfloat16)
    fns = C.REGISTRY["matmul_reducescatter_2d"]
    before = dict(cmm.block_matmul.launches_by_path)
    got = fns["fused_ring2d"].fn(gs.to(cuda), m["model"], x=x.to(cuda),
                                 rs_axis=m["data"], xpose=True)
    torch.cuda.synchronize()
    launched = {p: n - before[p] for p, n in
                cmm.block_matmul.launches_by_path.items()}
    assert launched == {"f32": 0, "wmma": 0, "wgmma": D2 * Q2}
    want = fns["default"].fn(gs.to(cuda), m["model"], x=x.to(cuda),
                             rs_axis=m["data"], xpose=True)
    assert got.shape == want.shape == (D2 * Q2, M2 // D2, k)
    err = float((got.float() - want.float()).abs().max())
    assert err <= _ring2d_tol(want, D2 * Q2), err
    mc = StackedMesh((D2, Q2), ("data", "model"), "cpu")
    cpu = fns["fused_ring2d"].fn(gs.float(), mc["model"], x=x.float(),
                                 rs_axis=mc["data"], xpose=True)
    err = float((got.float().cpu() - cpu).abs().max())
    assert err <= _ring2d_tol(cpu, D2 * Q2), err


@needs_cuda
@pytest.mark.parametrize("shape", [
    (8, 512, 768, 1536), (8, 512, 2048, 1536),       # forward chunks
    (8, 1536, 512, 768), (8, 1536, 512, 2048)])      # transpose chunks
def test_block_matmul_at_the_ring2d_chunks_takes_wgmma(cuda, shape):
    B, mm, k, n = shape
    g = torch.Generator(device="cpu").manual_seed(mm + k + n)
    x = torch.randn(B, mm, k, generator=g).to(torch.bfloat16).to(cuda)
    w = (torch.randn(B, k, n, generator=g) * k ** -0.5).to(
        torch.bfloat16).to(cuda)
    before = dict(cmm.block_matmul.launches_by_path)
    got = cmm.block_matmul(x, w)
    torch.cuda.synchronize()
    assert cmm.block_matmul.launches_by_path["wgmma"] == before["wgmma"] + 1
    want = cmm.block_matmul_plain(x, w)
    err = float((got.float() - want.float()).abs().max())
    assert err <= 2.0 ** -7 * max(1.0, float(want.float().abs().max()))


@needs_cuda
def test_selfcheck_two_axis_run_on_card(cuda):
    rep = selfcheck.run_mesh((2, 4), cuda)
    assert rep["failures"] == [] and rep["impls"] == 64


@needs_cuda
def test_embedding_backward_is_float32_exact_on_the_card(cuda):
    """The bf16 table's gradient under Zipf ids (a row repeated thousands
    of times) is within one bf16 unit in the last place of the exact sum,
    twice over: the rows are summed in float32 before one rounding."""
    rng = np.random.default_rng(11)
    n, d, v = 16384, 256, 1024
    rows = torch.as_tensor(rng.zipf(1.3, n) % v).to(cuda)
    g = torch.as_tensor(rng.normal(size=(n, d))).to(torch.bfloat16).to(cuda)
    want = torch.zeros(v, d, dtype=torch.float64, device=cuda).index_add_(
        0, rows, g.double())
    ulp = torch.finfo(torch.bfloat16).eps * want.abs()
    for _ in range(2):
        table = torch.zeros(v, d, dtype=torch.bfloat16, device=cuda,
                            requires_grad=True)
        _TakeRows.apply(table, rows).backward(g)
        assert bool(((table.grad.double() - want).abs() <= ulp).all())


# ---------------------------------------------------------------------------
# training through the kernels: the autograd Functions (forward on the
# kernel, backward through the plain version under autograd)
# ---------------------------------------------------------------------------


def _grads_close(got, want, rtol=1e-5):
    """Each gradient within ``rtol`` of its max-norm: both sides
    differentiate the same plain version on the card, with the same
    cotangent."""
    for a, b in zip(got, want):
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
        err = float((a.float() - b.float()).abs().max())
        assert err <= rtol * float(b.float().abs().max()) + 1e-30


def _plain_autograd(fn, ins, g):
    xs = [t.detach().clone().requires_grad_(True) for t in ins]
    return torch.autograd.grad(fn(*xs), xs, g)


@needs_cuda
@pytest.mark.parametrize("dtype,case,path", [
    (torch.bfloat16, (2, 128, 128, 2, 2, 128, True, 0, 0.0, 0, None),
     "wgmma"),
    (torch.bfloat16, (2, 40, 40, 1, 3, 32, True, 16, 0.0, 0, None),
     "mma_sync"),
    (torch.float32, (2, 33, 33, 2, 2, 16, True, 0, 20.0, 0, None), "f32")])
def test_flash_function_launches_the_kernel_and_grads_match(cuda, dtype,
                                                             case, path):
    from repro_torch.kernels import flash_attention as FA
    q, k, v = (t.requires_grad_(True) for t in _flash_inputs(cuda, case,
                                                              dtype))
    args = case[6:]
    kw = dict(zip(("causal", "window", "softcap", "q0", "kv_len"), args))
    before = _paths(FA.flash_attention)
    y = FA.FlashAttention.apply(q, k, v, *args)
    torch.cuda.synchronize()
    assert _took(FA.flash_attention, before) == {path: 1}
    assert _within_limit(FA, y.detach(), q.detach(), k.detach(), v.detach(),
                         **kw)
    g = torch.randn_like(y)
    got = torch.autograd.grad(y, (q, k, v), g)
    want = _plain_autograd(lambda *t: FA.flash_attention_plain(*t, **kw),
                           (q, k, v), g)
    _grads_close(got, want)


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_function_launches_the_kernel_and_grads_match(cuda, dtype):
    from repro_torch.kernels import rwkv6_scan as RW
    gen = torch.Generator(device="cpu").manual_seed(21)
    n, s, h, hd = 4, 100, 2, 64
    r, k, v = ((torch.randn(n, s, h, hd, generator=gen) * 0.5).to(dtype)
               .to(cuda).requires_grad_(True) for _ in range(3))
    dec = torch.randn(n, s, h, hd, generator=gen) * 0.5
    dec[..., ::2] += 5.0                  # decays that underflow to 0
    logw = (-torch.exp(dec)).to(cuda).requires_grad_(True)
    u = (torch.randn(2, h, hd, generator=gen) * 0.5).to(cuda)
    u.requires_grad_(True)
    before = dict(RW.rwkv6_scan.launches_by_path)
    y = RW.RWKV6Scan.apply(r, k, v, logw, u)
    torch.cuda.synchronize()
    assert RW.rwkv6_scan.launches_by_path["chunked"] == before["chunked"] + 1
    ins = [t.detach() for t in (r, k, v, logw, u)]
    want_y, _ = RW.rwkv6_scan_plain_log(*ins)
    y_lim, _ = RW.tolerance(*ins[:3], torch.exp(ins[3]), ins[4])
    assert bool(((y.detach() - want_y).abs() <= y_lim).all())
    g = torch.randn_like(y)
    got = torch.autograd.grad(y, (r, k, v, logw, u), g)
    want = _plain_autograd(lambda *t: RW.rwkv6_scan_plain_log(*t)[0],
                           (r, k, v, logw, u), g)
    _grads_close(got, want)


@needs_cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_function_launches_the_kernel_and_grads_match(cuda, dtype):
    from repro_torch.kernels import ssd_mamba2 as SSD
    gen = torch.Generator(device="cpu").manual_seed(22)
    n, s, h, p, ns = 4, 130, 2, 64, 64
    x = torch.randn(n, s, h, p, generator=gen).to(dtype).to(cuda)
    bc = torch.randn(n, s, 2 * ns, generator=gen).to(dtype).to(cuda)
    dt = torch.nn.functional.softplus(torch.randn(n, s, h, generator=gen))
    a = torch.exp(torch.randn(2, h, generator=gen) * 0.5)
    x, bc, dt, a = (t.to(cuda).requires_grad_(True) for t in (x, bc, dt, a))
    before = dict(SSD.ssd_scan.launches_by_path)
    y = SSD.SSDScan.apply(x, dt, a, bc[..., :ns], bc[..., ns:])
    torch.cuda.synchronize()
    assert SSD.ssd_scan.launches_by_path["chunked"] == before["chunked"] + 1
    ins = [t.detach() for t in (x, dt, a)] + [bc.detach()[..., :ns],
                                              bc.detach()[..., ns:]]
    want_y, _ = SSD.ssd_scan_plain(*ins)
    y_lim, _ = SSD.tolerance(*ins)
    assert bool(((y.detach() - want_y).abs() <= y_lim).all())
    g = torch.randn_like(y)
    got = torch.autograd.grad(y, (x, dt, a, bc), g)

    def plain(x_, dt_, a_, bc_):
        return SSD.ssd_scan_plain(x_, dt_, a_, bc_[..., :ns],
                                  bc_[..., ns:])[0]
    _grads_close(got, _plain_autograd(plain, (x, dt, a, bc), g))


@needs_cuda
@pytest.mark.parametrize("arch,kernel", [
    ("llama3.2-3b", "flash_attention"), ("rwkv6-3b", "rwkv6_scan"),
    ("zamba2-1.2b", "ssd_scan")])
def test_training_step_goes_through_the_kernels(cuda, arch, kernel):
    """A float32 smoke model's gradients on the card (TP 2 stacked): the
    kernel launches inside the step, and the gradients match the same
    step on the CPU (plain versions), max-norm relative 1e-3 a leaf
    (summation order over 4 layers)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import rwkv6_scan as RW
    from repro_torch.kernels import ssd_mamba2 as SSD
    from repro_torch.models.params import tree_leaves, tree_unflatten
    from repro_torch.train import Trainer
    wrapper = {"flash_attention": FA.flash_attention,
               "rwkv6_scan": RW.rwkv6_scan, "ssd_scan": SSD.ssd_scan}[kernel]
    cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32",
                              attn_impl="flash")
    batch = make_batch(cfg, 2, 64, 0)
    card = Trainer(cfg, mesh=(1, 2), device=cuda)
    params, _ = card.init(0)
    before = wrapper.launches
    l0, g0 = card.grads(params, card.put_batch(batch))
    torch.cuda.synchronize()
    assert wrapper.launches > before
    host = Trainer(cfg, mesh=(1, 2), device="cpu")
    l1, g1 = host.grads(tree_unflatten(params, [
        t.cpu() for t in tree_leaves(params)]), host.put_batch(batch))
    assert float(l0) == pytest.approx(float(l1), rel=1e-4)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        err = float((a.float().cpu() - b.float()).abs().max())
        assert err <= 1e-3 * float(b.float().abs().max()) + 1e-12


# ---------------------------------------------------------------------------
# Mixture-of-Experts: models.moe and dist.ops.ep_alltoall on the card
# ---------------------------------------------------------------------------


def _moe_setup(dtype, tp=4, cf=0.75):
    """A phi3.5-shaped MoE block at small widths (d_model 256, 8 experts
    of 128, top-2; a capacity factor that drops choices), weights drawn on
    the CPU from a seed and stacked for ``StackedAxis(tp)``."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.params import init_tree

    base = get_config("phi3.5-moe-42b-a6.6b")
    cfg = dataclasses.replace(
        base, d_model=256, dtype=dtype,
        moe=dataclasses.replace(base.moe, n_experts=8, d_ff_expert=128,
                                capacity_factor=cf))
    cpu = StackedAxis(tp, "cpu")
    gen = torch.Generator(device="cpu").manual_seed(22)
    params = init_tree(moe.moe_specs(cfg), gen, cpu)
    with torch.no_grad():
        params["router"].mul_(8.0)           # decisive routes
    x = torch.randn(1, 4, 64, cfg.d_model, generator=gen).to(
        getattr(torch, dtype)).expand(tp, 4, 64, cfg.d_model)
    return cfg, params, x


def _moe_run(cfg, params, x, axis):
    from repro_torch.dist.axes import bind
    from repro_torch.models import moe
    with bind(model=axis):
        xt = x.reshape(x.shape[0], -1, x.shape[-1])
        _, _, ids = moe._route(params, cfg, xt)
        y, aux = moe.moe_block(params, cfg, x)
    return ids, y, aux


@needs_cuda
def test_moe_block_on_the_card_matches_the_cpu(cuda):
    """float32, the same weights: the same expert ids, then outputs within
    1e-5 of their max-norm (summation order only) and the same aux."""
    cfg, params, x = _moe_setup("float32")
    ids_c, y_c, aux_c = _moe_run(cfg, params, x, StackedAxis(4, "cpu"))
    on = {k: v.to(cuda) for k, v in params.items()}
    ids_g, y_g, aux_g = _moe_run(cfg, on, x.to(cuda), StackedAxis(4, cuda))
    assert torch.equal(ids_g.cpu(), ids_c)
    err = (y_g.cpu() - y_c).abs().max() / y_c.abs().max()
    assert float(err) <= 1e-5, float(err)
    torch.testing.assert_close(aux_g.cpu(), aux_c, rtol=1e-5, atol=0)


@needs_cuda
def test_moe_block_default_calls_are_bit_equal_on_the_card(cuda):
    """The dispatch scatter writes each kept row once (only the cut-off
    drop bin repeats), so two calls agree bit for bit."""
    cfg, params, x = _moe_setup("bfloat16")
    on = {k: v.to(cuda) for k, v in params.items()}
    axis = StackedAxis(4, cuda)
    a = _moe_run(cfg, on, x.to(cuda), axis)[1]
    b = _moe_run(cfg, on, x.to(cuda), axis)[1]
    assert torch.equal(a, b)


@needs_cuda
@pytest.mark.parametrize("impl", ["default", "alltoall_as_alltoallv",
                                  "alltoall_as_ppermute"])
def test_ep_alltoall_forced_impls_equal_the_default_on_the_card(cuda, impl):
    from repro_torch.dist import ops
    from repro_torch.dist.axes import bind
    g = torch.Generator(device="cpu").manual_seed(3)
    x = torch.randn(8, 8 * 80, 512, generator=g).to(torch.bfloat16).to(cuda)
    axis = StackedAxis(8, cuda)
    with bind(model=axis):
        want = ops.ep_alltoall(x)
        with api.tuned(force={"alltoall": impl}) as ctx:
            got = ops.ep_alltoall(x)
    assert [r.impl for r in ctx.record] == [impl]
    assert torch.equal(got, want)
    # and the whole block under the forced impl
    cfg, params, xm = _moe_setup("bfloat16")
    on = {k: v.to(cuda) for k, v in params.items()}
    ax4 = StackedAxis(4, cuda)
    base = _moe_run(cfg, on, xm.to(cuda), ax4)[1]
    with api.tuned(force={"alltoall": impl}):
        forced = _moe_run(cfg, on, xm.to(cuda), ax4)[1]
    assert torch.equal(forced, base)
