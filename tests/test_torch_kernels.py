"""The port's kernels: plain versions against the reference's Pallas
kernels in interpret mode, and the matmul-reducescatter ring against the
reference ring.  The kernels themselves run in ``test_torch_cuda.py``.

Tolerances: placement is a copy, so ``guideline_pack`` is exact.  Both
matmuls accumulate in float32; float32 is held to the reference test's
2e-4, and a bfloat16 output, rounded once from float32 sums taken in a
different tile order, to one bfloat16 step (``2**-7`` relative).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ref import StackedAxis, ref_vmap, to_np

from repro.core import collectives as RC
from repro.kernels.collective_matmul import pallas_matmul
from repro.kernels.collective_matmul import \
    ring_matmul_reducescatter as ref_ring
from repro.kernels.pack import guideline_pack as ref_pack
from repro_torch.core import collectives as TC
from repro_torch.kernels import collective_matmul as cmm
from repro_torch.kernels.pack import guideline_pack

# ---------------------------------------------------------------------------
# guideline_pack (cases of tests/test_kernels.py)
# ---------------------------------------------------------------------------


def _pack_port(x: np.ndarray, idx: int, p: int, dtype=None) -> np.ndarray:
    t = torch.from_numpy(x)
    if dtype is not None:
        t = t.to(dtype)
    out = guideline_pack(t, torch.tensor([idx], dtype=torch.int32), p)
    return to_np(out.unsqueeze(0))[0]


@pytest.mark.parametrize("n,p,idx", [(1, 1, 0), (3, 2, 1), (16, 8, 7),
                                     (5, 4, 0), (7, 3, 2), (2, 8, 3)])
def test_pack_matches_reference(n, p, idx):
    x = np.arange(n * 4, dtype=np.float32).reshape(n, 4) + 1
    ref = np.asarray(ref_pack(jnp.asarray(x), idx, p, interpret=True))
    got = _pack_port(x, idx, p)
    assert got.shape == (p * n, 4)
    np.testing.assert_array_equal(got, ref)
    assert got.sum() == pytest.approx(x.sum(), rel=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_pack_dtypes(dtype):
    x = np.ones((8, 16), np.float32)
    ref = ref_pack(jnp.asarray(x, getattr(jnp, dtype)), 2, 4, interpret=True)
    got = guideline_pack(torch.from_numpy(x).to(getattr(torch, dtype)),
                         torch.tensor([2], dtype=torch.int32), 4)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(to_np(got.unsqueeze(0))[0],
                                  np.asarray(ref, np.float32))


def test_pack_int8_signed_values():
    rng = np.random.default_rng(5)
    x = rng.integers(-128, 128, size=(8, 16)).astype(np.int8)
    for idx in range(4):
        ref = np.asarray(ref_pack(jnp.asarray(x), idx, 4, interpret=True))
        got = guideline_pack(torch.from_numpy(x),
                             torch.tensor([idx], dtype=torch.int32), 4)
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("n,d,p,idx", [(5, 7, 3, 2), (1, 1, 7, 6),
                                       (13, 3, 5, 0)])
def test_pack_non_divisible_shapes(n, d, p, idx):
    x = np.random.default_rng(6).normal(size=(n, d)).astype(np.float32)
    ref = np.asarray(ref_pack(jnp.asarray(x), idx, p, interpret=True))
    np.testing.assert_array_equal(_pack_port(x, idx, p), ref)


def test_pack_batched_lanes_match_per_lane_reference():
    """R > 1: each lane r is placed at its own ``idx[r]``."""
    rng = np.random.default_rng(7)
    R, n, d, p = 5, 3, 4, 6
    x = rng.normal(size=(R, n, d)).astype(np.float32)
    idx = np.array([0, 5, 2, 2, 4], np.int32)
    got = guideline_pack(torch.from_numpy(x), torch.from_numpy(idx), p)
    for r in range(R):
        ref = ref_pack(jnp.asarray(x[r]), int(idx[r]), p, interpret=True)
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(ref))


def test_pack_checks_its_arguments():
    x = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="int32"):
        guideline_pack(x, torch.tensor([0, 1]), 4)
    with pytest.raises(ValueError, match="shape"):
        guideline_pack(x, torch.tensor([0], dtype=torch.int32), 4)
    with pytest.raises(ValueError, match="takes"):
        guideline_pack(torch.zeros(3), torch.tensor([0], dtype=torch.int32), 2)


@pytest.mark.parametrize("p", [3, 4])
def test_one_hot_place_of_a_rank3_payload(p):
    """``_one_hot_place`` flattens trailing dims to ``[n, prod(rest)]`` for
    the kernel and restores them."""
    x = np.random.default_rng(8).normal(size=(p, 2, 3, 2)).astype(np.float32)
    ref = ref_vmap(lambda a, ax: RC._one_hot_place(a, ax), x)
    got = TC._one_hot_place(torch.from_numpy(x), StackedAxis(p, device="cpu"))
    np.testing.assert_array_equal(to_np(got), ref)


# ---------------------------------------------------------------------------
# block matmul (cases of tests/test_collective_matmul.py)
# ---------------------------------------------------------------------------

SHAPES = [(128, 128, 128), (192, 64, 96), (100, 33, 17), (5, 256, 128)]


def _mm_tol(dtype, ref):
    if dtype == "float32":
        return 2e-4
    return 2.0 ** -7 * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_block_matmul_plain_matches_pallas_interpret(dtype, m, k, n):
    rng = np.random.default_rng(m + k + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    ref = pallas_matmul(jnp.asarray(x, getattr(jnp, dtype)),
                        jnp.asarray(w, getattr(jnp, dtype)),
                        bm=64, bn=64, bk=64, interpret=True)
    got = cmm.block_matmul(torch.from_numpy(x).to(getattr(torch, dtype)),
                           torch.from_numpy(w).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(to_np(got.unsqueeze(0))[0], ref, rtol=0,
                               atol=_mm_tol(dtype, ref))


def test_block_matmul_batched_and_shared_weight():
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.normal(size=(3, 7, 5)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 5, 4)).astype(np.float32))
    got = cmm.block_matmul(x, w)
    for b in range(3):
        np.testing.assert_allclose(got[b].numpy(), (x[b] @ w[b]).numpy(),
                                   atol=1e-5)
    shared = cmm.block_matmul(x, w[0])
    np.testing.assert_allclose(shared.numpy(), (x @ w[0]).numpy(), atol=1e-5)


def test_block_matmul_promotes_like_the_reference():
    x = torch.ones(2, 3, dtype=torch.bfloat16)
    w = torch.ones(3, 4, dtype=torch.float32)
    assert cmm.block_matmul(x, w).dtype == torch.float32


@pytest.mark.parametrize("p", [4, 8])
@pytest.mark.parametrize("n,k,m", [(4, 8, 6), (3, 5, 2)])
@pytest.mark.parametrize("mm", ["matmul", "kernel"])
def test_ring_matmul_reducescatter_matches_reference(p, n, k, m, mm):
    """Port ``mm="matmul"`` against the reference's ``"jnp"``, port
    ``"kernel"`` (the plain version on the CPU) against ``"pallas"`` in
    interpret mode; integer-valued float32, so exact."""
    rng = np.random.default_rng(10 + p)
    x = rng.integers(-6, 7, size=(p, p * n, k)).astype(np.float32)
    w = rng.integers(-3, 4, size=(k, m)).astype(np.float32)
    ref_mm = {"matmul": "jnp", "kernel": "pallas"}[mm]
    ref = ref_vmap(lambda a, ax: ref_ring(a, jnp.asarray(w), ax, mm=ref_mm),
                   x)
    got = cmm.ring_matmul_reducescatter(
        torch.from_numpy(x), torch.from_numpy(w),
        StackedAxis(p, device="cpu"), mm=mm)
    np.testing.assert_array_equal(to_np(got), ref)
    np.testing.assert_array_equal(
        to_np(got), (x @ w).sum(0).reshape(p, n, m))


def test_local_mm_auto_takes_torch_matmul_on_the_cpu():
    x = torch.randn(2, 3, dtype=torch.bfloat16)
    w = torch.randn(3, 4, dtype=torch.bfloat16)
    np.testing.assert_array_equal(
        cmm._local_mm(x, w, "auto").float().numpy(),
        torch.matmul(x, w).float().numpy())
    with pytest.raises(ValueError, match="unknown mm"):
        cmm._local_mm(x, w, "pallas")


def test_block_matmul_on_the_cpu_counts_no_kernel_path():
    """CPU tensors take the plain version: neither the launch count nor
    a path count moves (the C source picks the path only on the card)."""
    before = (cmm.block_matmul.launches, dict(cmm.block_matmul.launches_by_path))
    x = torch.randn(3, 5, 8, dtype=torch.bfloat16)
    w = torch.randn(8, 16, dtype=torch.bfloat16)
    np.testing.assert_array_equal(
        cmm.block_matmul(x, w).float().numpy(),
        cmm.block_matmul_plain(x, w).float().numpy())
    assert (cmm.block_matmul.launches,
            dict(cmm.block_matmul.launches_by_path)) == before
    assert set(cmm.block_matmul.launches_by_path) == {"f32", "wmma", "wgmma"}


def _variant_edits():
    from repro_torch.kernels import variants
    return [(table, name, edit) for table, variants_ in (
        ("ring", variants.RING), ("flash", variants.FLASH),
        ("matmul", variants.MATMUL), ("rwkv", variants.RWKV),
        ("ssd", variants.SSD))
        for name, edits in variants_.items() for edit in edits]


@pytest.mark.parametrize("table,name,edit", _variant_edits(),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_every_kernel_ablation_edit_matches_its_source(table, name, edit):
    """``kernels/variants.py`` edits copies of ``csrc/`` by exact text: an
    edit whose anchor the source no longer holds would stop the ablation
    run on the card."""
    from repro_torch.kernels import _build
    fname, old, new = edit
    text = (_build.CSRC / fname).read_text()
    assert text.count(old) >= 1 and old != new
