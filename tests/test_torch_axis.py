"""``StackedAxis`` primitives against ``lax`` under ``vmap``.

Each primitive of the port's rank axis takes a stacked ``[p, ...]``
operand; the reference is the ``lax`` collective applied per shard under
``jax.vmap(axis_name=)`` (``pshift`` against the reference's own partial-
permutation ``pshift``).  Inputs are integer-valued float32, so sums are
exact and the tolerance is 0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from test_torch_ref import StackedAxis, ref_vmap, to_np

from repro.core import _axis as RA
from repro_torch.core import _axis as TA

PS = (1, 2, 3, 4, 8)


def _x(p, rows, seed=0):
    rng = np.random.default_rng(seed + p)
    return rng.integers(-9, 10, size=(p, rows, 3)).astype(np.float32)


def _both(p, rows, ref_fn, port_fn):
    x = _x(p, rows)
    ref = ref_vmap(ref_fn, x)
    got = port_fn(torch.from_numpy(x), StackedAxis(p, device="cpu"))
    return ref, to_np(got)


@pytest.mark.parametrize("p", PS)
def test_index(p):
    ref = ref_vmap(lambda a, ax: lax.axis_index(ax) + 0 * a[0, 0].astype(
        jnp.int32), _x(p, 1))
    got = StackedAxis(p, device="cpu").index()
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("tiled", [True, False])
def test_all_gather(p, tiled):
    ref, got = _both(p, 2,
                     lambda a, ax: lax.all_gather(a, ax, axis=0, tiled=tiled),
                     lambda t, ax: ax.all_gather(t, tiled=tiled))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("p", PS)
def test_psum(p):
    ref, got = _both(p, 3, lambda a, ax: lax.psum(a, ax),
                     lambda t, ax: ax.psum(t))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("p", PS)
def test_psum_scatter(p):
    ref, got = _both(p, 2 * p,
                     lambda a, ax: lax.psum_scatter(a, ax,
                                                    scatter_dimension=0,
                                                    tiled=True),
                     lambda t, ax: ax.psum_scatter(t))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("p", PS)
def test_all_to_all(p):
    ref, got = _both(p, 2 * p,
                     lambda a, ax: lax.all_to_all(a, ax, split_axis=0,
                                                  concat_axis=0, tiled=True),
                     lambda t, ax: ax.all_to_all(t))
    np.testing.assert_array_equal(got, ref)


def _perms(p):
    """Full rings, partial shifts both ways, XOR partners, tree rounds."""
    out = [RA.ring_perm(p, 1), RA.ring_perm(p, max(p - 1, 1)),
           RA.shift_perm(p, 1), RA.shift_perm(p, -1)]
    if p > 2:
        out.append(RA.shift_perm(p, 2))
    if p & (p - 1) == 0 and p > 1:
        out.append([(i, i ^ 1) for i in range(p)])
    out.append([(r + 1, r) for r in range(0, p, 2) if r + 1 < p])
    return out


@pytest.mark.parametrize("p", PS)
def test_pshift(p):
    x = _x(p, 2)
    axis = StackedAxis(p, device="cpu")
    for pairs in _perms(p):
        ref = ref_vmap(lambda a, ax: RA.pshift(a, ax, pairs), x)
        got = axis.pshift(torch.from_numpy(x), pairs)
        np.testing.assert_array_equal(to_np(got), ref, err_msg=str(pairs))


@pytest.mark.parametrize("p", PS)
def test_perm_helpers(p):
    for s in (1, 2, -1):
        assert TA.ring_perm(p, s) == RA.ring_perm(p, s)
        assert TA.shift_perm(p, s) == RA.shift_perm(p, s)
    assert TA.tree_rounds(p) == RA.tree_rounds(p)


def test_pshift_rejects_two_sources_for_one_rank():
    axis = StackedAxis(3, device="cpu")
    with pytest.raises(ValueError, match="two sources"):
        axis.pshift(torch.zeros(3, 1), [(0, 1), (2, 1)])


def test_bfloat16_psum_under_vmap():
    """bfloat16 integer sums stay exact (|sum| <= 256)."""
    p = 4
    x = _x(p, 3)
    ref = jax.vmap(lambda a: lax.psum(a, "x"), axis_name="x")(
        jnp.asarray(x, jnp.bfloat16))
    got = StackedAxis(p, device="cpu").psum(
        torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_np(got),
                                  np.asarray(ref, np.float32))
