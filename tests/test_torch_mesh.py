"""The stacked data x model mesh (``StackedMesh``) against the reference
under nested ``jax.vmap``, and every one-axis impl on either axis of it.

Lane ``i*q + j`` of a ``(d, q)`` mesh is rank i of the outer axis ``o``
and rank j of the inner axis ``i``: the order of the reference's nested
``jax.vmap(jax.vmap(f, axis_name="i"), axis_name="o")``.  The same
integer-valued inputs, made from a seed with numpy, go through both.

Tolerances are those of ``test_torch_collectives.py``: float32 inputs
hold small integers, so every sum is exact in any order and the exact
impls are held bit for bit.  The quantized-wire impls are held as in
``test_torch_wire.py``: bit for bit on the ops whose sums stay exact,
and to the float32 dot-product bound where a dequantized operand is
multiplied.
"""
import dataclasses
import json
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from test_torch_collectives import BLOCKED, _kwargs
from test_torch_ref import RC, TC, StackedAxis, ported_impls, to_np
from test_torch_wire import EXACT, U32

from repro.core import _axis as raxis
from repro_torch.core import api as tapi
from repro_torch.core import selfcheck as tsc
from repro_torch.core._axis import StackedMesh
from repro_torch.dist import axes as taxes

MESHES = ((2, 2), (2, 3), (4, 2), (2, 4))
NAMES = ("o", "i")


def nested(f):
    """``f`` per rank under the reference's nested vmap (outer "o")."""
    return jax.vmap(jax.vmap(f, axis_name="i"), axis_name="o")


def ints(rng, *shape, lo=-8):
    return rng.integers(lo, -lo + 1, size=shape).astype(np.float32)


def flat(a) -> np.ndarray:
    """``[d, q, ...]`` -> ``[d*q, ...]`` (the lane order)."""
    a = np.asarray(a)
    return a.reshape((-1,) + a.shape[2:])


def mesh_of(d, q):
    return StackedMesh((d, q), NAMES, "cpu")


# ---------------------------------------------------------------------------
# the mesh itself
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,q", MESHES)
@pytest.mark.parametrize("which", NAMES)
def test_mesh_views_match_reference_axis_index(d, q, which):
    m = mesh_of(d, q)
    ax = m[which]
    want = flat(nested(lambda a: lax.axis_index(which) + 0 * a)(
        jnp.zeros((d, q), jnp.int32)))
    assert ax.index().tolist() == want.tolist()
    assert ax.size == (d if which == "o" else q)
    assert ax.lanes == d * q and m.lanes == d * q
    assert ax.lane_index().tolist() == list(range(d * q))
    groups = ax.groups()
    assert groups.shape == (d * q // ax.size, ax.size)
    assert sorted(groups.flatten().tolist()) == list(range(d * q))
    for g in groups:
        assert ax.index()[g].tolist() == list(range(ax.size))


COLLECTIVES = ("all_gather", "all_gather_untiled", "psum", "pmax",
               "psum_scatter", "all_to_all", "ring", "partial")


def _ref_collective(name, a, ax):
    p = lax.psum(1, ax)
    if name == "all_gather":
        return lax.all_gather(a, ax, axis=0, tiled=True)
    if name == "all_gather_untiled":
        return lax.all_gather(a, ax, axis=0)
    if name == "psum":
        return lax.psum(a, ax)
    if name == "pmax":
        return lax.pmax(a, ax)
    if name == "psum_scatter":
        return lax.psum_scatter(a, ax, scatter_dimension=0, tiled=True)
    if name == "all_to_all":
        return lax.all_to_all(a, ax, 0, 0, tiled=True)
    if name == "ring":
        return raxis.pshift(a, ax, raxis.ring_perm(p, 1))
    return raxis.pshift(a, ax, raxis.shift_perm(p, 1))


def _port_collective(name, x, ax):
    if name == "all_gather_untiled":
        return ax.all_gather(x, tiled=False)
    if name == "ring":
        return ax.pshift(x, [(r, (r + 1) % ax.size) for r in range(ax.size)])
    if name == "partial":
        return ax.pshift(x, [(r, r + 1) for r in range(ax.size - 1)])
    return getattr(ax, name)(x)


@pytest.mark.parametrize("name", COLLECTIVES)
@pytest.mark.parametrize("d,q", MESHES)
@pytest.mark.parametrize("which", NAMES)
def test_mesh_collective_matches_reference(name, d, q, which):
    rng = np.random.default_rng(d * 10 + q)
    p = d if which == "o" else q
    x = ints(rng, d, q, 2 * p, 3)
    want = flat(nested(lambda a: _ref_collective(name, a, which))(
        jnp.asarray(x)))
    got = _port_collective(name, torch.from_numpy(flat(x)), mesh_of(d, q)[
        which])
    np.testing.assert_array_equal(to_np(got), want)


def test_one_name_mesh_is_the_stacked_axis():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(ints(rng, 4, 8, 3))
    a, b = StackedAxis(4, "cpu"), StackedMesh((4,), ("x",), "cpu")["x"]
    for name in COLLECTIVES:
        np.testing.assert_array_equal(to_np(_port_collective(name, x, a)),
                                      to_np(_port_collective(name, x, b)))
    assert a.index().tolist() == b.index().tolist() == [0, 1, 2, 3]
    assert (a.lanes, a.size, b.lanes, b.size) == (4, 4, 4, 4)


def test_mesh_refuses_bad_shapes_and_wrong_lane_counts():
    with pytest.raises(ValueError):
        StackedMesh((2, 2), ("a",), "cpu")
    with pytest.raises(ValueError):
        StackedMesh((2, 2), ("a", "a"), "cpu")
    with pytest.raises(ValueError, match="lanes"):
        mesh_of(2, 2)["o"].psum(torch.zeros(3, 1))


# ---------------------------------------------------------------------------
# every one-axis impl on either axis of a mesh
# ---------------------------------------------------------------------------


def _impl_cases():
    out = []
    for op, nm in ported_impls():
        impl = TC.REGISTRY[op][nm]
        if impl.hier or op == "matmul_reducescatter_2d":
            continue
        for d, q in MESHES:
            for which in NAMES:
                p = d if which == "o" else q
                if impl.requires_pow2 and p & (p - 1):
                    continue
                out.append((op, nm, d, q, which))
    return out


def _run_impl(op, nm, d, q, which):
    """``(reference, port, tolerance)`` of one impl on one mesh axis."""
    p = d if which == "o" else q
    rng = np.random.default_rng(zlib.crc32(f"{op}/{nm}/{d}/{q}/{which}"
                                           .encode()))
    rows = p * 4 if op in BLOCKED else 5
    if op == "matmul_reducescatter":
        rows = p * 3
    x = ints(rng, d, q, rows, 3)
    kw = _kwargs(op, p)
    ref_fn, port_fn = RC.REGISTRY[op][nm].fn, TC.REGISTRY[op][nm].fn
    ax = mesh_of(d, q)[which]
    second, tol = None, 0.0
    if op == "matmul_accumulate":
        second = ints(rng, 4, p * rows, lo=-4)
        ref = nested(lambda a: ref_fn(a, which, x=jnp.asarray(second)))(
            jnp.asarray(x))
        got = port_fn(torch.from_numpy(flat(x)), ax,
                      x=torch.from_numpy(second))
    elif op in TC.FUSED_OPS:
        second = ints(rng, 3, 4, lo=-4)
        ref = nested(lambda a: ref_fn(a, which, w=jnp.asarray(second)))(
            jnp.asarray(x))
        got = port_fn(torch.from_numpy(flat(x)), ax,
                      w=torch.from_numpy(second))
    else:
        ref = nested(lambda a: ref_fn(a, which, **kw))(jnp.asarray(x))
        got = port_fn(torch.from_numpy(flat(x)), ax, **kw)
    if TC.REGISTRY[op][nm].wire_dtype is not None and op not in EXACT:
        # a dequantized operand is multiplied: the two packages' dot
        # products round in another order (test_torch_wire.py's bound)
        xa, sa = np.abs(flat(x)).reshape(-1, 3), np.abs(second)
        if op == "allgather_matmul":
            dots, k = float((xa @ sa).max()), sa.shape[0]
        else:       # max(|x| @ |W|) over every group's gathered weight
            dots, k = float(sa.sum(1).max() * xa.max()), sa.shape[1]
        tol = 2 * (k + p) * U32 * dots
    return flat(ref).astype(np.float64), to_np(got).astype(np.float64), tol


@pytest.mark.parametrize("op,nm,d,q,which", _impl_cases())
def test_impl_on_a_mesh_axis_matches_nested_vmap(op, nm, d, q, which):
    ref, got, tol = _run_impl(op, nm, d, q, which)
    assert got.shape == ref.shape
    if tol == 0.0:
        np.testing.assert_array_equal(got, ref)
    else:
        assert float(np.abs(got - ref).max()) <= tol


def test_every_one_axis_impl_runs_on_both_axes():
    """The parametrization above covers all 59 one-axis impls."""
    covered = {(op, nm) for op, nm, *_ in _impl_cases()}
    assert len(covered) == 59


# ---------------------------------------------------------------------------
# dispatch on a mesh axis
# ---------------------------------------------------------------------------


def test_dispatch_on_a_mesh_axis_records_per_rank_cells():
    d, q = 2, 4
    m = mesh_of(d, q)
    x = torch.ones(d * q, 6, 3)
    with tapi.tuned() as ctx:
        tapi.allgather(x, m["i"])
        tapi.allreduce(x, m["o"])
        tapi.allreduce(x, m["o"], inner_axis=m["i"])
    (c1, c2, c3) = [r.cell for r in ctx.record]
    assert (c1.p, c1.nbytes, c1.p2) == (q, 6 * 3 * 4, 0)
    assert (c2.p, c2.nbytes, c2.p2) == (d, 6 * 3 * 4, 0)
    assert (c3.p, c3.p2, c3.hier) == (d, q, True)


def test_bind_both_names_to_mesh_views():
    m = StackedMesh((2, 3), ("data", "model"), "cpu")
    with taxes.bind(data=m["data"], model=m["model"]):
        assert taxes.axis_size("data") == 2 and taxes.axis_size("model") == 3
        assert taxes.axis_index("model").tolist() == [0, 1, 2, 0, 1, 2]
        assert taxes.axis_index("data").tolist() == [0, 0, 0, 1, 1, 1]


def test_dispatch_refuses_two_axes_of_different_meshes():
    a, b = mesh_of(2, 2), mesh_of(2, 2)
    with pytest.raises(ValueError, match="one StackedMesh"):
        tapi.allreduce(torch.ones(4, 2, 1), a["o"], inner_axis=a["o"])
    with pytest.raises(ValueError, match="one StackedMesh"):
        tapi.allreduce(torch.ones(4, 2, 1), a["o"],
                       inner_axis=StackedAxis(4, "cpu"))
    # views of two equal meshes are the same layout: accepted
    tapi.allreduce(torch.ones(4, 2, 1), a["o"], inner_axis=b["i"])


# ---------------------------------------------------------------------------
# selfcheck's two-axis run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d,q", MESHES)
def test_selfcheck_two_axis_run_covers_every_impl(d, q):
    rep = tsc.run_mesh((d, q), "cpu")
    assert rep["failures"] == [] and rep["demoted"] == []
    assert rep["devices"] == f"{d}x{q}"
    assert rep["impls"] == sum(len(v) for v in RC.REGISTRY.values()) == 64


@pytest.mark.parametrize("op,nm,xpose_only,want", [
    ("allgather", "MPIX_ag_ag", False, ["allgather@2x4/MPIX_ag_ag"]),
    ("allreduce", "MPIX_rs_ar_ag", False, ["allreduce@2x4/MPIX_rs_ar_ag"]),
    ("reducescatter", "MPIX_rs_rs", False, ["reducescatter@2x4/MPIX_rs_rs"]),
    ("matmul_reducescatter_2d", "fused_ring2d", False,
     ["matmul_reducescatter_2d@2x4/fused_ring2d",
      "matmul_reducescatter_2d@2x4/fused_ring2d/xpose"]),
    ("matmul_reducescatter_2d", "default", True,
     ["matmul_reducescatter_2d@2x4/default/xpose"]),
])
def test_selfcheck_two_axis_run_reports_a_broken_impl(monkeypatch, op, nm,
                                                      xpose_only, want):
    orig = TC.REGISTRY[op][nm]

    def fn(a, axis, **kw):
        y = orig.fn(a, axis, **kw)
        return y * 1.5 if kw.get("xpose") or not xpose_only else y

    monkeypatch.setitem(TC.REGISTRY[op], nm,
                        dataclasses.replace(orig, fn=fn))
    rep = tsc.run_mesh((2, 4), "cpu")
    assert rep["failures"] == want and rep["demoted"] == []


@pytest.mark.parametrize("p,runs", [(8, ["8", "2x4"]), (6, ["6", "2x3"]),
                                    (3, ["3"])])
def test_selfcheck_cli_adds_the_two_axis_run_when_p_is_even(capsys, p, runs):
    assert tsc.main(["--p", str(p), "--device", "cpu", "--json"]) == 0
    reps = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [str(r["devices"]) for r in reps] == runs
    assert all(r["failures"] == [] for r in reps)
    if len(reps) > 1:
        assert reps[1]["impls"] == 64
