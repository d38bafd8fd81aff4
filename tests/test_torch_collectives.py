"""Parity of every exact ported impl with the reference impl under
``vmap`` (the quantized-wire impls are in ``test_torch_wire.py``).

The same integer-valued inputs, made from a seed with numpy, go through
the reference per-shard function under ``jax.vmap(axis_name=)`` and
through the port's impl on a stacked CPU axis.

* float32 and int32 inputs hold small integers, so every sum is exact in
  any order: the tolerance is 0.
* bfloat16 keeps 8 significant bits; where a partial product exceeds 256
  the two packages may round a sum in a different order, so bfloat16 is
  held to ``2**-7`` of the largest reference magnitude.

Rooted ops use root ``p - 1``; power-of-two-only impls run only at p 4
and 8.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ref import RC, TC, StackedAxis, ported_impls, ref_vmap, to_np

import jax

ROOTED = ("bcast", "gather", "scatter", "reduce")
#: ops whose per-rank input holds one block per rank
BLOCKED = ("reducescatter", "alltoall", "scatter")
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "int32": torch.int32}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
          "int32": jnp.int32}


def _cases(ps):
    """Every exact ported impl at each p; the quantized-wire impls round
    their payload, so ``test_torch_wire.py`` holds them to the reference
    with their own tolerances."""
    out = []
    for op, nm in ported_impls():
        if TC.REGISTRY[op][nm].wire_dtype is not None:
            continue
        for p in ps:
            if TC.REGISTRY[op][nm].requires_pow2 and p & (p - 1):
                continue
            out.append((op, nm, p))
    return out


def _kwargs(op, p):
    kw = {}
    if op in ROOTED:
        kw["root"] = p - 1
    if op in ("allreduce", "reduce"):
        kw["chunk"] = 2
    return kw


def run_both(op, nm, p, dtype, seed=0):
    """``(reference, port)`` outputs as float64/int numpy arrays."""
    rng = np.random.default_rng(seed + 97 * p)
    rows = p * 4 if op in BLOCKED else 5
    if op == "matmul_reducescatter":
        rows = p * 3
    x = rng.integers(-8, 9, size=(p, rows, 3)).astype(np.float32)
    kw = _kwargs(op, p)
    ref_fn = RC.REGISTRY[op][nm].fn
    port_fn = TC.REGISTRY[op][nm].fn
    xt = torch.from_numpy(x).to(TORCH_DT[dtype])
    xj = jnp.asarray(x, JAX_DT[dtype])
    axis = StackedAxis(p, device="cpu")
    if op == "matmul_accumulate":
        # the payload is each rank's [5, 3] weight block; x [4, 5p] is
        # shared by every rank
        stat = rng.integers(-4, 5, size=(4, p * rows)).astype(np.float32)
        ref = ref_vmap(ref_fn, xj, x=jnp.asarray(stat, JAX_DT[dtype]))
        got = port_fn(xt, axis, x=torch.from_numpy(stat).to(TORCH_DT[dtype]))
    elif op in TC.FUSED_OPS:
        w = rng.integers(-4, 5, size=(3, 4)).astype(np.float32)
        ref = ref_vmap(ref_fn, xj, w=jnp.asarray(w, JAX_DT[dtype]))
        got = port_fn(xt, axis, w=torch.from_numpy(w).to(TORCH_DT[dtype]))
    else:
        ref = ref_vmap(ref_fn, xj, **kw)
        got = port_fn(xt, axis, **kw)
    assert got.dtype == TORCH_DT[dtype]
    return np.asarray(ref, np.float64), to_np(got).astype(np.float64)


@pytest.mark.parametrize("op,nm,p", _cases((3, 4, 8)))
def test_impl_matches_reference_float32(op, nm, p):
    ref, got = run_both(op, nm, p, "float32")
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("op,nm,p", _cases((8,)))
def test_impl_matches_reference_int32(op, nm, p):
    ref, got = run_both(op, nm, p, "int32", seed=1)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("op,nm,p", _cases((3,)))
def test_impl_matches_reference_bfloat16(op, nm, p):
    ref, got = run_both(op, nm, p, "bfloat16", seed=2)
    assert got.shape == ref.shape
    tol = 2.0 ** -7 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


@pytest.mark.parametrize("op", ["scan", "exscan"])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_scan_max_matches_reference(op, dtype):
    p = 8
    rng = np.random.default_rng(3)
    x = rng.integers(-50, 50, size=(p, 4, 3)).astype(np.float32)
    for nm in TC.REGISTRY[op]:
        ref = ref_vmap(RC.REGISTRY[op][nm].fn, jnp.asarray(x, JAX_DT[dtype]),
                       op="max")
        got = TC.REGISTRY[op][nm].fn(
            torch.from_numpy(x).to(TORCH_DT[dtype]),
            StackedAxis(p, device="cpu"), op="max")
        np.testing.assert_array_equal(to_np(got), np.asarray(ref))


@pytest.mark.parametrize("p", [4, 8])
def test_matmul_reducescatter_per_rank_weights(p):
    """A stacked ``w [p, K, M]`` (one weight shard per rank, both operands
    mapped) against the reference under a two-operand vmap."""
    rng = np.random.default_rng(4)
    x = rng.integers(-8, 9, size=(p, p * 2, 5)).astype(np.float32)
    w = rng.integers(-4, 5, size=(p, 5, 3)).astype(np.float32)
    axis = StackedAxis(p, device="cpu")
    for nm in TC.REGISTRY["matmul_reducescatter"]:
        ref = jax.vmap(lambda a, b: RC.REGISTRY["matmul_reducescatter"][nm]
                       .fn(a, "x", w=b), axis_name="x")(jnp.asarray(x),
                                                        jnp.asarray(w))
        got = TC.REGISTRY["matmul_reducescatter"][nm].fn(
            torch.from_numpy(x), axis, w=torch.from_numpy(w))
        np.testing.assert_array_equal(to_np(got), np.asarray(ref))
