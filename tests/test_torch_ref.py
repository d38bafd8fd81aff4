"""Harness of the parity tests between the PyTorch port (``repro_torch``)
and the JAX reference (``repro``), plus tests of the harness itself.

On jax 0.9 the reference imports only after two shims, which the root
``conftest.py`` applies just before ``repro._compat`` first loads (the
hook of ``src/sitecustomize.py``); the reference itself is not edited.
The other ``test_torch_*`` files import their helpers from here.

Helpers:

* ``ref_vmap(fn, xs, axis="x", **kw)`` runs a reference per-shard function
  over a stacked numpy operand under ``jax.vmap(axis_name=axis)`` and
  returns numpy;
* ``needs_cuda`` marks a test that needs a CUDA card; the ``cuda`` fixture
  skips it, with the reason, where there is none (both live in
  ``_torch_cuda.py`` so that the card's own tests need no JAX).
"""
import os
import subprocess
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.core.collectives as RC  # noqa: E402
from repro_torch.core import collectives as TC  # noqa: E402
from repro_torch.core._axis import StackedAxis, stack_shards, unstack  # noqa: E402,E501

from _torch_cuda import cuda, needs_cuda  # noqa: E402,F401


def ref_vmap(fn, xs, axis: str = "x", **kw) -> np.ndarray:
    """``fn(shard, axis, **kw)`` for every leading-dim shard of ``xs``
    under ``jax.vmap(axis_name=axis)``, as numpy."""
    out = jax.vmap(lambda a: fn(a, axis, **kw), axis_name=axis)(
        jnp.asarray(xs))
    return np.asarray(out)


def to_np(t: torch.Tensor) -> np.ndarray:
    """A torch result as numpy (bfloat16 widened to float32, exactly)."""
    return np.stack(unstack(t))


def ported_impls() -> list[tuple[str, str]]:
    """``(op, impl)`` of every impl the port carries."""
    return [(op, nm) for op, impls in TC.REGISTRY.items() for nm in impls]


# ---------------------------------------------------------------------------
# the harness itself
# ---------------------------------------------------------------------------


def test_reference_imports_with_shim():
    import repro.core.api as api
    assert callable(api.allgather)


def test_reference_registry_counts():
    assert len(RC.REGISTRY) == 14
    assert sum(len(v) for v in RC.REGISTRY.values()) == 64


def test_port_carries_every_flat_impl_and_the_fused_gather_and_scatter_ops():
    """Every reference impl on the ten flat ops and the four fused ones,
    the quantized-wire, the hierarchical ``MPIX_*`` and the 2-D impls
    included: all 64, in the reference's order."""
    assert TC.FUSED_OPS == ("allgather_matmul", "matmul_reducescatter",
                            "matmul_accumulate", "matmul_reducescatter_2d")
    assert not set(TC.FLAT_OPS) & set(TC.FUSED_OPS)
    assert list(TC.REGISTRY) == list(RC.REGISTRY)
    want = {(op, nm) for op, impls in RC.REGISTRY.items() for nm in impls}
    assert ported_impls() == [(op, nm) for op, impls in RC.REGISTRY.items()
                              for nm in impls]
    assert len(want) == 64
    assert {(op, nm) for op, nm in want
            if TC.REGISTRY[op][nm].hier} == {
        ("allgather", "MPIX_ag_ag"), ("allreduce", "MPIX_rs_ar_ag"),
        ("reducescatter", "MPIX_rs_rs")}
    assert sum(RC.REGISTRY[op][nm].wire_dtype is not None
               for op, nm in want) == 12
    for op, nm in want:
        r, t = RC.REGISTRY[op][nm], TC.REGISTRY[op][nm]
        assert (t.guideline, t.requires_pow2, t.wire_dtype, t.hier) == (
            r.guideline, r.requires_pow2, r.wire_dtype, r.hier)
        if t.wire_dtype is not None or t.hier:
            assert t.desc == r.desc
        for nbytes, p in ((1, 2), (4096, 8), (10 ** 6, 6)):
            assert t.extra_bytes(nbytes, p) == r.extra_bytes(nbytes, p)


def test_port_imports_neither_jax_nor_the_reference():
    code = ("import sys, importlib, pkgutil, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' "
            "or m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src")]
        + sys.path))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_stack_unstack_carries_bfloat16_bits():
    import ml_dtypes
    rng = np.random.default_rng(0)
    shards = [rng.normal(size=(3, 5)).astype(ml_dtypes.bfloat16)
              for _ in range(4)]
    t = stack_shards(shards, device="cpu")
    assert t.dtype == torch.bfloat16 and tuple(t.shape) == (4, 3, 5)
    for a, b in zip(unstack(t), shards):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))


def test_entry_points_refuse_to_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StackedAxis(4)
    ax = StackedAxis(4, device="cpu")
    assert ax.device.type == "cpu" and ax.size == 4


def test_ref_vmap_matches_a_plain_stack():
    x = np.arange(24, dtype=np.float32).reshape(4, 2, 3)
    got = ref_vmap(RC.allgather_default, x)
    np.testing.assert_array_equal(
        got, np.broadcast_to(x.reshape(8, 3), (4, 8, 3)))
