"""The backward halves of the port's ``dist.ops`` against the JAX package.

Every op that issues a collective is a ``torch.autograd.Function`` in the
port and a ``jax.custom_vjp`` in the JAX package.  Each case runs the op
at p = 4 over ``model`` and over ``data`` (the reference under
``jax.vmap(axis_name=...)``, the port on a ``StackedAxis`` bound to the
same name), takes the gradient of ``sum(y * c)`` for a fixed per-rank
cotangent ``c``, and holds the port's gradients to the reference's
``jax.grad`` at rtol 1e-6 (the bar of ``tests/test_dist_grads.py``), with
the default impls, with the guideline mock-ups that file forces, and with
the three ``fused_ring`` impls forced.  Operands and the cotangent hold
small integers, so every product and sum is exact in any order.

The records: the (cell, impl, phase) multiset that one forward and one
backward dispatch equals the reference's (it records while tracing, the
port on every call; one eager call of each gives one record per
dispatch on both sides).  A collective left to plain torch autograd would
give the right gradient and no ``bwd`` record, so the records are what
shows the backward went through the dispatcher.
"""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_ref  # noqa: F401  (the reference's import shims)

from repro.core import api as rapi
from repro.dist import ops as rops
from repro_torch.core import api as tapi
from repro_torch.core._axis import StackedAxis
from repro_torch.dist import axes as taxes
from repro_torch.dist import ops as tops

P = 4
AXES = ["model", "data"]

MOCKUP_FORCE = {"allgather": "allgather_as_allreduce",
                "reducescatter": "rsb_as_allreduce",
                "allreduce": "allreduce_as_reduce_bcast",
                "alltoall": "alltoall_as_ppermute"}
RING_FORCE = {"allgather_matmul": "fused_ring",
              "matmul_reducescatter": "fused_ring",
              "matmul_accumulate": "fused_ring"}
FORCES = [pytest.param(None, id="defaults"),
          pytest.param(MOCKUP_FORCE, id="mockups"),
          pytest.param(RING_FORCE, id="fused_ring")]


# (name, per-rank operand shapes given the axis, call(ops, args, axis))
CASES = [
    ("fsdp_gather_d0", lambda ax: [(8, 6)],
     lambda o, a, ax: o.fsdp_gather(a[0], 0, ax)),
    ("fsdp_gather_d1", lambda ax: [(3, 8, 6)],
     lambda o, a, ax: o.fsdp_gather(a[0], 1, ax)),
    ("tp_allgather_last", lambda ax: [(8, 6)],
     lambda o, a, ax: o.tp_allgather(a[0], -1, ax)),
    ("tp_reducescatter", lambda ax: [(8, 6)],
     lambda o, a, ax: o.tp_reducescatter(a[0], 0, ax)),
    ("tp_reducescatter_d1", lambda ax: [(3, 8)],
     lambda o, a, ax: o.tp_reducescatter(a[0], 1, ax)),
    ("tp_allreduce", lambda ax: [(8, 6)],
     lambda o, a, ax: o.tp_allreduce(a[0], ax)),
    ("tp_copy", lambda ax: [(8, 6)],
     lambda o, a, ax: o.tp_copy(a[0], ax) * 3),
    ("tp_psum_grad", lambda ax: [(8, 6)],
     lambda o, a, ax: o.tp_psum_grad(a[0], ax) * 2),
    ("allgather_matmul", lambda ax: [(2, 8), (8, 3)],
     lambda o, a, ax: o.allgather_matmul(a[0], a[1], ax)),
    ("matmul_reducescatter", lambda ax: [(8, 8), (8, 3)],
     lambda o, a, ax: o.matmul_reducescatter(a[0], a[1], ax)),
    ("fsdp_matmul", lambda ax: [(2, 5, 8), (8, 3)],
     lambda o, a, ax: o.fsdp_matmul(a[0], a[1], ax)),
    ("matmul_accumulate", lambda ax: [(2, 5, 4 * 8), (8, 3)],
     lambda o, a, ax: o.matmul_accumulate(a[0], a[1], ax)),
    ("matmul_accumulate_uneven", lambda ax: [(5, 30), (8, 3)],
     lambda o, a, ax: o.matmul_accumulate(a[0], a[1], ax)),
    ("col_matmul_rows_divide", lambda ax: [(2, 4, 8), (8, 3)],
     lambda o, a, ax: o.col_matmul(a[0], a[1], ax)),
    ("col_matmul_ragged_rows", lambda ax: [(5, 8), (8, 3)],
     lambda o, a, ax: o.col_matmul(a[0], a[1], ax)),
    # fsdp_dim=0: tp_copy over model, the accumulate ring over data; the
    # axis under test is bound, the other one is not
    ("col_matmul_fsdp0", lambda ax: [(2, 4, 32),
                                     (32 if ax == "model" else 8, 3)],
     lambda o, a, ax: o.col_matmul(a[0], a[1], fsdp_dim=0)),
    ("row_matmul_rows_divide", lambda ax: [(2, 4, 8), (8, 3)],
     lambda o, a, ax: o.row_matmul(a[0], a[1], ax)),
    ("row_matmul_ragged_rows", lambda ax: [(5, 8), (8, 3)],
     lambda o, a, ax: o.row_matmul(a[0], a[1], ax)),
    # fsdp_dim=1 with one axis bound: tp_allreduce(fsdp_matmul(...))
    ("row_matmul_fsdp1", lambda ax: [(2, 4, 8), (8, 3)],
     lambda o, a, ax: o.row_matmul(a[0], a[1], fsdp_dim=1)),
]
IDS = [c[0] for c in CASES]


def _operands(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(-3, 4, size=(P,) + s).astype(np.float32)
            for s in shapes]


def _cot(shape):
    """The per-rank cotangent: small integers, fixed."""
    n = int(np.prod(shape))
    return ((np.arange(n) % 7) - 3).astype(np.float32).reshape(shape)


def ref_run(call, args, axis, force):
    def loss(*a):
        y = call(rops, a, axis)
        return jnp.sum(y * jnp.asarray(_cot(y.shape))), y

    with rapi.tuned(force=force or {}) as ctx:
        (_, y), gs = jax.vmap(
            jax.value_and_grad(loss, argnums=tuple(range(len(args))),
                               has_aux=True),
            axis_name=axis)(*[jnp.asarray(a) for a in args])
    return np.asarray(y), [np.asarray(g) for g in gs], ctx.record


def port_run(call, args, axis, force):
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    with taxes.bind(**{axis: StackedAxis(P, "cpu")}), \
            tapi.tuned(force=force or {}) as ctx:
        y = call(tops, ts, axis)
        c = torch.as_tensor(_cot(tuple(y.shape[1:])))
        (y * c).sum().backward()
    return y.detach().numpy(), [t.grad.numpy() for t in ts], ctx.record


def _records(rec):
    return collections.Counter((dataclasses.astuple(r.cell), r.impl,
                                r.phase) for r in rec)


@pytest.mark.parametrize("force", FORCES)
@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("name,shapes,call", CASES, ids=IDS)
def test_grads_match_the_reference(name, shapes, call, axis, force):
    args = _operands(shapes(axis), IDS.index(name))
    ry, rg, _ = ref_run(call, args, axis, force)
    ty, tg, _ = port_run(call, args, axis, force)
    np.testing.assert_allclose(ty, ry, rtol=1e-6, atol=0)
    assert len(tg) == len(rg)
    for g, r in zip(tg, rg):
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=1e-6, atol=0)


@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("name,shapes,call", CASES, ids=IDS)
def test_backward_records_equal_the_reference(name, shapes, call, axis):
    args = _operands(shapes(axis), IDS.index(name))
    _, _, rrec = ref_run(call, args, axis, None)
    _, _, trec = port_run(call, args, axis, None)
    assert _records(trec) == _records(rrec)
    if any(r.phase == "bwd" for r in rrec):
        assert {r.phase for r in trec} >= {"bwd"}


def test_every_pair_records_a_backward_collective_over_its_axis():
    """The ops whose backward issues a collective over the bound axis do
    so under phase ``bwd``; those whose backward needs none (the Megatron
    "g" side) record forward dispatches only."""
    want_bwd = {"fsdp_gather_d0", "fsdp_gather_d1", "tp_allgather_last",
                "tp_reducescatter", "tp_reducescatter_d1", "tp_copy",
                "tp_psum_grad", "allgather_matmul", "matmul_reducescatter",
                "fsdp_matmul", "matmul_accumulate",
                "matmul_accumulate_uneven", "col_matmul_rows_divide",
                "col_matmul_ragged_rows", "col_matmul_fsdp0",
                "row_matmul_fsdp1"}
    for name, shapes, call in CASES:
        axis = "data" if "fsdp" in name or "accumulate" in name else "model"
        _, _, trec = port_run(call, _operands(shapes(axis), 0), axis, None)
        got = {r.phase for r in trec}
        assert ("bwd" in got) == (name in want_bwd), (name, got)


def test_forward_without_grad_saves_nothing_and_records_the_same():
    """Outside autograd the fused FSDP ops run their primal (no gathered
    operand kept), with the same dispatches."""
    x, w = _operands([(2, 4, 32), (8, 3)], 3)
    with taxes.bind(data=StackedAxis(P, "cpu")):
        with tapi.tuned() as c1:
            y1 = tops.col_matmul(torch.as_tensor(x), torch.as_tensor(w),
                                 fsdp_dim=0)
        xt = torch.tensor(x, requires_grad=True)
        with tapi.tuned() as c2:
            y2 = tops.col_matmul(xt, torch.as_tensor(w), fsdp_dim=0)
    assert y1.grad_fn is None and y2.grad_fn is not None
    np.testing.assert_array_equal(y1.numpy(), y2.detach().numpy())
    assert _records(c1.record) == _records(c2.record)


def test_transposed_operands_reach_the_collective_contiguous_and_counted():
    """The backward hands ``w.T``-style operands to the fused ops as
    contiguous copies made in ``dist.ops``, each one counted."""
    x, w = _operands([(2, 8), (8, 3)], 4)
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    before = (tops._contig.copies, tops._contig.bytes)
    seen = []
    real = tapi.matmul_reducescatter

    def spy(a, b, axis, **kw):
        seen.append(b.is_contiguous())
        return real(a, b, axis, **kw)

    with taxes.bind(model=StackedAxis(P, "cpu")):
        y = tops.allgather_matmul(xt, wt)
        tapi.matmul_reducescatter = spy
        try:
            y.backward(torch.ones_like(y))     # a contiguous cotangent
        finally:
            tapi.matmul_reducescatter = real
    assert seen == [True]
    assert tops._contig.copies == before[0] + 1
    assert tops._contig.bytes == before[1] + w.nbytes


def test_two_dim_ops_still_raise_naming_both_axes():
    with taxes.bind(model=StackedAxis(2, "cpu"), data=StackedAxis(2, "cpu")):
        with pytest.raises(NotImplementedError, match="both axes"):
            tops.row_matmul(torch.zeros(2, 4, 8), torch.zeros(2, 8, 3),
                            fsdp_dim=1)


def test_backward_on_another_thread_dispatches_under_the_forward_context():
    """Autograd runs the backward of CUDA tensors on a device thread of
    its own; the backward collectives must still be tuned and recorded by
    the context their forward ran in.  Here the backward runs on a fresh
    thread, outside any context."""
    import threading
    x, w = _operands([(2, 4, 32), (8, 3)], 5)
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    with taxes.bind(data=StackedAxis(P, "cpu")), \
            tapi.tuned(force=RING_FORCE) as ctx:
        y = tops.col_matmul(xt, wt, fsdp_dim=0)
    th = threading.Thread(target=lambda: y.sum().backward())
    th.start()
    th.join(timeout=60)
    assert not th.is_alive() and wt.grad is not None
    assert [(r.cell.op, r.impl, r.phase) for r in ctx.record] == [
        ("matmul_accumulate", "fused_ring", "fwd"),
        ("matmul_reducescatter", "fused_ring", "bwd")]
    assert tapi.current_context() is None
