"""The pod axis: the port's ``Trainer(mesh=(pod, d, t))`` on a three-name
``StackedMesh`` against the JAX package's ``train_fn`` under nested
``vmap`` (outer ``pod``, then ``data``, inner ``model``) on the CPU.

Model: the smoke config of llama3.2-3b in float32 (4 layers, unscanned),
weights from the reference's ``init_tree`` with its constant leaves
randomized, carried by ``params.from_reference``; the batch is cut over
pod x data (pod rank i's data rank j takes slice ``i*d + j``), every
parameter is replicated over ``pod``.  One step, with the cross-pod
gradient all-reduce in float32 and in bf16 (``compress="bf16"``).

Tolerances: as ``tests/test_torch_train.py`` (float32, summation order
only): loss and grad norm 1e-5 relative; parameters and AdamW state 1e-5
of the leaf's max-norm plus 1e-7.  With ``compress="bf16"`` each
gradient is rounded to bf16 before the cross-pod sum, in both packages,
so a summation-order difference may move a gradient element by one bf16
step, 2^-7 of it: the AdamW first moment is held to 2^-7 and the second
(the square) to 2^-6 of the leaf's max-norm.
"""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import test_torch_ref  # noqa: F401  (the reference's import shims)
from test_torch_models import port_cfg, randomized, ref_params, smoke
from test_torch_train import B, LR, S, WARM, close, pairs

from repro.core import api as rapi
from repro.data import make_batch as rmake_batch
from repro.models import lm as rlm
from repro.models.params import ParamSpec as RSpec
from repro.optim import optimizers as ropt
from repro.train import trainer as rtrainer
from repro_torch.core._axis import StackedMesh
from repro_torch.data import make_batch
from repro_torch.models.params import from_reference, tree_leaves
from repro_torch.train import Trainer

NAMES = ("pod", "data", "model")
MESH = (2, 1, 2)


def ref_cut_mesh(tree, rspecs, shape):
    """The reference's global tree cut for the nested vmap over ``NAMES``:
    leaf ``[pod, d, t, *local]``, each dim assigned to a name split into
    that name's blocks, replicated over the others (numpy slicing,
    independent of the port's ``shard``)."""
    sizes = dict(zip(NAMES, shape))

    def cut(a, s):
        a = np.asarray(a)
        local = tuple(n // sizes.get(d, 1) for n, d in zip(a.shape, s.dims))
        out = np.empty(shape + local, a.dtype)
        for idx in np.ndindex(*shape):
            coord = dict(zip(NAMES, idx))
            sl = tuple(slice(coord[d] * m, (coord[d] + 1) * m)
                       if d in coord else slice(None)
                       for m, d in zip(local, s.dims))
            out[idx] = a[sl]
        return jnp.asarray(out)
    return jax.tree.map(cut, tree, rspecs,
                        is_leaf=lambda x: isinstance(x, RSpec))


def ref_join_mesh(stacked, rspecs):
    """The inverse of ``ref_cut_mesh`` (a leaf replicated over a name is
    that name's rank 0 copy)."""
    def join(a, s):
        a = np.asarray(a)
        for k in reversed(range(len(NAMES))):        # model, data, pod
            nm = NAMES[k]
            blocks = [np.take(a, i, axis=k) for i in range(a.shape[k])]
            a = (np.concatenate(blocks, axis=k + s.dims.index(nm))
                 if nm in s.dims else blocks[0])
        return a
    return jax.tree.map(join, stacked, rspecs,
                        is_leaf=lambda x: isinstance(x, RSpec))


def _ref_step(rcfg, tree, compress):
    pod, d, t = MESH
    _, rtrain = rtrainer.make_step_fns(rcfg, compress=compress, base_lr=LR,
                                       warmup=WARM)
    rspecs = rlm.model_specs(rcfg, tp=t)
    params = ref_cut_mesh(tree, rspecs, MESH)
    opt = jax.vmap(jax.vmap(jax.vmap(ropt.get_optimizer(
        rcfg.optimizer)[0])))(params)
    fn = rtrain
    for nm in reversed(NAMES):
        fn = jax.vmap(fn, in_axes=(0, 0, 0, None), axis_name=nm)
    batch = {k: jnp.asarray(np.broadcast_to(
        v.reshape(pod, d, 1, -1, *v.shape[1:]),
        (pod, d, t, v.shape[0] // (pod * d)) + v.shape[1:]))
        for k, v in rmake_batch(rcfg, B, S, 0).items()}
    rec = []
    with rapi.tuned(record=rec):
        params, opt, m = jax.jit(fn)(params, opt, batch, jnp.int32(0))
    return jax.tree.map(np.asarray, (m, params, opt)), rec, rspecs


@pytest.fixture(scope="module", params=["none", "bf16"])
def pod_step(request):
    rcfg = smoke("float32", scan_layers=False)
    tree = randomized(ref_params(rcfg), 8)
    ref, rrec, rspecs = _ref_step(rcfg, tree, request.param)
    tr = Trainer(port_cfg(rcfg), mesh=MESH, device="cpu", base_lr=LR,
                 warmup=WARM, compress=request.param, record=[])
    _, opt = tr.init(0)
    params = from_reference(tree, tr.specs, tr.axis)
    params, opt, m = tr.step(params, opt,
                             tr.put_batch(make_batch(tr.cfg, B, S, 0)), 0)
    got = ({k: float(v) for k, v in m.items()}, tr.to_global(params, opt),
           tr.record)
    return ref, rrec, got, rspecs, tr


def test_pod_step_matches_the_reference(pod_step):
    (rm, rp, ro), _, (tm, tstate, _), rspecs, tr = pod_step
    assert isinstance(tr.axis, StackedMesh) and tr.axis.names == NAMES
    assert tm["loss"] == pytest.approx(float(rm["loss"][0, 0, 0]), rel=1e-5)
    assert tm["grad_norm"] == pytest.approx(
        float(rm["grad_norm"][0, 0, 0]), rel=1e-5)
    for path, t, r in pairs(tstate["params"], ref_join_mesh(rp, rspecs)):
        close(t.float().numpy(), r)
    bf16 = tr.compress == "bf16"
    for k, rtol in (("m", 2 ** -7 if bf16 else 1e-5),
                    ("v", 2 ** -6 if bf16 else 1e-5)):
        for path, t, r in pairs(tstate["opt"][k],
                                ref_join_mesh(ro[k], rspecs)):
            close(t.float().numpy(), r, rtol=rtol)
    assert int(tstate["opt"]["count"]) == 1


def test_pod_step_records_equal_the_reference_trace(pod_step):
    """The port's step dispatches what the reference's trace recorded:
    every leaf's cross-pod all-reduce under ``bwd`` (in bf16 with
    ``compress="bf16"``), and the metrics' all-reduces over pod."""
    _, rrec, (_, _, rec), _, tr = pod_step

    def key(r_):
        return collections.Counter((dataclasses.astuple(r.cell), r.impl,
                                    r.phase) for r in r_)
    assert key(rec) == key(rrec)
    n_leaves = len(tree_leaves(tr.specs))
    pod_bwd = [r for r in rec if r.cell.op == "allreduce"
               and r.phase == "bwd" and r.cell.p == MESH[0]]
    assert len(pod_bwd) >= n_leaves
    if tr.compress == "bf16":
        assert sum(r.cell.dtype == "bfloat16" for r in pod_bwd) >= n_leaves


def test_pod_put_batch_layout():
    """``[pod*d*t, B/(pod*d), S]``: lane ``(i*d + j)*t + k`` holds slice
    ``i*d + j`` of the rows, the same on its t model ranks."""
    cfg = port_cfg(smoke("float32"))
    for mesh in ((2, 2, 2), (2, 1, 1), (1, 1, 3)):
        tr = Trainer(cfg, mesh=mesh, device="cpu")
        pod, d, t = mesh
        batch = make_batch(cfg, 8, S, 0)
        got = tr.put_batch(batch)["tokens"]
        assert tuple(got.shape) == (pod * d * t, 8 // (pod * d), S)
        rows = np.asarray(batch["tokens"]).reshape(pod * d, -1, S)
        for lane in range(pod * d * t):
            np.testing.assert_array_equal(got[lane].numpy(),
                                          rows[lane // t])
