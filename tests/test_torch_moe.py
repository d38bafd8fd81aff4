"""The port's Mixture-of-Experts slice against the JAX package on the CPU:
``dist.ops.ep_alltoall``, ``models.moe`` and phi3.5-moe-42b-a6.6b's smoke
model, forward, prefill, decode and served.

Weights: seeded numpy (or the JAX package's ``init_tree``), carried into
the port by ``params.from_reference`` and cut along their "model" dims
(and "data" dims on a mesh) by the JAX package's own specs for the
reference side, which runs under ``vmap(axis_name="model")`` (nested
``vmap`` over ``data`` outside ``model`` on a mesh).

Routing first, values second: ``lax.top_k`` breaks ties toward the lower
index and ``torch.topk`` makes no promise, and near-ties can be decided
by a different summation order.  Each ``moe_block`` test therefore
asserts first that the expert ids and the kept (token, slot) choices
equal the reference's (the same router computed with ``jnp``), then
compares values: float32 outputs and aux within 1e-5 of the output's
max-norm (summation order only), a drop that differs would move an
output row by O(1).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import (port_cfg, port_params, ref_params, ref_shard,
                               rel, rvmap, tnp)

from repro import configs as rconfigs
from repro.core import api as rapi
from repro.dist import ops as rops
from repro.models import lm as rlm
from repro.models import moe as rmoe
from repro.models.config import ModelConfig as RCfg
from repro.models.config import MoEConfig as RMoE
from repro_torch.core import api as tapi
from repro_torch.core._axis import StackedAxis, StackedMesh
from repro_torch.dist import axes as taxes
from repro_torch.dist import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.models import moe as tmoe
from repro_torch.models import params as tparams
from repro_torch.models.config import ModelConfig as TCfg
from repro_torch.models.config import MoEConfig as TMoE

ARCH = "phi3.5-moe-42b-a6.6b"
D, F_EXP = 32, 48
B, S = 4, 16                      # T = 64 tokens
MOE_RTOL = 1e-5


# ---------------------------------------------------------------------------
# ep_alltoall
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p", [2, 4])
def test_ep_alltoall_value_and_grad_match_the_reference(p):
    """Value and vjp against the JAX package's ``_alltoall`` pair under
    ``vmap(axis_name="model")``; the backward is the same alltoall,
    dispatched under phase ``bwd`` (exact: a permutation)."""
    rng = np.random.default_rng(p)
    x = rng.normal(size=(p, 3 * p, 5)).astype(np.float32)
    c = rng.normal(size=x.shape).astype(np.float32)

    def ref(xs, cs):
        y, vjp = jax.vjp(lambda a: rops.ep_alltoall(a), xs)
        return y, vjp(cs)[0]
    ry, rg = jax.vmap(ref, axis_name="model")(jnp.asarray(x), jnp.asarray(c))

    xt = torch.tensor(x, requires_grad=True)
    with taxes.bind(model=StackedAxis(p, "cpu")), tapi.tuned() as ctx:
        y = tops.ep_alltoall(xt)
        (y * torch.as_tensor(c)).sum().backward()
    np.testing.assert_array_equal(tnp(y), np.asarray(ry))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(rg))
    assert [(r.cell.op, r.phase) for r in ctx.record] == [
        ("alltoall", "fwd"), ("alltoall", "bwd")]
    # over an unbound axis: the identity, nothing dispatched
    with tapi.tuned() as ctx:
        assert tops.ep_alltoall(xt) is xt
    assert not ctx.record


@pytest.mark.parametrize("impl", ["alltoall_as_alltoallv",
                                  "alltoall_as_ppermute"])
def test_ep_alltoall_forced_impls_equal_the_default_with_their_grads(impl):
    x = np.random.default_rng(7).normal(size=(4, 8, 3)).astype(np.float32)
    out = {}
    for force in (None, {"alltoall": impl}):
        xt = torch.tensor(x, requires_grad=True)
        with taxes.bind(model=StackedAxis(4, "cpu")), \
                tapi.tuned(force=force) as ctx:
            y = tops.ep_alltoall(xt)
            (y * torch.arange(y.numel()).view(y.shape)).sum().backward()
        out[force is None] = (y.detach(), xt.grad)
        assert {r.impl for r in ctx.record} == {impl if force else "default"}
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][1], out[False][1])


# ---------------------------------------------------------------------------
# moe_block
# ---------------------------------------------------------------------------


def _rcfg(n_experts=4, capacity_factor=0.5, n_shared=0,
          global_capacity=False):
    return RCfg(name="moe-test", family="moe", n_layers=1, d_model=D,
                n_heads=2, n_kv_heads=2, d_ff=F_EXP, vocab_size=64,
                dtype="float32",
                moe=RMoE(n_experts=n_experts, top_k=2, d_ff_expert=F_EXP,
                         n_shared=n_shared, capacity_factor=capacity_factor,
                         global_capacity=global_capacity))


def _tcfg(rcfg):
    kw = {f.name: getattr(rcfg, f.name) for f in dataclasses.fields(rcfg)}
    kw["moe"] = TMoE(**dataclasses.asdict(rcfg.moe))
    return TCfg(**kw)


def _weights(rcfg, seed=3):
    """A global float32 tree for ``moe_specs`` from a seeded numpy
    generator (the router scaled up so that routing is decisive)."""
    rng = np.random.default_rng(seed)

    def leaf(s):
        std = 1.0 if s.shape == (D, rcfg.moe.n_experts) else 0.2
        return (rng.normal(size=s.shape) * std).astype(np.float32)
    return jax.tree.map(leaf, rmoe.moe_specs(rcfg),
                        is_leaf=lambda s: hasattr(s, "dims"))


def _cut(tree, specs, sizes):
    """Global leaves -> per-lane shards ``[*mesh, *local]`` for the nested
    ``vmap``: each dim assigned to a name of ``sizes`` split into that
    many blocks; ``sizes`` lists the names outer first."""
    def one(a, s):
        a = jnp.asarray(a)
        for k, (name, n) in enumerate(sizes):
            if name in s.dims:
                i = s.dims.index(name) + k
                a = jnp.moveaxis(jnp.stack(jnp.split(a, n, axis=i)), 0, k)
            else:
                a = jnp.broadcast_to(a[(slice(None),) * k + (None,)],
                                     a.shape[:k] + (n,) + a.shape[k:])
        return a
    return jax.tree.map(one, tree, specs,
                        is_leaf=lambda s: hasattr(s, "dims"))


def _x(seed=4, b=B):
    return np.random.default_rng(seed).normal(size=(b, S, D)).astype(
        np.float32)


def ref_routes(tree, rcfg, x):
    """The JAX package's routing and keep decision (``models/moe.py``
    :69-117, local capacity), computed here with ``jnp`` on one device:
    ``(expert_ids [T, k], keep [T*k])``."""
    m = rcfg.moe
    xt = jnp.asarray(x).reshape(-1, D)
    probs = jax.nn.softmax(xt @ jnp.asarray(tree["router"]), axis=-1)
    _, ids = jax.lax.top_k(probs, m.top_k)
    flat = ids.reshape(-1)
    oh = jax.nn.one_hot(flat, m.n_experts, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(oh, axis=0) - 1) * oh, axis=-1)
    return np.asarray(ids), np.asarray(pos < rmoe._capacity(xt.shape[0],
                                                            rcfg))


def port_routes(params, tcfg, x):
    xt = torch.as_tensor(x).reshape(1, -1, D)
    _, _, ids = tmoe._route({"router": params["router"][:1]}, tcfg, xt)
    _, keep, *_ = tmoe._keep(tcfg, ids.reshape(1, -1), xt.shape[1])
    return ids[0].numpy(), keep[0].numpy()


def _ref_block(tree, rcfg, x, tp):
    rp = _cut(tree, rmoe.moe_specs(rcfg), [("model", tp)])
    return rvmap(lambda p, a: rmoe.moe_block(p, rcfg, a), rp,
                 jnp.asarray(x), in_axes=(0, None))


def _port_block(tree, tcfg, x, axis, **bound):
    params = tparams.from_reference(tree, tmoe.moe_specs(tcfg), axis)
    xt = torch.as_tensor(x)
    with taxes.bind(**bound):
        y, aux = tmoe.moe_block(params, tcfg, xt.expand(
            axis.lanes, *xt.shape))
    return params, y, aux


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("n_experts", [4, 8])
def test_moe_block_matches_the_reference_with_drops(n_experts, tp):
    """A capacity factor of 0.5 drops choices; ids and the kept set first,
    then outputs and aux."""
    rcfg = _rcfg(n_experts)
    tcfg = _tcfg(rcfg)
    tree, x = _weights(rcfg), _x()
    rids, rkeep = ref_routes(tree, rcfg, x)
    assert not rkeep.all(), "the capacity factor must drop choices here"
    axis = StackedAxis(tp, "cpu")
    params, y, aux = _port_block(tree, tcfg, x, axis, model=axis)
    tids, tkeep = port_routes(params, tcfg, x)
    np.testing.assert_array_equal(tids, rids)
    np.testing.assert_array_equal(tkeep, rkeep)
    ry, raux = _ref_block(tree, rcfg, x, tp)
    assert tuple(aux.shape) == (tp,)
    assert rel(tnp(y), ry) <= MOE_RTOL
    np.testing.assert_allclose(tnp(aux), np.asarray(raux), rtol=MOE_RTOL)
    # a dropped choice contributes nothing: a token with both choices
    # dropped has a zero output
    both = ~rkeep.reshape(-1, 2).any(-1)
    if both.any():
        assert not tnp(y)[0].reshape(-1, D)[both].any()


def test_moe_block_with_a_shared_expert_matches_the_reference():
    rcfg = _rcfg(4, capacity_factor=1.25, n_shared=1)
    tcfg = _tcfg(rcfg)
    tree, x = _weights(rcfg, seed=5), _x(6)
    axis = StackedAxis(2, "cpu")
    params, y, aux = _port_block(tree, tcfg, x, axis, model=axis)
    np.testing.assert_array_equal(port_routes(params, tcfg, x)[0],
                                  ref_routes(tree, rcfg, x)[0])
    ry, raux = _ref_block(tree, rcfg, x, 2)
    assert rel(tnp(y), ry) <= MOE_RTOL
    np.testing.assert_allclose(tnp(aux), np.asarray(raux), rtol=MOE_RTOL)


def test_moe_block_backward_runs_its_alltoalls_under_bwd():
    """Gradients flow through both shuffles: each alltoall of the forward
    has its backward twin, dispatched under phase ``bwd``."""
    rcfg = _rcfg(4)
    tcfg = _tcfg(rcfg)
    axis = StackedAxis(2, "cpu")
    params = tparams.from_reference(_weights(rcfg), tmoe.moe_specs(tcfg),
                                    axis)
    for t in params.values():
        t.requires_grad_(True)
    x = torch.as_tensor(_x()).expand(2, B, S, D).clone().requires_grad_(True)
    with taxes.bind(model=axis), tapi.tuned() as ctx:
        y, aux = tmoe.moe_block(params, tcfg, x)
        (y.square().sum() + aux.sum()).backward()
    ops = [(r.cell.op, r.phase) for r in ctx.record]
    assert ops.count(("alltoall", "fwd")) == 2
    assert ops.count(("alltoall", "bwd")) == 2
    assert all(bool(torch.isfinite(t.grad).all()) and bool(t.grad.any())
               for t in (x, *params.values()))


@pytest.mark.parametrize("layout", ["model 4", "data 2 x model 2"])
def test_expert_leaves_carry_shard_and_checkpoint_in_the_global_layout(
        layout, tmp_path):
    """The expert leaves are 3-D and cut on their leading dim over model
    (and on d_model over data); the router is float32, cut over data
    only.  The weight carrier, ``init_tree`` and ``to_reference`` agree on
    that cut, and a checkpoint of the global tree restores bit for bit."""
    from repro_torch.ckpt import checkpoint as ckpt
    rcfg = _rcfg(8, n_shared=1)
    tcfg = _tcfg(rcfg)
    specs = tmoe.moe_specs(tcfg)
    if layout == "model 4":
        axis, sizes = StackedAxis(4, "cpu"), [("model", 4)]
    else:
        axis = StackedMesh((2, 2), ("data", "model"), "cpu")
        sizes = [("data", 2), ("model", 2)]
    tree = _weights(rcfg, 12)
    params = tparams.from_reference(tree, specs, axis)
    cut = _cut(tree, rmoe.moe_specs(rcfg), sizes)
    for k in ("router", "w_in", "w_gate", "w_out"):
        want = np.asarray(cut[k]).reshape(params[k].shape)
        np.testing.assert_array_equal(params[k].numpy(), want)
    assert params["router"].dtype == torch.float32
    back = tparams.to_reference(params, specs, axis)
    for k in ("router", "w_in", "w_gate", "w_out"):
        np.testing.assert_array_equal(back[k].numpy(), tree[k])
    ckpt.save(tmp_path, 1, back)
    got = ckpt.restore(tmp_path, 1, back)
    assert all(torch.equal(got[k], back[k]) for k in ("router", "w_in"))
    # init_tree: one global draw cut the same way, whatever the layout
    g1 = torch.Generator().manual_seed(0)
    g2 = torch.Generator().manual_seed(0)
    one = tparams.init_tree(specs, g1, StackedAxis(1, "cpu"))
    many = tparams.init_tree(specs, g2, axis)
    for k in ("router", "w_in", "w_out"):
        torch.testing.assert_close(
            tparams.to_reference(many, specs, axis)[k], one[k][0],
            rtol=0, atol=0)


# -- global capacity on a (data 2, model tp) stacked mesh ---------------------

DP = 2


def _mesh_both(rcfg, tree, x, tp, force=None):
    """The block on a (data DP, model tp) mesh: the JAX package under
    nested vmap (data outside), the port on a ``StackedMesh`` with both
    names bound.  Both ``[DP, tp, B/DP, S, D]``, and the port's record."""
    tcfg = _tcfg(rcfg)
    xs = x.reshape(DP, B // DP, S, D)
    rp = _cut(tree, rmoe.moe_specs(rcfg), [("data", DP), ("model", tp)])
    xr = jnp.broadcast_to(jnp.asarray(xs)[:, None],
                          (DP, tp) + xs.shape[1:])
    f = jax.vmap(jax.vmap(lambda p, a: rmoe.moe_block(p, rcfg, a)[0],
                          axis_name="model"), axis_name="data")
    with rapi.tuned(force=force or {}):
        ry = np.asarray(f(rp, xr))
    mesh = StackedMesh((DP, tp), ("data", "model"), "cpu")
    params = tparams.from_reference(tree, tmoe.moe_specs(tcfg), mesh)
    xt = torch.as_tensor(xs).repeat_interleave(tp, dim=0)  # lane i*tp + j
    with taxes.bind(data=mesh["data"], model=mesh["model"]), \
            tapi.tuned(force=force or {}) as ctx:
        y, _ = tmoe.moe_block(params, tcfg, xt)
    return tnp(y).reshape(DP, tp, B // DP, S, D), ry, ctx.record


def _single(rcfg, tree, x):
    tcfg = _tcfg(rcfg)
    axis = StackedAxis(1, "cpu")
    return tnp(_port_block(tree, tcfg, x, axis)[1])[0]


@pytest.mark.parametrize("tp", [1, 2])
def test_global_capacity_matches_single_device_exactly(tp):
    rcfg = _rcfg(4, capacity_factor=0.75, global_capacity=True)
    tree, x = _weights(rcfg, 8), _x(9)
    got, ry, _ = _mesh_both(rcfg, tree, x, tp)
    want = _single(rcfg, tree, x)
    for j in range(tp):
        np.testing.assert_allclose(got[:, j].reshape(B, S, D), want,
                                   rtol=0, atol=1e-6)
    assert rel(got, ry) <= MOE_RTOL


def test_local_capacity_diverges_on_this_batch():
    """The divergence global capacity removes exists on this batch, in
    both packages alike."""
    rcfg = _rcfg(4, capacity_factor=0.75, global_capacity=False)
    tree, x = _weights(rcfg, 8), _x(9)
    got, ry, _ = _mesh_both(rcfg, tree, x, 2)
    want = _single(rcfg, tree, x)
    assert np.abs(got[:, 0].reshape(B, S, D) - want).max() > 1e-3
    assert rel(got, ry) <= MOE_RTOL


def test_global_capacity_router_allreduce_is_tunable():
    """The router-stats exchange is one dispatched allreduce over data of
    ``[DP, E]`` int32: a forced impl serves it, with the same result."""
    rcfg = _rcfg(4, capacity_factor=0.75, global_capacity=True)
    tree, x = _weights(rcfg, 8), _x(9)
    base, _, _ = _mesh_both(rcfg, tree, x, 2)
    got, ry, rec = _mesh_both(rcfg, tree, x, 2,
                              force={"allreduce": "allreduce_as_doubling"})
    stats = [r for r in rec if r.cell.op == "allreduce"
             and r.cell.nbytes == DP * 4 * 4]
    assert len(stats) == 1 and stats[0].impl == "allreduce_as_doubling"
    np.testing.assert_array_equal(got, base)
    assert rel(got, ry) <= MOE_RTOL


def test_global_capacity_noop_without_data_axis():
    x = _x(9)
    ys = []
    for gc in (True, False):
        rcfg = _rcfg(4, capacity_factor=0.75, global_capacity=gc)
        axis = StackedAxis(2, "cpu")
        with tapi.tuned() as ctx:
            ys.append(tnp(_port_block(_weights(rcfg, 8), _tcfg(rcfg), x,
                                      axis, model=axis)[1]))
        assert all(r.cell.op == "alltoall" for r in ctx.record)
    np.testing.assert_array_equal(ys[0], ys[1])


def test_global_capacity_with_expert_parallelism():
    """(data 2, model 2): every model rank of every data rank matches the
    single-device run, and the nested-vmap reference."""
    rcfg = _rcfg(4, capacity_factor=0.75, global_capacity=True)
    tree, x = _weights(rcfg, 10), _x(11)
    got, ry, rec = _mesh_both(rcfg, tree, x, 2)
    want = _single(rcfg, tree, x)
    np.testing.assert_allclose(got[:, 0].reshape(B, S, D), want, atol=1e-5)
    np.testing.assert_array_equal(got[:, 1], got[:, 0])
    assert rel(got, ry) <= MOE_RTOL
    assert {r.cell.op for r in rec} >= {"alltoall", "allreduce",
                                        "allgather"}


# ---------------------------------------------------------------------------
# the whole phi3.5 smoke model
# ---------------------------------------------------------------------------


def phi(dtype="float32", **moe_kw):
    rcfg = rconfigs.get_config(ARCH).smoke()
    return dataclasses.replace(
        rcfg, dtype=dtype, scan_layers=False,
        moe=dataclasses.replace(rcfg.moe, **moe_kw))


def test_the_moe_block_kind_is_ported_and_its_specs_match():
    from test_torch_models import specs_match
    for tp in (1, 2, 4):
        specs_match(phi(), tp)
    specs_match(dataclasses.replace(phi(), scan_layers=True), 2)


@pytest.mark.parametrize("tp", [1, 2])
def test_phi_forward_matches_with_aux(tp):
    rcfg = phi()
    tree = ref_params(rcfg, seed=3)
    rp = ref_shard(tree, rcfg, tp)
    params, axis = port_params(tree, rcfg, tp)
    toks = np.random.default_rng(4).integers(0, rcfg.vocab_size, (B, S))
    want, _, raux = rvmap(lambda p: rlm.forward(
        p, rcfg, {"tokens": jnp.asarray(toks, jnp.int32)}), rp)
    with taxes.bind(model=axis):
        got, _, aux = tlm_forward(params, rcfg, toks)
    assert rel(tnp(got), want) <= 1e-4
    np.testing.assert_allclose(tnp(aux), np.asarray(raux), rtol=1e-5)
    # loss_fn adds 0.01 of it, as the JAX package's does
    from repro_torch.models import lm as tlm
    batch = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(toks)}
    with taxes.bind(model=axis):
        loss, parts = tlm.loss_fn(params, port_cfg(rcfg), batch)
    rloss, _ = rvmap(lambda p: rlm.loss_fn(p, rcfg, {
        "tokens": jnp.asarray(toks, jnp.int32),
        "labels": jnp.asarray(toks, jnp.int32)}), rp)
    np.testing.assert_allclose(tnp(loss), np.asarray(rloss), rtol=1e-5)


def tlm_forward(params, rcfg, toks):
    from repro_torch.models import lm as tlm
    return tlm.forward(params, port_cfg(rcfg), {"tokens": torch.as_tensor(
        toks)})


@pytest.mark.parametrize("tp", [1, 2])
def test_phi_prefill_then_decode_matches(tp):
    """A prefill of 11 tokens and 4 decode steps in a 16-slot cache, each
    step's logits against the reference (1e-4 max-norm relative)."""
    from repro_torch.models import lm as tlm
    rcfg = phi()
    tcfg = port_cfg(rcfg)
    tree = ref_params(rcfg, seed=5)
    rp = ref_shard(tree, rcfg, tp)
    params, axis = port_params(tree, rcfg, tp)
    n_pre, n_dec, slots = 11, 4, 16
    toks = np.random.default_rng(6).integers(0, rcfg.vocab_size,
                                             (2, n_pre + n_dec))
    jt = jnp.asarray(toks, jnp.int32)

    def ref_steps(p):
        c = rlm.init_caches(rcfg, 2, slots)
        lg, c = rlm.prefill(p, rcfg, {"tokens": jt[:, :n_pre]}, c)
        out = [lg]
        for i in range(n_pre, n_pre + n_dec):
            lg, c = rlm.decode_step(p, rcfg, jt[:, i:i + 1], c, i)
            out.append(lg)
        return out
    want = rvmap(ref_steps, rp)
    tt = torch.as_tensor(toks)
    with taxes.bind(model=axis):
        caches = tlm.init_caches(tcfg, 2, slots)
        lg, caches = tlm.prefill(params, tcfg, {"tokens": tt[:, :n_pre]},
                                 caches)
        got = [lg]
        for i in range(n_pre, n_pre + n_dec):
            lg, caches = tlm.decode_step(params, tcfg, tt[:, i:i + 1],
                                         caches, i)
            got.append(lg)
    for g, w in zip(got, want):
        assert rel(tnp(g), w) <= 1e-4


@pytest.mark.parametrize("tp", [1, 2])
def test_phi_decode_matches_full_forward_without_drops(tp):
    """The port's counterpart of ``tests/test_models_smoke.py:109``: with
    a no-drop capacity factor the decode step equals the full forward at
    the last position (the JAX package's bar, 2e-2; here float32, 1e-4),
    and both equal the reference's."""
    from repro_torch.models import lm as tlm
    rcfg = phi(capacity_factor=8.0)
    tcfg = port_cfg(rcfg)
    tree = ref_params(rcfg, seed=1)
    rp = ref_shard(tree, rcfg, tp)
    params, axis = port_params(tree, rcfg, tp)
    toks = np.random.default_rng(5).integers(0, rcfg.vocab_size, (B, 12))
    jt = jnp.asarray(toks, jnp.int32)

    def ref_steps(p):
        full, _, _ = rlm.forward(p, rcfg, {"tokens": jt})
        c = rlm.init_caches(rcfg, B, 16)
        _, c = rlm.prefill(p, rcfg, {"tokens": jt[:, :-1]}, c)
        lg, _ = rlm.decode_step(p, rcfg, jt[:, -1:], c, 11)
        return full[:, -1], lg[:, 0]
    rfull, rlast = rvmap(ref_steps, rp)
    tt = torch.as_tensor(toks)
    with taxes.bind(model=axis):
        full, _, _ = tlm.forward(params, tcfg, {"tokens": tt})
        caches = tlm.init_caches(tcfg, B, 16)
        _, caches = tlm.prefill(params, tcfg, {"tokens": tt[:, :-1]}, caches)
        last, _ = tlm.decode_step(params, tcfg, tt[:, -1:], caches, 11)
    assert rel(tnp(last[:, :, 0]), tnp(full[:, :, -1])) <= 1e-4
    assert rel(tnp(full[:, :, -1]), rfull) <= 1e-4
    assert rel(tnp(last[:, :, 0]), rlast) <= 1e-4


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_phi_serve_records_alltoall_and_reserves_like_the_reference(
        tmp_path):
    """The serve at tp 2, float32, against the JAX package's serve loop:
    the same records (the two alltoalls of every MoE block among them),
    tokens and logits, and under the per-phase profiles the same picks."""
    from test_torch_serve import (N_TOKENS, S_MAX, _check_records,
                                  _prompts, ref_serve)
    from repro.core import costmodel as rcm
    from repro.core import trace as rtrace
    from repro.core import tuner as rtuner
    from repro_torch.core import costmodel as tcm
    from repro_torch.core import profiles as tprof
    from repro_torch.core import trace as ttrace
    from repro_torch.core import tuner as ttuner
    from test_torch_tuning import reference_without_wire

    tp = 2
    rcfg = dataclasses.replace(phi(), attn_impl="flash")
    tree = ref_params(rcfg, seed=2)
    rp = ref_shard(tree, rcfg, tp)
    params, axis = port_params(tree, rcfg, tp)
    tcfg = port_cfg(rcfg)
    prompts = _prompts(rcfg)
    r_toks, r_lgs, r_ctx = ref_serve(rcfg, tp, rp, prompts)
    res = tserve.serve(tcfg, axis, params, torch.as_tensor(prompts), S_MAX,
                       N_TOKENS)
    _check_records(res.ctx, r_ctx)
    n_moe = rcfg.n_layers
    assert sum(r.cell.op == "alltoall" and r.phase == "prefill"
               for r in res.ctx.record) == 2 * n_moe
    np.testing.assert_array_equal(res.tokens.numpy(), r_toks)
    for a, b in zip(r_lgs, res.logits):
        assert np.abs(a - b.numpy()).max() / np.abs(a).max() <= 1e-4

    r_trace = rtrace.Trace.from_context(r_ctx)
    t_trace = ttrace.Trace.from_context(res.ctx)
    with reference_without_wire():
        r_rep = rtuner.tune_trace(
            r_trace, rtuner.CostModelBackend(rcm.BGQ_LIKE))
    t_rep = ttuner.tune_trace(t_trace,
                              ttuner.CostModelBackend(tcm.BGQ_LIKE))
    for ph, store in r_rep.phase_profiles.items():
        assert sorted(p.to_text() for p in t_rep.phase_profiles[ph]) == \
            sorted(p.to_text() for p in store)
    t_rep.save(tmp_path / "port")
    _, phases = tprof.resolve_stores(tmp_path / "port")
    r_toks2, r_lgs2, r_ctx2 = ref_serve(rcfg, tp, rp, prompts,
                                        phase_profiles=r_rep.phase_profiles)
    res2 = tserve.serve(tcfg, axis, params, torch.as_tensor(prompts),
                        S_MAX, N_TOKENS, phase_profiles=phases)
    _check_records(res2.ctx, r_ctx2)
    np.testing.assert_array_equal(res2.tokens.numpy(), r_toks2)
    for a, b in zip(r_lgs2, res2.logits):
        assert np.abs(a - b.numpy()).max() / np.abs(a).max() <= 1e-4
    assert "MPI_Alltoall" in tapi.format_footer(res2.ctx)
    assert tapi.format_footer(res2.ctx).splitlines() == \
        rapi.format_footer(r_ctx2).splitlines()


def test_phi_cli_serves_tunes_and_reserves_on_the_cpu(tmp_path, capsys):
    assert tserve.main(["--device", "cpu", "--arch", ARCH, "--tp", "2",
                        "--batch", "2", "--prompt-len", "9", "--tokens", "3",
                        "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert f"arch={ARCH} (smoke)" in out and "logits agree" in out
    assert "MPI_Alltoall" in out
    assert (tmp_path / "trace.jsonl").exists()
