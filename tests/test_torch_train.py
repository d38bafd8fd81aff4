"""The port's training modules (``optim``, ``data``, ``train``, ``ckpt``,
``ft.watchdog``, ``launch.train``) against the JAX package on the CPU.

Model: the smoke config of llama3.2-3b (4 layers, d_model 64, 512
vocab), float32 for the numerical parity and bfloat16 where the
checkpoint must carry raw bits; weights are the JAX package's
``init_tree`` (its constant leaves randomized) carried across with
``params.from_reference``.  The reference trains under
``jax.vmap(axis_name=...)`` over its per-shard ``train_fn``
(``make_step_fns``), the port's ``Trainer`` on a ``StackedAxis`` of the
same size bound to the same name: FSDP over ``data`` and TP over
``model``, p = 4.

Tolerances (float32; the two packages differ in summation order only):
losses and grad norms 1e-5 relative; AdamW state and parameters 1e-5
of the leaf's max-norm plus 1e-7, since an update divides by
``sqrt(v) + eps`` and so carries the gradient's relative error
(~1e-6) into each element; the optimizer unit tests 1e-6.
"""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_ref  # noqa: F401  (the reference's import shims)
from test_torch_models import port_cfg, randomized, ref_params, smoke

from repro.ckpt import checkpoint as rck
from repro.core import api as rapi
from repro.data import make_batch as rmake_batch
from repro.models import layers as rlayers
from repro.models import lm as rlm
from repro.models.params import ParamSpec as RSpec
from repro.optim import optimizers as ropt
from repro.train import Trainer as RTrainer
from repro.train import trainer as rtrainer
from repro_torch.ckpt import AsyncCheckpointer
from repro_torch.ckpt import checkpoint as tck
from repro_torch.core._axis import StackedAxis, StackedMesh
from repro_torch.data import batch_specs, make_batch
from repro_torch.dist import axes as taxes
from repro_torch.ft import StepWatchdog
from repro_torch.launch import train as tlaunch
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models.params import from_reference, tree_leaves
from repro_torch.optim import optimizers as topt
from repro_torch.train import Trainer

P = 4
B, S = 8, 16
LR, WARM = 3e-3, 2
LAYOUTS = {"data": (P, 1), "model": (1, P)}


def tnp(t) -> np.ndarray:
    """A copy: the trainer updates its tensors in place."""
    return t.detach().float().cpu().numpy().copy()


def close(got, want, rtol=1e-5, atol=1e-7):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.max(np.abs(got - want), initial=0.0)
    assert err <= rtol * np.max(np.abs(want), initial=0.0) + atol, err


def pairs(port, ref, path=()):
    """``(path, port leaf, reference leaf)`` of two nested dicts."""
    if isinstance(port, dict):
        assert sorted(port) == sorted(ref), (path, sorted(port), sorted(ref))
        for k in port:
            yield from pairs(port[k], ref[k], path + (k,))
    else:
        yield "/".join(path), port, ref


def ref_cut(tree, rspecs, name, p):
    """The reference's global tree cut for ``vmap(axis_name=name)``: the
    dim assigned to ``name`` split into p shards, other leaves
    repeated."""
    def cut(a, s):
        for i, d in enumerate(s.dims):
            if d == name:
                return jnp.stack(jnp.split(jnp.asarray(a), p, axis=i))
        return jnp.stack([jnp.asarray(a)] * p)
    return jax.tree.map(cut, tree, rspecs,
                        is_leaf=lambda x: isinstance(x, RSpec))


def ref_join(stacked, rspecs, name):
    """The inverse of ``ref_cut`` (a replicated leaf is rank 0's)."""
    def join(a, s):
        a = np.asarray(a)
        for i, d in enumerate(s.dims):
            if d == name:
                return np.concatenate(list(a), axis=i)
        return a[0]
    return jax.tree.map(join, stacked, rspecs,
                        is_leaf=lambda x: isinstance(x, RSpec))


def rbatch(batch, name, p):
    return {k: jnp.asarray(v.reshape(p, -1, *v.shape[1:]) if name == "data"
                           else v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# lr schedule and optimizers on stacked leaves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("step", [0, 1, 7, 99, 100, 101, 5000, 10_000, 20_000])
def test_lr_schedule_matches(step):
    want = float(ropt.lr_schedule(step, base_lr=3e-4, warmup=100))
    got = float(topt.lr_schedule(step, base_lr=3e-4, warmup=100))
    assert got == pytest.approx(want, rel=1e-6, abs=0)


SHAPES = {"mat": (6, 5), "vec": (7,), "cube": (2, 3, 4)}


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_matches_per_rank_on_stacked_leaves(name):
    """Three updates of stacked leaves (2-D, 1-D and 3-D per rank) against
    the reference applied per rank under vmap: the stacked [p, d] leaf is
    not factored, and Adafactor's means and rms stay within a rank."""
    rng = np.random.default_rng(0)
    params = {k: rng.normal(size=(P,) + s).astype(np.float32)
              for k, s in SHAPES.items()}
    r_init, r_upd = ropt.get_optimizer(name)
    t_init, t_upd = topt.get_optimizer(name)
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    rs = jax.vmap(r_init)(rp)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    ts = t_init(tp)
    if name == "adafactor":
        assert set(ts["f"]["vec"]) == {"v"}
        assert set(ts["f"]["mat"]) == {"vr", "vc"}
    for i in range(3):
        g = {k: rng.normal(size=(P,) + s).astype(np.float32)
             for k, s in SHAPES.items()}
        g["mat"][1] *= 100.0          # one rank's clip differs
        lr = ropt.lr_schedule(i + 5, base_lr=1e-2, warmup=4)
        rp, rs = jax.vmap(lambda g_, s_, p_: r_upd(g_, s_, p_, lr=lr))(
            {k: jnp.asarray(v) for k, v in g.items()}, rs, rp)
        tp, ts = t_upd({k: torch.tensor(v) for k, v in g.items()}, ts, tp,
                       lr=topt.lr_schedule(i + 5, base_lr=1e-2, warmup=4))
    for k in SHAPES:
        close(tnp(tp[k]), rp[k], rtol=1e-6)
    for path, t, r in pairs({k: v for k, v in ts.items() if k != "count"},
                            {k: v for k, v in rs.items() if k != "count"}):
        close(tnp(t), r, rtol=1e-6)
    assert int(ts["count"]) == 3 and np.all(np.asarray(rs["count"]) == 3)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shard,n_shards", [(0, 1), (1, 2), (3, 4)])
def test_make_batch_equals_the_reference_in_process(shard, n_shards):
    cfg = smoke()
    for step in (0, 7):
        got = make_batch(port_cfg(cfg), 8, 32, step, shard=shard,
                         n_shards=n_shards)
        want = rmake_batch(cfg, 8, 32, step, shard=shard, n_shards=n_shards)
        assert sorted(got) == sorted(want)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    specs = batch_specs(port_cfg(cfg), 8, 32)
    assert specs["tokens"] == ((8, 32), "int32")


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_sharded_xent_and_its_grad_match(tp):
    rng = np.random.default_rng(tp)
    v = 32
    logits = rng.normal(size=(tp, 2, 5, v // tp)).astype(np.float32) * 3
    labels = rng.integers(0, v, size=(2, 5))
    mask = (rng.random((2, 5)) > 0.3).astype(np.float32)

    def rf(lg, m):
        return rlayers.sharded_xent(lg, jnp.asarray(labels), m)
    for m in (None, mask):
        want, wg = jax.vmap(jax.value_and_grad(rf), in_axes=(0, None),
                            axis_name="model")(jnp.asarray(logits),
                                               None if m is None else
                                               jnp.asarray(m))
        lt = torch.tensor(logits, requires_grad=True)
        with taxes.bind(model=StackedAxis(tp, "cpu")):
            got = tlayers.sharded_xent(lt, torch.as_tensor(labels),
                                       None if m is None else
                                       torch.as_tensor(m))
        got.sum().backward()
        close(tnp(got), want, rtol=1e-6)
        close(tnp(lt.grad), wg, rtol=1e-5)


@pytest.mark.parametrize("name,p", [("model", 1), ("model", 2), ("model", 4),
                                    ("data", 2), ("data", 4)])
def test_loss_fn_matches(name, p):
    rcfg = smoke("float32", scan_layers=False)
    tree = randomized(ref_params(rcfg), 3)
    tp = p if name == "model" else 1
    rp = ref_cut(tree, rlm.model_specs(rcfg, tp=tp), name, p)
    batch = rmake_batch(rcfg, B, S, 0)
    in_b = 0 if name == "data" else None
    want = jax.vmap(lambda q, b: rlm.loss_fn(q, rcfg, b)[0],
                    in_axes=(0, in_b), axis_name=name)(
        rp, rbatch(batch, name, p))
    tr = Trainer(port_cfg(rcfg), mesh=(p, 1) if name == "data" else (1, p),
                 device="cpu")
    params = from_reference(tree, tr.specs, tr.axis, tr.name or "model")
    with tr._tuned():
        got, aux = tlm.loss_fn(params, tr.cfg, tr.put_batch(batch))
    assert aux["aux"] == 0.0 and got.shape == (p,)
    close(tnp(got), want, rtol=1e-5)


# ---------------------------------------------------------------------------
# Trainer against the reference's train_fn
# ---------------------------------------------------------------------------


def _ref_trajectory(rcfg, tree, name, n_steps, n_micro=1):
    """The reference's train_fn under vmap: per step (metrics, params,
    opt) as numpy, and the records of its (single) trace."""
    _, rtrain = rtrainer.make_step_fns(rcfg, n_micro=n_micro, base_lr=LR,
                                       warmup=WARM)
    tp = P if name == "model" else 1
    rspecs = rlm.model_specs(rcfg, tp=tp)
    params = ref_cut(tree, rspecs, name, P)
    opt = jax.vmap(ropt.get_optimizer(rcfg.optimizer)[0])(params)
    in_b = 0 if name == "data" else None
    fn = jax.jit(jax.vmap(rtrain, in_axes=(0, 0, in_b, None),
                          axis_name=name))
    out, rec = [], []
    for i in range(n_steps):
        with rapi.tuned(record=rec):
            params, opt, m = fn(params, opt,
                                rbatch(rmake_batch(rcfg, B, S, i), name, P),
                                jnp.int32(i))
        out.append(jax.tree.map(np.asarray, (m, params, opt)))
    return out, rec, rspecs


@pytest.fixture(scope="module", params=["data", "model"])
def trajectory(request):
    name = request.param
    rcfg = smoke("float32", scan_layers=False)
    tree = randomized(ref_params(rcfg), 2)
    ref, rrec, rspecs = _ref_trajectory(rcfg, tree, name, 3)
    tr = Trainer(port_cfg(rcfg), mesh=LAYOUTS[name], device="cpu",
                 base_lr=LR, warmup=WARM, record=[])
    _, opt = tr.init(0)
    params = from_reference(tree, tr.specs, tr.axis, name)
    got = []
    for i in range(3):
        n_rec = len(tr.record)
        params, opt, m = tr.step(params, opt,
                                 tr.put_batch(make_batch(tr.cfg, B, S, i)), i)
        got.append(({k: float(v) for k, v in m.items()},
                    _np_tree({"params": params, "opt": opt}),
                    tr.record[n_rec:]))
    return name, ref, rrec, got, rspecs


def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    return tnp(t)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_trainer_steps_match_the_reference(trajectory, n_steps):
    name, ref, _, got, _ = trajectory
    for i in range(n_steps):
        (rm, rp, ro), (tm, tstate, _) = ref[i], got[i]
        assert tm["loss"] == pytest.approx(float(rm["loss"][0]), rel=1e-5)
        assert tm["grad_norm"] == pytest.approx(float(rm["grad_norm"][0]),
                                                rel=1e-5)
        assert tm["lr"] == pytest.approx(float(rm["lr"][0]), rel=1e-6)
        for path, t, r in pairs(tstate["params"], rp):
            close(t, r)
        for path, t, r in pairs(tstate["opt"], ro):
            if path == "count":
                assert int(t) == i + 1 and np.all(r == i + 1)
            else:
                close(t, r)
    if n_steps == 3:
        assert not np.array_equal(got[2][1]["params"]["embed"]["table"],
                                  got[0][1]["params"]["embed"]["table"])


def test_trainer_step_records_equal_the_reference_trace(trajectory):
    """One port step dispatches what the reference's one trace recorded:
    the forward collectives, every backward pair's under ``bwd``, the
    grad-sync allreduces under ``bwd`` and the metric allreduces."""
    import collections
    name, _, rrec, got, _ = trajectory

    def key(rec):
        return collections.Counter((dataclasses.astuple(r.cell), r.impl,
                                    r.phase) for r in rec)
    assert key(got[0][2]) == key(rrec)
    assert key(got[1][2]) == key(rrec)
    phases = collections.Counter(r.phase for r in rrec)
    assert phases["bwd"] > 0 and phases["fwd"] > 0


def test_trainer_resumes_from_a_carried_reference_state():
    """The reference's AdamW state after its first step (m, v, count),
    joined to global shapes and carried in with ``from_global``: the
    port's second step matches the reference's."""
    rcfg = smoke("float32", scan_layers=False)
    tree = randomized(ref_params(rcfg), 4)
    ref, _, rspecs = _ref_trajectory(rcfg, tree, "data", 2)
    _, p1, o1 = ref[0]
    tr = Trainer(port_cfg(rcfg), mesh=(P, 1), device="cpu", base_lr=LR,
                 warmup=WARM)
    params, opt = tr.from_global({
        "params": ref_join(p1, rspecs, "data"),
        "opt": {"m": ref_join(o1["m"], rspecs, "data"),
                "v": ref_join(o1["v"], rspecs, "data"),
                "count": o1["count"][0]}})
    assert int(opt["count"]) == 1
    params, opt, m = tr.step(params, opt,
                             tr.put_batch(make_batch(tr.cfg, B, S, 1)), 1)
    rm, rp, _ = ref[1]
    assert float(m["loss"]) == pytest.approx(float(rm["loss"][0]), rel=1e-5)
    for path, t, r in pairs(_np_tree(params), rp):
        close(t, r)


def test_microbatch_equivalence():
    """n_micro = 2 against 1 on the same batch: the loss is the mean over
    the same tokens, the grads the mean of the microbatches' (FSDP p = 4,
    2 sequences per rank)."""
    cfg = port_cfg(smoke("float32", scan_layers=False))
    out = []
    for n_micro in (1, 2):
        tr = Trainer(cfg, mesh=(P, 1), device="cpu", n_micro=n_micro,
                     base_lr=LR, warmup=WARM)
        params, opt = tr.init(3)
        batch = tr.put_batch(make_batch(cfg, B, S, 0))
        loss, grads = tr.grads(params, batch)
        for i in range(2):
            params, opt, m = tr.step(params, opt, batch, i)
        out.append((float(loss), [tnp(g) for g in tree_leaves(grads)],
                    [tnp(p) for p in tree_leaves(params)]))
    (l1, g1, p1), (l2, g2, p2) = out
    assert l1 == pytest.approx(l2, rel=1e-5)
    for a, b in zip(g1, g2):
        close(b, a, rtol=1e-5, atol=1e-8)
    for a, b in zip(p1, p2):
        close(b, a, rtol=1e-4, atol=1e-6)


def test_loss_decreases():
    cfg = port_cfg(smoke())
    tr = Trainer(cfg, mesh=(1, 2), device="cpu", base_lr=3e-3, warmup=5)
    params, opt = tr.init(0)
    losses = []
    for i in range(25):
        params, opt, m = tr.step(params, opt,
                                 tr.put_batch(make_batch(cfg, 8, 32, i)), i)
        losses.append(float(m["loss"]))
    assert np.all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses


def test_trainer_refuses_both_axes_and_training_through_flash():
    """Both axes above 1 build the data x model mesh, and training through
    flash takes its autograd Function: what is refused is a mesh with an
    empty axis.  The flash step equals the ``ref`` step from the same
    weights (the two attention paths differ in summation order only)."""
    cfg = port_cfg(smoke("float32"))
    assert isinstance(Trainer(cfg, mesh=(2, 2), device="cpu").axis,
                      StackedMesh)
    with pytest.raises(ValueError, match=">= 1"):
        Trainer(cfg, mesh=(2, 0), device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        Trainer(cfg, mesh=(2, 1, 0), device="cpu")
    out = []
    for impl in ("flash", "ref"):
        tr = Trainer(dataclasses.replace(cfg, attn_impl=impl), mesh=(1, 2),
                     device="cpu")
        params, opt = tr.init(0)
        params, opt, m = tr.step(params, opt,
                                 tr.put_batch(make_batch(cfg, 2, 8, 0)), 0)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    assert np.isfinite(out[0]).all()
    assert out[0] == pytest.approx(out[1], rel=1e-5)


def test_trainer_without_a_device_refuses_the_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(port_cfg(smoke()), mesh=(2, 1))


# ---------------------------------------------------------------------------
# checkpoints: the reference's layout, both directions
# ---------------------------------------------------------------------------


def _bf16_trainer(mesh):
    cfg = port_cfg(smoke("bfloat16"))             # a scanned group
    return Trainer(cfg, mesh=mesh, device="cpu", base_lr=LR, warmup=WARM)


def _stepped(tr, n=2):
    params, opt = tr.init(5)
    for i in range(n):
        params, opt, _ = tr.step(params, opt,
                                 tr.put_batch(make_batch(tr.cfg, B, S, i)),
                                 i)
    return params, opt


@pytest.mark.parametrize("mesh", [(P, 1), (1, P), (1, 1)])
def test_ckpt_roundtrip(tmp_path, mesh):
    tr = _bf16_trainer(mesh)
    params, opt = _stepped(tr)
    g = tr.to_global(params, opt)
    tck.save(tmp_path, 2, g, extra={"mesh": list(mesh)})
    assert tck.latest_step(tmp_path) == 2
    man = tck.manifest(tmp_path, 2)
    assert man["extra"] == {"mesh": list(mesh)}
    assert man["dtypes"]["params/embed/table"] == "uint16"
    assert man["shapes"]["params/stack/g0/b0_attn/attn/w_q"] == [4, 64, 64]
    back = tck.restore(tmp_path, 2, tr.global_specs())
    p2, o2 = tr.from_global(back)
    # global arrays round-trip bit for bit.  A leaf replicated over the
    # model axis comes back as rank 0's copy: under TP with replicated K/V
    # (2 KV heads, tp 4) the reference's ln1 grads differ per rank, and
    # its shard_map out_specs P() keeps one copy too
    for path, t, r in pairs(_np_tree(tr.to_global(p2, o2)), _np_tree(g)):
        np.testing.assert_array_equal(t, r)
    for a, b in zip(tree_leaves(params), tree_leaves(p2)):
        assert a.dtype == b.dtype and a.shape == b.shape
    other = _bf16_trainer((2, 1) if mesh != (2, 1) else (1, 2))
    p3, o3 = other.from_global(back)       # another layout, same model
    for path, t, r in pairs(_np_tree(other.to_global(p3, o3)["params"]),
                            _np_tree(g["params"])):
        np.testing.assert_array_equal(t, r)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tr = _bf16_trainer((P, 1))
    params, opt = _stepped(tr)
    g = tr.to_global(params, opt)
    tck.save(tmp_path, 2, g)
    rcfg = smoke("bfloat16")
    rp, ro = RTrainer(rcfg, mesh=None).init(0)
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        {"params": rp, "opt": ro})
    back = rck.restore(tmp_path, 2, like)
    assert back["params"]["embed"]["table"].dtype == jnp.bfloat16
    for path, t, r in pairs(_np_tree(g), jax.tree.map(
            lambda a: np.asarray(a, np.float32), back)):
        np.testing.assert_array_equal(t, r)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    rcfg = smoke("bfloat16")
    rtr = RTrainer(rcfg, mesh=None, base_lr=LR, warmup=WARM)
    rp, ro = rtr.init(0)
    for i in range(2):
        rp, ro, _ = rtr.step(rp, ro,
                             rtr.put_batch(rmake_batch(rcfg, B, S, i)), i)
    rck.save(tmp_path, 2, {"params": rp, "opt": ro})
    tr = _bf16_trainer((P, 1))
    params, opt = tr.from_global(tck.restore(tmp_path, 2, tr.global_specs()))
    assert int(opt["count"]) == 2
    want = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        {"params": rp, "opt": ro})
    for path, t, r in pairs(_np_tree(tr.to_global(params, opt)), want):
        np.testing.assert_array_equal(t, r)
    # and the restored state trains on
    params, opt, m = tr.step(params, opt,
                             tr.put_batch(make_batch(tr.cfg, B, S, 2)), 2)
    assert np.isfinite(float(m["loss"]))


def test_ckpt_gc_keep_and_async_checkpointer(tmp_path):
    tr = _bf16_trainer((1, 1))
    params, opt = tr.init(0)
    g = tr.to_global(params, opt)
    for s in (1, 2, 3, 4, 5):
        tck.save(tmp_path / "gc", s, {"p": g["params"]}, keep=2)
    steps = sorted(p.name for p in (tmp_path / "gc").glob("step_*"))
    assert steps == ["step_000000004", "step_000000005"]
    acp = AsyncCheckpointer(tmp_path / "a")
    acp.save(1, g)
    acp.save(2, g)
    acp.wait()
    assert tck.latest_step(tmp_path / "a") == 2
    back = tck.restore(tmp_path / "a", 2, tr.global_specs())
    for path, t, r in pairs(_np_tree(back), _np_tree(g)):
        np.testing.assert_array_equal(t, r)


def test_async_checkpointer_surfaces_a_failed_write(tmp_path):
    (tmp_path / "file").write_text("not a directory")
    acp = AsyncCheckpointer(tmp_path / "file")
    acp.save(1, {"x": torch.zeros(2)})
    with pytest.raises(OSError):
        acp.wait()
    acp.wait()                            # the error is raised once


# ---------------------------------------------------------------------------
# watchdog and the CLI
# ---------------------------------------------------------------------------


def test_watchdog_flags_stragglers(monkeypatch):
    """Ten 2 ms steps, then a 50 ms one, on a fake clock: the verdict does
    not depend on how long a loaded host sleeps."""
    from repro_torch.ft import watchdog
    now = [0.0]
    monkeypatch.setattr(watchdog.time, "perf_counter", lambda: now[0])

    def step(seconds):
        wd.start_step()
        now[0] += seconds
        return wd.end_step()
    wd = StepWatchdog(ratio=3.0)
    for _ in range(10):
        assert not step(0.002)
    assert step(0.05)
    assert wd.straggler_steps == [10]
    assert wd.median == pytest.approx(0.002)


def test_watchdog_hang_timer_fires():
    import threading
    import time
    fired = threading.Event()
    wd = StepWatchdog(hang_timeout=0.05, on_hang=fired.set)
    wd.start_step()
    time.sleep(0.15)
    assert fired.is_set()
    wd.end_step()


def _cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tlaunch.main(argv) == 0
    return buf.getvalue()


def test_train_cli_runs_then_resumes(tmp_path, monkeypatch):
    monkeypatch.delenv("PGTUNE_PROFILE_DIR", raising=False)
    ck = str(tmp_path / "ck")
    base = ["--device", "cpu", "--smoke", "--mesh", "1x4", "--log-every",
            "1", "--ckpt-dir", ck, "--seq", "16"]
    out = _cli(base + ["--steps", "3"])
    assert "step     2" in out and "done: 3 steps" in out
    assert tck.latest_step(ck) == 3
    out = _cli(base + ["--steps", "5", "--force",
                       "allreduce:alg=allreduce_as_reduce_bcast"])
    assert "resumed from step 3" in out and "done: 2 steps" in out
    assert "step     3" in out and "step     2" not in out
    assert tck.manifest(ck, 5)["step"] == 5
    out = _cli(base[:2] + ["--smoke", "--mesh", "2x2", "--steps", "1",
                           "--seq", "16", "--ckpt-dir", str(tmp_path / "x")])
    assert "done: 1 steps" in out and tck.latest_step(tmp_path / "x") == 1
    out = _cli(base[:2] + ["--smoke", "--mesh", "2x1x2", "--steps", "1",
                           "--seq", "16", "--ckpt-dir", str(tmp_path / "y")])
    assert "done: 1 steps" in out and tck.latest_step(tmp_path / "y") == 1
    with pytest.raises(ValueError, match="pxdxt"):
        tlaunch.main(["--device", "cpu", "--smoke", "--mesh", "2x2x2x2",
                      "--steps", "1", "--ckpt-dir", str(tmp_path / "z")])


def test_record_tune_trace_retrain_and_the_cli_reads_the_profiles(
        tmp_path, monkeypatch):
    """Record one step, ``tune_trace`` it per phase (the cost model of
    the JAX package's preset, exact impls only), re-take the same step
    from the same state under the per-phase profiles: the loss and every
    gradient agree (1e-5: the mock-ups sum in another order), the picks
    show in the bwd phase,
    and the train CLI reads the profiles through ``resolve_stores``."""
    from repro_torch.core import collectives as C
    from repro_torch.core import costmodel, profiles, tuner
    from repro_torch.core import trace as ttrace
    monkeypatch.delenv("PGTUNE_PROFILE_DIR", raising=False)
    cfg = port_cfg(smoke("float32", scan_layers=False))
    tr = Trainer(cfg, mesh=(1, P), device="cpu", record=[])
    params, _ = tr.init(0)
    batch = tr.put_batch(make_batch(cfg, B, S, 0))
    loss0, g0 = tr.grads(params, batch)
    rec = ttrace.Trace.from_record(tr.record)
    assert set(rec.phases()) == {"fwd", "bwd"}
    # the quantized-wire impls are approximate: out of an exact-gradient
    # comparison
    try:
        for op, impls in C.REGISTRY.items():
            for nm, impl in impls.items():
                if impl.wire_dtype is not None:
                    C.demote(op, nm, "exact gradients")
        rep = tuner.tune_trace(rec,
                               tuner.CostModelBackend(costmodel.BGQ_LIKE))
    finally:
        C.clear_demotions()
    rep.save(tmp_path / "prof")
    _, phases = profiles.resolve_stores(tmp_path / "prof")
    assert set(phases) == {"fwd", "bwd"}
    tuned = Trainer(cfg, mesh=(1, P), device="cpu", phase_profiles=phases,
                    record=[])
    loss1, g1 = tuned.grads(params, batch)
    assert float(loss1) == pytest.approx(float(loss0), rel=1e-5)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        close(tnp(b), tnp(a), rtol=1e-5, atol=1e-8)
    picks = {(r.phase, r.impl) for r in tuned.record}
    assert any(ph == "bwd" and impl != "default" for ph, impl in picks)
    out = _cli(["--device", "cpu", "--smoke", "--mesh", "1x4", "--steps",
                "1", "--seq", "16", "--ckpt-dir", str(tmp_path / "ck"),
                "--profile-dir", str(tmp_path / "prof")])
    assert "phases=['bwd', 'fwd']" in out


# ---------------------------------------------------------------------------
# data x model: the Trainer on a (2, 2) StackedMesh against the reference's
# train_fn under nested vmap (outer "data", inner "model")
# ---------------------------------------------------------------------------

MESH2 = (2, 2)


def ref_cut2(tree, rspecs, d, t):
    """The reference's global tree cut for the nested vmap: leaf ``[d, t,
    *local]``, block i of its "data" dim and block j of its "model" dim at
    ``[i, j]`` (numpy slicing, independent of the port's ``shard``)."""
    def cut(a, s):
        a = np.asarray(a)
        out = np.empty((d, t) + tuple(
            n // (d if dd == "data" else t if dd == "model" else 1)
            for n, dd in zip(a.shape, s.dims)), a.dtype)
        for i in range(d):
            for j in range(t):
                sl = []
                for n, dd in zip(a.shape, s.dims):
                    k, b = ((d, i) if dd == "data" else
                            (t, j) if dd == "model" else (1, 0))
                    sl.append(slice(b * n // k, (b + 1) * n // k))
                out[i, j] = a[tuple(sl)]
        return jnp.asarray(out)
    return jax.tree.map(cut, tree, rspecs,
                        is_leaf=lambda x: isinstance(x, RSpec))


def ref_join2(stacked, rspecs):
    """The inverse of ``ref_cut2`` (a leaf replicated over a name is that
    name's rank 0 copy)."""
    def join(a, s):
        a = np.asarray(a)
        rows = []
        for i in range(a.shape[0]):
            blocks = list(a[i])
            row = (np.concatenate(blocks, axis=s.dims.index("model"))
                   if "model" in s.dims else blocks[0])
            rows.append(row)
        return (np.concatenate(rows, axis=s.dims.index("data"))
                if "data" in s.dims else rows[0])
    return jax.tree.map(join, stacked, rspecs,
                        is_leaf=lambda x: isinstance(x, RSpec))


def _ref_trajectory2(rcfg, tree, n_steps):
    d, t = MESH2
    _, rtrain = rtrainer.make_step_fns(rcfg, base_lr=LR, warmup=WARM)
    rspecs = rlm.model_specs(rcfg, tp=t)
    params = ref_cut2(tree, rspecs, d, t)
    opt = jax.vmap(jax.vmap(ropt.get_optimizer(rcfg.optimizer)[0]))(params)
    fn = jax.jit(jax.vmap(jax.vmap(rtrain, in_axes=(0, 0, 0, None),
                                   axis_name="model"),
                          in_axes=(0, 0, 0, None), axis_name="data"))
    out, rec = [], []
    for i in range(n_steps):
        b = {k: jnp.asarray(np.broadcast_to(
            v.reshape(d, 1, -1, *v.shape[1:]),
            (d, t, v.shape[0] // d) + v.shape[1:]))
            for k, v in rmake_batch(rcfg, B, S, i).items()}
        with rapi.tuned(record=rec):
            params, opt, m = fn(params, opt, b, jnp.int32(i))
        out.append(jax.tree.map(np.asarray, (m, params, opt)))
    return out, rec, rspecs


@pytest.fixture(scope="module")
def trajectory2():
    rcfg = smoke("float32", scan_layers=False)
    tree = randomized(ref_params(rcfg), 6)
    ref, rrec, rspecs = _ref_trajectory2(rcfg, tree, 3)
    tr = Trainer(port_cfg(rcfg), mesh=MESH2, device="cpu", base_lr=LR,
                 warmup=WARM, record=[])
    _, opt = tr.init(0)
    params = from_reference(tree, tr.specs, tr.axis)
    got = []
    for i in range(3):
        n_rec = len(tr.record)
        params, opt, m = tr.step(params, opt,
                                 tr.put_batch(make_batch(tr.cfg, B, S, i)), i)
        got.append(({k: float(v) for k, v in m.items()},
                    _np_tree(tr.to_global(params, opt)),
                    tr.record[n_rec:]))
    return ref, rrec, got, rspecs, tr


@pytest.mark.parametrize("n_steps", [1, 3])
def test_data_x_model_steps_match_the_reference(trajectory2, n_steps):
    ref, _, got, rspecs, _ = trajectory2
    for i in range(n_steps):
        (rm, rp, ro), (tm, tstate, _) = ref[i], got[i]
        assert tm["loss"] == pytest.approx(float(rm["loss"][0, 0]), rel=1e-5)
        assert tm["grad_norm"] == pytest.approx(
            float(rm["grad_norm"][0, 0]), rel=1e-5)
        for path, t, r in pairs(tstate["params"], ref_join2(rp, rspecs)):
            close(t, r)
        for k in ("m", "v"):
            for path, t, r in pairs(tstate["opt"][k],
                                    ref_join2(ro[k], rspecs)):
                close(t, r)
        assert int(tstate["opt"]["count"]) == i + 1


def test_data_x_model_step_records_equal_the_reference_trace(trajectory2):
    """One port step dispatches what the reference's one trace recorded,
    the 2-D cells of the row-parallel sites (``2d`` forward, ``2dT``
    backward) included."""
    import collections
    _, rrec, got, _, _ = trajectory2

    def key(rec):
        return collections.Counter((dataclasses.astuple(r.cell), r.impl,
                                    r.phase) for r in rec)
    assert key(got[0][2]) == key(rrec)
    roles = {(r.cell.op, r.cell.mm_role, r.phase) for r in got[0][2]}
    assert ("matmul_reducescatter_2d", "2d", "fwd") in roles
    assert ("matmul_reducescatter_2d", "2dT", "bwd") in roles
    cell = next(r.cell for r in got[0][2] if r.cell.mm_role == "2d")
    assert (cell.p, cell.p2) == MESH2


def test_data_x_model_forced_fused_ring2d_matches_default(trajectory2):
    """The forced 2-D ring (both directions) and the 1-D fused rings give
    the default step's gradients."""
    _, _, _, _, tr = trajectory2
    cfg = tr.cfg
    tree = tr.to_global(*tr.init(1))
    batch = make_batch(cfg, B, S, 0)
    out = []
    for force in ({}, {"matmul_reducescatter_2d": "fused_ring2d",
                       "allgather_matmul": "fused_ring",
                       "matmul_reducescatter": "fused_ring",
                       "matmul_accumulate": "fused_ring"}):
        t2 = Trainer(cfg, mesh=MESH2, device="cpu", force=force, record=[])
        params, _ = t2.from_global(tree)
        loss, grads = t2.grads(params, t2.put_batch(batch))
        out.append((float(loss), [tnp(g) for g in tree_leaves(grads)],
                    {(r.cell.op, r.impl) for r in t2.record}))
    (l0, g0, _), (l1, g1, rec1) = out
    assert l1 == pytest.approx(l0, rel=1e-5)
    for a, b in zip(g0, g1):
        close(b, a, rtol=1e-5, atol=1e-7)
    assert ("matmul_reducescatter_2d", "fused_ring2d") in rec1


def test_data_x_model_checkpoint_both_directions(tmp_path):
    """A checkpoint of the port's 2-D state restores in the reference, and
    one of the reference's nested-vmap 2-D state restores in the port's
    (2, 2) trainer, bit for bit in the global layout; both train on."""
    tr = _bf16_trainer(MESH2)
    params, opt = _stepped(tr)
    g = tr.to_global(params, opt)
    tck.save(tmp_path / "port", 2, g)
    rcfg = smoke("bfloat16")
    rp, ro = RTrainer(rcfg, mesh=None).init(0)
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        {"params": rp, "opt": ro})
    back = rck.restore(tmp_path / "port", 2, like)
    for path, t, r in pairs(_np_tree(g), jax.tree.map(
            lambda a: np.asarray(a, np.float32), back)):
        np.testing.assert_array_equal(t, r)
    # the reference's 2-D state (nested vmap, float32) -> its global
    # checkpoint -> the port's mesh trainer
    rcfg32 = smoke("float32", scan_layers=False)
    ref, _, rspecs = _ref_trajectory2(rcfg32, randomized(ref_params(rcfg32),
                                                         7), 2)
    _, rp2, ro2 = ref[1]
    rck.save(tmp_path / "ref", 2, {
        "params": ref_join2(rp2, rspecs),
        "opt": {"m": ref_join2(ro2["m"], rspecs),
                "v": ref_join2(ro2["v"], rspecs),
                "count": ro2["count"][0, 0]}})
    tr2 = Trainer(port_cfg(rcfg32), mesh=MESH2, device="cpu", base_lr=LR,
                  warmup=WARM)
    params, opt = tr2.from_global(tck.restore(tmp_path / "ref", 2,
                                              tr2.global_specs()))
    assert int(opt["count"]) == 2
    for path, t, r in pairs(_np_tree(tr2.to_global(params, opt)["params"]),
                            ref_join2(rp2, rspecs)):
        np.testing.assert_array_equal(t, r)
    params, opt, m = tr2.step(params, opt,
                              tr2.put_batch(make_batch(tr2.cfg, B, S, 2)), 2)
    assert np.isfinite(float(m["loss"]))
