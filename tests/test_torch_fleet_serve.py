"""The fleet serve and fault tolerance on the CPU: runtime dispatch plans
in a built step, the choice cache across a swap, llama3.2-3b's smoke
config served under a plan against the JAX package, the restart driver
and fleet heartbeats.

The JAX package switches a plan site with ``lax.switch`` inside a jitted
step and counts "zero re-jits"; the port's step is an eager function
built once, whose trailing argument is a host plan vector, so the
property held here is that ONE built step runs whatever impl the vector
names, call by call.  The JAX side of the llama parity runs its fleet
dispatch as its own tests do (``tests/test_fleet_retune.py``): jitted
prefill and decode under ``vmap(axis_name="model")`` with the plan
vector a replicated argument and ``api.plan_input`` inside, the
``shard_map`` of its ``launch/serve.py`` builders having no mesh of 4
devices on this host.  Both packages are fed the same vector contents.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import port_cfg
from test_torch_serve import (B, N_TOKENS, S0, S_MAX, _check_logits, _prompts,
                              _serve_both)

from repro.core import api as rapi
from repro.core import profiles as rprof
from repro.models import lm as rlm
from repro_torch.ckpt import checkpoint as ck
from repro_torch.core import api as tapi
from repro_torch.core import collectives as TC
from repro_torch.core import costmodel as tcm
from repro_torch.core import profiles as tprof
from repro_torch.core import trace as ttrace
from repro_torch.core import tuner as ttuner
from repro_torch.core._axis import StackedAxis
from repro_torch.ft import Heartbeats, run_with_restarts
from repro_torch.launch import serve as tserve

P = 4


@pytest.fixture
def probe_impl(monkeypatch):
    """A marker allreduce whose output tells which impl RAN."""
    probe = TC.Impl(name="probe_marker", op="allreduce",
                    fn=lambda x, axis, **kw: torch.full_like(x, 42.0),
                    guideline="EXT", extra_bytes=lambda n, p: 0)
    monkeypatch.setitem(TC.REGISTRY["allreduce"], "probe_marker", probe)
    return probe


def _probe_store():
    return tprof.ProfileStore([tprof.Profile(
        "allreduce", P, [tprof.Range(1, 1 << 20, "probe_marker")])])


def test_plan_dispatch_switches_impl_at_runtime_built_once(probe_impl):
    builds = []

    def build():
        builds.append(1)

        def step(x, vec):
            with tapi.plan_input(vec):
                return tapi.allreduce(x, axis)
        return step

    axis = StackedAxis(P, "cpu")
    plan = tapi.Plan(capacity=8)
    ref = tprof.StoreRef()
    f = build()
    x = torch.ones(P, 4)
    with tapi.tuned(store_ref=ref, plan=plan) as ctx:
        out0 = f(x, np.zeros(plan.capacity, np.int32))
        ((cell, phase, impls),) = plan.sites()
        assert "probe_marker" in impls and impls[0] == "default"
        torch.testing.assert_close(out0, torch.full((P, 4), float(P)))
        ref.swap(_probe_store(), None, epoch=1)
        vec1 = plan.vector(ref)
        assert vec1[0] == impls.index("probe_marker")
        torch.testing.assert_close(f(x, vec1), torch.full((P, 4), 42.0))
        # a CPU tensor vector reads the same; the vector, not the
        # context, decides: back to the default with zeros
        torch.testing.assert_close(f(x, torch.as_tensor(vec1)),
                                   torch.full((P, 4), 42.0))
        torch.testing.assert_close(f(x, np.zeros(8, np.int32)), out0)
        # an out-of-range index is clipped into the admissible list
        big = np.full(8, 999, np.int32)
        want = TC.REGISTRY["allreduce"][impls[-1]].fn(x, axis)
        torch.testing.assert_close(f(x, big), want)
    assert len(builds) == 1
    assert [r.impl for r in ctx.record] == [tapi.PLAN_IMPL] * 5
    with pytest.raises(ValueError, match="host"):
        with tapi.plan_input(torch.zeros(8, dtype=torch.int32,
                                         device="meta")):
            pass


def test_plan_sites_fall_back_to_static_dispatch(probe_impl):
    axis = StackedAxis(P, "cpu")
    x = torch.ones(P, 4)
    plan = tapi.Plan(capacity=8)
    vec = np.full(8, 1, np.int32)
    with tapi.tuned(plan=plan, force={"allreduce": "probe_marker"}) as ctx:
        with tapi.plan_input(vec):
            out = tapi.allreduce(x, axis)
    torch.testing.assert_close(out, torch.full((P, 4), 42.0))
    assert len(plan) == 0 and ctx.record[0].impl == "probe_marker"
    with tapi.tuned(plan=plan) as ctx:
        with tapi.plan_input(vec):
            tapi.allreduce(x, axis)
            ((_c, _ph, impls),) = plan.sites()
            TC.demote("allreduce", impls[1])
            try:   # the admissible set drifted: static dispatch
                out = tapi.allreduce(x, axis)
            finally:
                TC.clear_demotions()
    torch.testing.assert_close(out, torch.full((P, 4), float(P)))
    assert [r.impl for r in ctx.record] == [tapi.PLAN_IMPL, "default"]


def test_choice_cache_follows_a_swap(probe_impl):
    """A static site that already ran under a live ``store_ref`` picks up
    the swapped generation on its next call in the same context."""
    axis = StackedAxis(P, "cpu")
    ref = tprof.StoreRef()
    x = torch.ones(P, 4)
    with tapi.tuned(store_ref=ref) as ctx:
        first = tapi.allreduce(x, axis)
        ref.swap(_probe_store(), None, epoch=1)
        second = tapi.allreduce(x, axis)
        ref.swap(None, None, epoch=2)
        third = tapi.allreduce(x, axis)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert ref.rollback() == 1       # epoch 2 poisoned, 1 again
        fourth = tapi.allreduce(x, axis)
    torch.testing.assert_close(first, torch.full((P, 4), float(P)))
    torch.testing.assert_close(second, torch.full((P, 4), 42.0))
    torch.testing.assert_close(third, first)
    torch.testing.assert_close(fourth, second)
    assert [r.impl for r in ctx.record] == ["default", "probe_marker",
                                            "default", "probe_marker"]


def _ref_plan_server(rcfg, params, prompts, ref, plan):
    """The JAX package's fleet dispatch: prefill and decode jitted ONCE,
    vmapped, under ``tuned(store_ref=, plan=)``, the plan vector a
    replicated argument read through ``plan_input``.  Returns
    ``serve(vec) -> (tokens, full-vocab logits)``, greedy."""
    prompts = jnp.asarray(prompts, jnp.int32)
    j_init = jax.jit(jax.vmap(lambda _: rlm.init_caches(rcfg, B, S_MAX),
                              axis_name="model", axis_size=P, in_axes=None,
                              out_axes=0))

    def pf(p, c, v):
        with rapi.plan_input(v):
            return rlm.prefill(p, rcfg, {"tokens": prompts}, c)

    def dc(p, t, c, i, v):
        with rapi.plan_input(v):
            return rlm.decode_step(p, rcfg, t, c, i)
    j_pf = jax.jit(jax.vmap(pf, axis_name="model", in_axes=(0, 0, None)))
    j_dc = jax.jit(jax.vmap(dc, axis_name="model",
                            in_axes=(0, None, 0, None, None)))

    def greedy(lg):
        full = jnp.transpose(lg[:, :, -1], (1, 0, 2)).reshape(B, -1)
        return full, (jnp.argmax(full, -1).astype(jnp.int32)[:, None]
                      % rcfg.vocab_size)

    def serve(vec):
        v = jnp.asarray(vec, jnp.int32)
        with rapi.tuned(store_ref=ref, plan=plan):
            caches = j_init(0)
            with rapi.phase("prefill"):
                logits, caches = j_pf(params, caches, v)
            lg, tok = greedy(logits)
            toks, lgs = [tok], [lg]
            with rapi.phase("decode"):
                for step in range(N_TOKENS - 1):
                    logits, caches = j_dc(params, tok, caches,
                                          jnp.int32(S0 + step), v)
                    lg, tok = greedy(logits)
                    toks.append(tok)
                    lgs.append(lg)
        return (np.asarray(jnp.concatenate(toks, 1)),
                [np.asarray(a, np.float32) for a in lgs])
    serve.jits = (j_pf, j_dc)
    return serve


def _sites(plan):
    return [(dataclasses.astuple(c), ph, im) for c, ph, im in plan.sites()]


def test_llama_served_under_a_plan_like_the_reference(tmp_path):
    rcfg, rp, params, axis = _serve_both(P)
    tcfg = port_cfg(rcfg)
    prompts = _prompts(rcfg)
    live = tmp_path / "live"
    t_ref = tprof.resolve_stores(live, watch=True)
    r_ref = rprof.resolve_stores(live, watch=True)
    assert t_ref.epoch == r_ref.epoch == -1
    t_plan, r_plan = tapi.Plan(16), rapi.Plan(16)
    builds = []
    steps = []

    def build():
        builds.append(1)
        return (tserve.build_prefill(tcfg, axis, plan=t_plan),
                tserve.build_decode(tcfg, axis, plan=t_plan))

    def serve(vec, record=None):
        if not steps:
            steps.extend(build())
        return tserve.serve(tcfg, axis, params, torch.as_tensor(prompts),
                            S_MAX, N_TOKENS, store_ref=t_ref, plan=t_plan,
                            plan_vec=vec, steps=tuple(steps), record=record)

    r_serve = _ref_plan_server(rcfg, rp, prompts, r_ref, r_plan)

    def both(vec_t, vec_r):
        np.testing.assert_array_equal(vec_t, vec_r)
        res = serve(vec_t)
        r_toks, r_lgs = r_serve(vec_r)
        assert _check_logits(res, r_toks, r_lgs) is None
        return res

    # epoch 0: every site at the default; the sites register on first use
    rec = ttrace.ShardRecorder("live", seed=3)
    res0 = serve(np.zeros(16, np.int32), record=rec)
    r_serve(np.zeros(16, np.int32))
    assert _sites(t_plan) == _sites(r_plan) and len(t_plan) == 2
    assert res0.ctx.record is rec
    trace = rec.trace()
    assert {e.impl for e in trace} == {tapi.PLAN_IMPL}
    assert set(trace.phases()) == {"prefill", "decode"}
    both(t_plan.vector(t_ref), r_plan.vector(r_ref))

    # explore(eps=1): every site flips to the next admissible impl
    vt, et = t_plan.explore(t_ref, eps=1.0, rng=np.random.default_rng(5))
    vr, er = r_plan.explore(r_ref, eps=1.0, rng=np.random.default_rng(5))
    assert len(et) == len(er) == 2 and vt.any()
    res_x = both(vt, vr)

    # epoch 1, tuned by the port on the cost model and published; both
    # packages' refs adopt it from the same directory
    rep = ttuner.tune_trace(ttrace.Trace.from_record(
        tapi.DispatchRecord(c, "default", ph) for c, ph, _ in
        t_plan.sites()), ttuner.CostModelBackend(tcm.BGQ_LIKE))
    rep.save(live, epoch=1, source_digest="sha256:test")
    assert t_ref.poll() and r_ref.poll()
    assert t_ref.epoch == r_ref.epoch == 1
    v1 = t_plan.vector(t_ref)
    assert v1.any()                                   # the vector changed
    res1 = both(v1, r_plan.vector(r_ref))
    assert len(builds) == 1
    assert [j._cache_size() for j in r_serve.jits] == [1, 1]
    for res in (res_x, res1):
        report = tserve.check_serves(res0, res, 2e-2)
        assert report["steps"] >= 1


def _tiny_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(3, 4, generator=g),
            "b": [torch.zeros(4, dtype=torch.bfloat16)],
            "count": torch.zeros((), dtype=torch.int32)}


def _tiny_step(faults):
    def step(state, i):
        if faults.get(i):
            faults[i] -= 1
            raise RuntimeError(f"injected failure at step {i}")
        g = torch.Generator().manual_seed(100 + i)
        return {"w": state["w"] * 0.9 + torch.randn(3, 4, generator=g),
                "b": [(state["b"][0] + 0.125 * i).to(torch.bfloat16)],
                "count": state["count"] + 1}
    return step


def _same(a, b):
    return (torch.equal(a["w"], b["w"]) and torch.equal(a["b"][0], b["b"][0])
            and torch.equal(a["count"], b["count"]))


def test_restart_resumes_bit_identical(tmp_path):
    ref, stats0 = run_with_restarts(_tiny_state, _tiny_step({}), n_steps=20,
                                    ckpt_dir=tmp_path / "a", ckpt_every=4)
    got, stats = run_with_restarts(_tiny_state, _tiny_step({6: 1, 13: 2}),
                                   n_steps=20, ckpt_dir=tmp_path / "b",
                                   ckpt_every=4)
    assert stats0["restarts"] == 0 and stats["restarts"] == 3
    assert stats["resumed_from"] == [4, 12, 12]
    assert _same(got, ref) and got["count"].shape == ()
    # a cold resume: a new driver over the same directory starts from the
    # newest checkpoint, not from scratch
    calls = []

    def counting(state, i):
        calls.append(i)
        return _tiny_step({})(state, i)
    more, stats2 = run_with_restarts(_tiny_state, counting, n_steps=24,
                                     ckpt_dir=tmp_path / "b", ckpt_every=4)
    assert stats2["resumed_from"] == [20] and calls == [20, 21, 22, 23]
    ref24, _ = run_with_restarts(_tiny_state, _tiny_step({}), n_steps=24,
                                 ckpt_dir=tmp_path / "c", ckpt_every=4)
    assert _same(more, ref24)
    assert ck.latest_step(tmp_path / "b") == 24


def test_restart_gives_up_past_max_restarts(tmp_path):
    with pytest.raises(RuntimeError, match="injected failure at step 5"):
        run_with_restarts(_tiny_state, _tiny_step({5: 10}), n_steps=10,
                          ckpt_dir=tmp_path, ckpt_every=2, max_restarts=3)
    assert ck.latest_step(tmp_path) == 4
    state, stats = run_with_restarts(_tiny_state, _tiny_step({5: 3}),
                                     n_steps=10, ckpt_dir=tmp_path / "x",
                                     ckpt_every=2, max_restarts=3)
    assert stats["restarts"] == 3 and int(state["count"]) == 10


def test_heartbeats_on_a_fake_clock():
    now = [100.0]
    hb = Heartbeats(timeout=5.0, clock=lambda: now[0])
    hb.beat("a", epoch=1)
    hb.beat("b")
    assert hb.seen() == ["a", "b"] and hb.alive() == ["a", "b"]
    assert hb.epoch_of("a") == 1 and hb.epoch_of("b") is None
    now[0] += 5.0
    assert hb.dead() == []                    # exactly at the timeout: alive
    hb.beat("b", epoch=3)
    now[0] += 0.5
    assert hb.dead() == ["a"] and hb.alive() == ["b"]
    assert hb.epoch_of("b") == 3
    hb.beat("a")
    assert hb.dead() == [] and hb.alive() == ["a", "b"]
