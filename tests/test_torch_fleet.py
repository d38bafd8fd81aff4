"""The fleet loop's parity with the JAX package on the CPU: shard
recording and merging, epochal profile stores, runtime dispatch plans,
the tripwire, feedback statistics and the coordinator.

Every input is built from one seed (numpy or ``random.Random``) and fed
to both packages; the on-disk formats are shared, so each side also
reads what the other wrote:

* one stream of records and latencies gives BYTE-identical shard files
  (Algorithm R evictions and ``#@lat`` reservoirs included);
* ``merge_shards`` of either package over shards of the other gives the
  same trace and ``ShardNote``s, ``ChaosMonkey`` faults included;
* ``profiles_digest``/``shard_digest`` are equal strings, and a manifest
  either package wrote is adopted by the other's ``StoreRef.poll``,
  demotions included;
* a scripted swap / stale / poison / rollback run gives the same results;
* ``Plan`` slots, vectors and ``explore`` agree under one numpy rng, and
  ``_admissible_impls`` agrees for every op at p 6 and 8, with and
  without a scratch budget;
* ``EpochTripwire``, ``_mad_filter`` and ``FeedbackBackend`` agree
  exactly, ``estimate_trace_cost`` within 1e-12 relative on the same
  ``Topo`` constants, and ``FleetCoordinator.scan`` under a fake clock.
"""
import dataclasses
import shutil
import warnings

import numpy as np
import pytest

from repro.core import api as rapi
from repro.core import collectives as RC
from repro.core import costmodel as rcm
from repro.core import profiles as rprof
from repro.core import trace as rtrace
from repro.core import tuner as rtuner
from repro.core.cell import OpCell as ROpCell
from repro import ft as rft
from repro_torch import ft as tft
from repro_torch.core import api as tapi
from repro_torch.core import collectives as TC
from repro_torch.core import costmodel as tcm
from repro_torch.core import profiles as tprof
from repro_torch.core import trace as ttrace
from repro_torch.core import tuner as ttuner
from repro_torch.core.cell import OpCell as TOpCell

PKGS = {"ref": (rtrace, rprof, rapi, RC, rft, ROpCell),
        "port": (ttrace, tprof, tapi, TC, tft, TOpCell)}
IMPL = "allreduce_as_rsb_allgather"
#: one fabric's constants, given to both packages' cost models
TOPO = dict(name="fleet-test", alpha=2.0e-6, link_bw=4.0e10, gamma=3.0e-12,
            quant_bw=6.0e11)


@pytest.fixture(autouse=True)
def _clean_ledgers():
    RC.clear_demotions()
    TC.clear_demotions()
    yield
    RC.clear_demotions()
    TC.clear_demotions()


def _cells(OpCell):
    """Plain, fused and hierarchical cells, in a fixed order."""
    return [OpCell("allreduce", 4, 512), OpCell("allreduce", 4, 1 << 16,
                                                "bfloat16"),
            OpCell("allgather", 8, 2048),
            OpCell("allgather_matmul", 8, 4096, "bfloat16", 64, 256, 128,
                   "gather"),
            OpCell("allreduce", 2, 4096, p2=4),
            OpCell("reducescatter", 4, 8192, tier="ici"),
            OpCell("matmul_reducescatter_2d", 2, 1024, "bfloat16", 32, 64,
                   128, "2d", 4)]


def _stream(seed, n=400):
    """(cell index, phase, impl) of ``n`` dispatches and (cell index,
    impl, latency) of the explorations, drawn with numpy."""
    rng = np.random.default_rng(seed)
    recs = [(int(rng.integers(7)), ["fwd", "bwd", "decode"][rng.integers(3)],
             ["default", IMPL, "plan"][rng.integers(3)]) for _ in range(n)]
    obs = [(int(rng.integers(3)), IMPL, float(rng.lognormal(-9, 0.3)))
           for _ in range(90)]
    return recs, obs


def _record(pkg, server, seed, *, max_cells=6, reservoir=4, stream_seed=0):
    trace, _prof, api, _C, _ft, OpCell = PKGS[pkg]
    cells = _cells(OpCell)
    r = trace.ShardRecorder(server, max_cells=max_cells, reservoir=reservoir,
                            seed=seed)
    recs, obs = _stream(stream_seed)
    for i, (c, ph, im) in enumerate(recs):
        if i % 5 == 0:     # the legacy 5-tuple form too
            r.append((cells[c].op, cells[c].p, cells[c].nbytes, im, ph))
        else:
            r.append(api.DispatchRecord(cells[c], im, ph))
    for c, im, lat in obs:
        r.observe(cells[c], im, lat)
    return r


@pytest.mark.parametrize("max_cells,reservoir", [(6, 4), (64, 32)])
def test_shards_are_byte_identical(tmp_path, max_cells, reservoir):
    out = {}
    for pkg in PKGS:
        r = _record(pkg, "srv0", seed=7, max_cells=max_cells,
                    reservoir=reservoir)
        dropped = r.dropped
        path = r.flush(tmp_path / pkg, epoch=3)
        out[pkg] = (path.name, path.read_bytes(), dropped)
        assert len(r) == 0 and r.total() == 0          # flushed and reset
    assert out["port"] == out["ref"]
    if max_cells == 6:
        assert out["port"][2] > 0                      # evictions happened
    assert b"#@lat " in out["port"][1]


def _notes(report):
    return [(n.path.name, n.server, n.epoch, n.status, n.reason,
             n.dispatches, n.claimed, n.salvaged, n.dropped)
            for n in report.shards]


def _entries(trace):
    return [(dataclasses.astuple(e.cell), e.phase, e.impl, e.count)
            for e in trace.entries]


@pytest.mark.parametrize("writer", list(PKGS))
def test_merge_reads_the_other_packages_shards(tmp_path, writer):
    for i in range(4):
        r = _record(writer, f"srv{i}", seed=i, max_cells=5, stream_seed=i)
        r.flush(tmp_path, epoch=1 + i % 2)
    merged = {}
    for pkg in PKGS:
        rep = PKGS[pkg][0].Trace.merge_shards(tmp_path)
        merged[pkg] = (_entries(rep.trace), _notes(rep), rep.total(),
                       rep.dropped_weight)
    assert merged["port"] == merged["ref"]
    assert merged["port"][2] == sum(n[5] for n in merged["port"][1])
    # the latencies ride along and load alike
    lats = {pkg: {(dataclasses.astuple(c), im): v for (c, im), v in
                  PKGS[pkg][0].load_shard_latencies(tmp_path).items()}
            for pkg in PKGS}
    assert lats["port"] == lats["ref"] and lats["port"]


@pytest.mark.parametrize("monkey", list(PKGS))
def test_chaos_faults_quarantined_alike(tmp_path, monkey):
    paths = []
    for i in range(4):
        r = _record("port", f"srv{i}", seed=i, stream_seed=i)
        paths.append(r.flush(tmp_path, epoch=1))
    m = PKGS[monkey][4].ChaosMonkey(seed=5)
    m.tear_shard(paths[0])
    m.corrupt_line(paths[1])
    m.skew_header(paths[2], epoch=9)
    assert [e.kind for e in m.events] == ["torn-shard", "corrupt-line",
                                          "header-skew"]
    got = {}
    for pkg in PKGS:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            rep = PKGS[pkg][0].Trace.merge_shards(tmp_path)
            skip = [n.path for n in rep.quarantined]
            lat = PKGS[pkg][0].load_shard_latencies(tmp_path, skip=skip)
        got[pkg] = (_notes(rep), _entries(rep.trace),
                    sorted((dataclasses.astuple(c), im, len(v))
                           for (c, im), v in lat.items()))
    assert got["port"] == got["ref"]
    notes = got["port"][0]
    assert [n[3] for n in notes] == ["quarantined"] * 3 + ["merged"]
    assert notes[0][4].startswith("digest-mismatch")
    assert notes[2][4].startswith("meta-skew")
    # both chaos monkeys make the same faults from one seed
    for pkg in PKGS:
        shutil.rmtree(tmp_path / pkg, ignore_errors=True)
        p = _record("port", "srv0", seed=0).flush(tmp_path / pkg, epoch=1)
        mk = PKGS[pkg][4].ChaosMonkey(seed=11)
        mk.tear_shard(p)
        mk.corrupt_line(p)
        got[pkg] = p.read_bytes()
    assert got["port"] == got["ref"]


def _store(prof, impl=IMPL, p=4, hi=1 << 30):
    return prof.ProfileStore([prof.Profile("allreduce", p,
                                           [prof.Range(0, hi, impl)])])


def _fused_store(prof, OpCell):
    c = _cells(OpCell)[3]
    return prof.ProfileStore([prof.Profile(
        c.op, c.p, [prof.Range(0, 1 << 20, "fused_ring")], geom=c.geom())])


def test_digests_are_equal_strings(tmp_path):
    for i in range(3):
        _record("ref", f"s{i}", seed=i).flush(tmp_path / "shards", epoch=1)
    _store(rprof).save(tmp_path / "prof")
    _fused_store(rprof, ROpCell).save(tmp_path / "prof" / "decode")
    assert ttrace.shard_digest(tmp_path / "shards") == \
        rtrace.shard_digest(tmp_path / "shards")
    assert tprof.profiles_digest(tmp_path / "prof") == \
        rprof.profiles_digest(tmp_path / "prof")
    assert ttrace.shard_meta(next((tmp_path / "shards").iterdir())) == \
        rtrace.shard_meta(next((tmp_path / "shards").iterdir()))


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_manifest_adopted_across_packages(tmp_path, writer, reader):
    wt, wp, _wa, wC, _wf, wCell = PKGS[writer]
    rt, rp, _ra, rC, _rf, rCell = PKGS[reader]
    wC.demote("allreduce", "wire_q8", reason="tolerance")
    base = _store(wp)
    base.save(tmp_path, epoch=1, source_digest="sha256:abc")
    _fused_store(wp, wCell).save(tmp_path / "decode")
    wp.write_manifest(tmp_path, 2, source_digest="sha256:def", base=base,
                      phases={"decode": _fused_store(wp, wCell)})
    assert rp.read_manifest(tmp_path) == wp.read_manifest(tmp_path)
    ref = rp.resolve_stores(tmp_path, watch=True)
    assert ref.epoch == 2
    assert rC.is_demoted("allreduce", "wire_q8")
    assert ref.lookup(rCell("allreduce", 4, 512), "fwd") == IMPL
    assert ref.lookup(_cells(rCell)[3], "decode") == "fused_ring"
    man = rp.read_manifest(tmp_path)
    assert man["geometry_census"] == {"allgather_matmul": {
        "profiles": 1, "geometries": 1}, "allreduce": {"profiles": 1,
                                                        "geometries": 0}}


def _script(pkg, root):
    """The swap / stale / poison / rollback story on one package's
    ``StoreRef``, over a directory both write; returns every result."""
    _t, prof, _a, _C, _f, OpCell = PKGS[pkg]
    d = root / pkg
    out = []
    cell = OpCell("allreduce", 4, 512)
    with warnings.catch_warnings(record=True) as wlog:
        warnings.simplefilter("always")
        ref = prof.resolve_stores(d, watch=True)
        out.append(("start", ref.epoch))
        _store(prof, "allreduce_as_doubling").save(d, epoch=1)
        out.append(("poll1", ref.poll(), ref.epoch, ref.lookup(cell, "fwd")))
        out.append(("again", ref.poll(), ref.epoch))
        prof.write_manifest(d, 0)
        out.append(("stale", ref.poll(), ref.epoch))
        _store(prof, IMPL).save(d, epoch=2)
        out.append(("poll2", ref.poll(), ref.epoch, ref.lookup(cell, "fwd")))
        out.append(("swap-old", ref.swap(None, None, 1), ref.epoch))
        out.append(("rollback", ref.rollback(), ref.lookup(cell, "fwd")))
        prof.write_manifest(d, 2)
        out.append(("poisoned", ref.poll(), ref.epoch))
        out.append(("swap-poisoned", ref.swap(None, None, 2), ref.epoch))
        _store(prof, "allreduce_as_reduce_bcast").save(d, epoch=3)
        with open(d / "extra.pgtune", "w") as f:
            f.write(_store(prof).__iter__().__next__().to_text())
        out.append(("skew", ref.poll(), ref.epoch))
        (d / "extra.pgtune").unlink()
        out.append(("repaired", ref.poll(), ref.epoch,
                    ref.lookup(cell, "fwd")))
        out.append(("rollback2", ref.rollback(), ref.epoch))
        out.append(("rollback3", ref.rollback(), ref.epoch))
    kinds = [str(w.message).split(":")[0] for w in wlog]
    return out, kinds


def test_scripted_swap_stale_poison_rollback(tmp_path):
    got = {pkg: _script(pkg, tmp_path) for pkg in PKGS}
    assert got["port"] == got["ref"]
    out = dict((r[0], r[1:]) for r in got["port"][0])
    assert out["stale"] == (False, 1) and out["poisoned"] == (False, 1)
    assert out["skew"] == (False, 1) and out["repaired"][:2] == (True, 3)


def _sites(OpCell):
    cells = _cells(OpCell)
    return [(cells[0], "prefill", ("default", "allreduce_as_doubling",
                                   IMPL)),
            (cells[1], "decode", ("default", IMPL)),
            (cells[3], "decode", ("default", "fused_ring")),
            (cells[2], "fwd", ("default",)),
            (cells[0], "decode", ("default", "allreduce_as_doubling",
                                  IMPL))]


def test_plan_slots_vectors_and_explore_agree():
    got = {}
    for pkg in PKGS:
        _t, prof, api, _C, _f, OpCell = PKGS[pkg]
        plan = api.Plan(capacity=4)
        slots = [plan.slot(c, ph, im) for c, ph, im in _sites(OpCell)]
        slots.append(plan.slot(_cells(OpCell)[0], "prefill",
                               ("default", IMPL)))          # drifted set
        ref = prof.StoreRef(base=_store(prof), phases={
            "decode": _fused_store(prof, OpCell)}, epoch=1)
        vec = plan.vector(ref)
        vec_b = plan.vector(base=_store(prof, "allreduce_as_doubling"))
        rng = np.random.default_rng(3)
        explores = [plan.explore(ref, eps=eps, rng=rng)
                    for eps in (0.5, 1.0, 0.0)]
        got[pkg] = (slots, len(plan),
                    [(dataclasses.astuple(c), ph, im)
                     for c, ph, im in plan.sites()],
                    vec.tolist(), vec.dtype.str, vec_b.tolist(),
                    [(v.tolist(), sorted((dataclasses.astuple(c), ph, im)
                                         for (c, ph), im in e.items()))
                     for v, e in explores])
    assert got["port"] == got["ref"]
    assert got["port"][0] == [0, 1, 2, 3, None, None]
    assert any(got["port"][3])


def _op_cells(op, p, OpCell):
    """Cells of ``op`` at axis size ``p``: flat, hierarchical where the op
    has a two-axis form, fused with geometry where it is a matmul op."""
    role = {"allgather_matmul": "gather", "matmul_reducescatter": "scatter",
            "matmul_accumulate": "contract"}.get(op)
    if op == "matmul_reducescatter_2d":
        return [OpCell(op, p, 4096, "bfloat16", 64, 128, 256, "2d", 4),
                OpCell(op, p, 4096, "bfloat16", 64, 128, 256, "2dT", 3)]
    if role:
        return [OpCell(op, p, 4096, "bfloat16", 64, 128, 256, role)]
    out = [OpCell(op, p, 4096), OpCell(op, p, 1 << 20, "bfloat16")]
    if op in OpCell.HIER_OPS:
        out += [OpCell(op, p, 4096, p2=2), OpCell(op, p, 4096, p2=3)]
    return out


@pytest.mark.parametrize("p", [6, 8])
@pytest.mark.parametrize("budget", [None, 4096])
def test_admissible_impls_agree(p, budget):
    assert list(TC.REGISTRY) == list(RC.REGISTRY)
    TC.demote("allreduce", "wire_fp8")
    RC.demote("allreduce", "wire_fp8")
    n = 0
    for op in RC.REGISTRY:
        for rc, tc in zip(_op_cells(op, p, ROpCell),
                          _op_cells(op, p, TOpCell)):
            want = rapi._admissible_impls(
                op, rc, rapi.TuneContext(scratch_budget_bytes=budget))
            got = tapi._admissible_impls(
                op, tc, tapi.TuneContext(scratch_budget_bytes=budget))
            assert got == want, (op, rc)
            n += len(want) > 1
    assert n > 10


def test_tripwire_agrees():
    rng = np.random.default_rng(9)
    script = []
    for epoch, scale in ((1, 1.0), (2, 1.1), (3, 1.6), (4, 1.0), (5, 3.0)):
        script.append(("swap", epoch))
        script += [("cost", float(scale * rng.lognormal(0, 0.05)))
                   for _ in range(7)]
        if epoch == 2:
            script.append(("cost", 50.0))          # one spike
    got = {}
    for pkg in PKGS:
        prof, api = PKGS[pkg][1], PKGS[pkg][2]
        ref = prof.StoreRef(epoch=0)
        tw = api.EpochTripwire(ref, threshold=1.3, window=4, min_samples=3)
        out = []
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for kind, v in script:
                if kind == "swap":
                    out.append(("swap", ref.swap(None, None, v)))
                else:
                    out.append((tw.observe(v), ref.epoch, tw.baseline))
        got[pkg] = (out, tw.fired)
    assert got["port"] == got["ref"]
    assert got["port"][1]                       # it fired at least once


def test_mad_filter_and_feedback_backend_agree():
    rng = np.random.default_rng(4)
    for k in (0.0, 2.0, 4.0):
        for n in (1, 2, 3, 8, 31):
            s = list(rng.lognormal(-8, 0.2, n))
            s[: n // 4] = [x * 100 for x in s[: n // 4]]
            assert ttuner._mad_filter(s, k) == rtuner._mad_filter(s, k)
    assert ttuner._mad_filter([1.0] * 5, 4.0) == [1.0] * 5
    obs_cells = _cells(ROpCell)[:3], _cells(TOpCell)[:3]
    samples = [list(rng.lognormal(-9, 0.1, m)) + [1.0] for m in (2, 5, 9)]
    rb = rtuner.CostModelBackend(rcm.Topo(**TOPO))
    tb = ttuner.CostModelBackend(tcm.Topo(**TOPO))
    rf = rtuner.FeedbackBackend(rb, {(c, IMPL): s for c, s in
                                     zip(obs_cells[0], samples)})
    tf = ttuner.FeedbackBackend(tb, {(c, IMPL): s for c, s in
                                     zip(obs_cells[1], samples)})
    assert tf.rejected == rf.rejected > 0 and tf.name == \
        "feedback+" + tb.name
    for rc, tc in zip(obs_cells[0], obs_cells[1]):
        for im in ("default", IMPL):
            assert tf.latency(tc, im) == rf.latency(rc, im)
            assert tf.nrep_for(tc, im) == rf.nrep_for(rc, im)
            assert tf.observed_for(tc, im) == rf.observed_for(rc, im)


def test_estimate_trace_cost_agrees():
    recs, _ = _stream(2, n=300)
    traces = {}
    for pkg in PKGS:
        t, _p, api, _C, _f, OpCell = PKGS[pkg]
        cells = _cells(OpCell)
        traces[pkg] = t.Trace.from_record(
            api.DispatchRecord(cells[c], im, ph) for c, ph, im in recs)
    with pytest.raises(ValueError, match="explicit backend"):
        ttuner.estimate_trace_cost(traces["port"])
    rb = rtuner.CostModelBackend(rcm.Topo(**TOPO))
    tb = ttuner.CostModelBackend(tcm.Topo(**TOPO))
    for budget in (None, 1024):
        kw_r = dict(base=_store(rprof, "wire_q8"),
                    phases={"decode": _fused_store(rprof, ROpCell)},
                    scratch_budget_bytes=budget)
        kw_t = dict(base=_store(tprof, "wire_q8"),
                    phases={"decode": _fused_store(tprof, TOpCell)},
                    scratch_budget_bytes=budget)
        for kr, kt in (({}, {}), (kw_r, kw_t)):
            want = rtuner.estimate_trace_cost(traces["ref"], rb, **kr)
            got = ttuner.estimate_trace_cost(traces["port"], tb, **kt)
            assert sorted(got) == sorted(want)
            for ph in want:
                assert got[ph] == pytest.approx(want[ph], rel=1e-12,
                                                abs=0.0)
                assert want[ph] > 0


def test_coordinator_scan_agrees(tmp_path):
    now = [0.0]
    rb = rtuner.CostModelBackend(rcm.Topo(**TOPO))
    tb = ttuner.CostModelBackend(tcm.Topo(**TOPO))
    cos = {"ref": rft.FleetCoordinator(
               tmp_path, rprof.StoreRef(base=_store(rprof), epoch=1),
               backend=rb, heartbeat_timeout=10.0, clock=lambda: now[0]),
           "port": tft.FleetCoordinator(
               tmp_path, tprof.StoreRef(base=_store(tprof), epoch=1),
               backend=tb, heartbeat_timeout=10.0, clock=lambda: now[0])}
    with pytest.raises(ValueError, match="explicit backend"):
        tft.FleetCoordinator(tmp_path, None, backend=None)

    def scan():
        out = {}
        for pkg, co in cos.items():
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                st = co.scan()
            out[pkg] = st
        r, t = out["ref"], out["port"]
        assert (t.fleet_epoch, t.alive, t.dead, t.stragglers, t.quarantined,
                t.retune) == (r.fleet_epoch, r.alive, r.dead, r.stragglers,
                              r.quarantined, r.retune)
        assert (t.drift is None) == (r.drift is None)
        if r.drift is not None:
            assert t.drift == pytest.approx(r.drift, rel=1e-12)
        return t

    assert scan().fleet_epoch == -1
    cell = ROpCell("allreduce", 4, 512)
    t_model = rb.latency(cell, IMPL)
    for s in ("s0", "s1", "s2"):
        r = rtrace.ShardRecorder(s, seed=len(s))
        for i in range(6):
            r.append(rapi.DispatchRecord(ROpCell("allreduce", 4,
                                                 256 * (1 + i % 2)),
                                         "default", "fwd"))
        for _ in range(3):
            r.observe(cell, IMPL, 2.0 * t_model)
        r.flush(tmp_path, epoch=1)
    st = scan()
    assert st.alive == ["s0", "s1", "s2"] and st.retune      # drift ~2x
    now[0] += 8.0
    for s in ("s0", "s1"):
        rtrace.ShardRecorder(s).flush(tmp_path, epoch=2)
    now[0] += 8.0
    rtrace.ShardRecorder("s0").flush(tmp_path, epoch=3)
    rtrace.ShardRecorder("s0").flush(tmp_path, epoch=4)
    rft.ChaosMonkey(seed=1).tear_shard(tmp_path / "shard-s2-e000001.jsonl",
                                       keep_frac=0.5)
    st = scan()
    assert st.dead == ["s2"] and st.stragglers == ["s1"]
    assert st.quarantined == 1
    assert "RETUNE" in st.summary()
