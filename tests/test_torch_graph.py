"""The graph layer (``repro_torch.analysis.graph``/``interpose``/
``roofline``) against the JAX package's HLO layer on the CPU.

* The reference's fused fixture (``tests/test_hlo_interpose.py``'s
  ``FUSED_FIXTURE``: an all-gather feeding a matmul on its row dim, one
  feeding a matmul that contracts the gathered dim, a matmul feeding a
  reduce-scatter and one feeding an all-reduce, over 4 ranks) written as
  a torch program on a fake world of 4, in the in-place and in the
  functional collective forms: ``map_sites`` gives the reference's four
  cells field for field, and ``scan_potential`` the reference's rows
  (``t_default``, ``best_impl``, ``t_best``) on the same ``Topo``, given
  explicitly.  Tolerance: none, the cells and the cost model's floats are
  compared for equality.
* Pairing: an unwaited functional collective, a wait of no collective
  and a collective inside a higher-order op (``cond``, ``while_loop``)
  raise ``GraphParseError``.
* ``program_costs`` on a small program: its dot flops equal 2·m·n·k by
  hand and ``FlopCounterMode``'s count of the eager run (exactly), and
  its bytes and live-bytes peak equal a hand count.
* ``roofline_terms`` / ``model_flops``: the reference's rows for all ten
  archs x four shapes, given the reference's constants as the chip
  record (test input only; the port's one preset is the H100's).

Every fake world is made and destroyed by the ``fake_world`` fixture,
whatever the test does, so no other file in the worker sees a default
process group.
"""
import dataclasses

import pytest
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as fc
from torch.utils.flop_counter import FlopCounterMode

import test_torch_ref  # noqa: F401  (the reference's import shims)
from test_hlo_interpose import FUSED_FIXTURE

from repro import configs as rconfigs
from repro.analysis import interpose as rinterpose
from repro.analysis import roofline as rroofline
from repro.core import costmodel as rcostmodel
from repro.launch import shapes as rshapes
from repro_torch import configs as tconfigs
from repro_torch.analysis import graph as tgraph
from repro_torch.analysis import interpose as tinterpose
from repro_torch.analysis import roofline as troofline
from repro_torch.core import costmodel as tcostmodel
from repro_torch.launch import shapes as tshapes
from repro_torch.launch.mesh import init_fake_world


@pytest.fixture
def fake_world():
    made = []

    def make(n: int):
        init_fake_world(n)
        made.append(n)
    try:
        yield make
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _empty(*shape):
    return torch.empty(shape, dtype=torch.float32)


def fused_inplace(x, w, xk, w2):
    """FUSED_FIXTURE with the in-place collectives ``dist.*`` records."""
    ag = x.new_empty((4 * x.shape[0], x.shape[1]))
    dist.all_gather_into_tensor(ag, x)
    dot = ag @ w
    agk = xk.new_empty((4 * xk.shape[0], xk.shape[1]))
    dist.all_gather_into_tensor(agk, xk)
    dotk = agk.t() @ agk
    dot2 = dot @ w2
    dist.all_reduce(dot2)
    rs = dot.new_empty((dot.shape[0] // 4, dot.shape[1]))
    dist.reduce_scatter_tensor(rs, dot)
    return rs, dotk, dot2


def fused_functional(x, w, xk, w2):
    """FUSED_FIXTURE with the functional collectives (each waited)."""
    g = dist.group.WORLD
    ag = fc.all_gather_tensor(x, 0, g)
    dot = ag @ w
    agk = fc.all_gather_tensor(xk, 0, g)
    dotk = agk.t() @ agk
    dot2 = dot @ w2
    ar = fc.all_reduce(dot2, "sum", g)
    rs = fc.reduce_scatter_tensor(dot, "sum", 0, g)
    return rs + 0, dotk, ar + 0


FIXTURE_ARGS = ((8, 16), (16, 32), (8, 16), (32, 24))


def _fixture_graph(fn):
    return tgraph.capture(fn, *(_empty(*s) for s in FIXTURE_ARGS))


def _cell(c) -> tuple:
    return tuple(getattr(c, f.name) for f in dataclasses.fields(c))


def _by_cell(scs):
    return sorted(scs, key=lambda sc: _cell(sc.cell))


@pytest.mark.parametrize("fn", [fused_inplace, fused_functional],
                         ids=["inplace", "functional"])
def test_fused_fixture_maps_to_the_reference_cells(fake_world, fn):
    fake_world(4)
    gm = _fixture_graph(fn)
    mapped, unmapped = tinterpose.map_sites(gm)
    ref, ref_un = rinterpose.map_sites(FUSED_FIXTURE)
    assert unmapped == [] and ref_un == []
    assert len(mapped) == 4
    got, want = _by_cell(mapped), _by_cell(ref)
    assert [_cell(sc.cell) for sc in got] == [_cell(sc.cell) for sc in want]
    assert [(sc.fused, bool(sc.adjacent_dot)) for sc in got] == \
        [(sc.fused, bool(sc.adjacent_dot)) for sc in want]
    by_op = {sc.cell.op: sc for sc in mapped}
    assert by_op["allgather_matmul"].cell.mm_role == "gather"
    assert by_op["matmul_accumulate"].cell.mm_k == 32
    assert by_op["matmul_reducescatter"].cell.nbytes == 32 * 16 * 4
    assert not by_op["allreduce"].fused and by_op["allreduce"].adjacent_dot
    assert {sc.site.form for sc in mapped} == {
        "inplace" if fn is fused_inplace else "functional"}


@pytest.mark.parametrize("fn", [fused_inplace, fused_functional],
                         ids=["inplace", "functional"])
def test_fused_fixture_prices_as_the_reference(fake_world, fn):
    fake_world(4)
    gm = _fixture_graph(fn)
    topo = tcostmodel.Topo(**dataclasses.asdict(rcostmodel.V5E_ICI))
    rep = tinterpose.scan_potential(gm, topo=topo, label="fixture")
    ref = rinterpose.scan_potential(FUSED_FIXTURE, topo=rcostmodel.V5E_ICI,
                                    label="fixture")
    assert rep.ok and rep.world == ref.world == 4

    def rows(r):
        return [(_cell(x.sc.cell), x.t_default, x.best_impl, x.t_best)
                for x in sorted(r.rows, key=lambda x: _cell(x.sc.cell))]
    assert rows(rep) == rows(ref)
    assert rep.potential() == ref.potential()
    assert "x on the table" in rep.table()
    j, rj = rep.to_json(), ref.to_json()
    assert set(j) == set(rj) and set(j["rows"][0]) == set(rj["rows"][0])


def test_scan_potential_takes_no_default_topology(fake_world):
    fake_world(4)
    gm = _fixture_graph(fused_inplace)
    with pytest.raises(TypeError):
        tinterpose.scan_potential(gm)
    with pytest.raises(ValueError, match="Topo"):
        tinterpose.scan_potential(gm, topo=None)
    with pytest.raises(TypeError):
        tinterpose.tuning_potential(fused_inplace,
                                    *(_empty(*s) for s in FIXTURE_ARGS))


def test_sites_bytes_groups_and_permute_batches(fake_world):
    """Operand bytes (an all-gather its shard, a reduce-scatter its full
    input), a subgroup's size, dtype names, and one collective-permute
    per send/recv batch."""
    fake_world(4)
    pair = dist.new_group([0, 1])

    def prog(x):
        out = x.new_empty((2 * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=pair)
        r = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, 1), dist.P2POp(dist.irecv, r, 3)]
        for q in dist.batch_isend_irecv(ops):
            q.wait()
        rs = x.new_empty((x.shape[0] // 4,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(rs, out[:x.shape[0]])
        return out, r, rs

    gm = tgraph.capture(prog, torch.empty((8, 3), dtype=torch.bfloat16))
    sites = tgraph.collective_sites(gm)
    assert [(s.base_op, s.operand_bytes, s.group_size, s.dtype)
            for s in sites] == [
        ("all-gather", 8 * 3 * 2, 2, "bfloat16"),
        ("collective-permute", 8 * 3 * 2, 4, "bfloat16"),
        ("reduce-scatter", 8 * 3 * 2, 4, "bfloat16")]
    assert tgraph.module_world(gm) == 4
    cb = tgraph.collective_bytes(gm)
    assert cb["total_bytes"] == 3 * 48 and cb["all-gather"]["count"] == 1


# ---------------------------------------------------------------------------
# pairing: never a silent undercount
# ---------------------------------------------------------------------------


def _graph(build) -> torch.fx.GraphModule:
    g = torch.fx.Graph()
    x = g.placeholder("x")
    g.output(build(g, x))
    return torch.fx.GraphModule(torch.nn.Module(), g)


def test_an_unwaited_functional_collective_raises(fake_world):
    fake_world(4)
    gm = _graph(lambda g, x: g.call_function(
        torch.ops._c10d_functional.all_reduce.default, (x, "sum", "0")))
    with pytest.raises(tgraph.GraphParseError, match="never waited"):
        tgraph.collective_sites(gm)


def test_a_wait_of_no_collective_raises():
    gm = _graph(lambda g, x: g.call_function(
        torch.ops._c10d_functional.wait_tensor.default, (x,)))
    with pytest.raises(tgraph.GraphParseError, match="no collective"):
        tgraph.collective_sites(gm)


@pytest.mark.parametrize("hop", ["cond", "while_loop"])
def test_a_collective_inside_a_higher_order_op_raises(fake_world, hop):
    fake_world(4)
    world = dist.group.WORLD

    def in_cond(x):
        return torch.cond(x.sum() > 0,
                          lambda y: fc.all_reduce(y, "sum", world) * 1,
                          lambda y: y * 2, (x,))

    def in_loop(x):
        return torch._higher_order_ops.while_loop(
            lambda i, y: i < 3,
            lambda i, y: (i + 1, fc.all_reduce(y, "sum", world) + 0),
            (torch.tensor(0), x))
    gm = tgraph.capture(in_cond if hop == "cond" else in_loop,
                        torch.ones(4))
    for fn in (tgraph.collective_sites, tgraph.program_costs,
               tinterpose.map_sites):
        with pytest.raises(tgraph.GraphParseError, match=hop):
            fn(gm)


# ---------------------------------------------------------------------------
# program costs
# ---------------------------------------------------------------------------


def _costs_prog(a, b, c, d):
    e = a @ b                                   # mm   [6, 5] x [5, 7]
    f = torch.bmm(c, d)                         # bmm  [3, 4, 8] x [3, 8, 2]
    g = torch.einsum("ij,jk->ik", e.t(), a)     # [7, 6] x [6, 5]
    return e.sum() + f.sum() + g.sum()


def test_program_costs_dot_flops_by_hand_and_flop_counter():
    shapes = ((6, 5), (5, 7), (3, 4, 8), (3, 8, 2))
    args = [torch.randn(s) for s in shapes]
    gm = tgraph.capture(_costs_prog, *args)
    pc = tgraph.program_costs(gm)
    by_hand = 2 * 6 * 7 * 5 + 2 * 3 * 4 * 2 * 8 + 2 * 7 * 5 * 6
    with FlopCounterMode(display=False) as counter:
        _costs_prog(*args)
    assert pc["dot_flops"] == by_hand == counter.get_total_flops()
    assert pc["argument_bytes"] == sum(4 * torch.Size(s).numel()
                                       for s in shapes)


def test_program_costs_bytes_and_live_peak_by_hand():
    def prog(x):
        y = x * 2               # reads 1024, writes 1024
        z = y + 1               # reads 1024, writes 1024; y dies here
        return z.sum()          # reads 1024, writes 4
    gm = tgraph.capture(prog, torch.ones(256))
    pc = tgraph.program_costs(gm)
    assert pc["bytes"] == 2048 + 2048 + 1028
    assert pc["argument_bytes"] == 1024 and pc["output_bytes"] == 4
    assert pc["peak_live_bytes"] == 2048
    assert pc["dot_flops"] == 0


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------


#: the reference's constants as a chip record (test input only)
REF_CHIP = troofline.Chip("reference", {"bfloat16": rroofline.PEAK_FLOPS},
                          rroofline.HBM_BW, rroofline.LINK_BW)


@pytest.mark.parametrize("arch", sorted(rconfigs.ARCHS))
def test_roofline_terms_match_the_reference(arch):
    rcfg, tcfg = rconfigs.get_config(arch), tconfigs.get_config(arch)
    cost = {"flops": 3.1e15, "bytes accessed": 7.7e12}
    coll = {"total_bytes": 1.9e10}
    for shape in rshapes.SHAPES:
        rc, tc = rshapes.SHAPES[shape], tshapes.SHAPES[shape]
        assert troofline.model_flops(tcfg, tc, 256) == \
            rroofline.model_flops(rcfg, rc, 256)
        for over in ({}, {"flops_override": 2.5e14,
                          "bytes_override": 3.3e11}):
            want = rroofline.roofline_terms(
                arch, shape, "16x16", cost=cost, coll=coll, cfg=rcfg,
                cell=rc, n_devices=256, **over)
            got = troofline.roofline_terms(
                arch, shape, "16x16", cost=cost, coll=coll, cfg=tcfg,
                cell=tc, n_devices=256, chip=REF_CHIP, **over)
            assert got.row() == want.row()
            assert got.step_time_bound == want.step_time_bound


def test_stacked_collectives_go_to_the_memory_term():
    cfg = tconfigs.get_config("llama3.2-3b")
    cell = tshapes.SHAPES["decode_32k"]
    kw = dict(cost={}, coll={"total_bytes": 3.35e12}, cfg=cfg, cell=cell,
              n_devices=1, chip=troofline.H100_SXM, flops_override=1.0,
              bytes_override=3.35e12)
    procs = troofline.roofline_terms("a", "s", "m", **kw)
    stacked = troofline.roofline_terms("a", "s", "m", stacked=True, **kw)
    assert procs.t_memory == pytest.approx(1.0)
    assert procs.t_collective == pytest.approx(3.35e12 / 450e9)
    assert stacked.t_collective == 0.0
    assert stacked.t_memory == pytest.approx(2.0)
    assert troofline.H100_FLOPS["bfloat16"] == 989e12
    assert troofline.H100_BYTES_PER_S == 3.35e12
