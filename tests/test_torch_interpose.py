"""Interposition at the graph layer: the rewrite mode across processes,
the record-to-site matching and ``tuning_potential``, against the JAX
package's ``analysis/interpose.py`` on the CPU.

* The rewrite (``interpose.rewrite``) of the reference's
  ``REWRITE_SCRIPT`` program (``tests/test_hlo_interpose.py``) on a gloo
  world of 4 processes: with ``allgather_as_ring`` and
  ``alltoall_as_ppermute`` forced, every rank's output is bit-exact with
  the default's, ``changed`` is the reference's slow test's list, no
  record is unmatched, no site is extra, and the matched ops are the
  four the reference matches.  The world's output is the reference's
  ``shard_map`` program's, run here on 4 forced host devices in a
  subprocess (float32: the movement mock-ups copy bits, so the
  comparison is for equality).
* ``_match_records_to_sites``: the reference's unit test on the port's
  sites of its fused fixture (``tests/test_torch_graph.py``).
* ``tuning_potential`` captures, maps and prices a program on a given
  ``Topo`` and refuses to price without one.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_analysis_ranks as ranks
import test_torch_ref  # noqa: F401  (the reference's import shims)
from test_hlo_interpose import REWRITE_SCRIPT
from test_torch_graph import (FIXTURE_ARGS, _empty, _fixture_graph,
                              fused_inplace)

from repro_torch.analysis import interpose as tinterpose
from repro_torch.core import costmodel as tcostmodel
from repro_torch.core.api import DispatchRecord
from repro_torch.core.cell import OpCell
from repro_torch.launch.mesh import init_fake_world, spawn

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 180.0

#: the reference's REWRITE_SCRIPT, printing its program's output too
REF_OUT = REWRITE_SCRIPT.replace(
    '"bitexact": res.bitexact,', '"bitexact": res.bitexact,\n'
    '    "out": np.asarray(res.tuned_out).tolist(),').replace(
    "import json\n", "import json\nimport numpy as np\n")


@pytest.fixture
def fake4():
    init_fake_world(4)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _reference_rewrite() -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", REF_OUT], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_rewrite_is_bitexact_on_a_gloo_world_of_four():
    got = spawn(ranks.rewrite_rank, 4, backend="gloo", timeout_s=TIMEOUT_S)
    ref = _reference_rewrite()
    for r in got:
        assert r["bitexact"] is True
        assert [list(c) for c in r["changed"]] == ref["changed"] == [
            ["allgather", "allgather_as_ring"],
            ["alltoall", "alltoall_as_ppermute"]]
        assert r["unmatched"] == [] and r["extra"] == []
        assert ref["unmatched"] == [] and ref["extra"] == []
        assert {op for op, _ in r["matched"]} == {
            op for op, _ in ref["matched"]} == {
            "allgather", "reducescatter", "allreduce", "alltoall"}
    world_out = np.concatenate([r["out"][0] for r in got])
    np.testing.assert_array_equal(world_out,
                                  np.asarray(ref["out"], np.float32))


def test_match_records_to_sites(fake4):
    sites = [sc.site for sc in
             tinterpose.map_sites(_fixture_graph(fused_inplace))[0]]
    recs = [
        DispatchRecord(OpCell.plain("allgather", 4, 8 * 16 * 4), "default",
                       ""),
        DispatchRecord(OpCell.plain("allreduce", 4, 32 * 24 * 4),
                       "default", ""),
        DispatchRecord(OpCell.plain("allreduce", 4, 999), "default", ""),
        DispatchRecord(OpCell.plain("allgather", 1, 64), "default", ""),
    ]
    matched, unmatched, free = tinterpose._match_records_to_sites(recs,
                                                                  sites)
    assert [(r.cell.op, s.base_op) for r, s in matched] == [
        ("allgather", "all-gather"), ("allreduce", "all-reduce")]
    assert [r.cell.nbytes for r in unmatched] == [999]   # no such site
    assert sorted(s.base_op for s in free) == ["all-gather",
                                               "reduce-scatter"]


def test_tuning_potential_prices_on_the_given_topology(fake4):
    topo = tcostmodel.Topo("test-fabric", alpha=5e-6, link_bw=20e9,
                           gamma=1e-12, quant_bw=1e12)
    args = [_empty(*s) for s in FIXTURE_ARGS]
    rep = tinterpose.tuning_potential(fused_inplace, *args, topo=topo)
    assert rep.ok and rep.topo == "test-fabric" and len(rep.rows) == 4
    assert rep.potential() >= 1.0
    assert rep.label == "fused_inplace"
    with pytest.raises(ValueError, match="Topo"):
        tinterpose.tuning_potential(fused_inplace, *args, topo="v5e-ici")


def test_rewrite_refuses_nothing_on_one_process():
    """On no process group (a single process, no collective), the
    rewrite still captures, runs and compares: a program with no
    dispatch has nothing to match and stays bit-exact."""
    x = torch.arange(12.0).reshape(3, 4)
    res = tinterpose.rewrite(lambda a: (a * 2).sum(0), x,
                             force={"allgather": "allgather_as_ring"})
    tinterpose.assert_bitexact(res)
    assert res.matched == [] and res.changed == [] and res.extra_sites == []
