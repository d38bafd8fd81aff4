"""The process-group rank axis (``GroupAxis``, ``GroupMesh``) on gloo,
worlds of local processes spawned per test (``launch.mesh.spawn``).

Each world meets at a ``TCPStore`` its parent serves on a port the
system picks (so xdist workers cannot collide) and runs under a hard
timeout that kills its ranks, so a hang fails.  The ranks run
``tests/_torch_group_ranks.py``, which imports no JAX; the parent makes
every input with numpy and passes it as arrays, and holds what the
ranks return to the stacked axis and to the JAX package:

* (i) every primitive against ``StackedAxis`` at world 4 and on each
  axis of a (2, 2) mesh: copies (``all_gather``, ``all_to_all``,
  ``pshift``) bit-equal in float32 and bfloat16, ``pmax`` exact,
  ``psum`` and ``psum_scatter`` within 1e-6 of max|ref| in float32 and
  ``p * 2**-7 * max|ref|`` in bfloat16 (gloo adds in another order; in
  bfloat16 it rounds each of the p - 1 additions);
* (ii) ``selfcheck --world 4`` and ``--world 8``, flat and mesh: no
  failure, the totals of the stacked run at p 4 and 8;
* (iii) a planted broken ``pshift`` the group selfcheck must report;
* (iv) the measured replay of ``test_measured_backend_trace_replay_4dev``
  (JAX package): the p 4 and (2, 2) cells measured, the p 8 cell skipped
  with a note, every rank the same samples and picks, one profile
  directory written;
* (v) llama3.2-3b's smoke config served at TP 4 on a ``GroupAxis``,
  held to the JAX package's serve within ``test_torch_serve.RTOL``.
"""
import json
import types

import numpy as np
import pytest
import torch

import _torch_group_ranks as ranks
from test_torch_models import port_cfg, ref_params, ref_shard
from test_torch_serve import (B, N_TOKENS, S_MAX, _cfg, _check_logits,
                              _check_records, _prompts, ref_serve)

from repro_torch.core import selfcheck
from repro_torch.core._axis import StackedAxis, StackedMesh
from repro_torch.launch.mesh import init_world, make_host_mesh, spawn
from repro_torch.models import lm as tlm
from repro_torch.models import params as tparams

#: seconds a world may run before its ranks are killed
TIMEOUT_S = 240.0


def _world(fn, world, *args):
    return spawn(fn, world, backend="gloo", args=args, timeout_s=TIMEOUT_S)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_primitives_match_the_stacked_axis(dt):
    rng = np.random.default_rng(26)
    x = rng.normal(size=(4, 3, 2)).astype(np.float32)
    xb = rng.normal(size=(4, 8, 2)).astype(np.float32)
    got = _world(ranks.primitives, 4, x, xb, dt)
    stacked = StackedMesh((2, 2), ("o", "i"), "cpu")
    axes = {"world": StackedAxis(4, "cpu"), "o": stacked["o"],
            "i": stacked["i"]}
    tdt = getattr(torch, dt)
    for (nm, ax) in axes.items():
        want = ranks.primitive_outputs(ax, torch.from_numpy(x).to(tdt),
                                       torch.from_numpy(xb).to(tdt))
        for k, w in want.items():
            w = w.float().numpy()
            mine = np.concatenate([g[nm][k] for g in got])
            assert mine.shape == w.shape, (nm, k)
            if k in ("psum", "psum_scatter"):
                tol = (1e-6 if dt == "float32"
                       else ax.size * 2 ** -7) * np.abs(w).max()
                assert np.abs(mine - w).max() <= tol, (nm, k)
            else:
                np.testing.assert_array_equal(mine, w, err_msg=str((nm, k)))
    # every primitive went through its one library call
    calls = got[0]["calls"]
    for k in ("all_gather", "all_to_all", "psum", "pmax", "psum_scatter",
              "pshift"):
        assert calls.get(k, 0) > 0, (k, calls)


@pytest.mark.parametrize("world", [4, 8])
def test_group_selfcheck_has_the_stacked_totals(world, capsys):
    assert selfcheck.main(["--world", str(world), "--dist-backend", "gloo",
                           "--device", "cpu", "--json"]) == 0
    flat, mesh = (json.loads(ln) for ln in
                  capsys.readouterr().out.strip().splitlines()[-2:])
    want_flat = selfcheck.run(world, "cpu")
    want_mesh = selfcheck.run_mesh((2, world // 2), "cpu")
    for got, want in ((flat, want_flat), (mesh, want_mesh)):
        assert got["failures"] == [] and got["demoted"] == want["demoted"]
        assert got["total"] == want["total"] and got["devices"] == \
            want["devices"]
        assert got["world"] == world and got["backend"] == "gloo"
        assert list(got["not_applicable"]) == ["ring_allgather_matmul_rdma"]
        assert "one address space" in got["not_applicable"][
            "ring_allgather_matmul_rdma"]
    assert mesh["impls"] == 64


def test_group_selfcheck_reports_a_broken_pshift():
    flat, mesh = _world(ranks.planted_selfcheck, 4)[0]
    for rep in (flat, mesh):
        assert rep["failures"], rep
    # rings and shift schedules fail; a single library collective does not
    assert "scan/default" in flat["failures"]
    assert "allgather/allgather_as_ring" in flat["failures"]
    assert "allreduce/default" not in flat["failures"]


def test_measured_replay_on_a_world_of_four(tmp_path):
    out = tmp_path / "profiles"
    got = _world(ranks.measured_replay, 4, str(out))
    first = got[0]
    assert first["sup"] == 4
    assert first["n_meas"] > 0                  # the p 4 cell measured
    assert first["n_meas_2d"] >= 2, first       # the (2, 2) 2-D cell
    assert first["skips"] and "p=8" in first["skips"][0], first
    assert first["est_default"] > 0.0
    # the slowest rank's samples on every rank: the same counts, times
    # and picks everywhere, one profile directory
    for g in got[1:]:
        assert g["samples"] == first["samples"]
        assert g["digest"] == first["digest"]
    assert len(list(out.rglob("*.pgtune"))) == first["n_profiles"]


def test_tp4_serve_on_a_group_axis_matches_the_reference():
    rcfg = _cfg()
    tree = ref_params(rcfg, seed=2)
    prompts = _prompts(rcfg)
    r_toks, r_lgs, r_ctx = ref_serve(rcfg, 4, ref_shard(tree, rcfg, 4),
                                     prompts)
    tcfg = port_cfg(rcfg)
    stacked = tparams.from_reference(tree, tlm.model_specs(tcfg, 4),
                                     StackedAxis(4, "cpu"))
    got = _world(ranks.serve_tp, 4, tcfg, stacked, prompts,
                 S_MAX, N_TOKENS)
    for g in got:
        assert g["tokens"].shape == (B, N_TOKENS)
        np.testing.assert_array_equal(g["tokens"], got[0]["tokens"])
        res = types.SimpleNamespace(
            tokens=torch.as_tensor(g["tokens"]),
            logits=[torch.as_tensor(a) for a in g["logits"]])
        assert _check_logits(res, r_toks, r_lgs) is None
        _check_records(types.SimpleNamespace(record=g["record"]), r_ctx)
        assert g["calls"]["psum"] > 0 and g["calls"]["all_gather"] > 0


def test_process_axes_refuse_what_they_cannot_run(tmp_path):
    """No fallback: gloo runs only where the CPU was asked for, a world
    above the visible GPUs is refused by NCCL with its one-rank-per-GPU
    limit, and a process axis has no lane grid and no one-kernel ring.
    The sequence-sharded decode is no longer refused: its step builds on
    a process mesh (each data rank writes the slots it owns)."""
    got = _world(ranks.refusals, 2)
    for g in got:
        assert "CPU" in g["gloo on the card"] or "CUDA" in \
            g["gloo on the card"]
        assert "gloo by default" in g
        for k in ("groups", "stride"):
            assert g[k].startswith("NotImplementedError") and \
                "process-group axis" in g[k]
        assert "1 lane" in g["two lanes"]
        assert g["one-kernel ring"].startswith("NotImplementedError") and \
            "one address space" in g["one-kernel ring"]
        assert "seq-sharded decode" not in g
        reason, none = g["off_process_axis"]
        assert "one address space" in reason and none is None
        # the dispatcher's admissible set leaves it out on CUDA operands
        assert g["admitted"] == ["default", "fused_ring"]
    with pytest.raises(ValueError, match="init_method or store"):
        init_world("gloo", rank=0, world=1)
    with pytest.raises(ValueError, match="one rank per GPU"):
        init_world("nccl", rank=0, world=torch.cuda.device_count() + 1,
                   init_method=(tmp_path / "store").as_uri())
    assert isinstance(make_host_mesh((2, 2), ("data", "model"), "cpu"),
                      StackedMesh)
