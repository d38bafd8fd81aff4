"""The dry run (``launch.dryrun``), the production mesh on a fake world,
``shapes.local_args`` and the sequence-sharded decode across processes,
against the JAX package on the CPU.

* The smoke llama3.2-3b prefill and decode cells (seq 32, batch 8,
  ``scan_layers=False``) on a fake (2, 4) world (``interpose.
  compile_zoo_graph``) against the reference's ``compile_zoo_hlo`` on 8
  forced host devices under ``api.tuned(record=)``, in a subprocess:
  - the same multiset of dispatch records (op, p, nbytes, dtype);
  - the same per-device argument bytes, apart from two named
    differences: the reference's int32 scalars (each attention cache's
    ``len`` leaf and the decode position ``t``; host ints in the port),
    counted; and the reference prefill's cache parameters, which its
    prefill never reads, so XLA's sharding propagation leaves them
    replicated (``sharding={replicated}``, the global batch), where the
    port's are the local shards;
  - the same collective bytes by class, apart from two XLA passes, each
    asserted as such: the CPU backend's float normalization runs every
    bf16 collective in float32 (every reference site's operand is f32,
    twice the bytes of its bfloat16 record), and CSE merges the two
    all-gathers of the tied embedding table (the port gathers it for the
    embedding and again for the head, from one parameter);
  - the same dot flops, exactly at decode; at prefill the reference
    computes the head over every prompt position and the port over the
    last only (``lm.prefill``), a named difference of 2·B·(S-1)·D·V/tp
    flops; after it, within 1 %.
* The production meshes: the smoke llama3.2-3b cells at 16 x 16 and
  2 x 16 x 16 (and gemma3-1b's ``long_500k``, the sequence-sharded decode
  on a process mesh) are ``ok`` with no unmapped site; the CLI exits
  nonzero on an error cell and refuses the flash path.
* The sequence-sharded decode of gemma3-1b (smoke) across a gloo world
  at (data, model) = (2, 2), held to the same decode on a stacked (2, 2)
  mesh within ``SERVE_RTOL`` (max-norm relative, the serve path's bar in
  ``chip_smoke.py``), tokens equal.
"""
import dataclasses
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

from repro_torch.analysis import graph as tgraph
from repro_torch.analysis import interpose as tinterpose
from repro_torch.configs import get_config
from repro_torch.core._axis import StackedAxis, StackedMesh
from repro_torch.dist.axes import bind
from repro_torch.launch import dryrun, serve
from repro_torch.launch import shapes as tshapes
from repro_torch.launch.mesh import (init_fake_world, make_production_mesh,
                                     spawn)
from repro_torch.models import lm
from repro_torch.models.params import init_tree

ROOT = pathlib.Path(__file__).resolve().parents[1]
SERVE_RTOL = 5e-2          # chip_smoke.py's serve bar
TIMEOUT_S = 180.0

#: the reference side of the comparison: compile_zoo_hlo's two smoke
#: cells under a recording context, with what the test compares
REF_SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json
import repro.configs as rconfigs
from repro.analysis import interpose
from repro.analysis.hlo import (collective_bytes, collective_sites,
                                parse_instructions, program_costs,
                                _shape_bytes)
from repro.core import api

get = rconfigs.get_config
rconfigs.get_config = lambda a: dataclasses.replace(get(a),
                                                    scan_layers=False)
out = {}
for kind in ("prefill", "decode"):
    rec = []
    with api.tuned(record=rec):
        hlo, _ = interpose.compile_zoo_hlo("llama3.2-3b", kind=kind,
                                           mesh_shape=(2, 4))
    params = [i for i in parse_instructions(hlo) if i.op == "parameter"
              and i.computation.endswith("_spmd")]
    out[kind] = {
        "records": sorted([r.cell.op, r.cell.p, r.cell.nbytes, r.cell.dtype]
                          for r in rec),
        "args": [[_shape_bytes(i.type_str), i.type_str.split("{")[0],
                  "caches[" in i.line, "sharding={replicated}" in i.line]
                 for i in params],
        "coll": collective_bytes(hlo),
        "sites": [[s.base_op, s.operand_bytes, s.group_size, s.dtype]
                  for s in collective_sites(hlo)],
        "dot_flops": program_costs(hlo)["dot_flops"],
    }
print(json.dumps(out))
"""


@pytest.fixture
def fake_world():
    def make(n: int):
        init_fake_world(n)
    try:
        yield make
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def _root(node):
    """The placeholder a node derives from through its first arguments
    (None for a value the program made)."""
    while isinstance(node, torch.fx.Node) and node.op != "placeholder":
        node = node.args[0] if node.args else None
    return node if isinstance(node, torch.fx.Node) else None


def _multiset(rows):
    out = {}
    for r in rows:
        out[tuple(r)] = out.get(tuple(r), 0) + 1
    return out


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_smoke_cell_matches_the_reference(fake_world, reference, kind):
    fake_world(8)
    ref = reference[kind]
    gm, info = tinterpose.compile_zoo_graph("llama3.2-3b", kind=kind,
                                            mesh_shape=(2, 4))
    # 1. the dispatch records
    got = sorted([r.cell.op, r.cell.p, r.cell.nbytes, r.cell.dtype]
                 for r in info["records"])
    assert got == ref["records"]

    # 2. per-device argument bytes, two named differences
    pc = tgraph.program_costs(gm)
    cfg = get_config("llama3.2-3b").smoke()
    n_attn = sum(1 for k in cfg.pattern() if k.startswith("attn"))
    scalars = [a for a in ref["args"] if a[1] == "s32[]"]
    caches = [a for a in ref["args"] if a[2]]
    if kind == "decode":
        # each attention cache's "len" leaf, and the position t
        assert len(scalars) == n_attn + 1
        assert all(not a[3] for a in caches if a[1] != "s32[]")
        assert sum(a[0] for a in ref["args"]) - 4 * len(scalars) == \
            pc["argument_bytes"]
    else:
        assert scalars == []
        # never read by the reference's prefill: replicated, the global
        # batch (d = 2 times the port's local shards)
        assert caches and all(a[3] for a in caches)
        port_caches = info["arg_bytes"][2]
        assert sum(a[0] for a in caches) == 2 * port_caches
        assert sum(a[0] for a in ref["args"]) - port_caches == \
            pc["argument_bytes"]
    assert sum(info["arg_bytes"]) == pc["argument_bytes"]

    # 3. collective bytes by class, two named XLA passes
    sites = tgraph.collective_sites(gm)
    assert {s.dtype for s in sites} == {"bfloat16"}
    assert {r[3] for r in ref["records"]} == {"bfloat16"}
    # float normalization: every reference collective runs in float32
    assert {s[3] for s in ref["sites"]} == {"float32"}
    halved = _multiset([s[0], s[1] // 2, s[2]] for s in ref["sites"])
    mine = _multiset([s.base_op, s.operand_bytes, s.group_size]
                     for s in sites)
    # CSE: the tied table's two gathers (of one parameter, each through a
    # transposed copy) are one in XLA
    by_root = {}
    for s in sites:
        if s.base_op == "all-gather":
            by_root.setdefault(_root(s.inputs[0]), []).append(s)
    twice = [v for k, v in by_root.items() if k is not None and len(v) > 1]
    assert len(twice) == 1 and len(twice[0]) == 2
    table = twice[0]
    assert [(s.operand_bytes, s.group_size) for s in table] == \
        [(table[0].operand_bytes, table[0].group_size)] * 2
    dup = (table[0].base_op, table[0].operand_bytes, table[0].group_size)
    mine[dup] -= 1
    assert mine == halved
    cb = tgraph.collective_bytes(gm)
    for klass, v in ref["coll"].items():
        if klass == "total_bytes":
            continue
        extra = table[0].operand_bytes if klass == "all-gather" else 0
        assert cb[klass]["bytes"] == v["bytes"] // 2 + extra
        assert cb[klass]["count"] == v["count"] + (klass == "all-gather")

    # 4. dot flops
    if kind == "decode":
        assert pc["dot_flops"] == ref["dot_flops"]
    else:
        b_loc, s, v_loc = 8 // 2, 32, cfg.vocab_padded // 4
        head_rest = 2 * b_loc * (s - 1) * cfg.d_model * v_loc
        assert pc["dot_flops"] == ref["dot_flops"] - head_rest
        assert abs(pc["dot_flops"] + head_rest - ref["dot_flops"]) <= \
            0.01 * ref["dot_flops"]


CELLS = [("llama3.2-3b", "prefill_32k", False),
         ("llama3.2-3b", "decode_32k", False),
         ("llama3.2-3b", "prefill_32k", True),
         ("llama3.2-3b", "decode_32k", True),
         ("gemma3-1b", "long_500k", False)]


@pytest.mark.parametrize("arch,shape,multi_pod", CELLS)
def test_production_mesh_cells_are_ok(fake_world, arch, shape, multi_pod):
    fake_world(512 if multi_pod else 256)
    res = dryrun.run_cell(arch, shape, multi_pod=multi_pod, smoke=True)
    assert res["status"] == "ok", res
    assert res["unmapped"] == [] and res["sites"] > 0
    assert res["devices"] == (512 if multi_pod else 256)
    assert res["pgmpi_footer"].startswith("#@pgmpi alg ")
    assert "modeled_collective_latency_us" not in res
    assert res["memory"]["argument_bytes"] > 0
    assert set(res["roofline"]) >= {"t_compute", "t_memory",
                                    "t_collective", "bottleneck"}
    json.dumps(res)


def test_production_train_cell_and_topo(fake_world, tmp_path):
    from repro_torch.core.costmodel import Topo
    topo = Topo("fitted", alpha=2e-6, link_bw=1e11, gamma=1e-12,
                quant_bw=1e12)
    path = tmp_path / "topo.json"
    path.write_text(json.dumps(dataclasses.asdict(topo)))
    fake_world(256)
    res = dryrun.run_cell("llama3.2-3b", "train_4k", multi_pod=False,
                          smoke=True, n_micro=1,
                          topo=dryrun.load_topo(path))
    assert res["status"] == "ok" and res["unmapped"] == []
    lat = res["modeled_collective_latency_us"]
    assert lat["selected"] == lat["default"] > 0
    assert res["collectives"]["reduce-scatter"]["count"] > 0
    skip = dryrun.run_cell("llama3.2-3b", "long_500k", multi_pod=False,
                           smoke=True)
    assert skip["status"] == "skip" and "500k" in skip["reason"]


def test_fake_world_and_production_mesh_refusals(fake_world):
    with pytest.raises(RuntimeError, match="fake world of 256"):
        make_production_mesh()
    fake_world(8)
    with pytest.raises(RuntimeError, match="already exists"):
        init_fake_world(8)
    with pytest.raises(RuntimeError, match="fake world of 512"):
        make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="data_ptr"):
        dryrun.trace_cell(
            dataclasses.replace(get_config("llama3.2-3b").smoke(),
                                attn_impl="flash"),
            tshapes.SHAPES["decode_32k"], None)


def test_local_args_cut_every_leaf(fake_world):
    fake_world(8)
    from repro_torch.launch.mesh import make_group_mesh
    cfg = get_config("llama3.2-3b").smoke()
    mesh = make_group_mesh((2, 4), ("data", "model"), "cpu")
    cell = tshapes.SHAPES["train_4k"]
    specs = tshapes.input_specs(cfg, cell, mesh)
    args = tshapes.local_args(cfg, cell, mesh)
    sizes = {"data": 2, "model": 4}
    flat_s, flat_a = [], []
    tshapes.map_args(flat_s.append, specs)

    def leaves(t):
        if isinstance(t, dict):
            for v in t.values():
                leaves(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                leaves(v)
        else:
            flat_a.append(t)
    leaves(args)
    assert len(flat_s) == len(flat_a)
    for s, a in zip(flat_s, flat_a):
        want = () if not s.shape else (1,) + s.local_shape(sizes)
        assert tuple(a.shape) == want and str(a.dtype) == f"torch.{s.dtype}"
    # the optimizer's moments are cut as their parameters
    assert tuple(args[1]["m"]["embed"]["table"].shape) == \
        tuple(args[0]["embed"]["table"].shape)


def test_cli_exits_nonzero_on_an_error_cell(capsys):
    rc = dryrun.main(["--arch", "llama3.2-3b", "--shape", "decode_32k",
                      "--smoke", "--attn-impl", "flash"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and line["status"] == "error"
    assert "data_ptr" in line["error"]
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# the sequence-sharded decode across processes
# ---------------------------------------------------------------------------


def test_seq_sharded_decode_on_a_gloo_mesh_matches_the_stacked_one():
    cfg = get_config("gemma3-1b").smoke()
    mesh_shape, s_max, n_tokens, seed = (2, 2), 48, 6, 3
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, 20))
    got = spawn(ranks.seq_decode_rank, 4, backend="gloo",
                args=(cfg, mesh_shape, prompts, s_max, n_tokens, seed),
                timeout_s=TIMEOUT_S)
    # the same decode with the four ranks stacked on one device
    d, t = mesh_shape
    mesh = StackedMesh(mesh_shape, ("data", "model"), "cpu")
    maxis = StackedAxis(t, "cpu")
    specs = lm.model_specs(cfg, t)
    params = init_tree(specs, torch.Generator().manual_seed(seed), mesh)
    mparams = init_tree(specs, torch.Generator().manual_seed(seed), maxis)
    tokens = torch.as_tensor(prompts)
    with bind(model=maxis):
        caches = lm.init_caches(cfg, 1, s_max)
    logits, caches = serve.build_prefill(cfg, maxis)(
        mparams, {"tokens": tokens}, caches)
    lg0 = serve.full_vocab(logits)
    want = serve.decode_from(cfg, mesh, params, serve.seq_shards(caches, d),
                             lg0, tokens.shape[1], n_tokens,
                             cell=tshapes.SHAPES["long_500k"])
    for g in got:
        assert g["spread"] == [0.0] * (n_tokens - 1)
        np.testing.assert_array_equal(g["tokens"], want.tokens.numpy())
        res = serve.ServeResult(torch.as_tensor(g["tokens"]),
                                [torch.as_tensor(x) for x in g["logits"]],
                                0.0, 0.0, None)
        rep = serve.check_serves(want, res, SERVE_RTOL)
        assert rep["steps"] == n_tokens and rep["diverged_at"] is None
