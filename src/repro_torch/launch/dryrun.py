"""Production-mesh dry run: capture every (arch x shape x mesh) cell on a
fake world.

The JAX package's ``launch/dryrun.py`` lowers and compiles each cell on
512 forced host devices.  The port captures each cell's program
(``analysis.graph.capture``) as one rank of a fake world of 256 or 512
ranks (``launch.mesh.init_fake_world``; torch's ``"fake"`` process-group
backend moves no data), on the production ``GroupMesh``
(``make_production_mesh``) and the fake local arguments of
``launch.shapes.local_args``.  A cell reports the graph's memory
(argument, output and peak-live bytes), its ``program_costs``, its
collective bytes by class, its collective sites (every one must map to a
tuning cell), the roofline on the H100's data-sheet rates, the dispatch
footer and the capture's seconds, as one JSON line::

    python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape all \\
        --multi-pod both
    python -m repro_torch.launch.dryrun --arch gemma3-1b --smoke \\
        --shape decode_32k --force "allgather:alg=allgather_as_ring" \\
        --topo build/chip_smoke/topo.json

It checks shapes, sites and bytes only: nothing runs, and the values of
training over a ``GroupMesh`` are not checked here.  The fake tensors are
CPU tensors, so a scan takes its plain version: the
hand-written kernels are ctypes calls on ``data_ptr``, which a fake
tensor does not have, so ``--attn-impl flash`` is refused (the config's
default, ``ref``, is traced, as the JAX package's dry run traces its
plain attention).  ``modeled_collective_latency_us`` (the dispatched
schedule against the all-default one) and ``tuning_potential`` (every
site priced against its best mock-up, ``interpose.scan_potential``) are
given only with ``--topo``, a JSON ``costmodel.Topo`` such as
``chip_smoke.py`` phase 5 fits: no fabric is assumed.  Python
loops unroll in the graph, so each cell has its own time limit
(``--cell-timeout``); a cell past it is reported as an error.  The run
exits nonzero on any cell with ``status: error``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import signal
import sys
import threading
import time
import traceback

import torch

MESH_NAMES = {False: "16x16", True: "2x16x16"}
WORLDS = {False: 256, True: 512}

#: the dry run's default limit on one cell's capture, in seconds
CELL_TIMEOUT_S = 300.0

_NO_KERNELS = ("the hand-written kernels are ctypes calls on data_ptr "
               "(kernels/_build.py), which fake tensors do not have: the "
               "dry run traces attn_impl='ref'")


def with_len(caches, t: int):
    """The cache tree with each attention cache's filled length ``"len"``
    (a host int in the port, not an argument leaf) set to ``t``."""
    if isinstance(caches, list):
        return [with_len(c, t) for c in caches]
    if isinstance(caches, dict):
        out = {k: with_len(v, t) for k, v in caches.items()}
        if "k" in caches or "c_kv" in caches:
            out["len"] = t
        return out
    return caches


def _program(cfg, cell, mesh):
    """``(fn, args)`` of the cell on ``mesh``, the arguments fake."""
    from repro_torch.dist.axes import bind
    from repro_torch.launch import serve
    from repro_torch.launch.shapes import local_args

    args = local_args(cfg, cell, mesh)
    if cell.kind == "prefill":
        return serve.build_prefill(cfg, mesh), args
    if cell.kind == "decode":
        params, tok, caches, _t = args
        t = cell.seq_len - 1
        return serve.build_decode(cfg, mesh, cell), (
            params, tok, with_len(caches, t), t)
    if cell.kind != "train":
        raise ValueError(f"unknown kind {cell.kind!r}")
    from repro_torch.train.trainer import make_step_fns
    _, _, train_fn = make_step_fns(cfg, mesh, None, n_micro=cell.n_micro)

    def train(params, opt, batch, step: int):
        with bind(**{n: mesh[n] for n in mesh.names}):
            return train_fn(params, opt, batch, step)
    params, opt, batch, _step = args
    return train, (params, opt, batch, 0)


def trace_cell(cfg, cell, mesh, *, profiles=None, force=None):
    """Capture one cell's program on ``mesh`` under ``api.tuned(profiles=,
    force=)``: ``(graph, dispatch records, the fake arguments)``.
    Refuses the flash path (the kernels cannot be traced)."""
    from repro_torch.analysis.graph import capture
    from repro_torch.core import api

    if cfg.attn_impl == "flash":
        raise ValueError(f"attn_impl='flash': {_NO_KERNELS}")
    fn, args = _program(cfg, cell, mesh)
    rec: list = []
    with api.tuned(profiles=profiles, force=force, record=rec):
        gm = capture(fn, *args)
    return gm, rec, args


def load_topo(path):
    """A ``costmodel.Topo`` from a JSON object of its fields (what
    ``dataclasses.asdict`` of a fitted one gives; ``chip_smoke.py``
    writes phase 5's fit so)."""
    from repro_torch.core.costmodel import Topo
    data = json.loads(pathlib.Path(path).read_text())
    return Topo(**data)


def _modeled_latency(records, topo) -> dict:
    """Cost-model latency of the dispatched collective schedule vs the
    all-default one on ``topo`` (the paper's tuned-vs-default panel)."""
    from repro_torch.core import costmodel as cm
    t_sel = t_def = 0.0
    for rec in records:
        try:
            t_sel += cm.latency_cell(rec.cell, rec.impl, topo)
            t_def += cm.latency_cell(rec.cell, "default", topo)
        except KeyError:
            pass
    return {"selected": round(t_sel * 1e6, 2),
            "default": round(t_def * 1e6, 2)}


@contextlib.contextmanager
def _time_limit(seconds: float | None, what: str):
    """Raise ``TimeoutError`` in this (main) thread after ``seconds``."""
    if not seconds or threading.current_thread() is not \
            threading.main_thread():
        yield
        return

    def fire(signum, frame):
        raise TimeoutError(f"{what} ran past its limit of {seconds:.0f} s "
                           "(--cell-timeout)")
    old = signal.signal(signal.SIGALRM, fire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def run_cell(arch: str, shape: str, *, multi_pod: bool,
             force: dict | None = None, profiles=None,
             graph_dir: str | None = None, attn_impl: str | None = None,
             n_micro: int | None = None,
             capacity_factor: float | None = None, unroll: bool = False,
             tag: str = "", topo=None, smoke: bool = False,
             cell_timeout: float | None = CELL_TIMEOUT_S) -> dict:
    """One cell on the production mesh of the fake world this process is
    a rank of (``init_fake_world(256)``, or ``512`` with ``multi_pod``)."""
    from repro_torch.analysis.graph import (collective_bytes,
                                            program_costs)
    from repro_torch.analysis.interpose import map_sites, scan_potential
    from repro_torch.analysis.roofline import H100_SXM, roofline_terms
    from repro_torch.configs import get_config
    from repro_torch.core import api
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.shapes import SHAPES, applicable

    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    if attn_impl:
        cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    if unroll:
        cfg = dataclasses.replace(cfg, scan_layers=False)
    if capacity_factor and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    cell = SHAPES[shape]
    if n_micro:
        cell = dataclasses.replace(cell, n_micro=n_micro)
    mesh_name = MESH_NAMES[bool(multi_pod)]
    ok, why = applicable(cfg, cell)
    if not ok:
        return {"arch": arch, "shape": shape, "mesh": mesh_name,
                "status": "skip", "reason": why}

    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    n_dev = WORLDS[bool(multi_pod)]
    with _time_limit(cell_timeout, f"{arch} {shape} {mesh_name}"):
        gm, records, _ = trace_cell(cfg, cell, mesh, profiles=profiles,
                                    force=force)
        trace_s = time.time() - t0
        coll = collective_bytes(gm)
        pc = program_costs(gm)
        mapped, unmapped = map_sites(gm)
    if graph_dir:
        d = pathlib.Path(graph_dir)
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{arch}_{shape}_{mesh_name}.graph.txt").write_text(
            gm.print_readable(print_output=False))
    rl = roofline_terms(arch, shape, mesh_name, cost={}, coll=coll,
                        cfg=cfg, cell=cell, n_devices=n_dev, chip=H100_SXM,
                        flops_override=pc["dot_flops"],
                        bytes_override=pc["bytes"], dtype=cfg.dtype)
    ctx = api.TuneContext(record=records)
    res = {
        "arch": arch, "shape": shape, "mesh": mesh_name,
        "status": "ok" if not unmapped else "error",
        "variant": tag or "baseline",
        "smoke": bool(smoke),
        "pgmpi_footer": api.format_footer(ctx),
        "devices": int(n_dev),
        "trace_s": round(trace_s, 1),
        "memory": {"argument_bytes": pc["argument_bytes"],
                   "output_bytes": pc["output_bytes"],
                   "peak_live_bytes": pc["peak_live_bytes"]},
        "program_costs": pc,
        "collectives": coll,
        "sites": len(mapped) + len(unmapped),
        "unmapped": [f"{s.graph_op} {s.name}" for s in unmapped],
        "roofline": rl.row(),
    }
    if unmapped:
        res["error"] = f"{len(unmapped)} collective sites map to no cell"
    if topo is not None:
        res["modeled_collective_latency_us"] = _modeled_latency(records,
                                                                topo)
        rep = scan_potential(gm, topo=topo, profiles=profiles,
                             label=f"{arch}/{shape}@{mesh_name}")
        res["tuning_potential"] = {
            k: rep.to_json()[k] for k in ("topo", "potential",
                                          "total_default_s", "total_best_s",
                                          "n_sites", "n_unmapped")}
        res["tuning_potential"]["line"] = [
            ln for ln in rep.table().splitlines()
            if ln.startswith("collectives vs. best mock-ups:")][0]
    return res


def _cell_argv(mp: bool, arch: str, shape: str, args) -> list[str]:
    """The command line that captures one cell in a process of its own."""
    argv = [sys.executable, "-m", "repro_torch.launch.dryrun",
            "--arch", arch, "--shape", shape,
            "--multi-pod", "on" if mp else "off",
            "--cell-timeout", str(args.cell_timeout)]
    for flag, val in (("--force", args.force),
                      ("--profile-dir", args.profile_dir),
                      ("--out", args.out), ("--graph-dir", args.graph_dir),
                      ("--attn-impl", args.attn_impl),
                      ("--n-micro", args.n_micro), ("--cf", args.cf),
                      ("--tag", args.tag), ("--topo", args.topo)):
        if val:
            argv += [flag, str(val)]
    for flag, on in (("--unroll", args.unroll), ("--smoke", args.smoke)):
        if on:
            argv.append(flag)
    return argv


def _run_parallel(cells, args) -> list[dict]:
    """Capture ``cells`` (``(multi_pod, arch, shape)``) ``args.jobs`` at a
    time, each in a fresh process (its own fake world); a process that
    outlives its cell's limit (plus a minute to start) is killed and its
    cell reported as an error.  Results in the order of ``cells``."""
    import os
    import subprocess
    src = str(pathlib.Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    limit = args.cell_timeout + 60.0
    results: dict[int, dict] = {}
    running: dict[int, tuple] = {}
    todo = list(enumerate(cells))

    def error(cell, why):
        mp, arch, shape = cell
        return {"arch": arch, "shape": shape, "mesh": MESH_NAMES[mp],
                "status": "error", "error": why}
    try:
        while todo or running:
            while todo and len(running) < args.jobs:
                i, cell = todo.pop(0)
                proc = subprocess.Popen(
                    _cell_argv(*cell, args), env=env, text=True,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE)
                running[i] = (proc, cell, time.monotonic())
            time.sleep(0.2)
            for i, (proc, cell, t0) in list(running.items()):
                if proc.poll() is None:
                    if time.monotonic() - t0 > limit:
                        proc.kill()
                        proc.communicate()
                        results[i] = error(cell, f"TimeoutError: killed "
                                                 f"after {limit:.0f} s")
                        del running[i]
                    continue
                out, err = proc.communicate()
                del running[i]
                lines = [ln for ln in out.splitlines() if ln.startswith("{")]
                try:
                    results[i] = json.loads(lines[-1])
                except (IndexError, json.JSONDecodeError):
                    results[i] = error(cell, f"no result (exit "
                                             f"{proc.returncode}): "
                                             f"{err[-500:]}")
    finally:
        for proc, _, _ in running.values():
            proc.kill()
            proc.communicate()
    return [results[i] for i in range(len(cells))]


def main(argv=None) -> int:
    from repro_torch.configs import ARCHS
    from repro_torch.core.api import parse_module_spec
    from repro_torch.launch.mesh import init_fake_world
    from repro_torch.launch.shapes import SHAPES

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", choices=("on", "off", "both"),
                    default="off")
    ap.add_argument("--force", default="",
                    help="op:alg=...;op:alg=... (PGMPITuneCLI syntax)")
    ap.add_argument("--profile-dir", default="",
                    help="load tuned profiles (PGMPITuneD mode)")
    ap.add_argument("--out", default="", help="write one JSON per cell here")
    ap.add_argument("--graph-dir", default="",
                    help="write each cell's captured graph "
                         "(print_readable) here")
    ap.add_argument("--attn-impl", default="", choices=("", "ref", "flash"))
    ap.add_argument("--n-micro", type=int, default=0)
    ap.add_argument("--cf", type=float, default=0.0,
                    help="MoE capacity factor override")
    ap.add_argument("--unroll", action="store_true",
                    help="scan_layers=False (the port's layer groups are "
                         "Python lists, unrolled either way)")
    ap.add_argument("--tag", default="", help="variant tag for the JSON")
    ap.add_argument("--topo", default="",
                    help="a JSON costmodel.Topo: adds the modeled "
                         "collective latency")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke-size configs")
    ap.add_argument("--cell-timeout", type=float, default=CELL_TIMEOUT_S,
                    help="seconds one cell's capture may take")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells captured at once, each in a process of "
                         "its own (1: one after another in this one)")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    pods = {"on": [True], "off": [False], "both": [False, True]}[
        args.multi_pod]
    force = parse_module_spec(args.force) if args.force else None
    profiles = None
    if args.profile_dir:
        from repro_torch.core.profiles import ProfileStore
        profiles = ProfileStore.load(args.profile_dir)
    topo = load_topo(args.topo) if args.topo else None

    failures = 0
    if args.jobs > 1:
        cells = [(mp, arch, shape) for mp in pods for arch in archs
                 for shape in shapes]
        for res in _run_parallel(cells, args):
            failures += res["status"] == "error"
            print(json.dumps(res), flush=True)
        return 1 if failures else 0
    for mp in pods:
        init_fake_world(WORLDS[mp])
        try:
            for arch in archs:
                for shape in shapes:
                    try:
                        res = run_cell(
                            arch, shape, multi_pod=mp, force=force,
                            profiles=profiles,
                            graph_dir=args.graph_dir or None,
                            attn_impl=args.attn_impl or None,
                            n_micro=args.n_micro or None,
                            capacity_factor=args.cf or None,
                            unroll=args.unroll, tag=args.tag, topo=topo,
                            smoke=args.smoke,
                            cell_timeout=args.cell_timeout)
                    except Exception as e:
                        traceback.print_exc()
                        res = {"arch": arch, "shape": shape,
                               "mesh": MESH_NAMES[mp], "status": "error",
                               "error": f"{type(e).__name__}: "
                                        f"{str(e)[:500]}"}
                    failures += res["status"] == "error"
                    print(json.dumps(res), flush=True)
                    if args.out:
                        d = pathlib.Path(args.out)
                        d.mkdir(parents=True, exist_ok=True)
                        sfx = f"_{args.tag}" if args.tag else ""
                        (d / (f"{res['arch']}_{res['shape']}_"
                              f"{res['mesh']}{sfx}.json")
                         ).write_text(json.dumps(res, indent=1))
        finally:
            torch.distributed.destroy_process_group()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
