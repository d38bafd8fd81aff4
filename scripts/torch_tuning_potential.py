"""Report-only graph-layer interposition over the port's ``configs/`` zoo.

The port's counterpart of ``scripts/tuning_potential.py``: captures each
requested zoo model (``repro_torch``) as one rank of a fake (data, model)
world on fake tensors, finds EVERY collective of the captured graph
(in-place and functional c10d ops, send/recv batches), maps each site to
a tuning cell, and prices default vs. best mock-up on the given fabric,
the paper's "tuning potential" table on captured programs.  ``--topo``
is required (a JSON ``costmodel.Topo``, such as ``chip_smoke.py`` phase
5 fits): no fabric is assumed.  Exits nonzero on a graph parse error or
any collective that maps to no cell.

  python scripts/torch_tuning_potential.py --arch gemma3-1b \
      --arch llama3.2-3b --kind decode --mesh 2x4 --topo topo.json \
      --out results/graph_potential
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", action="append", default=[],
                    help="zoo config name (repeatable; default: "
                         "gemma3-1b + llama3.2-3b)")
    ap.add_argument("--kind", default="train",
                    choices=("train", "prefill", "decode"))
    ap.add_argument("--mesh", default="2x4",
                    help="fake process mesh DATAxMODEL, e.g. 2x4")
    ap.add_argument("--out", default=str(ROOT / "results" /
                                         "graph_potential"))
    ap.add_argument("--profile-dir", default=None,
                    help="ProfileStore directory: adds a profile-tuned "
                         "column to the report")
    ap.add_argument("--dump-graph", "--dump-hlo", dest="dump_graph",
                    action="store_true",
                    help="also write the captured graph per model")
    ap.add_argument("--topo", required=True,
                    help="a JSON costmodel.Topo to price on")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    archs = args.arch or ["gemma3-1b", "llama3.2-3b"]
    mesh_shape = tuple(int(x) for x in args.mesh.split("x"))
    n_dev = 1
    for x in mesh_shape:
        n_dev *= x

    import torch.distributed as dist

    from repro_torch.analysis.graph import GraphParseError
    from repro_torch.analysis.interpose import (compile_zoo_graph,
                                                scan_potential)
    from repro_torch.core.profiles import resolve_stores
    from repro_torch.launch.dryrun import load_topo
    from repro_torch.launch.mesh import init_fake_world

    topo = load_topo(args.topo)
    profiles, _phases = resolve_stores(args.profile_dir)
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    failed = False
    init_fake_world(n_dev)
    try:
        for arch in archs:
            label = f"{arch}/{args.kind}@{args.mesh}"
            try:
                gm, _info = compile_zoo_graph(arch, kind=args.kind,
                                              mesh_shape=mesh_shape)
                rep = scan_potential(gm, topo=topo, profiles=profiles,
                                     label=label)
            except GraphParseError as e:
                print(f"PARSE ERROR [{label}]: {e}", file=sys.stderr)
                failed = True
                continue
            print(rep.table())
            print()
            stem = f"{arch.replace('.', '_')}_{args.kind}"
            (out_dir / f"{stem}.json").write_text(
                json.dumps(rep.to_json(), indent=1) + "\n")
            (out_dir / f"{stem}.txt").write_text(rep.table() + "\n")
            if args.dump_graph:
                (out_dir / f"{stem}.graph.txt").write_text(
                    gm.print_readable(print_output=False))
            if not rep.ok:
                print(f"UNMAPPED COLLECTIVES [{label}]: "
                      f"{[s.graph_op for s in rep.unmapped]}",
                      file=sys.stderr)
                failed = True
    finally:
        dist.destroy_process_group()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
