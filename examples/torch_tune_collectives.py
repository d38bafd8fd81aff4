"""Offline collective tuning CLI on the PyTorch port — the PGMPITuneCLI
workflow of ``examples/tune_collectives.py``, with its flags and output.

Benchmarks every mock-up against the default (the cost model at any
axis size, or device time measured on stacked ranks), detects guideline
violations, and writes Listing-1 performance profiles:

  PYTHONPATH=src python examples/torch_tune_collectives.py \\
      --backend costmodel --topo v5e-ici --axis-size 16 --out results/profiles
  PYTHONPATH=src python examples/torch_tune_collectives.py \\
      --backend measured --axis-size 8

``--backend measured`` runs ``tuner.MeasuredBackend`` on ``--axis-size``
ranks stacked as lanes of one device (``--device``, the CUDA card unless
``--device cpu`` is given): a ring hop there is a device-memory copy, not
a link.  The JAX example measures at the host's device count instead.
The cost model needs no device.
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import costmodel, tuner  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", choices=("costmodel", "measured"),
                    default="costmodel")
    ap.add_argument("--topo", default="v5e-ici",
                    choices=sorted(costmodel.PRESETS))
    ap.add_argument("--axis-size", type=int, default=16)
    ap.add_argument("--min-win", type=float, default=0.10,
                    help="paper's 10%% replacement threshold")
    ap.add_argument("--scratch-budget", type=int, default=None,
                    help="size_msg_buffer_bytes analogue")
    ap.add_argument("--out", default="results/profiles")
    ap.add_argument("--device", default=None,
                    help="torch device of the measured backend; default: "
                         "the CUDA card")
    args = ap.parse_args(argv)

    if args.backend == "costmodel":
        backend = tuner.CostModelBackend(costmodel.PRESETS[args.topo])
    else:
        backend = tuner.MeasuredBackend(args.axis_size, args.device)

    rep = tuner.tune(axis_size=args.axis_size, backend=backend,
                     min_win=args.min_win,
                     scratch_budget_bytes=args.scratch_budget)
    print(rep.summary())
    print("\nviolations:")
    for v in rep.violations:
        print(f"  {v.gl_kind:16s} {v.op:14s} p={v.axis_size} "
              f"{v.nbytes:>9d}B x{v.speedup:5.2f} {v.best_impl or ''}")
    rep.profiles.save(args.out, fmt="text")
    print(f"\nwrote {len(rep.profiles)} profiles to {args.out}/")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
