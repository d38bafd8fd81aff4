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
a link.  With ``--world N`` it measures across N processes instead, one
rank each (a ``GroupAxis``), at the group's world, as the JAX example
measures at the host's device count; every rank holds the slowest rank's
samples and picks the same impls, and rank 0 writes the profiles:

  PYTHONPATH=src python examples/torch_tune_collectives.py \
      --backend measured --world 4 --dist-backend gloo --device cpu

NCCL runs one rank per GPU; gloo runs on the CPU.  The cost model needs
no device.
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import costmodel, profiles, tuner  # noqa: E402
from repro_torch.core._axis import GroupAxis  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402

#: a --world run that has not finished by then has hung
WORLD_TIMEOUT_S = 1800.0


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
    ap.add_argument("--world", type=int, default=None,
                    help="measure across N processes, one rank each, at "
                         "axis size N (--backend measured)")
    ap.add_argument("--dist-backend", default="nccl",
                    choices=("nccl", "gloo"),
                    help="the process group's backend with --world")
    args = ap.parse_args(argv)
    if args.world:
        if args.backend != "measured":
            raise SystemExit("--world measures: pass --backend measured")
        return mesh.spawn(_tune, args.world, backend=args.dist_backend,
                          args=(args,), timeout_s=WORLD_TIMEOUT_S)[0]
    return _tune(args)


def _tune(args) -> int:
    """Tune and write the profiles; with ``--world``, on this rank of the
    world (rank 0 prints and writes what every rank picked)."""
    axis = GroupAxis(args.device) if args.world else None
    say = print if axis is None or axis.rank == 0 else (lambda *a: None)
    if args.backend == "costmodel":
        backend = tuner.CostModelBackend(costmodel.PRESETS[args.topo])
    elif axis is not None:
        backend = tuner.MeasuredBackend(axis=axis)
        args.axis_size = axis.size
    else:
        backend = tuner.MeasuredBackend(args.axis_size, args.device)

    rep = tuner.tune(axis_size=args.axis_size, backend=backend,
                     min_win=args.min_win,
                     scratch_budget_bytes=args.scratch_budget)
    if axis is not None:
        base, _ = profiles.publish(rep.profiles, args.out, axis)
        say(f"{axis.size} ranks ({args.dist_backend}) picked the same "
            f"impls: digest {profiles.stores_digest(base, {})[:16]}")
    say(rep.summary())
    say("\nviolations:")
    for v in rep.violations:
        say(f"  {v.gl_kind:16s} {v.op:14s} p={v.axis_size} "
            f"{v.nbytes:>9d}B x{v.speedup:5.2f} {v.best_impl or ''}")
    if axis is None:
        rep.profiles.save(args.out, fmt="text")
    say(f"\nwrote {len(rep.profiles)} profiles to {args.out}/")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
