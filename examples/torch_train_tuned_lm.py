"""End-to-end training example on the PyTorch port, the counterpart of
``examples/train_tuned_lm.py``: synthetic data -> tuned collectives ->
fault-tolerant loop (watchdog + async checkpoints + restart).

The default runs a small llama-family model for a few hundred steps;
``--full-size`` selects the real config.  All collectives go through the
tuned dispatcher; ``--force`` overrides per-op algorithms using the
paper's ``--module`` syntax.

The JAX example trains on one device (``mesh=None``), where the
collectives degrade to the identity.  Here ``--mesh dxt`` (default
``2x2``: FSDP over 2 data ranks and TP over 2 model ranks, stacked on one
device) makes every collective real, and the profiles are tuned at that
axis size; the run ends with the Listing-2 footer of its dispatches.
The device is the CUDA card unless ``--device cpu`` is given.

  PYTHONPATH=src python examples/torch_train_tuned_lm.py --steps 60
  PYTHONPATH=src python examples/torch_train_tuned_lm.py \\
      --force "allreduce:alg=allreduce_as_rsb_allgather" --steps 20
"""
import argparse
import dataclasses
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.ckpt import AsyncCheckpointer, checkpoint as ck  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import api, costmodel, tuner  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.ft import StepWatchdog  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--n-micro", type=int, default=2)
    ap.add_argument("--full-size", action="store_true",
                    help="use the full arch config")
    ap.add_argument("--force", default="", help="op:alg=name;... override")
    ap.add_argument("--ckpt-dir", default="results/ckpt_example_torch")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="2x2",
                    help="'dxt' data x model ranks stacked on the device")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full_size:
        cfg = cfg.smoke()
        # widen slightly so the run is a real (if small) model
        cfg = dataclasses.replace(cfg, d_model=128, n_layers=4, d_ff=512)
    mesh = tuple(int(n) for n in args.mesh.split("x"))

    profiles = tuner.tune(
        axis_size=max(mesh),
        backend=tuner.CostModelBackend(costmodel.V5E_ICI)).profiles
    force = api.parse_module_spec(args.force) if args.force else None

    with api.tuned(profiles=profiles, force=force) as ctx:
        tr = Trainer(cfg, mesh=mesh, device=args.device,
                     n_micro=args.n_micro, profiles=profiles, force=force,
                     base_lr=1e-3, warmup=10, record=ctx.record)
    params, opt = tr.init(0)
    start = 0
    last = ck.latest_step(args.ckpt_dir)
    if last is not None:
        params, opt = tr.from_global(
            ck.restore(args.ckpt_dir, last, tr.global_specs()))
        start = last
        print(f"resumed from step {last}")

    acp = AsyncCheckpointer(args.ckpt_dir)
    wd = StepWatchdog(ratio=4.0)
    t0 = time.time()
    for i in range(start, args.steps):
        wd.start_step()
        batch = tr.put_batch(make_batch(cfg, args.batch, args.seq, i))
        params, opt, m = tr.step(params, opt, batch, i)
        loss = float(m["loss"])           # waits for the step
        if wd.end_step():
            print(f"step {i}: straggler (median {wd.median*1e3:.1f}ms)")
        if i % 10 == 0:
            print(f"step {i:4d} loss {loss:.4f} "
                  f"gnorm {float(m['grad_norm']):.2f} "
                  f"({wd.median*1e3:.0f} ms/step)")
        if (i + 1) % args.ckpt_every == 0:
            acp.save(i + 1, tr.to_global(params, opt))
    acp.wait()
    print(f"done: {args.steps - start} steps in {time.time()-t0:.1f}s, "
          f"stragglers={len(wd.straggler_steps)}")
    print(api.format_footer(ctx) or "#(no dispatch recorded)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
