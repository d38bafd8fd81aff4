"""Fault-tolerance demo on the PyTorch port, the counterpart of
``examples/elastic_restart.py``: inject node failures mid-training; the
restart driver resumes from the newest checkpoint and converges to the
SAME final state as a failure-free run (deterministic, step-keyed data).

The model is llama3.2-3b's smoke config, trained on the CUDA card unless
``--device cpu`` is given; ``--mesh dxt`` stacks d data and t model ranks
on the device (default ``1x1``: no collective, as in the JAX example).
Exits 1 unless both injected failures were restarted from and the final
parameters and optimizer state are bit-identical to those of a run with
no failures.

  PYTHONPATH=src python examples/torch_elastic_restart.py --device cpu
"""
import argparse
import pathlib
import shutil
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.ft import run_with_restarts  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    ap.add_argument("--mesh", default="1x1",
                    help="'dxt' data x model ranks stacked on the device")
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--ckpt-every", type=int, default=6)
    ap.add_argument("--ckpt-dir", default="results/ckpt_elastic_torch")
    args = ap.parse_args(argv)

    cfg = get_config("llama3.2-3b").smoke()
    mesh = tuple(int(n) for n in args.mesh.split("x"))
    tr = Trainer(cfg, mesh=mesh, device=args.device, base_lr=1e-3,
                 warmup=5)
    ckdir = pathlib.Path(args.ckpt_dir)
    shutil.rmtree(ckdir, ignore_errors=True)

    def init_state():
        p, o = tr.init(0)
        return {"params": p, "opt": o}

    faults = {9: 1, 17: 1}   # two injected node failures

    def step_fn(state, i):
        if i in faults and faults.pop(i):
            raise RuntimeError(f"injected failure at step {i}")
        batch = tr.put_batch(make_batch(cfg, 4, 32, i))
        p, o, m = tr.step(state["params"], state["opt"], batch, i)
        print(f"  step {i:3d} loss {float(m['loss']):.4f}")
        return {"params": p, "opt": o}

    final, stats = run_with_restarts(init_state, step_fn,
                                     n_steps=args.steps, ckpt_dir=ckdir,
                                     ckpt_every=args.ckpt_every)
    print(f"\nrestarts: {stats['restarts']}, resumed from: "
          f"{stats['resumed_from']}")

    # failure-free reference (the faults were spent above)
    shutil.rmtree(ckdir, ignore_errors=True)
    ref, ref_stats = run_with_restarts(init_state, step_fn,
                                       n_steps=args.steps, ckpt_dir=ckdir,
                                       ckpt_every=args.ckpt_every)
    shutil.rmtree(ckdir, ignore_errors=True)
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(final),
                                                 tree_leaves(ref)))
    print("bit-identical to failure-free run:", same)
    ok = same and stats["restarts"] == 2 and ref_stats["restarts"] == 0
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
