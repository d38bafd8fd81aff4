"""Quickstart on the PyTorch port: the workflow of ``examples/quickstart.py``.

1. offline-tune the collective layer (cost model, v5e ICI, at the
   training mesh's axis size),
2. write/reload Listing-1 performance profiles,
3. train a tiny LM with the tuned dispatcher active,
4. print the paper's Listing-2 footer showing which mock-ups served which
   payload sizes.

The JAX example trains on one device (``mesh=None``), where every
collective degrades to the identity and the footer is empty.  Here the
ranks of a mesh are stacked on one device, so a real axis is cheap: the
model trains tensor-parallel over ``P = 4`` stacked ranks, the tuning
runs at that axis size, and the footer lists the dispatches of the
training steps (the tuned picks among them).

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
(the device is the CUDA card unless ``--device cpu`` is given).
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import api, costmodel, tuner  # noqa: E402
from repro_torch.core.profiles import ProfileStore  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402

P = 4                       # model ranks stacked on the device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    ap.add_argument("--out", default="results/profiles_quickstart")
    args = ap.parse_args(argv)

    # --- 1. offline tuning pass (PGMPITuneCLI) -----------------------------
    report = tuner.tune(axis_size=P,
                        backend=tuner.CostModelBackend(costmodel.V5E_ICI))
    print("== tuning report ==")
    print(report.summary())
    for v in report.violations[:5]:
        print(f"  {v.gl_kind:8s} {v.op:14s} {v.nbytes:>8d}B "
              f"x{v.speedup:.2f} -> {v.best_impl}")

    # --- 2. profiles to disk and back (PGMPITuneD) --------------------------
    pdir = pathlib.Path(args.out)
    report.profiles.save(pdir, fmt="text")
    profiles = ProfileStore.load(pdir)
    print(f"\nprofiles reloaded: {len(profiles)} "
          f"(e.g.)\n{next(iter(profiles)).to_text()}")

    # --- 3. train a tiny LM with tuned collectives --------------------------
    cfg = get_config("llama3.2-3b").smoke()
    with api.tuned(profiles=profiles) as ctx:
        tr = Trainer(cfg, mesh=(1, P), device=args.device,
                     profiles=profiles, base_lr=3e-3, warmup=5,
                     record=ctx.record)
        params, opt = tr.init(0)
        for i in range(20):
            batch = tr.put_batch(make_batch(cfg, 8, 32, i))
            params, opt, m = tr.step(params, opt, batch, i)
            if i % 5 == 0:
                print(f"step {i:3d} loss {float(m['loss']):.4f} "
                      f"lr {float(m['lr']):.1e}")

    # --- 4. the Listing-2 footer --------------------------------------------
    print("\n== pgmpi footer (which algorithm served each call) ==")
    print(api.format_footer(ctx) or "#(no dispatch recorded)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
