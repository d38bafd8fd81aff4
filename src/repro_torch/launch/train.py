"""Distributed training CLI.

Composes the pieces: the stacked axis binding, tuned-profile loading
(PGMPITuneD), the Trainer, deterministic data, async checkpointing, the
straggler watchdog and crash-resume, with the JAX package's flags
(``repro/launch/train.py``)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --smoke --mesh 1x4 --steps 50 --profile-dir results/profiles

``--mesh dxt`` stacks d data ranks (FSDP) and t model ranks (TP) on the
device: one of them above 1 binds that axis alone, both above 1 the two
axes of one stacked mesh (``--mesh 2x2`` on the CPU, ``--mesh 2x4`` on
the card); a three-axis mesh (the JAX package's ``2x16x16`` with a pod
axis) raises.  The device is the card unless ``--device cpu`` is
given.
"""
from __future__ import annotations

import argparse
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--mesh", default="",
                    help="'dxt': d data ranks and t model ranks stacked "
                         "on the device; empty = a single rank")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--compress", choices=("none", "bf16"), default="none")
    ap.add_argument("--profile-dir", default="",
                    help="tuned-profile directory (flat files = base store,"
                         " per-phase subdirs from tuner.tune_trace);"
                         " default: $PGTUNE_PROFILE_DIR")
    ap.add_argument("--force", default="", help="op:alg=...;... override")
    ap.add_argument("--ckpt-dir", default="results/train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    from repro_torch.ckpt import AsyncCheckpointer, checkpoint as ck
    from repro_torch.configs import get_config
    from repro_torch.core.api import parse_module_spec
    from repro_torch.core.profiles import resolve_stores
    from repro_torch.data import make_batch
    from repro_torch.ft import StepWatchdog
    from repro_torch.train import Trainer

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()

    mesh = (1, 1)
    if args.mesh:
        dims = args.mesh.split("x")
        if len(dims) != 2:
            raise NotImplementedError(
                f"--mesh {args.mesh}: only 'dxt' (data x model) is ported; "
                "the pod axis is not")
        mesh = (int(dims[0]), int(dims[1]))

    # precedence: --profile-dir > $PGTUNE_PROFILE_DIR > none
    profiles, phase_stores = resolve_stores(args.profile_dir or None)
    if profiles is not None or phase_stores:
        print(f"profiles: base={len(profiles) if profiles else 0} "
              f"phases={sorted(phase_stores)}")
    force = parse_module_spec(args.force) if args.force else None

    tr = Trainer(cfg, mesh=mesh, device=args.device, n_micro=args.n_micro,
                 compress=args.compress, profiles=profiles,
                 phase_profiles=phase_stores or None, force=force,
                 base_lr=args.lr, warmup=args.warmup)
    params, opt = tr.init(0)
    start = ck.latest_step(args.ckpt_dir) or 0
    if start:
        params, opt = tr.from_global(
            ck.restore(args.ckpt_dir, start, tr.global_specs()))
        print(f"resumed from step {start}")

    acp = AsyncCheckpointer(args.ckpt_dir)
    wd = StepWatchdog(ratio=4.0)
    t0 = time.time()
    for i in range(start, args.steps):
        wd.start_step()
        batch = tr.put_batch(make_batch(cfg, args.global_batch, args.seq, i))
        params, opt, m = tr.step(params, opt, batch, i)
        loss = float(m["loss"])           # waits for the step
        straggler = wd.end_step()
        if i % args.log_every == 0 or straggler:
            note = "  [STRAGGLER]" if straggler else ""
            print(f"step {i:5d}  loss {loss:.4f}  "
                  f"gnorm {float(m['grad_norm']):.2f}  "
                  f"lr {float(m['lr']):.2e}  "
                  f"{wd.median*1e3:.0f} ms/step{note}", flush=True)
        if (i + 1) % args.ckpt_every == 0:
            acp.save(i + 1, tr.to_global(params, opt))
    acp.wait()
    ck.save(args.ckpt_dir, args.steps, tr.to_global(params, opt))
    dt = time.time() - t0
    tok = (args.steps - start) * args.global_batch * args.seq
    print(f"done: {args.steps - start} steps, {tok/dt:.0f} tok/s, "
          f"stragglers={len(wd.straggler_steps)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
