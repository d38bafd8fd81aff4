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
the card).  ``--mesh pxdxt`` adds the JAX package's pod axis (its
``2x16x16``): p pods of pure data parallelism, parameters replicated
over them and every gradient all-reduced across them (``--compress bf16``
sends that all-reduce in bf16); all three axes are bound, sizes of 1
included (``--mesh 2x1x2`` on the CPU).  The device is the card unless
``--device cpu`` is given.

``--world N`` trains across N local processes, one rank each, spawned
under a hard deadline (``CLI_TIMEOUT_S``; a world that has not finished
by then is killed and the run fails): the mesh is laid over the processes
(``--mesh dxt`` or ``pxdxt`` with a product of N; without ``--mesh``, N
data ranks), every rank trains its lane on rank 0's batch, rank 0 prints
and writes the checkpoints, and a resumed run restores on every rank.
``--dist-backend gloo`` runs on the CPU (``--device cpu``); NCCL, the
default, runs one rank a GPU::

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --world 4 \
        --mesh 2x2 --dist-backend gloo --device cpu --steps 3
"""
from __future__ import annotations

import argparse
import time

#: a ``--world`` run that has not finished by then has hung
CLI_TIMEOUT_S = 900.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--mesh", default="",
                    help="'dxt': d data ranks and t model ranks stacked "
                         "on the device, or 'pxdxt' with p pods; empty = "
                         "a single rank")
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
    ap.add_argument("--world", type=int, default=None,
                    help="train across N processes, one rank each: the "
                         "mesh's ranks (N data ranks without --mesh)")
    ap.add_argument("--dist-backend", default="nccl",
                    choices=("nccl", "gloo"),
                    help="the process group's backend with --world (NCCL: "
                         "one rank per GPU; gloo: pass --device cpu)")
    args = ap.parse_args(argv)
    if args.world:
        from repro_torch.launch.mesh import spawn
        return spawn(_cli, args.world, backend=args.dist_backend,
                     args=(args,), timeout_s=CLI_TIMEOUT_S)[0]
    return _cli(args)


def _cli(args) -> int:
    """The training loop, on stacked ranks or (with ``--world``) on this
    rank of the world; rank 0 prints and writes the checkpoints."""
    import torch.distributed as dist

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

    procs = bool(args.world)
    rank0 = not procs or dist.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    mesh = (args.world, 1) if procs else (1, 1)
    if args.mesh:
        mesh = tuple(int(n) for n in args.mesh.split("x"))
        if len(mesh) not in (2, 3):
            raise ValueError(f"--mesh {args.mesh}: 'dxt' or 'pxdxt'")

    # precedence: --profile-dir > $PGTUNE_PROFILE_DIR > none
    profiles, phase_stores = resolve_stores(args.profile_dir or None)
    if profiles is not None or phase_stores:
        say(f"profiles: base={len(profiles) if profiles else 0} "
              f"phases={sorted(phase_stores)}")
    force = parse_module_spec(args.force) if args.force else None

    tr = Trainer(cfg, mesh=mesh, device=args.device, n_micro=args.n_micro,
                 compress=args.compress, profiles=profiles,
                 phase_profiles=phase_stores or None, force=force,
                 base_lr=args.lr, warmup=args.warmup, processes=procs)
    params, opt = tr.init(0)
    # every rank reads the checkpoint: a write is followed by a barrier
    start = ck.latest_step(args.ckpt_dir) or 0
    if start:
        params, opt = tr.from_global(
            ck.restore(args.ckpt_dir, start, tr.global_specs()))
        say(f"resumed from step {start}")

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
            say(f"step {i:5d}  loss {loss:.4f}  "
                  f"gnorm {float(m['grad_norm']):.2f}  "
                  f"lr {float(m['lr']):.2e}  "
                  f"{wd.median*1e3:.0f} ms/step{note}", flush=True)
        if (i + 1) % args.ckpt_every == 0:
            tree = tr.to_global(params, opt)     # every rank gathers
            if rank0:
                acp.save(i + 1, tree)
    tree = tr.to_global(params, opt)
    if rank0:
        acp.wait()
        ck.save(args.ckpt_dir, args.steps, tree)
    if procs:
        tr.axis.barrier()        # the write has landed before any rank ends
    dt = time.time() - t0
    tok = (args.steps - start) * args.global_batch * args.seq
    where = (f" over {args.world} processes ({args.dist_backend}, mesh "
             f"{'x'.join(map(str, mesh))})" if procs else "")
    say(f"done: {args.steps - start} steps{where}, {tok/dt:.0f} tok/s, "
        f"stragglers={len(wd.straggler_steps)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
