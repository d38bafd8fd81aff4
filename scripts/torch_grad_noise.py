"""How far a training step's gradients move when the SSM scans' outputs
move by a relative ``--eps``: the noise floor of a gradient comparison,
beside the distance between the step through the kernels and the step
through the plain versions.

Trains ``--steps`` steps in ``--train-dtype`` from a seed, casts the
weights to ``--dtype``, then takes one step's gradients three ways on
the same batch: through the model's autograd Functions (the kernels on
the card), through the plain versions under autograd, and through the
plain versions with each scan's output multiplied by ``1 + eps *
N(0, 1)``.  Prints, for each batch, the largest per-leaf max-norm
relative distances of the first and the third from the second::

    PYTHONPATH=src python scripts/torch_grad_noise.py --arch zamba2-1.2b \\
        --layers 7 --vocab 8192 --seq 256 --device cpu

On the CPU the Functions run the plain versions, so the first distance
is 0.  Full width; ``--vocab`` (0: the config's) and ``--layers`` cut.
"""
import argparse
import dataclasses
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import make_batch  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rw  # noqa: E402
from repro_torch.kernels import ssd_mamba2 as ssd  # noqa: E402
from repro_torch.models import attention, ssm  # noqa: E402
from repro_torch.models.params import (tree_leaves, tree_paths,  # noqa: E402
                                       tree_unflatten)
from repro_torch.train import Trainer  # noqa: E402


def plain_fns(eps: float, gen: torch.Generator | None):
    """The scans and attention through their plain versions, each scan's
    output times ``1 + eps * N(0, 1)`` when ``gen`` is given."""
    def noise(y):
        if gen is None:
            return y
        return y * (1 + eps * torch.randn(y.shape, generator=gen,
                                          device=gen.device))

    class Flash:
        @staticmethod
        def apply(q, k, v, causal, window, softcap, q0, kv_len, scale):
            return fa.flash_attention_plain(q, k, v, causal=causal,
                                            window=window, softcap=softcap,
                                            q0=q0, kv_len=kv_len,
                                            scale=scale)

    class RWKV:
        @staticmethod
        def apply(*args):
            return noise(rw.rwkv6_scan_plain_log(*args)[0])

    class SSD:
        @staticmethod
        def apply(*args):
            return noise(ssd.ssd_scan_plain(*args)[0])
    return Flash, RWKV, SSD


def grads_with(tr, params, batch, fns=None) -> dict:
    saved = attention.FlashAttention, ssm.RWKV6Scan, ssm.SSDScan
    if fns is not None:
        attention.FlashAttention, ssm.RWKV6Scan, ssm.SSDScan = fns
    try:
        _, g = tr.grads(params, batch)
    finally:
        attention.FlashAttention, ssm.RWKV6Scan, ssm.SSDScan = saved
    return {k: v.float().cpu() for k, v in tree_paths(g)}


def worst(got: dict, want: dict, n: int = 3) -> str:
    errs = {k: float((got[k] - w).abs().max())
            / max(float(w.abs().max()), 1e-30) for k, w in want.items()}
    return ", ".join(f"{k} {errs[k]:.3e}"
                     for k in sorted(errs, key=errs.get, reverse=True)[:n])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-3b")
    ap.add_argument("--dtype", default="float32",
                    help="dtype of the compared steps")
    ap.add_argument("--train-dtype", default="bfloat16")
    ap.add_argument("--eps", type=float, default=1e-6)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--steps", type=int, default=7)
    ap.add_argument("--batches", type=int, default=3,
                    help="compared batches (make_batch steps 100, 101, ..)")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args(argv)

    base = get_config(args.arch)
    cfg = dataclasses.replace(base, n_layers=args.layers,
                              vocab_size=args.vocab or base.vocab_size,
                              dtype=args.train_dtype, attn_impl="flash")
    tr = Trainer(cfg, mesh=(1, args.tp), device=args.device, base_lr=3e-4,
                 warmup=args.steps + 1)
    params, opt = tr.init(1)
    for i in range(args.steps):
        batch = tr.put_batch(make_batch(cfg, args.batch, args.seq, i))
        params, opt, _ = tr.step(params, opt, batch, i)
    del opt
    cfg = dataclasses.replace(cfg, dtype=args.dtype)
    tr = Trainer(cfg, mesh=(1, args.tp), device=args.device)
    dt = getattr(torch, args.dtype)
    params = tree_unflatten(params, [t.to(dt) if t.dtype == torch.bfloat16
                                     or t.dtype == torch.float32 else t
                                     for t in tree_leaves(params)])
    gen = torch.Generator(device=tr.axis.device).manual_seed(0)
    print(f"{args.arch} {args.layers} layers, TP {args.tp}, {args.batch} x "
          f"{args.seq} tokens, {args.steps} {args.train_dtype} steps, then "
          f"{args.dtype}; eps {args.eps:g}")
    for b in range(args.batches):
        batch = tr.put_batch(make_batch(cfg, args.batch, args.seq, 100 + b))
        kernels = grads_with(tr, params, batch)
        plain = grads_with(tr, params, batch, plain_fns(args.eps, None))
        noisy = grads_with(tr, params, batch, plain_fns(args.eps, gen))
        print(f"batch {b}: kernels vs plain: {worst(kernels, plain)}; plain "
              f"with eps noise vs plain: {worst(noisy, plain)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
