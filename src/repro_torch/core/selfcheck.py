"""Validation of every mock-up against a dense numpy oracle.

    python -m repro_torch.core.selfcheck --p 8 [--device cpu] [--json]

Runs every registered implementation on a stacked axis of ``p`` ranks
(``core._axis``) and compares it with the oracle; the JSON report has the
JAX package's schema (``devices`` holds the number of stacked ranks).
Power-of-two-only impls are skipped when ``p`` is not a power of two,
exactly as dispatch would never pick them there.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from repro_torch.core import collectives as C
from repro_torch.core._axis import StackedAxis


def run(p: int = 8, device=None, *, seed: int = 42,
        verbose: bool = False) -> dict:
    """Check every impl at axis size ``p``; returns the JSON report."""
    axis = StackedAxis(p, device)
    rng = np.random.default_rng(seed)
    n, w = 6, 3
    x = rng.normal(size=(p, n, w)).astype(np.float32)
    xb = rng.normal(size=(p, p * n, w)).astype(np.float32)
    full = x.reshape(p * n, w)
    results: dict[str, bool] = {}

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(axis.device)

    def impls(op):
        for nm, impl in C.REGISTRY[op].items():
            if impl.requires_pow2 and p & (p - 1):
                continue
            yield nm, impl.fn

    def check(name, got, want, rank=None):
        g = got.detach().cpu().numpy()
        if rank is not None:
            g = g[rank]
        ok = g.shape == np.shape(want) and bool(
            np.allclose(g, want, atol=1e-5))
        results[name] = ok
        if verbose:
            print(f"{name:44s} {'OK' if ok else 'FAIL'}")

    for nm, fn in impls("allgather"):
        check(f"allgather/{nm}", fn(dev(x), axis),
              np.broadcast_to(full, (p,) + full.shape))
    want = x.sum(0)
    for nm, fn in impls("allreduce"):
        check(f"allreduce/{nm}", fn(dev(x), axis, chunk=2),
              np.broadcast_to(want, (p,) + want.shape))
    for nm, fn in impls("reducescatter"):
        check(f"reducescatter/{nm}", fn(dev(xb), axis),
              xb.sum(0).reshape(p, n, w))
    wanta2a = xb.reshape(p, p, n, w).transpose(1, 0, 2, 3).reshape(
        p, p * n, w)
    for nm, fn in impls("alltoall"):
        check(f"alltoall/{nm}", fn(dev(xb), axis), wanta2a)
    root_b, root_g, root_s, root_r = 3 % p, 2 % p, 5 % p, 1 % p
    for nm, fn in impls("bcast"):
        check(f"bcast/{nm}", fn(dev(x), axis, root=root_b),
              np.broadcast_to(x[root_b], (p, n, w)))
    for nm, fn in impls("gather"):
        check(f"gather/{nm}", fn(dev(x), axis, root=root_g), full,
              rank=root_g)
    for nm, fn in impls("scatter"):
        check(f"scatter/{nm}", fn(dev(xb), axis, root=root_s),
              xb[root_s].reshape(p, n, w))
    for nm, fn in impls("reduce"):
        check(f"reduce/{nm}", fn(dev(x), axis, root=root_r, chunk=2),
              x.sum(0), rank=root_r)
    wantscan = np.cumsum(x, axis=0)
    for nm, fn in impls("scan"):
        check(f"scan/{nm}", fn(dev(x), axis), wantscan)
    for nm, fn in impls("exscan"):
        check(f"exscan/{nm}", fn(dev(x), axis), wantscan - x)

    wm = rng.normal(size=(w, 4)).astype(np.float32)
    want_agmm = full @ wm
    for nm, fn in impls("allgather_matmul"):
        check(f"allgather_matmul/{nm}", fn(dev(x), axis, w=dev(wm)),
              np.broadcast_to(want_agmm, (p,) + want_agmm.shape))
    want_mmrs = (xb @ wm).sum(0).reshape(p, n, 4)
    for nm, fn in impls("matmul_reducescatter"):
        check(f"matmul_reducescatter/{nm}", fn(dev(xb), axis, w=dev(wm)),
              want_mmrs)

    fails = [k for k, v in results.items() if not v]
    return {"devices": p, "total": len(results), "failures": fails,
            "demoted": []}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--p", type=int, default=8,
                    help="number of ranks stacked on the device")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; pass cpu to run "
                         "on the CPU)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    rep = run(args.p, args.device, verbose=not args.json)
    if args.json:
        print(json.dumps(rep))
    else:
        print(f"\n{rep['total']} checks, failures: "
              f"{rep['failures'] or 'none'}")
    return 1 if rep["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
