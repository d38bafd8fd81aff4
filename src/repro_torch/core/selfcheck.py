"""Validation of every mock-up against a dense numpy oracle.

    python -m repro_torch.core.selfcheck --p 8 [--device cpu] [--json]

Runs every registered implementation on a stacked axis of ``p`` ranks
(``core._axis``) and compares it with the oracle; the JSON report has the
JAX package's schema (``devices`` holds the number of stacked ranks).
Power-of-two-only impls are skipped when ``p`` is not a power of two,
exactly as dispatch would never pick them there.

Quantized-wire mock-ups (``wire_q8`` / ``wire_fp8``) are held to a
per-wire-dtype max-norm relative bound, ``wire_tol(dtype, wire_hops(op,
p))``, instead of the exact ``atol``: one that breaks it is DEMOTED from
the admissible set (``collectives.demote``) and listed under
``"demoted"``, not as a failure.  ``run_gate`` applies the same gate to any
payload.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from repro_torch.core import collectives as C
from repro_torch.core._axis import StackedAxis
from repro_torch.kernels.quant import wire_tol


def wire_hops(op: str, p: int) -> int:
    """Number of independently quantized error terms that can ADD into one
    output element of a wire impl: the multiplier on ``wire_tol``'s base.

    A gather-style ring quantizes each block once at its origin and no two
    blocks' errors meet (1).  The travelling-accumulator reduce-scatter
    requantizes on each of its p-1 hops, and the wire allreduce adds the
    allgather's quantization on top (p).  ``matmul_accumulate`` quantizes
    each weight block once, but the contraction sums all p-1 wire-crossed
    blocks' errors into every output element (p-1)."""
    if op in ("reducescatter", "matmul_reducescatter", "matmul_accumulate"):
        return max(p - 1, 1)
    if op == "allreduce":
        return max(p, 1)
    return 1


def rel_err(got, want) -> float:
    """Max-norm relative error: the wire-tolerance metric."""
    g = np.asarray(got, np.float64)
    w = np.asarray(want, np.float64)
    return float(np.max(np.abs(g - w)) / max(np.max(np.abs(w)), 1e-30))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float64).numpy()


def run_gate(op: str, name: str, x, *, w=None, demote: bool = True,
             device=None):
    """Run one impl of ``op`` on a stacked payload ``x`` (``[p, ...]``, one
    leading block per rank; numpy or torch) on a stacked axis and apply
    the wire tolerance gate against the dense numpy oracle.

    ``w`` is the fused ops' second operand: the ``[K, M]`` weight of
    ``allgather_matmul`` / ``matmul_reducescatter``, the stationary
    ``[T, K]`` x of ``matmul_accumulate`` (whose payload ``x`` is then the
    stacked weight K-blocks).  Returns ``(ok, rel, tol)``.  A wire impl
    that breaks its tolerance is demoted (unless ``demote=False``); other
    impls are held to 1e-5 and never demoted.  ``device=None`` is the GPU,
    whatever device ``x`` is on (``_axis.resolve_device``)."""
    impl = C.REGISTRY[op][name]
    xt = torch.as_tensor(x)
    p = xt.shape[0]
    axis = StackedAxis(p, device)
    xt = xt.to(axis.device)
    xn = _np(xt)
    if op in ("allgather", "allreduce", "reducescatter"):
        got = impl.fn(xt, axis)
        if op == "allgather":
            full = xn.reshape((-1,) + xn.shape[2:])
            want = np.broadcast_to(full, (p,) + full.shape)
        elif op == "allreduce":
            want = np.broadcast_to(xn.sum(0), (p,) + xn.shape[1:])
        else:
            want = xn.sum(0).reshape((p, -1) + xn.shape[2:])
    elif op in ("allgather_matmul", "matmul_reducescatter"):
        wt = torch.as_tensor(w).to(axis.device, xt.dtype)
        got = impl.fn(xt, axis, w=wt)
        wn = _np(wt)
        if op == "allgather_matmul":
            full = xn.reshape(-1, xn.shape[-1]) @ wn
            want = np.broadcast_to(full, (p,) + full.shape)
        else:
            want = (xn @ wn).sum(0).reshape(p, -1, wn.shape[-1])
    elif op == "matmul_accumulate":
        stat = torch.as_tensor(w).to(axis.device, xt.dtype)
        got = impl.fn(xt, axis, x=stat)
        wantv = _np(stat) @ xn.reshape(-1, xn.shape[-1])
        want = np.broadcast_to(wantv, (p,) + wantv.shape)
    else:
        raise KeyError(f"run_gate does not model {op!r}")
    rel = rel_err(_np(got), want)
    if impl.wire_dtype is None:
        return rel <= 1e-5, rel, 1e-5
    tol = wire_tol(impl.wire_dtype, wire_hops(op, p))
    ok = rel <= tol
    if not ok and demote:
        C.demote(op, name, reason=f"tolerance rel={rel:.3g} > {tol:.3g}")
    return ok, rel, tol


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
    demoted: list[str] = []

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(axis.device)

    def impls(op):
        for nm, impl in C.REGISTRY[op].items():
            if impl.requires_pow2 and p & (p - 1):
                continue
            yield nm, impl.fn

    def check(name, got, want, rank=None):
        g = _np(got)
        if rank is not None:
            g = g[rank]
        op, nm = name.split("/")
        wd = C.REGISTRY[op][nm].wire_dtype
        if g.shape != np.shape(want):
            ok = False
        elif wd is None:
            ok = bool(np.allclose(g, want, atol=1e-5))
        else:
            # the wire gate: breaking it demotes the impl, it does not
            # fail the suite
            rel = rel_err(g, want)
            tol = wire_tol(wd, wire_hops(op, p))
            ok = rel <= tol
            if not ok:
                C.demote(op, nm, reason=f"tolerance rel={rel:.3g} > "
                                        f"{tol:.3g}")
                demoted.append(name)
        results[name] = ok
        if verbose:
            tag = "OK" if ok else ("DEMOTED" if name in demoted else "FAIL")
            print(f"{name:44s} {tag}")

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

    # matmul_accumulate: the payload is the weight's K-blocks, the
    # stationary x [T, K] is shared by every rank
    k_loc, t_rows = 2, 5
    wacc = rng.normal(size=(p * k_loc, 4)).astype(np.float32)
    xacc = rng.normal(size=(t_rows, p * k_loc)).astype(np.float32)
    want_acc = xacc @ wacc
    for nm, fn in impls("matmul_accumulate"):
        check(f"matmul_accumulate/{nm}",
              fn(dev(wacc.reshape(p, k_loc, 4)), axis, x=dev(xacc)),
              np.broadcast_to(want_acc, (p,) + want_acc.shape))

    fails = [k for k, v in results.items() if not v and k not in demoted]
    return {"devices": p, "total": len(results), "failures": fails,
            "demoted": demoted}


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
              f"{rep['failures'] or 'none'}, demoted: "
              f"{rep['demoted'] or 'none'}")
    return 1 if rep["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
