"""Validation of every mock-up against a dense numpy oracle.

    python -m repro_torch.core.selfcheck --p 8 [--device cpu] [--json]

Runs every one-axis implementation on a stacked axis of ``p`` ranks
(``core._axis``) and compares it with the oracle; the JSON report has the
JAX package's schema (``devices`` holds the number of stacked ranks).
Power-of-two-only impls are skipped when ``p`` is not a power of two,
exactly as dispatch would never pick them there.  When ``p`` is even the
two-axis run (``run_mesh``) follows on a ``(2, p/2)`` ``StackedMesh``, as
the JAX package's selfcheck does: every one-axis impl on each of its
axes, the hierarchical ``MPIX_*`` impls over the joint group and the 2-D
impls in both directions, all 64.  One JSON line is printed per run.

Across processes (``run_group``)::

    python -m repro_torch.core.selfcheck --world 4 --dist-backend gloo \
        --device cpu --json

spawns 4 ranks, one process each, and runs the same checks on a
``GroupAxis`` and, for an even world, on a ``(2, N/2)`` ``GroupMesh``:
each rank runs its own lane against the oracle of the whole array, and
rank 0's report (every check AND-reduced over the ranks) is printed.
Its totals are those of ``--p N``; it lists the one-kernel ring under
``not_applicable`` with the reason (it is not a check).

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
from functools import partial

import numpy as np
import torch

from repro_torch.core import collectives as C
from repro_torch.core._axis import (GroupAxis, GroupMesh, StackedAxis,
                                    StackedMesh)
from repro_torch.kernels.collective_matmul_rdma import ONE_ADDRESS_SPACE
from repro_torch.kernels.quant import wire_tol
from repro_torch.launch.mesh import spawn


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


def _check_axis(axis, tag: str, rng, check, dev, own, layout) -> None:
    """Every one-axis impl on ``axis`` (a ``StackedAxis``, one axis of a
    ``StackedMesh``, or their process counterparts) against the oracle of
    each group of lanes of ``layout``, the stacked view whose lanes the
    inputs are drawn for (``axis`` itself when it is stacked).  ``own(a)``
    is what the axis holds of a stacked ``[L, ...]`` input (all of it, or
    on a process axis this rank's lane) on its device, ``dev(a)`` a
    shared operand on the device."""
    p, lanes = layout.size, layout.lanes
    check = partial(check, p=p)
    groups = list(layout.groups().cpu().numpy())   # each group's lanes
    n, w = 6, 3
    x = rng.normal(size=(lanes, n, w)).astype(np.float32)
    xb = rng.normal(size=(lanes, p * n, w)).astype(np.float32)

    def per_group(f, a=x):
        """``[lanes, ...]``: each group's lanes hold ``f`` of its input."""
        outs = [np.asarray(f(a[g])) for g in groups]
        out = np.empty((lanes,) + outs[0].shape[1:], np.float64)
        for g, o in zip(groups, outs):
            out[g] = o
        return out

    def at_root(f, root, a=x):
        """The root lane of every group, and what it must hold."""
        return ([g[root] for g in groups],
                np.stack([np.asarray(f(a[g])) for g in groups]))

    def impls(op):
        for nm, impl in C.REGISTRY[op].items():
            if impl.hier or (impl.requires_pow2 and p & (p - 1)):
                continue
            yield nm, impl.fn

    def name(op, nm):
        return f"{op}{tag}/{nm}"

    def bcast(f):
        return lambda g: np.broadcast_to(f(g), (p,) + np.shape(f(g)))

    for nm, fn in impls("allgather"):
        check(name("allgather", nm), fn(own(x), axis),
              per_group(bcast(lambda g: g.reshape(p * n, w))))
    for nm, fn in impls("allreduce"):
        check(name("allreduce", nm), fn(own(x), axis, chunk=2),
              per_group(bcast(lambda g: g.sum(0))))
    for nm, fn in impls("reducescatter"):
        check(name("reducescatter", nm), fn(own(xb), axis),
              per_group(lambda g: g.sum(0).reshape(p, n, w), xb))
    for nm, fn in impls("alltoall"):
        check(name("alltoall", nm), fn(own(xb), axis),
              per_group(lambda g: g.reshape(p, p, n, w).transpose(
                  1, 0, 2, 3).reshape(p, p * n, w), xb))
    root_b, root_g, root_s, root_r = 3 % p, 2 % p, 5 % p, 1 % p
    for nm, fn in impls("bcast"):
        check(name("bcast", nm), fn(own(x), axis, root=root_b),
              per_group(lambda g: np.broadcast_to(g[root_b], (p, n, w))))
    for nm, fn in impls("gather"):
        check(name("gather", nm), fn(own(x), axis, root=root_g),
              *reversed(at_root(lambda g: g.reshape(p * n, w), root_g)))
    for nm, fn in impls("scatter"):
        check(name("scatter", nm), fn(own(xb), axis, root=root_s),
              per_group(lambda g: g[root_s].reshape(p, n, w), xb))
    for nm, fn in impls("reduce"):
        check(name("reduce", nm), fn(own(x), axis, root=root_r, chunk=2),
              *reversed(at_root(lambda g: g.sum(0), root_r)))
    for nm, fn in impls("scan"):
        check(name("scan", nm), fn(own(x), axis),
              per_group(lambda g: np.cumsum(g, axis=0)))
    for nm, fn in impls("exscan"):
        check(name("exscan", nm), fn(own(x), axis),
              per_group(lambda g: np.cumsum(g, axis=0) - g))

    wm = rng.normal(size=(w, 4)).astype(np.float32)
    for nm, fn in impls("allgather_matmul"):
        check(name("allgather_matmul", nm), fn(own(x), axis, w=dev(wm)),
              per_group(bcast(lambda g: g.reshape(p * n, w) @ wm)))
    for nm, fn in impls("matmul_reducescatter"):
        check(name("matmul_reducescatter", nm),
              fn(own(xb), axis, w=dev(wm)),
              per_group(lambda g: (g @ wm).sum(0).reshape(p, n, 4), xb))

    # matmul_accumulate: the payload is the weight's K-blocks, the
    # stationary x [T, K] is shared by every rank
    k_loc, t_rows = 2, 5
    wacc = rng.normal(size=(lanes, k_loc, 4)).astype(np.float32)
    xacc = rng.normal(size=(t_rows, p * k_loc)).astype(np.float32)
    for nm, fn in impls("matmul_accumulate"):
        check(name("matmul_accumulate", nm),
              fn(own(wacc), axis, x=dev(xacc)),
              per_group(bcast(lambda g: xacc @ g.reshape(p * k_loc, 4)),
                        wacc))


def _checker(results: dict, demoted: list, verbose: bool, lane=None,
             world=None):
    """``check(name, got, want, rank=None, p=0)``: exact impls at atol
    1e-5, wire impls through the tolerance gate at axis size ``p``
    (breaking it demotes the impl, it does not fail the suite).  ``rank``
    (one lane or a list of lanes) selects the rows of ``got`` a rooted op
    must hold.

    On a process axis ``got`` is this rank's lane ``lane`` of the stacked
    layout and is held to that lane of ``want`` (a rooted op's non-root
    ranks hold nothing); a wire impl's max-norm error is reduced over
    ``world`` (the axis over every rank), so every rank gates it alike."""
    def check(name, got, want, rank=None, p=0):
        g = _np(got)
        want = np.asarray(want)
        if lane is not None:
            roots = None if rank is None else list(np.atleast_1d(rank))
            if roots is None:
                want = want[lane:lane + 1]
            elif lane in roots:
                want = want[[roots.index(lane)]]
            else:
                want = None             # not a root: nothing to hold
        elif rank is not None:
            g = g[rank]
        op_tag, nm = name.split("/")[:2]
        op = op_tag.split("@")[0]
        wd = C.REGISTRY[op][nm].wire_dtype
        shape_ok = want is None or g.shape == want.shape
        if wd is None:
            ok = shape_ok and (want is None
                               or bool(np.allclose(g, want, atol=1e-5)))
        else:
            num = den = 0.0
            if want is not None and shape_ok:
                num = float(np.max(np.abs(np.asarray(g, np.float64) - want)))
                den = float(np.max(np.abs(want)))
            bad = float(not shape_ok)
            if world is not None:
                red = world.pmax(torch.tensor([[num, den, bad]],
                                              dtype=torch.float64,
                                              device=world.device))
                num, den, bad = red[0].tolist()
            ok = not bad
            if ok:
                rel = num / max(den, 1e-30)
                tol = wire_tol(wd, wire_hops(op, p))
                ok = rel <= tol
                if not ok:
                    C.demote(op, nm, reason=f"tolerance rel={rel:.3g} > "
                                            f"{tol:.3g}")
                    demoted.append(name)
        results[name] = ok
        if verbose:
            tag = "OK" if ok else ("DEMOTED" if name in demoted else "FAIL")
            print(f"{name:48s} {tag}")
    return check


def _report(devices, results: dict, demoted: list, **extra) -> dict:
    fails = [k for k, v in results.items() if not v and k not in demoted]
    return {"devices": devices, "total": len(results), "failures": fails,
            "demoted": demoted, **extra}


def _movers(device, lane=None):
    """``(dev, own)`` of ``_check_axis``: a numpy operand on ``device``,
    and what an axis holds of a stacked one (on a process axis, the lane
    ``lane``)."""
    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def own(a):
        return dev(a if lane is None else a[lane:lane + 1])
    return dev, own


def _group_report(devices, results: dict, demoted: list, world) -> dict:
    """The report of a run on a process axis: every check AND-reduced
    over the ranks (so every rank holds the same report), with the
    backend and the one-kernel ring, which no process axis runs."""
    keys = list(results)
    if keys:
        bad = torch.tensor([[0.0 if results[k] else 1.0 for k in keys]],
                           device=world.device)
        bad = world.pmax(bad)[0].tolist()
        for k, b in zip(keys, bad):
            results[k] = not b
    return _report(devices, results, demoted, world=world.size,
                   backend=torch.distributed.get_backend(),
                   not_applicable={"ring_allgather_matmul_rdma":
                                   ONE_ADDRESS_SPACE})


def run(p: int = 8, device=None, *, seed: int = 42,
        verbose: bool = False) -> dict:
    """Check every one-axis impl at axis size ``p``; returns the JSON
    report."""
    axis = StackedAxis(p, device)
    rng = np.random.default_rng(seed)
    results: dict[str, bool] = {}
    demoted: list[str] = []
    check = _checker(results, demoted, verbose)
    dev, own = _movers(axis.device)
    _check_axis(axis, "", rng, check, dev, own, axis)
    return _report(p, results, demoted)


def run_mesh(shape=(2, 4), device=None, *, seed: int = 42,
             verbose: bool = False) -> dict:
    """The two-axis run on a ``StackedMesh`` of ``shape`` (outer "o",
    inner "i"): every one-axis impl on each axis (each group of lanes
    against its own oracle), the hierarchical ``MPIX_*`` impls and the
    defaults' ``inner_axis`` path over the joint group in outer-major
    order, and both 2-D impls, forward and transpose, in the
    ``row_matmul(fsdp_dim=1)`` layout.  Together: all 64 impls."""
    mesh = StackedMesh(shape, ("o", "i"), device)
    results: dict[str, bool] = {}
    demoted: list[str] = []
    check = _checker(results, demoted, verbose)
    dev, own = _movers(mesh.device)
    _check_mesh(mesh, mesh, seed, check, dev, own)
    return _report(f"{shape[0]}x{shape[1]}", results, demoted,
                   impls=_covered(results))


def _covered(results: dict) -> int:
    return len({(k.split("/")[0].split("@")[0], k.split("/")[1])
                for k in results})


def _check_mesh(mesh, layout, seed: int, check, dev, own) -> None:
    """The checks of ``run_mesh`` on ``mesh`` (stacked or of processes),
    the inputs drawn for the lanes of ``layout``, its stacked view."""
    d, q = layout.shape
    lanes = layout.lanes
    rng = np.random.default_rng(seed)
    for nm in mesh.names:
        _check_axis(mesh[nm], f"@{nm}", rng, check, dev, own, layout[nm])

    # hierarchical: the joint group, outer-major
    n, w = 6, 3
    x = rng.normal(size=(lanes, n, w)).astype(np.float32)
    xb = rng.normal(size=(lanes, lanes * n, w)).astype(np.float32)
    full = x.reshape(lanes * n, w)
    tag = f"@{d}x{q}"
    for op, xin, want in (
            ("allgather", x, np.broadcast_to(full, (lanes,) + full.shape)),
            ("allreduce", x, np.broadcast_to(x.sum(0), x.shape)),
            ("reducescatter", xb, xb.sum(0).reshape(lanes, n, w))):
        for nm, impl in C.REGISTRY[op].items():
            if impl.hier or nm == "default":
                check(f"{op}{tag}/{nm}",
                      impl.fn(own(xin), mesh["o"], inner_axis=mesh["i"]),
                      want)

    # 2-D: lane (i, j) holds x's j-th K-slice and W's (j K-rows, i col
    # block); the transpose's cotangent rows shard over "o" and each "i"
    # rank contributes its own stationary x
    t2, kl, ml = 2 * q, 3, 4
    x2d = rng.normal(size=(t2, q * kl)).astype(np.float32)
    w2d = rng.normal(size=(q * kl, d * ml)).astype(np.float32)
    xs = np.stack([x2d[:, j * kl:(j + 1) * kl] for i in range(d)
                   for j in range(q)])
    ws = np.stack([w2d[j * kl:(j + 1) * kl, i * ml:(i + 1) * ml]
                   for i in range(d) for j in range(q)])
    want2d = x2d @ w2d
    tl = t2 // q
    want_f = np.stack([want2d[j * tl:(j + 1) * tl] for i in range(d)
                       for j in range(q)])
    # transpose: rs axis "o" (d), gather axis "i" (q): g's rows are cut
    # over "i", every "o" rank has its own x; the sum over "o" is scattered
    # by rows of M
    m2 = d * ml
    g2d = rng.normal(size=(t2, m2)).astype(np.float32)
    xt = [rng.normal(size=(t2, kl)).astype(np.float32) for _ in range(d)]
    gs = np.stack([g2d[j * tl:(j + 1) * tl] for i in range(d)
                   for j in range(q)])
    xts = np.stack([xt[i] for i in range(d) for j in range(q)])
    want_t = sum(g2d.T @ xt[i] for i in range(d))
    mt = m2 // d
    want_tt = np.stack([want_t[i * mt:(i + 1) * mt] for i in range(d)
                        for j in range(q)])
    for nm, impl in C.REGISTRY["matmul_reducescatter_2d"].items():
        check(f"matmul_reducescatter_2d{tag}/{nm}",
              impl.fn(own(ws), mesh["o"], x=own(xs), rs_axis=mesh["i"]),
              want_f)
        check(f"matmul_reducescatter_2d{tag}/{nm}/xpose",
              impl.fn(own(gs), mesh["i"], x=own(xts), rs_axis=mesh["o"],
                      xpose=True),
              want_tt)


def run_group(device=None, *, seed: int = 42) -> list[dict]:
    """The selfcheck across processes, run on every rank of an
    initialized world of N (``launch.mesh.init_world``): every one-axis
    impl on a ``GroupAxis`` over the world, then, for even N, the checks
    of ``run_mesh`` on a ``(2, N/2)`` ``GroupMesh``.  Each rank draws the
    global inputs from ``seed`` as ``run``/``run_mesh`` do, runs its own
    lane and holds it to that lane of the oracle; the reports are
    AND-reduced over the ranks (the same on every rank) and their totals
    are those of the stacked runs at p = N."""
    world = GroupAxis(device)
    lane = world.rank
    dev, own = _movers(world.device, lane)
    reps = []
    results: dict[str, bool] = {}
    demoted: list[str] = []
    check = _checker(results, demoted, False, lane, world)
    _check_axis(world, "", np.random.default_rng(seed), check, dev, own,
                StackedAxis(world.size, "cpu"))
    reps.append(_group_report(world.size, results, demoted, world))
    if world.size % 2 == 0:
        shape = (2, world.size // 2)
        mesh = GroupMesh(shape, ("o", "i"), device)
        results, demoted = {}, []
        check = _checker(results, demoted, False, lane, world)
        _check_mesh(mesh, StackedMesh(shape, ("o", "i"), "cpu"), seed,
                    check, dev, own)
        reps.append(_group_report(f"{shape[0]}x{shape[1]}", results,
                                  demoted, world))
        reps[-1]["impls"] = _covered(results)
    return reps


#: a group run that has not finished by then has hung: its ranks are killed
GROUP_TIMEOUT_S = 600.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--p", type=int, default=8,
                    help="number of ranks stacked on the device")
    ap.add_argument("--world", type=int, default=None,
                    help="run across N processes, one rank each "
                         "(GroupAxis), instead of stacked ranks")
    ap.add_argument("--dist-backend", default="nccl",
                    choices=("nccl", "gloo"),
                    help="the process group's backend with --world (NCCL: "
                         "one rank per GPU; gloo: pass --device cpu)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; pass cpu to run "
                         "on the CPU)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    if args.world:
        reps = spawn(run_group, args.world, backend=args.dist_backend,
                     args=(args.device,), timeout_s=GROUP_TIMEOUT_S)[0]
    else:
        reps = [run(args.p, args.device, verbose=not args.json)]
        if args.p % 2 == 0:
            reps.append(run_mesh((2, args.p // 2), args.device,
                                 verbose=not args.json))
    for rep in reps:
        if args.json:
            print(json.dumps(rep))
        else:
            print(f"\n{rep['devices']}: {rep['total']} checks, failures: "
                  f"{rep['failures'] or 'none'}, demoted: "
                  f"{rep['demoted'] or 'none'}")
            for k, why in rep.get("not_applicable", {}).items():
                print(f"not applicable on a process axis: {k}: {why}")
    return 1 if any(rep["failures"] for rep in reps) else 0


if __name__ == "__main__":
    sys.exit(main())
