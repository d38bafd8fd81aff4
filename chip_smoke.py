#!/usr/bin/env python3
"""Drive the PyTorch port's tuning loop on one CUDA card, end to end.

    python3 chip_smoke.py [--out DIR]

Phases (each raises on failure; nothing is caught):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build the kernels from the sources in the checkout (set-up time):
   ``nvcc`` for the block matmul and the Triton JIT for guideline_pack,
   started together;
3. each kernel against its plain PyTorch version at the slice's shapes and
   at ragged shapes: max error, tolerance, kernel ms, plain ms, the bound,
   and for the GEMM the ``torch.matmul`` time;
4. ``selfcheck`` of every impl at p = 8 and p = 6;
5. fit an ``h100-stacked`` Topo from ``sweep_axis`` (alpha, beta, gamma);
6. ``tune()`` with the measured backend at p = 8 over the flat ops, and the
   fused op over a size sweep at llama3.2-3b's GEMM widths; save and reload
   the profiles;
7. record one llama3.2-3b sequence-parallel block (d_model 3072, d_ff
   8192, 4096 tokens, p = 8 ranks stacked on the card) under the tuned
   profiles as a Trace;
8. replay it with ``tune_trace`` (measured backend), run the block again
   under the new profiles, check it against the default impls, print the
   ``#@pgmpi`` footer, and force ``allgather_as_allreduce`` and
   ``fused_ring`` once so both kernels run whatever the tuner picked.

Kernel launch counts are zeroed just before phase 6 and read after each of
phases 6-8; every kernel must have launched in the tune, replay and
dispatch phases.  The p ranks are stacked on ONE card: a ring hop is a
device-memory copy, so the times measure on-chip data movement and launch
overhead, not a link between GPUs.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  With no CUDA device, or without the
``src/repro_torch`` package beside this script, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

H100_BYTES_PER_S = 3.35e12          # HBM3, H100 SXM data sheet
H100_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
SEED = 20170701
DEVICE = "cuda"

# llama3.2-3b (src/repro/configs/llama3_2_3b.py) at train_4k
D_MODEL, D_FF, HEADS, HEAD_DIM, TOKENS, P = 3072, 8192, 24, 128, 4096, 8
TUNE_SIZES = (1, 1024, 32768, 1_048_576, 16_777_216)


def log(*a):
    print(*a, flush=True)


def nvidia_smi(fields: str) -> str:
    res = subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / iters


def counts(pack, cmm) -> dict:
    return {"guideline_pack": pack.guideline_pack.launches,
            "block_matmul": cmm.block_matmul.launches}


def zero_counts(pack, cmm) -> None:
    pack.guideline_pack.launches = 0
    cmm.block_matmul.launches = 0


def require_launched(phase: str, before: dict, after: dict) -> dict:
    delta = {k: after[k] - before[k] for k in after}
    log(f"[{phase}] kernel launches: {json.dumps(delta)}")
    missing = [k for k, v in delta.items() if v <= 0]
    if missing:
        raise RuntimeError(f"{phase}: kernels never launched: {missing}")
    return delta


def block(api, axis, torch, x, wv, wo, wu, wd):
    """One llama3.2-3b sequence-parallel block on stacked ranks.

    x ``[p, T/p, D]`` is the sequence-sharded residual.  The attention is
    stood in by its value projection (a plain torch.matmul; the slice has
    no attention kernel), whose ``[T, 384]`` per-rank output feeds the
    attn-out matmul-reducescatter; the up-projection is a plain
    torch.matmul and the MLP-down product a matmul-reducescatter."""
    h = api.allgather(x, axis)                                # [p, T, D]
    o = api.matmul_reducescatter(torch.matmul(h, wv), wo, axis)
    x2 = x + o
    h2 = api.allgather(x2, axis)
    u = torch.nn.functional.silu(torch.matmul(h2, wu))        # [p, T, F/p]
    return x2 + api.matmul_reducescatter(u, wd, axis)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "chip_smoke"),
                    help="directory for profiles, trace and the report")
    args = ap.parse_args(argv)

    if not (SRC / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    os.environ.setdefault("TRITON_HOME", str(ROOT / "build" / "kernels"))
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(ROOT / "build" / "kernels" / "triton"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.core import api, collectives as C, costmodel, measure
    from repro_torch.core import profiles, selfcheck, trace, tuner
    from repro_torch.core._axis import StackedAxis
    from repro_torch.core.cell import OpCell
    from repro_torch.kernels import _build, collective_matmul as cmm, pack

    torch.backends.cuda.matmul.allow_tf32 = False     # plain f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    dev = torch.device(DEVICE)
    t_start = time.perf_counter()
    report: dict = {}

    # -- 1. the card ---------------------------------------------------------
    card = nvidia_smi("name,power.limit")
    log(card)                       # exactly as nvidia-smi prints it
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    report["card"] = card

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    errs: list[BaseException] = []

    def nvcc_build():
        try:
            cmm.build()
        except BaseException as e:      # re-raised below, in this thread
            errs.append(e)

    th = threading.Thread(target=nvcc_build)
    th.start()
    for dt in (torch.float32, torch.bfloat16):     # Triton JIT per dtype
        pack.guideline_pack(torch.ones(1, 4, 4, dtype=dt, device=dev),
                            torch.zeros(1, dtype=torch.int32, device=dev), 2)
    th.join()
    if errs:
        raise errs[0]
    torch.cuda.synchronize()
    log(f"[2] kernels built in {time.perf_counter() - t0:.1f} s")
    for ln in _build.build_log("block_matmul").splitlines():
        if "registers" in ln or "spill" in ln or "smem" in ln:
            log(f"[2] ptxas: {ln.strip()}")

    # -- 3. kernels against their plain versions -----------------------------
    g = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(
            dtype)

    kernels = {}
    # guideline_pack at the GL3 placement of the block's 3 MiB bf16 allgather
    xs = randn(P, TOKENS // P, D_MODEL)
    idx = torch.arange(P, dtype=torch.int32, device=dev)
    got = pack.guideline_pack(xs, idx, P)
    want = pack.guideline_pack_plain(xs, idx, P)
    err = float((got.float() - want.float()).abs().max())
    if err != 0.0:
        raise RuntimeError(f"guideline_pack differs from plain: {err}")
    nbytes = (P * P + P) * xs[0].numel() * xs.element_size()
    kernels["guideline_pack"] = dict(
        name="guideline_pack", route="triton",
        source="src/repro_torch/kernels/pack.py",
        replaces="src/repro/kernels/pack.py:29",
        max_abs_err=err,
        ms=time_ms(torch, lambda: pack.guideline_pack(xs, idx, P)),
        plain_ms=time_ms(torch, lambda: pack.guideline_pack_plain(xs, idx,
                                                                   P)),
        bound_ms=nbytes / H100_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None)
    log(f"[3] guideline_pack x{list(xs.shape)} bf16 p={P}: max_abs_err "
        f"{err} (tolerance 0: a copy) kernel "
        f"{kernels['guideline_pack']['ms']:.4f} ms plain "
        f"{kernels['guideline_pack']['plain_ms']:.4f} ms bound "
        f"{kernels['guideline_pack']['bound_ms']:.4f} ms")
    for shape, dt, p_, ids in (((3, 37, 11), torch.float32, 5, [4, 0, 2]),
                               ((2, 1, 1), torch.int8, 7, [6, 3]),
                               ((1, 13, 3), torch.int32, 5, [0])):
        xr = randn(*shape, dtype=torch.float32, scale=50).to(dt)
        ir = torch.tensor(ids, dtype=torch.int32, device=dev)
        if not torch.equal(pack.guideline_pack(xr, ir, p_),
                           pack.guideline_pack_plain(xr, ir, p_)):
            raise RuntimeError(f"guideline_pack ragged {shape} {dt} differs")
        log(f"[3] guideline_pack ragged {list(shape)} {dt} p={p_}: exact")

    def mm_case(B, m, k, n, dt, shared_w=False):
        x = randn(B, m, k, dtype=dt)
        w = randn(*(() if shared_w else (B,)), k, n, dtype=dt,
                  scale=k ** -0.5)
        got = cmm.block_matmul(x, w)
        want = cmm.block_matmul_plain(x, w)
        err = float((got.float() - want.float()).abs().max())
        scale = max(1.0, float(want.float().abs().max()))
        tol = (2.0 ** -7 if dt != torch.float32 else 1e-5) * scale
        if not err <= tol:
            raise RuntimeError(f"block_matmul {B}x{m}x{k}x{n} {dt}: error "
                               f"{err} > tolerance {tol}")
        return x, w, err, tol

    # the MLP-down ring step: all 8 ranks' [512, 1024] @ [1024, 3072]
    name_dt = {torch.bfloat16: "bfloat16", torch.float32: "float32"}
    for label, (m, k) in (("mlp-down", (TOKENS // P, D_FF // P)),
                          ("attn-out", (TOKENS // P, HEADS * HEAD_DIM // P))):
        for dt in (torch.bfloat16, torch.float32):
            x, w, err, tol = mm_case(P, m, k, D_MODEL, dt)
            flops = 2 * P * m * k * D_MODEL
            byts = (x.numel() + w.numel() + P * m * D_MODEL) * x.element_size()
            t_b, t_f = byts / H100_BYTES_PER_S, flops / H100_FLOPS[name_dt[dt]]
            rec = dict(
                name="block_matmul", route="cuda",
                source="src/repro_torch/kernels/csrc/block_matmul.cu",
                replaces="src/repro/kernels/collective_matmul.py:124",
                max_abs_err=err,
                ms=time_ms(torch, lambda: cmm.block_matmul(x, w)),
                plain_ms=time_ms(torch, lambda: cmm.block_matmul_plain(x, w)),
                bound_ms=max(t_b, t_f) * 1e3,
                bound_by="bytes" if t_b > t_f else "operations",
                library_ms=time_ms(torch, lambda: torch.matmul(x, w)))
            log(f"[3] block_matmul {label} [{P},{m},{k}]@[{P},{k},{D_MODEL}]"
                f" {name_dt[dt]}: max_abs_err {err:.3e} (tolerance "
                f"{tol:.3e}) kernel {rec['ms']:.4f} ms plain "
                f"{rec['plain_ms']:.4f} ms torch.matmul "
                f"{rec['library_ms']:.4f} ms bound {rec['bound_ms']:.4f} ms "
                f"({rec['bound_by']}) = "
                f"{flops / rec['ms'] / 1e9:.1f} TFLOP/s")
            if label == "mlp-down" and dt == torch.bfloat16:
                kernels["block_matmul"] = rec
    for B, m, k, n, dt, shared in ((2, 100, 33, 17, torch.bfloat16, False),
                                   (3, 5, 256, 130, torch.float32, True),
                                   (1, 129, 72, 200, torch.float16, False),
                                   (8, 512, 1000, 3000, torch.bfloat16,
                                    True)):
        _, _, err, tol = mm_case(B, m, k, n, dt, shared)
        log(f"[3] block_matmul ragged [{B},{m},{k}]@[{k},{n}] {dt} "
            f"shared_w={shared}: max_abs_err {err:.3e} (tolerance {tol:.3e})")

    # -- 4. selfcheck ----------------------------------------------------------
    for p_ in (P, 6):
        rep = selfcheck.run(p_, dev)
        log(f"[4] selfcheck p={p_}: {json.dumps(rep)}")
        if rep["failures"]:
            raise RuntimeError(f"selfcheck p={p_} failed: {rep['failures']}")

    # -- 5. fit the h100-stacked Topo -------------------------------------------
    bench = measure.Bench(P, dev)
    sw_sizes = (1 << 10, 1 << 14, 1 << 18, 1 << 20, 1 << 22)
    ag = bench.sweep_axis("allgather", sw_sizes, count=9)
    ar = bench.sweep_axis("allreduce", sw_sizes, count=9)
    base = costmodel.Topo("h100-stacked", alpha=0.0, link_bw=1.0, gamma=0.0,
                          matmul_flops=H100_FLOPS["bfloat16"])
    topo = costmodel.fit_topo(P, ag, ar, name="h100-stacked", base=base)
    log(f"[5] allgather sweep (bytes, s): {ag}")
    log(f"[5] allreduce sweep (bytes, s): {ar}")
    log(f"[5] fitted {topo.name}: alpha {topo.alpha:.4e} s, beta "
        f"{topo.beta:.4e} s/B (link_bw {topo.link_bw / 1e9:.1f} GB/s), "
        f"gamma {topo.gamma:.4e} s/B")
    report["topo"] = dataclasses.asdict(topo)
    del bench

    # ======== the main path: tune -> record -> replay -> dispatch ========
    zero_counts(pack, cmm)
    c0 = counts(pack, cmm)

    # -- 6. tune ---------------------------------------------------------------
    t0 = time.perf_counter()
    backend = tuner.MeasuredBackend(P, dev, max_nrep=20)
    trep = tuner.tune(list(C.FLAT_OPS), TUNE_SIZES, axis_size=P,
                      backend=backend)
    geo = trace.Trace([trace.TraceEntry(OpCell(
        "matmul_reducescatter", P, rows * k * 2, "bfloat16", k, rows,
        D_MODEL, "scatter")) for k in (HEADS * HEAD_DIM // P, D_FF // P)
        for rows in (TOKENS // 4, TOKENS)])
    grep = tuner.tune_trace(geo, backend)
    store = trep.profiles
    for ph_store in grep.phase_profiles.values():
        for prof in ph_store:
            store.add(prof)
    log(f"[6] tune: {len(trep.measurements) + len(grep.measurements)} "
        f"measurements in {time.perf_counter() - t0:.1f} s")
    for ln in trep.summary().splitlines() + grep.summary().splitlines():
        log(f"[6] {ln}")
    pat = [v for v in trep.violations if v.gl_kind == "pattern"]
    for v in pat:
        log(f"[6] violation {v.op} p={v.axis_size} {v.nbytes}B: {v.detail}"
            f" (x{v.speedup:.2f})")
    for v in trep.violations:
        if v.gl_kind != "pattern":
            log(f"[6] {v.gl_kind} {v.op} {v.nbytes}B: {v.detail}")
    report["violations"] = [dataclasses.asdict(v) for v in trep.violations]
    prof_dir = out_dir / "profiles"
    store.save(prof_dir)
    reloaded = profiles.ProfileStore.load(prof_dir)
    if sorted(p.to_text() for p in reloaded) != sorted(
            p.to_text() for p in store):
        raise RuntimeError("profiles did not survive save/load")
    log(f"[6] {len(store)} profiles saved to {prof_dir} and reloaded")
    c6 = counts(pack, cmm)
    require_launched("6 tune", c0, c6)
    del backend

    # -- 7. record the block ---------------------------------------------------
    axis = StackedAxis(P, dev)
    x = randn(P, TOKENS // P, D_MODEL)
    f_attn, f_ff = HEADS * HEAD_DIM // P, D_FF // P
    wv = randn(P, D_MODEL, f_attn, scale=D_MODEL ** -0.5)
    wo = randn(P, f_attn, D_MODEL, scale=(P * f_attn) ** -0.5)
    wu = randn(P, D_MODEL, f_ff, scale=D_MODEL ** -0.5)
    wd = randn(P, f_ff, D_MODEL, scale=(P * f_ff) ** -0.5)
    ws = (x, wv, wo, wu, wd)
    with api.tuned(profiles=reloaded) as ctx7:
        out7 = block(api, axis, torch, *ws)
    torch.cuda.synchronize()
    rec = trace.Trace.from_context(ctx7)
    rec.save(out_dir / "block_trace.jsonl")
    for ln in rec.summary().splitlines():
        log(f"[7] {ln}")
    for e in rec.entries:
        log(f"[7] {e.to_json()}")
    c7 = counts(pack, cmm)
    log(f"[7 record] kernel launches: "
        f"{json.dumps({k: c7[k] - c6[k] for k in c7})}")

    # -- 8. replay, then dispatch under the new profiles -----------------------
    t0 = time.perf_counter()
    rrep = tuner.tune_trace(rec, tuner.MeasuredBackend(P, dev, max_nrep=20))
    log(f"[8] tune_trace in {time.perf_counter() - t0:.1f} s")
    for ln in rrep.summary().splitlines():
        log(f"[8] {ln}")
    for m in rrep.measurements:
        log(f"[8] measured {m.op} {m.nbytes}B {m.impl}: "
            f"{m.latency * 1e3:.4f} ms (nrep {m.nrep})")
    rrep.save(out_dir / "trace_profiles")
    _, phases = profiles.load_stores(out_dir / "trace_profiles")
    c8a = counts(pack, cmm)
    require_launched("8 replay", c7, c8a)

    with api.tuned(phase_profiles=phases, profiles=reloaded) as ctx8:
        out8 = block(api, axis, torch, *ws)
    with api.tuned(force={"allgather": "default",
                          "matmul_reducescatter": "default"}):
        ref = block(api, axis, torch, *ws)
    with api.tuned() as ctxf:
        ag_forced = api.allgather(x, axis, impl="allgather_as_allreduce")
        h = api.allgather(x, axis)
        a = torch.matmul(h, wv)
        mm_forced = api.matmul_reducescatter(a, wo, axis, impl="fused_ring")
        mm_default = api.matmul_reducescatter(a, wo, axis, impl="default")
    torch.cuda.synchronize()
    c8b = counts(pack, cmm)
    require_launched("8 dispatch", c8a, c8b)
    for ln in api.format_footer(ctx8).splitlines():
        log(f"[8] {ln}")
    for ln in api.format_footer(ctxf).splitlines():
        log(f"[8] forced: {ln}")
    scale = max(1.0, float(ref.float().abs().max()))
    # bf16: the ring rounds p partial sums where the default rounds once,
    # <= p * 2**-8 of the output per matmul-reducescatter; two in series
    tol = 2.0 ** -4 * scale
    for label, got, want, t in (
            ("recorded block", out7, ref, tol),
            ("tuned block", out8, ref, tol),
            ("allgather_as_allreduce", ag_forced, h, 0.0),
            ("fused_ring", mm_forced, mm_default, tol)):
        if tuple(got.shape) != tuple(want.shape) or not bool(
                torch.isfinite(got.float()).all()):
            raise RuntimeError(f"{label}: bad output {tuple(got.shape)}")
        err = float((got.float() - want.float()).abs().max())
        log(f"[8] {label} vs default impls: max_abs_err {err:.4e} "
            f"(tolerance {t:.4e}) shape {list(got.shape)}")
        if not err <= t:
            raise RuntimeError(f"{label} differs from the default: {err}")

    main_path = {k: c8b[k] - c0[k] for k in c8b}
    log(f"[main path] kernel launches: {json.dumps(main_path)}")
    for k, v in main_path.items():
        kernels[k]["launches"] = v
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    (out_dir / "report.json").write_text(json.dumps(report, indent=1))
    log(f"[done] {report['seconds']:.1f} s")
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kernels[n][k] for k in order}
                                  for n in ("guideline_pack",
                                            "block_matmul")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
