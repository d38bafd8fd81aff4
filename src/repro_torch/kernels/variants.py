"""Ablations of the hand-written CUDA kernels, timed on the card.

    python -m repro_torch.kernels.variants [ring] [flash] [--only NAME ...]

Each variant is a copy of ``csrc/`` with a few source edits (a stage
count, a tile width, one part of the loop taken out or put back), built
like the kernels themselves into ``build/variants/<name>/`` and timed by
the device time that ``torch.profiler`` records (mean per launch of 20)
at the shapes of ``chip_smoke.py`` phase 3.  A variant that takes work out
computes a wrong result: it shows where the time goes, nothing more; the
base variants are checked against their plain versions.  Needs a CUDA
card.  Prints the card's name and power limit, then one line per variant
and shape.
"""
from __future__ import annotations

import argparse
import shutil
import subprocess

import torch

from repro_torch.core._axis import StackedAxis
from repro_torch.kernels import _build
from repro_torch.kernels import collective_matmul_rdma as rdma
from repro_torch.kernels import flash_attention as fa

_GEMM = "hopper_gemm.cuh"
_RING = "agmm_ring.cu"
_FA = "flash_attention.cu"

RING = {
    "base": [],
    "2 stages": [(_GEMM, "constexpr int STAGES = 3;",
                  "constexpr int STAGES = 2;")],
    "4 stages": [(_GEMM, "constexpr int STAGES = 3;",
                  "constexpr int STAGES = 4;")],
    "128x128 tile, 6 stages": [
        (_GEMM, "constexpr int BN = 256;", "constexpr int BN = 128;"),
        (_GEMM, "constexpr int STAGES = 3;", "constexpr int STAGES = 6;")],
    "no copies": [(_RING, "        if (send || gath)\n",
                   "        if (false)\n")],
    "copies one load at a time": [
        (_RING, "  constexpr int UNROLL = 8;", "  constexpr int UNROLL = 1;")],
}

_NO_MASK = (_FA, "    const bool whole = k_last < P.kv_len &&\n"
                 "                       (!P.causal || k_last <= wq_min) &&",
            "    const bool whole = true || k_last < P.kv_len &&\n"
            "                       (!P.causal || k_last <= wq_min) &&")
_NO_EXP = (_FA, "        s[4 * j + e] = exp2f(s[4 * j + e] - mn_a);\n"
                "        s[4 * j + 2 + e] = exp2f(s[4 * j + 2 + e] - mn_b);",
           "        s[4 * j + e] = s[4 * j + e] - mn_a;\n"
           "        s[4 * j + 2 + e] = s[4 * j + 2 + e] - mn_b;")
_NO_PV = (_FA, "      wgmma_pv<DH>(o, pa[kk], dv + kk * (16 * 128 >> 4));",
          "      o[kk] += __uint_as_float(pa[kk][0] ^ pa[kk][3]);")
_NO_S = (_FA, "      hopper::wgmma_ss_n128_bf16<0>(s, dq + off, dk + off, "
              "ks > 0);",
         "      s[ks] = __uint_as_float((uint32_t)(dq + off + dk));")
FLASH = {
    "base": [],
    "3 stages": [(_FA, "  static constexpr int STAGES = 2;\n"
                       "  static constexpr int THREADS = 384;",
                  "  static constexpr int STAGES = 3;\n"
                  "  static constexpr int THREADS = 384;")],
    "lightest row tiles first": [
        (_FA, "  const int row0 = (tiles - 1 - blockIdx.x / groups) * S::BM;",
         "  const int row0 = (blockIdx.x / groups) * S::BM;")],
    "softcap test per score": [(_FA, "    logits<64>(P, s);\n",
                                "#pragma unroll\n"
                                "    for (int i = 0; i < 64; ++i)\n"
                                "      s[i] = cap(P, s[i]) * LOG2E;\n")],
    "no mask": [_NO_MASK],
    "no exp": [_NO_EXP],
    "no PV product": [_NO_PV],
    "no S product": [_NO_S],
    "no math (pipeline only)": [_NO_MASK, _NO_EXP, _NO_PV, _NO_S],
}


def device_ms(fn, needle: str, iters: int = 20, tries: int = 3) -> float:
    """Mean device time per launch of the kernels whose name contains
    ``needle`` over ``iters`` calls of ``fn``, from ``torch.profiler``.
    A profiler session now and then records no kernel at all (or drops
    one): the mean is over the launches it recorded, and a session that
    recorded none is run again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if needle in e.key and str(
            getattr(e, "device_type", "")).endswith("CUDA")]
        count = sum(e.count for e in rows)
        if count > iters:
            raise RuntimeError(f"{count} launches of {needle!r} in {iters} "
                               f"calls")
        if count:
            return sum(e.self_device_time_total for e in rows) / 1e3 / count
    raise RuntimeError(f"the profiler recorded no launch of {needle!r} in "
                       f"{tries} sessions of {iters} calls")


def _variant_lib(lib: str, name: str, edits):
    """Build ``lib`` from a copy of csrc/ with ``edits`` applied and load
    it; returns a stand-in for the wrapper module's ``_lib``."""
    mod = rdma if lib == "agmm_ring" else fa
    slug = "".join(c if c.isalnum() else "_" for c in f"{lib}_{name}")
    d = _build.build_dir().parent / "variants" / slug
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(_build.CSRC, d)
    for fname, old, new in edits:
        path = d / fname
        text = path.read_text()
        if old not in text:
            raise RuntimeError(f"variant {name!r}: the source {fname} no "
                               f"longer holds {old[:60]!r}")
        path.write_text(text.replace(old, new))
    csrc, _build.CSRC = _build.CSRC, d
    try:
        _build._LIBS.pop(lib, None)
        built = mod._lib()
    finally:
        _build.CSRC = csrc
        _build._LIBS.pop(lib, None)      # the next plain call builds csrc/
    for ln in _build.build_log(lib).splitlines():
        if "C75" in ln:
            print(f"  ptxas: {ln.strip()[:160]}")
    return lambda: built


def ring(only, gen) -> None:
    p, n, k, m = 8, 512, 3072, 2048          # the gate/up allgather-matmul
    dev = torch.device("cuda")
    x = torch.randn(p, n, k, generator=gen, device=dev).bfloat16()
    w = (torch.randn(p, k, m, generator=gen, device=dev)
         * k ** -0.5).bfloat16()
    axis = StackedAxis(p, dev)
    want = rdma.ring_allgather_matmul_rdma_plain(x, w)
    flops = 2 * p * p * n * k * m
    for name, edits in RING.items():
        if only and name not in only:
            continue
        lib = _variant_lib("agmm_ring", name, edits)
        keep, rdma._lib = rdma._lib, lib
        try:
            out = rdma.ring_allgather_matmul_rdma(x, w, axis)
            err = float((out.float() - want.float()).abs().max())
            ms = device_ms(lambda: rdma.ring_allgather_matmul_rdma(x, w,
                                                                   axis),
                           "agmm_ring")
        finally:
            rdma._lib = keep
        print(f"ring {name}: gate/up p={p} x[{n},{k}] w[{p},{k},{m}] bf16 "
              f"{ms:.4f} ms = {flops / ms / 1e9:.1f} TFLOP/s, max_abs_err "
              f"{err:.3e}", flush=True)


def flash(only, gen) -> None:
    dev = torch.device("cuda")
    shapes = (  # (label, (N, Sq, HK, G, dh), causal)
        ("llama3.2-3b prefill, causal", (32, 1024, 1, 3, 128), True),
        ("llama3.2-3b prefill, no mask", (32, 1024, 1, 3, 128), False),
        ("N 8, S 4096, no mask", (8, 4096, 1, 1, 128), False),
        ("zamba2-1.2b prefill, causal", (32, 1024, 4, 1, 64), True))
    ins = {}
    for label, (nb, s, hk, g, dh), _ in shapes:
        ins[label] = tuple(
            torch.randn(*sh, generator=gen, device=dev).bfloat16()
            for sh in ((nb, s, hk, g, dh), (nb, s, hk, dh), (nb, s, hk, dh)))
    for name, edits in FLASH.items():
        if only and name not in only:
            continue
        lib = _variant_lib("flash_attention", name, edits)
        keep, fa._lib = fa._lib, lib
        try:
            for label, (nb, s, hk, g, dh), causal in shapes:
                q, k, v = ins[label]
                got = fa.flash_attention(q, k, v, causal=causal)
                err = ""
                if name == "base":
                    want = fa.flash_attention_plain(q, k, v, causal=causal)
                    ok = bool(((got.float() - want.float()).abs()
                               <= fa.tolerance(q, k, v, want,
                                               causal=causal)).all())
                    err = f", within the limit: {ok}"
                ms = device_ms(lambda: fa.flash_attention(
                    q, k, v, causal=causal), "fa_wgmma")
                pairs = s * (s + 1) // 2 if causal else s * s
                flops = 4 * dh * pairs * nb * hk * g
                print(f"flash {name}: {label} {ms:.4f} ms = "
                      f"{flops / ms / 1e9:.1f} TFLOP/s{err}", flush=True)
        finally:
            fa._lib = keep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("kernels", nargs="*", default=["ring", "flash"],
                    help="ring and/or flash (default: both)")
    ap.add_argument("--only", nargs="*", default=[],
                    help="variant names to run (default: all)")
    args = ap.parse_args(argv)
    if set(args.kernels) - {"ring", "flash"}:
        ap.error(f"kernels are ring and flash, not {args.kernels}")
    if not torch.cuda.is_available():
        raise SystemExit("variants: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(20170701)
    if "ring" in args.kernels:
        ring(set(args.only), gen)
    if "flash" in args.kernels:
        flash(set(args.only), gen)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
