"""Ablations of the hand-written CUDA kernels, timed on the card.

    python -m repro_torch.kernels.variants [ring] [flash] [matmul] [rwkv]
        [ssd] [--only NAME ...] [--csrc DIR] [--no-long] [--shapes TEXT ...]

Each variant is a copy of ``csrc/`` with a few source edits (a stage
count, a tile width, one part of the loop taken out or put back), built
like the kernels themselves into ``build/variants/<name>/`` and timed by
the device time that ``torch.profiler`` records (mean per launch of 20;
long_500k's prefill layers by CUDA events over 2 launches) at the shapes
of ``chip_smoke.py`` phase 3.  A variant that takes work out computes a wrong result: it shows
where the time goes, nothing more; the base variants, and flash's that
give plan() back a kernel a path ran on before (``FLASH_CHECKED``), are
checked against their plain versions.  ``--csrc DIR`` builds the
variants from another copy of ``csrc/`` (a parent commit's, unpacked by
``git archive``), so that two sources are timed in one run; ``--no-long``
leaves out long_500k's prefill layers, ``--shapes`` keeps the flash shapes
whose label holds one of the texts.  Needs a CUDA card.  Prints the
card's name and power limit, then one line per variant and shape.
"""
from __future__ import annotations

import argparse
import functools
import pathlib
import shutil
import subprocess

import torch

from repro_torch.core._axis import StackedAxis
from repro_torch.kernels import _build
from repro_torch.kernels import collective_matmul as cmm
from repro_torch.kernels import collective_matmul_rdma as rdma
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rwkv6_scan as rw
from repro_torch.kernels import ssd_mamba2 as sd

_GEMM = "hopper_gemm.cuh"
_RING = "agmm_ring.cu"
_FA = "flash_attention.cu"
_BM = "block_matmul.cu"
_RW = "rwkv6_scan.cu"
_SSD = "ssd_scan.cu"
_MODULES = {"agmm_ring": rdma, "flash_attention": fa, "block_matmul": cmm,
            "rwkv6_scan": rw, "ssd_scan": sd}

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
_NO_S = (_FA, "      wgmma_qk<S::BN>(s, dq + (ks / 4) * (S::Q_BOX >> 4) + inner,\n"
              "                      dk + (ks / 4) * (S::KV_BOX >> 4) + inner, "
              "ks > 0);",
         "      s[ks] = __uint_as_float((uint32_t)(dq + inner + dk));")
# the MLA prefill kernel (fa_mla_wgmma_kernel)
_MLA_NO_S = (_FA, "      hopper::wgmma_ss_n32_bf16<0>(s, dq + off, dk + off, "
                  "ks > 0);",
             "      s[ks % 16] = __uint_as_float((uint32_t)(dq + off + dk));")
_MLA_NO_PV = (_FA, "      hopper::wgmma_ss_n256_bf16<1>(o, dp + kk * 2,\n"
                   "                                    dv + kk * (16 * 128 >> "
                   "4), 1);",
              "      o[kk] += __uint_as_float((uint32_t)(dp + dv));")
_D64_NO_S = (_FA, "      hopper::wgmma_ss_n128_bf16<0>(s, dq + ks * 2, dk + ks * 2, "
                  "ks > 0);",
             "      s[ks] = __uint_as_float((uint32_t)(dq + ks + dk));")
_D64_NO_PV = (_FA, "      hopper::wgmma_rs_n64_bf16<1>(o, pa[kk], dv + kk * (16 * 128 "
                   ">> 4), 1);",
              "      o[kk] += __uint_as_float(pa[kk][0] ^ pa[kk][3]);")
FLASH = {
    "base": [],
    # the kernels that the dh-256 wgmma instance and the MLA wgmma prefill
    # took over from, chosen by plan() as before: dh 256 on mma.sync, the
    # MLA prefill on "mla"
    "dh 256 on mma_sync": [
        (_FA, "(dh == 64 || dh == 128 || dh == 256) && rows >= 64 &&",
         "(dh == 64 || dh == 128) && rows >= 64 &&")],
    "MLA prefill on mla": [
        (_FA, "  } else if (dh == MLA_DQ && dv == MLA_DV && v_in_k && vec_ok &&",
         "  } else if (false && dh == MLA_DQ && dv == MLA_DV && v_in_k &&")],
    # each Q load waits for the one before it: the round trip a load that
    # the first port's Q loop paid before its store
    "Q loads one round trip each": [
        (_FA, "    if (R < rows)\n      v[i] = __ldg(",
         "    if (R < rows && (i == 0 || v[i - 1].x != 0x7fc00001))\n"
         "      v[i] = __ldg(")],
    "3 stages": [(_FA, "  static constexpr int STAGES = 2;\n"
                       "  static constexpr int THREADS = DH == 256 ? 256 : 384;",
                  "  static constexpr int STAGES = DH == 256 ? 2 : 3;\n"
                  "  static constexpr int THREADS = DH == 256 ? 256 : 384;")],
    "lightest row tiles first": [
        (_FA, "  const int row0 = (tiles - 1 - blockIdx.x / groups) * S::BM;",
         "  const int row0 = (blockIdx.x / groups) * S::BM;")],
    "softcap test per score": [(_FA, "    logits<NS>(P, s);\n",
                                "#pragma unroll\n"
                                "    for (int i = 0; i < NS; ++i)\n"
                                "      s[i] = cap(P, s[i]) * LOG2E;\n")],
    "no mask": [_NO_MASK],
    "no exp": [_NO_EXP],
    "no PV product": [_NO_PV],
    "no S product": [_NO_S],
    "no math (pipeline only)": [_NO_MASK, _NO_EXP, _NO_PV, _NO_S],
    "MLA: no PV product": [_MLA_NO_PV],
    "MLA: no S product": [_MLA_NO_S],
    "MLA: no math (pipeline only)": [_MLA_NO_S, _MLA_NO_PV],
    # the kernel the dh-64 prefill ran on before fa_wgmma64_kernel
    # (fa_wgmma_kernel<64>, which capped calls keep); the decodes' former
    # kernel is gone from the source, so the parent's source times it:
    # --csrc
    "replaced: dh-64 prefill": [
        (_FA, "rc = dh == 64 && !(softcap > 0.f) ? launch_wgmma64(P, s)",
         "rc = false ? launch_wgmma64(P, s)")],
    "dh-256 decode: 2 stages (3 CTAs an SM)": [
        (_FA, "static constexpr int STAGES = DHP == 256 ? 3 : 4;",
         "static constexpr int STAGES = DHP == 256 ? 2 : 4;")],
    # where fa_ring_kernel's time goes: without the last CTA's merge of
    # the splits (every split decode's: the ticket is not taken), without
    # its loads, without its math
    "decodes: no merge of the splits": [
        (_FA, "if (threadIdx.x == 0) last = atomicAdd(tickets + group, 1) == "
              "splits - 1;", "if (threadIdx.x == 0) last = 0;")],
    "ring decode: no loads": [
        (_FA, "    if (i < nb) load(i, b0 + i);", "    (void)load;"),
        (_FA, "    if (j + R::STAGES < nb) load(stage, b0 + j + R::STAGES);",
         "")],
    "ring decode: no math": [(_FA, "    ring_step<DHP, LDS>(",
                                "    if (false) ring_step<DHP, LDS>(")],
    # where the MLA decode's time goes (fa_mla_kernel<1, 64>; the edits
    # also reach the "mla" prefill instance): without its K/V loads (Q
    # still staged), without its S and PV products; "decodes: no merge of
    # the splits" also takes its merge out
    "mla decode: no loads": [
        (_FA, "  if (b_lo < b_hi) stage(0, b_lo);", "  (void)stage;"),
        (_FA, "    if (nbuf == 2 && kb + 1 < b_hi) stage(buf ^ 1, kb + 1);",
         "")],
    "mla decode: no math": [
        (_FA, "    for (int k32 = 0; k32 < nk32; ++k32) {",
         "    for (int k32 = 0; k32 < 0; ++k32) {"),
        (_FA, "      for (int kk = 0; kk < BN / 16; ++kk) {\n"
              "        uint32_t a[RG][4];",
         "      for (int kk = 0; kk < 0; ++kk) {\n        uint32_t a[RG][4];")],
    "dh 64: no ping-pong": [
        (_FA, "  auto my_turn = [&]() { hopper::named_bar_sync(2 + wg, 256); };",
         "  auto my_turn = [&]() {};"),
        (_FA, "    if (!(wg == 1 && last_issue)) hopper::named_bar_arrive(3 - "
              "wg, 256);", "    (void)last_issue;"),
        (_FA, "  if (wg == 1 && nblk > 0) hopper::named_bar_arrive(2, 256);",
         "")],
    "dh 64: 2 stages": [(_FA, "  static constexpr int STAGES = 4;\n"
                              "  static constexpr int THREADS = 288;",
                         "  static constexpr int STAGES = 2;\n"
                         "  static constexpr int THREADS = 288;")],
    "dh 64: no exp": [(_FA, "hopper::ex2(fmaf(", "(fmaf(")],
    "dh 64: no PV product": [_D64_NO_PV],
    "dh 64: no S product": [_D64_NO_S],
    "dh 64: no math (pipeline only)": [(_FA, "hopper::ex2(fmaf(", "(fmaf("),
                                       _D64_NO_PV, _D64_NO_S],
}
# flash variants that compute the function, held to the plain version
FLASH_CHECKED = ("base", "dh 256 on mma_sync", "MLA prefill on mla",
                 "replaced: dh-64 prefill",
                 "dh-256 decode: 2 stages (3 CTAs an SM)",
                 "dh 64: no ping-pong", "dh 64: 2 stages")


_TILE_N = (_BM, "return 2 * wide > sms ? 256 : 128;", "return {};")
MATMUL = {
    "base": [],
    "128-wide tiles": [(_TILE_N[0], _TILE_N[1], _TILE_N[2].format(128))],
    "256-wide tiles": [(_TILE_N[0], _TILE_N[1], _TILE_N[2].format(256))],
    "one CTA per tile": [
        (_BM, "const int grid = tiles < sms ? static_cast<int>(tiles) : sms;",
         "const int grid = static_cast<int>(tiles);")],
    "2 stages": [(_BM, "constexpr int WGMMA_STAGES = 3;",
                  "constexpr int WGMMA_STAGES = 2;")],
    "register epilogue": [(_BM, "constexpr bool TMA_EPILOGUE = true;",
                           "constexpr bool TMA_EPILOGUE = false;")],
}


def _rwkv_cta(cluster: int, threads: int, per_sm: int):
    base = {"CLUSTER": 2, "CTA_THREADS": 256, "MIN_CTAS_PER_SM": 3}
    want = {"CLUSTER": cluster, "CTA_THREADS": threads,
            "MIN_CTAS_PER_SM": per_sm}
    return [(_RW, f"constexpr int {k} = {base[k]};",
             f"constexpr int {k} = {want[k]};")
            for k in base if want[k] != base[k]]


def _rwkv_cut(anchor: str, cut: str):
    return [(_RW, anchor, cut)]


RWKV = {
    "base": [],
    "cluster 4 x 128 threads": _rwkv_cta(4, 128, 5),
    "cluster 2 x 128 threads": _rwkv_cta(2, 128, 4),
    "one CTA of 512 threads": _rwkv_cta(1, 512, 1),
    "no prefetch": [(_RW, "constexpr bool PREFETCH = true;",
                     "constexpr bool PREFETCH = false;")],
    "hd not a template constant": _rwkv_cut(
        "  if (p.hd == 64) return", "  if (false) return"),
    "no decode path": [(_RW, "int path(int s) { return s == 1 ? 1 : 0; }",
                        "int path(int s) { return s < 0 ? 1 : 0; }")],
    "no pair products": _rwkv_cut(
        "for (int cq = part; cq < hd4; cq += SPLIT) {",
        "for (int cq = part; cq < 0; cq += SPLIT) {"),
    "no exp in the pairs": _rwkv_cut("expf(fminf(", "(fminf("),
    "no r, k decay": _rwkv_cut("for (int i = tid; i < L * hd4; i += NT) {",
                               "for (int i = tid; i < 0; i += NT) {"),
    "no log": _rwkv_cut("  return logf(fmaxf(w, 1e-38f));", "  return w;"),
    "no cumsum scan": _rwkv_cut("  for (int o = 1; o < 32; o <<= 1) {",
                                "  for (int o = 32; o < 32; o <<= 1) {"),
    "no r, k, v, w loads": [
        (_RW, "      if (cq < hd4 && lane < lc) {", "      if (false) {"),
        (_RW, "      if (i < L * cq4 && t < lc && 4 * jq < ncol)",
         "      if (false)")],
    "no y products": _rwkv_cut(
        "for (int i = tid; i < 2 * (L / 4) * cq4; i += HALF) {",
        "for (int i = tid; i < 0; i += HALF) {"),
    "no state update": _rwkv_cut(
        "for (int i = tid - HALF; i < hd4 * cq4; i += HALF) {",
        "for (int i = tid - HALF; i < 0; i += HALF) {"),
}


def _ssd_cta(threads: int):
    return [(_SSD, "constexpr int CTA_THREADS = 512;",
             f"constexpr int CTA_THREADS = {threads};")]


def _ssd_cut(anchor: str, cut: str):
    return [(_SSD, anchor, cut)]


SSD = {
    "base": [],
    "one CTA of 256 threads": _ssd_cta(256),
    "no prefetch": [(_SSD, "constexpr bool PREFETCH = true;",
                     "constexpr bool PREFETCH = false;")],
    "no decode path": _ssd_cut("  return s == 1 ? 1 : 0;",
                               "  return s < 0 ? 1 : 0;"),
    "decode 64 columns a CTA": _ssd_cut(
        "constexpr int DECODE_COLS = 32;", "constexpr int DECODE_COLS = 64;"),
    "no x, B, C loads": [
        (_SSD, "      if (i < L * xq && s < lc)\n", "      if (false)\n"),
        (_SSD, "      if (v < bq && s < lc) {", "      if (false) {")],
    "C B^T on FMAs, not mma.sync": [(_SSD, "PAIRS_MMA = true;",
                                     "PAIRS_MMA = false;")],
    # C B^T's products in one head of eight, the others decay zeros: what
    # sharing them across a row's eight heads could save at most
    "C B^T products in one head of 8": _ssd_cut(
        "for (int q = 0; q < NS; q += 16) {",
        "for (int q = 0; q < (h % 8 ? 0 : NS); q += 16) {"),
    "no pairs": [
        (_SSD, "for (int k = tid - HALF; k < TRI; k += HALF) {",
         "for (int k = tid - HALF; k < 0; k += HALF) {"),
        (_SSD, "k < TRI_MMA; k += HALF / 32) {", "k < 0; k += HALF / 32) {")],
    "no exp in the pairs": [
        (_SSD, "expf(fminf(at(ct, e)", "(fminf(at(ct, e)"),
        (_SSD, "expf(fminf(cum[tt] - cum[ss], 0.f))",
         "(fminf(cum[tt] - cum[ss], 0.f))")],
    "no inter products": _ssd_cut("for (int q = k; q < NS; q += 4) {",
                                  "for (int q = k; q < 0; q += 4) {"),
    "no intra products": _ssd_cut("for (int s = k; s < tb + 4; s += 4) {",
                                  "for (int s = k; s < 0; s += 4) {"),
    "no state update": _ssd_cut(
        "for (int i = tid; i < NQ * JQ; i += HALF) {",
        "for (int i = tid; i < 0; i += HALF) {"),
    "no cumsum scan": _ssd_cut("  for (int o = 1; o < 32; o <<= 1) {",
                               "  for (int o = 32; o < 32; o <<= 1) {"),
}


def call_device_ms(fn, iters: int = 20, tries: int = 3) -> float:
    """Mean device time per call of ``fn`` over ``iters`` calls: every
    kernel it launches, from ``torch.profiler`` (for a library call whose
    kernels' names are not known)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if str(getattr(e, "device_type", "")).endswith("CUDA"))
        if total:
            return total / 1e3 / iters
    raise RuntimeError(f"the profiler recorded no kernel in {tries} "
                       f"sessions of {iters} calls")


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


def events_ms(fn, iters: int) -> float:
    """Mean ms a call of ``fn`` over ``iters`` back-to-back calls between
    two CUDA events, after one warm-up call: for launches of a second and
    more (long_500k's global layer), whose host time hides, and after
    which ``torch.profiler`` sessions recorded no launch at all."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


CSRC = None         # --csrc: the copy of csrc/ the variants are built from
_SOURCE = ""        # its tag in flash's lines


def _variant_lib(lib: str, name: str, edits):
    """Build ``lib`` from a copy of csrc/ (or of ``CSRC``) with ``edits``
    applied and load it; returns a stand-in for the wrapper module's
    ``_lib``."""
    mod = _MODULES[lib]
    slug = "".join(c if c.isalnum() else "_" for c in f"{lib}_{name}")
    d = _build.build_dir().parent / "variants" / slug
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(CSRC or _build.CSRC, d)
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
    fn = ""
    for ln in _build.build_log(lib).splitlines():
        if "Function properties for" in ln:
            fn = ln.split("for ", 1)[1]
        if "C75" in ln or ("spill stores" in ln
                           and " 0 bytes spill stores" not in ln):
            print(f"  ptxas: {fn[:90]}: {ln.strip()[:120]}")
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


def flash(only, gen, no_long=False, keep=()) -> None:
    dev = torch.device("cuda")
    mla = dict(scale=192 ** -0.5)
    long_len = 524288 - 32                   # long_500k's prompt, one lane
    shapes = (  # (label, (N, Sq, Skv, HK, G, dh, dv or None: v = k), kw)
        ("llama3.2-3b prefill, causal", (32, 1024, 1024, 1, 3, 128, None),
         dict(causal=True)),
        ("llama3.2-3b decode kv_len 1056", (32, 1, 2048, 1, 3, 128, None),
         dict(causal=True, q0=1055, kv_len=1056)),
        ("llama3.2-3b prefill, no mask", (32, 1024, 1024, 1, 3, 128, None),
         dict(causal=False)),
        ("N 8, S 4096, no mask", (8, 4096, 4096, 1, 1, 128, None),
         dict(causal=False)),
        ("zamba2-1.2b prefill, causal", (32, 1024, 1024, 4, 1, 64, None),
         dict(causal=True)),
        ("gemma3-1b prefill per lane, dh 256",
         (16, 1024, 1024, 1, 1, 256, None), dict(causal=True)),
        ("gemma3-1b local layer, dh 256", (16, 1024, 1024, 1, 1, 256, None),
         dict(causal=True, window=512)),
        ("paligemma-3b prefix rows, dh 256", (32, 256, 256, 1, 1, 256, None),
         dict(causal=False)),
        ("paligemma-3b text rows, dh 256", (32, 1024, 1280, 1, 1, 256, None),
         dict(causal=True, q0=256)),
        ("deepseek-v3 MLA prefill, v a view of k",
         (32, 1024, 1024, 1, 16, 576, 512), dict(causal=True, **mla)),
        ("deepseek-v3 MLA decode kv_len 1056",
         (32, 1, 2048, 1, 16, 576, 512),
         dict(causal=True, q0=1055, kv_len=1056, **mla)),
        # whisper-medium at TP 8 (phase 19): dh 64, non-causal
        ("whisper-medium encoder self-attention, dh 64",
         (32, 1500, 1500, 2, 1, 64, None), dict(causal=False)),
        ("whisper-medium cross-attention prefill, dh 64",
         (32, 192, 1500, 2, 1, 64, None), dict(causal=False)),
        ("whisper-medium cross-attention decode, dh 64",
         (32, 1, 1500, 2, 1, 64, None), dict(causal=False, q0=192)),
        # the dh-256 decodes: gemma3-1b per lane on the (2, 4) mesh (global
        # and local layers), paligemma-3b and gemma2-9b at TP 8
        ("gemma3-1b decode kv_len 1056, dh 256",
         (16, 1, 2048, 1, 1, 256, None),
         dict(causal=True, q0=1055, kv_len=1056)),
        ("gemma3-1b local decode kv_len 1056, dh 256",
         (16, 1, 2048, 1, 1, 256, None),
         dict(causal=True, window=512, q0=1055, kv_len=1056)),
        ("paligemma-3b decode kv_len 1312, dh 256",
         (32, 1, 2048, 1, 1, 256, None),
         dict(causal=True, q0=1311, kv_len=1312)),
        ("gemma2-9b TP 8 decode kv_len 1056, dh 256",
         (32, 1, 2048, 1, 2, 256, None),
         dict(causal=True, window=4096, softcap=50.0, q0=1055,
              kv_len=1056)),
        # long_500k's prefill layers: timed by events over 2 launches, not
        # held to the plain version here (chip_smoke.py phase 3 holds them
        # on slices)
        ("gemma3-1b long_500k global layer",
         (1, long_len, long_len, 1, 4, 256, None), dict(causal=True)),
        ("gemma3-1b long_500k local layer",
         (1, long_len, long_len, 1, 4, 256, None),
         dict(causal=True, window=512)))
    if no_long:
        shapes = tuple(s for s in shapes if s[1][1] != long_len)
    if keep:
        shapes = tuple(s for s in shapes if any(k in s[0] for k in keep))
    ins, flops = {}, {}
    for label, (nb, sq, skv, hk, g, dh, dv), kw in shapes:
        q, k, v = (torch.randn(*sh, generator=gen, device=dev).bfloat16()
                   for sh in ((nb, sq, hk, g, dh), (nb, skv, hk, dh),
                              (nb, skv, hk, dh)))
        ins[label] = (q, k, v if dv is None else k[..., :dv])
        q0, w = kw.get("q0", 0), kw.get("window", 0)
        kvl = kw.get("kv_len", skv)
        pairs = sum((min(kvl, q0 + i + 1) if kw["causal"] else kvl)
                    - (max(0, q0 + i - w + 1) if w else 0)
                    for i in range(sq))
        flops[label] = 2 * (dh + (dv or dh)) * pairs * nb * hk * g
    for name, edits in FLASH.items():
        if only and name not in only:
            continue
        lib = _variant_lib("flash_attention", name, edits)
        keep, fa._lib = fa._lib, lib
        try:
            for label, (nb, sq, skv, hk, g, dh, dv), kw in shapes:
                q, k, v = ins[label]
                before = dict(fa.flash_attention.launches_by_path)
                got = fa.flash_attention(q, k, v, **kw)
                path = [p_ for p_, c in fa.flash_attention.launches_by_path
                        .items() if c != before[p_]]
                err = ""
                long = sq == long_len
                if not long and name in FLASH_CHECKED:
                    want = fa.flash_attention_plain(q, k, v, **kw)
                    ok = bool(((got.float() - want.float()).abs()
                               <= fa.tolerance(q, k, v, want, **kw)).all())
                    err = f", within the limit: {ok}"
                call = functools.partial(fa.flash_attention, q, k, v, **kw)
                ms = events_ms(call, 2) if long else device_ms(call, "fa_")
                print(f"flash {name}{_SOURCE}: {label} path "
                      f"{'/'.join(path)} "
                      f"{ms:.4f} ms = {flops[label] / ms / 1e9:.1f} "
                      f"TFLOP/s{err}", flush=True)
        finally:
            fa._lib = keep


def matmul(only, gen) -> None:
    dev = torch.device("cuda")
    shapes = (  # (label, (B, m, k, n)): chip_smoke.py's main-path steps
        ("mlp-down", (8, 512, 1024, 3072)), ("attn-out", (8, 512, 384, 3072)),
        ("K/V accumulate", (8, 4096, 384, 1024)),
        ("K/V accumulate, 512 rows", (8, 512, 384, 1024)))
    ins = {label: (torch.randn(b, m, k, generator=gen, device=dev).bfloat16(),
                   (torch.randn(b, k, n, generator=gen, device=dev)
                    * k ** -0.5).bfloat16())
           for label, (b, m, k, n) in shapes}
    for name, edits in MATMUL.items():
        if only and name not in only:
            continue
        lib = _variant_lib("block_matmul", name, edits)
        keep, cmm._lib = cmm._lib, lib
        try:
            for label, (b, m, k, n) in shapes:
                x, w = ins[label]
                got = cmm.block_matmul(x, w)
                want = cmm.block_matmul_plain(x, w).float()
                ok = float((got.float() - want).abs().max()) <= 2.0 ** -7 * \
                    max(1.0, float(want.abs().max()))
                ms = device_ms(lambda: cmm.block_matmul(x, w), "bm_wgmma")
                print(f"matmul {name}: {label} [{b},{m},{k}]@[{b},{k},{n}] "
                      f"bf16 {ms:.4f} ms = {2 * b * m * k * n / ms / 1e9:.1f}"
                      f" TFLOP/s, within the limit: {ok}", flush=True)
        finally:
            cmm._lib = keep


def rwkv(only, gen) -> None:
    dev = torch.device("cuda")
    n, h, hd = 32, 5, 64                  # the rwkv6-3b serve at TP 8

    def ins(s, s0=None):
        return (*(torch.randn(n, s, h, hd, generator=gen,
                              device=dev).bfloat16() for _ in range(3)),
                torch.exp(-torch.exp(0.5 * torch.randn(
                    n, s, h, hd, generator=gen, device=dev))),
                0.5 * torch.randn(8, h, hd, generator=gen, device=dev), s0)
    pre = ins(1024)
    dec = ins(1, rw.rwkv6_scan_plain(*pre)[1])
    for name, edits in RWKV.items():
        if only and name not in only:
            continue
        lib = _variant_lib("rwkv6_scan", name, edits)
        keep, rw._lib = rw._lib, lib
        try:
            for label, a in (("prefill S 1024", pre), ("decode S 1", dec)):
                (y, sf), (yp, sp) = rw.rwkv6_scan(*a), rw.rwkv6_scan_plain(*a)
                yl, sl = rw.tolerance(*a)
                ok = bool(((y - yp).abs() <= yl).all()
                          and ((sf - sp).abs() <= sl).all())
                ms = device_ms(lambda: rw.rwkv6_scan(*a), "rwkv6_")
                print(f"rwkv {name}: {label} r[{n},{a[0].shape[1]},{h},{hd}] "
                      f"bf16 {ms:.4f} ms, within the limit: {ok}",
                      flush=True)
        finally:
            rw._lib = keep


def ssd(only, gen) -> None:
    dev = torch.device("cuda")
    n, h, p, ns = 32, 8, 64, 64            # the zamba2-1.2b serve at TP 8

    def ins(s, s0=None):
        bc = torch.randn(n, s, 2 * ns, generator=gen, device=dev).bfloat16()
        return (torch.randn(n, s, h, p, generator=gen, device=dev).bfloat16(),
                torch.nn.functional.softplus(torch.randn(
                    n, s, h, generator=gen, device=dev)),
                torch.exp(0.5 * torch.randn(8, h, generator=gen, device=dev)),
                bc[..., :ns], bc[..., ns:], s0)
    pre = ins(1024)
    dec = ins(1, sd.ssd_scan_plain(*pre)[1])
    for name, edits in SSD.items():
        if only and name not in only:
            continue
        lib = _variant_lib("ssd_scan", name, edits)
        keep, sd._lib = sd._lib, lib
        try:
            for label, a in (("prefill S 1024", pre), ("decode S 1", dec)):
                before = dict(sd.ssd_scan.launches_by_path)
                (y, sf), (yp, sp) = sd.ssd_scan(*a), sd.ssd_scan_plain(*a)
                path = [k for k, v in sd.ssd_scan.launches_by_path.items()
                        if v != before[k]]
                yl, sl = sd.tolerance(*a)
                ok = bool(((y - yp).abs() <= yl).all()
                          and ((sf - sp).abs() <= sl).all())
                ms = device_ms(lambda: sd.ssd_scan(*a), "ssd_")
                print(f"ssd {name}: {label} x[{n},{a[0].shape[1]},{h},{p}] "
                      f"bf16 path {'/'.join(path)} {ms:.4f} ms, within the "
                      f"limit: {ok}", flush=True)
        finally:
            sd._lib = keep


KERNELS = {"ring": ring, "flash": flash, "matmul": matmul, "rwkv": rwkv,
           "ssd": ssd}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("kernels", nargs="*", default=list(KERNELS),
                    help=f"any of {', '.join(KERNELS)} (default: all)")
    ap.add_argument("--only", nargs="*", default=[],
                    help="variant names to run (default: all)")
    ap.add_argument("--csrc", default=None,
                    help="build the variants from this copy of csrc/")
    ap.add_argument("--no-long", action="store_true",
                    help="flash: leave out long_500k's prefill layers")
    ap.add_argument("--shapes", nargs="*", default=[],
                    help="flash: the shapes whose label holds one of these")
    args = ap.parse_args(argv)
    if set(args.kernels) - set(KERNELS):
        ap.error(f"kernels are {', '.join(KERNELS)}, not {args.kernels}")
    if not torch.cuda.is_available():
        raise SystemExit("variants: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    global CSRC, _SOURCE
    if args.csrc:
        CSRC = pathlib.Path(args.csrc).resolve()
        _SOURCE = f" [{args.csrc}]"
    gen = torch.Generator(device="cuda").manual_seed(20170701)
    for name, run in KERNELS.items():
        if name in args.kernels:
            if name == "flash":
                run(set(args.only), gen, args.no_long, args.shapes)
            else:
                run(set(args.only), gen)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
