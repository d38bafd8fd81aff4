#!/usr/bin/env python3
"""Drive the PyTorch port's tuning loop, its serving paths (dense, SSM and
Mixture-of-Experts) and its training paths (one stacked axis, a data x
model mesh, a pod x data x model mesh, and training through the model
kernels) on one CUDA card, end to end.

    python3 chip_smoke.py [--out DIR]

Phases (each raises on failure; nothing is caught):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build the kernels from the sources in the checkout (set-up time):
   one ``nvcc`` each for the block matmul, the all-gather-matmul ring,
   flash attention, the RWKV6 scan and the SSD scan, and the Triton JIT
   for guideline_pack, quant_pack and dequant_unpack, all started
   together;
3. each kernel against its plain PyTorch version at the slice's shapes and
   at ragged shapes: max error, tolerance, the kernel's device time
   (``torch.profiler``, the ms of record) beside the events mean over
   back-to-back calls, plain ms, the bound, and the device time of the one
   PyTorch call that computes the same function, where there is one;
   ``block_matmul`` at the main path's four ring-step shapes (MLP-down,
   attn-out, the K/V accumulate at 4096 and 512 rows) and ragged ones,
   with the path each call took (``wgmma``, ``wmma``, ``f32``); the
   ring's block tier (kernel 4) for every rank; the wire
   kernels' q bytes, scales and dequantized values bit for bit, also at
   the replay's width-1 allgather payload and the K/V weight block;
   flash attention at the serve path's prefill and decode shapes, the TPU
   kernel's test cases and ragged lengths, with
   ``scaled_dot_product_attention`` as the library time, and three planted
   faults (the causal edge or the filled length off by one, the first
   128-key block dropped) that its elementwise limit must reject, and at
   zamba2's shared-attention shape (dh 64, 4 heads and 4 KV heads per
   rank) and phi3.5-moe's (dh 128, 4 q heads over 1 KV head per rank:
   its prefill on ``wgmma``, every decode step's length on ``split_kv``);
   each kernel's path counts (the ring's ``wgmma``/``wmma``/``f32``,
   flash's ``wgmma``/``split_kv``/``mma_sync``/``f32``); the ring's and
   flash's times both as the events mean over back-to-back calls (each
   ring call reads the error words back, a host round trip; a decode call
   is shorter than its host time) and as the kernel's device time from
   ``torch.profiler``, which is their ``ms`` in the kernels line;
   ``block_matmul`` also at the 2-D ring's chunk shapes of phase 13
   (forward and transpose, at w_o and MLP-down, all on ``wgmma``); the
   two scans (``rwkv6_scan``, ``ssd_scan``) at the SSM serves' prefill
   and decode (S = 1 from a non-zero state), the TPU kernels' test cases
   (with the strong decay) and ragged lengths, held to their elementwise
   limits, with planted faults (the inter-chunk state carry dropped, the
   bonus u left out, the mask's diagonal dropped, the ragged last row left
   out) that must fail them; each scan's prefill on its ``chunked`` path,
   its decode on its ``decode`` path (also in place), and ``ssd_scan`` at
   the TPU kernel's shapes on its ``general`` path, each call's path
   printed;
4. ``selfcheck`` of every one-axis impl (59) at p = 8 and p = 6, with
   the wire tolerance gate's demotions, and its two-axis run on a (2, 4)
   stacked mesh: every one-axis impl on each axis, the ``MPIX_*`` impls
   and both 2-D impls in both directions, all 64 impls;
5. fit an ``h100-stacked`` Topo from ``sweep_axis`` (alpha, beta, gamma),
   with ``quant_bw`` from quant_pack's phase-3 rate;
6. ``tune()`` with the measured backend at p = 8 over the flat ops, and the
   fused ops at llama3.2-3b's GEMM widths (``matmul_accumulate`` at its
   K/V projection); save and reload the profiles; then the tuning CLI
   (``examples/torch_tune_collectives.py``, ``--backend measured
   --axis-size 8``) writes its Listing-1 profiles, timed;
7. record one llama3.2-3b sequence-parallel block (d_model 3072, d_ff
   8192, 4096 tokens, p = 8 ranks stacked on the card) under the tuned
   profiles as a Trace;
8. replay it with ``tune_trace`` (measured backend), run the block again
   under the new profiles and under the CLI's reloaded profiles, check
   both against the default impls, print the
   ``#@pgmpi`` footer, and force ``allgather_as_allreduce``, the three
   ``fused_ring`` impls, ``wire_q8`` on the allgather and ``wire_fp8`` on
   the gate/up allgather-matmul once, so every kernel runs whatever the
   tuner picked; print ``fused_ring`` against ``default`` at the gate/up
   cell and the impl ``tune_trace`` picked there; then, after the main
   path's counts, the two-axis cells of phase 13 on the (2, 4) mesh, each
   impl the median of NREP samples: the 2-D cells of w_o and MLP-down,
   forward and transpose, ``fused_ring2d`` against ``default``, and one
   hierarchical cell per op, ``MPIX_*`` against ``default``;
9. ``torch.profiler`` over one call of the allgather and matmul_accumulate
   impls at the block's shapes: host time, and device time by kernel;
10. serve llama3.2-3b at full width (28 layers, TP p = 8 stacked on the
   card, ``attn_impl="flash"``, random weights from a seeded generator):
   4 requests of 1024 prompt tokens, the prefill's token and 32 greedy
   decode steps, a 2048-slot KV cache.  Serve under the defaults while
   recording the trace, ``tune_trace`` it with the measured backend, save
   and reload the per-phase profiles, serve again under them, and hold
   the second serve's logits to the first's; then ``torch.profiler`` over
   one prefill and one decode step for flash attention's device share;
11. the same serve for rwkv6-3b (32 RWKV6 layers, 40 heads of 64: 5 per
   rank) and zamba2-1.2b (38 Mamba2 layers, d_inner 4096 = 64 heads of
   64, state 64, and one shared attention block after every 6, each
   occurrence with its own KV cache), at full width with the same
   requests, each followed by a state-carry check: float32 weights, 2
   layers, prefill(S - 1) + decode(1) against the full forward at the
   last position, through the kernels;
12. train llama3.2-3b at full width, cut to ``TRAIN_LAYERS`` layers (bf16,
   AdamW, ``attn_impl="ref"``, random weights from a seeded generator):
   (a) FSDP over p = 8 stacked data ranks, 8 x 1024 tokens from
   ``make_batch``, 2 warm-up and 5 timed steps (median step ms, tokens/s,
   peak memory, each step's loss, the dispatches of a step per op and
   phase) and one step under ``torch.profiler`` (device busy share);
   (b) record one step's gradients, ``tune_trace`` its fwd and bwd
   phases with the measured backend (the quantized wire held out: it is
   approximate), save and reload the per-phase profiles and take the
   same gradients under them; (c) the same gradients with
   ``TRAIN_FORCE`` (``fused_ring`` on the three fused ops,
   ``allgather_as_allreduce``): ``block_matmul``, the ring and
   ``guideline_pack`` must launch and ``fused_ring`` must serve the bwd
   phase; (b) and (c) must match the default gradients within
   ``TRAIN_RTOL``; (e) save a checkpoint of (a)'s state, take the next
   step, restore the checkpoint into a fresh trainer and take the same
   step: the same loss; (d) TP over p = 8 stacked model ranks, 2 x 1024
   tokens, 2 steps and a forced step (``allreduce_as_rsb_allgather``
   besides) within ``TRAIN_RTOL``;
13. train the same model on the (data 2, model 4) mesh stacked on the
   card, 2 x 1024 tokens a data rank: (a) the default step (median of 5
   after 2 warm-up, tokens/s, peak memory, device busy share, dispatches
   by op and phase); (b) ``tune_trace`` of one step's fwd and bwd phases
   (measured, every cell at its own world), the per-phase profiles saved,
   reloaded and trained on; (c) a forced step (``MESH_FORCE``:
   ``fused_ring2d`` both directions and the 1-D fused rings) and the
   standalone 2-D pair at w_o, whose dx runs the ring; (b) and (c) within
   ``TRAIN_RTOL`` of the default gradients; (d) a checkpoint of (a)'s
   state restored into a fresh trainer gives the same loss bit for bit;
   (e) one step on the (2, 2, 2) pod x data x model mesh with each cell
   stamped with its axis's tier, whose footer lists the cross-pod
   all-reduces (one per leaf in bwd);
14. train through the kernels' autograd Functions: each Function at the
   training shapes against autograd through its plain version (output
   within the kernel's ``tolerance``, input gradients within that limit
   max-norm relative); (a) llama3.2-3b with ``attn_impl="flash"`` in
   phase 12's FSDP layout, timed beside phase 12's ``ref`` step, its loss
   and gradients within ``TRAIN_RTOL`` of the ``ref`` step's from the same
   weights and batch; (b) rwkv6-3b (8 of 32 layers) and (c) zamba2-1.2b
   (12 of 38 layers: two hybrid periods, so the shared flash block trains
   twice) at full width, TP over 4 stacked model ranks, 2 x 1024 tokens,
   timed in bf16, then in float32 each kernel call's output within its
   tolerance of its plain version at the model's inputs, and the loss and
   gradients within ``TRAIN_RTOL`` of the same step taken through the
   plain versions under autograd with each call's value pinned to the
   kernel's (the unpinned plain step read beside it);
15. serve phi3.5-moe-42b-a6.6b at full width, cut to ``MOE_LAYERS`` = 16
   of 32 layers (16 experts of d_ff 6400, top-2, capacity factor 1.25;
   TP p = 8 stacked: 2 experts a rank, both all-to-alls of every MoE block
   dispatched; flash; phase 10's requests): (a) the default serve,
   recording, with rank 0's routes probed (``RouteProbe``); ``tune_trace``
   of its trace with the measured backend, the alltoall cells' default
   and mock-up times printed, the per-phase profiles saved and reloaded;
   (b) the tuned re-serve, probed, and its ``#@pgmpi`` footer with the
   alltoall picks: every route that changed between the two serves must
   have been a near-tie in the default serve, and the logits of every
   request that no changed route reached are held to ``SERVE_RTOL``
   (``route_changes``, ``check_held``); (c) the default serve again,
   unprobed (its times are the ones of record): logits bit-equal to
   (a)'s; (d) the serve with alltoall forced to ``alltoall_as_ppermute``:
   logits bit-equal to (a)'s; (e) the router readings: prefill-only
   serves, probed, with allreduce forced to each of ``MOE_REORDERS``
   (other rounding orders move the router, so near-ties among the routes
   may flip), each held like (b), to each of ``MOE_LOSSY`` (read only),
   and to a planted wrong allreduce, whose move the bound
   ``ROUTE_MOVE_BOUND`` must reject; choices dropped over capacity per layer at prefill, peak
   memory, ``torch.profiler`` over one prefill and one decode step; then
   ``moe_block`` in float32 at the prefill shape on the card against the
   same call on the CPU, on tokens that drop choices (the same expert
   ids and kept choices, outputs within ``MOE_CHECK_RTOL``).

Kernel launch counts are zeroed just before phase 6 and read after each of
phases 6-8; every kernel of the main path must have launched in the tune,
replay and dispatch phases, every launch of the ring on the main path
must take its ``wgmma`` path, and so must every ``block_matmul`` launch
that TMA can address (the tuner's NREP probes scale a matmul_accumulate
cell down to a contraction of 1 row, which keeps ``wmma``; the log lists
those launches by depth).  The ring's block tier is not on the main
path: its launches are those of phase 3.  They are zeroed again just
before each serve path (phases 10 and 11) and read after each serve:
each model kernel must launch once per block of its kind and forward:
flash attention 28 x 33 times a llama3.2-3b serve and 6 x 33 times a
zamba2-1.2b serve, ``rwkv6_scan`` 32 x 33 times a rwkv6-3b serve (32
``chunked`` prefills, 32 x 32 ``decode`` steps),
``ssd_scan`` 38 x 33 times a zamba2-1.2b serve (38 ``chunked``, 38 x 32
``decode``, none ``general``), and no other; flash's
prefill launches (one per attention block) must take its ``wgmma`` path
and its decode launches its ``split_kv`` path.  They are zeroed again just before
the train path (phase 12) and read after it: ``block_matmul``, the ring
and ``guideline_pack`` must have launched in its forced step; each
row of the kernels line carries its ``train_launches``.  They are zeroed
again just before the mesh train path (phase 13) and read after it:
``block_matmul`` (all ``wgmma``) and ``guideline_pack`` must have
launched in its forced step, and ``block_matmul`` and the ring in the
standalone 2-D pair; each row carries its ``mesh_train_launches``.  They
are zeroed again just before phase 14's path (after its per-Function
checks) and read after it: flash attention on ``wgmma``, ``rwkv6_scan``
and ``ssd_scan`` on ``chunked`` must launch inside the timed steps and
inside each checked step; each row carries its
``kernel_train_launches``.  They are zeroed again just before the MoE
serve path (phase 15) and read around each of its four serves: flash
attention must launch 16 x 33 times a serve, 16 on ``wgmma`` (the
prefill) and 16 x 32 on ``split_kv``; each row carries its
``moe_serve_launches``.  The
ranks are stacked on ONE card: a ring hop is a device-memory copy, so
the times measure on-chip data movement and launch overhead, not a link
between GPUs, and both tiers of a two-axis mesh are the same memory.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  With no CUDA device, or without the
``src/repro_torch`` package beside this script, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import math
import os
import pathlib
import shutil
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
KV = 8 * HEAD_DIM          # the K (or V) projection's width: 8 KV heads
TUNE_SIZES = (1, 1024, 32768, 1_048_576, 16_777_216)
# the serve path: llama3.2-3b at full width, TP P stacked (3 q heads and 1
# KV head per rank); 4 requests of 1024 prompt tokens, the prefill's token
# and 32 greedy decode steps, a 2048-slot KV cache
SERVE_BATCH, SERVE_PROMPT, SERVE_DECODE, SERVE_SLOTS = 4, 1024, 32, 2048
# the SSM serves (rwkv6-3b: 40 heads of 64; zamba2-1.2b: d_inner 4096 = 64
# heads of 64, state 64, and its shared block's 32 heads of 64) and the
# scans' chunks (kernels/rwkv6_scan.py, kernels/ssd_mamba2.py)
RWKV_HEADS, ZAMBA_HEADS, RWKV_CHUNK, SSD_CHUNK = 40, 64, 32, 64
ZAMBA_ATTN_HEADS = 32
# the state-carry check: 2 requests, a prompt of CARRY_PROMPT - 1 tokens (not
# a multiple of either chunk) then one decode step, against the full forward
# over CARRY_PROMPT tokens, float32 weights: the two differ in summation
# order only (other chunk boundaries in the scans, other GEMM shapes), ~1e-6
# relative per layer; a wrong s0 or s_fin moves the last logits by O(1)
CARRY_PROMPT, CARRY_RTOL = 1000, 1e-3
# the re-served logits against the default serve's, max-norm relative: a
# tuned allreduce adds the p = 8 bf16 partial sums in another order (up to
# p - 1 roundings where the default rounds once, 2**-8 each) at each of the
# 57 allreduces of a forward; the JAX package holds its own two attention
# paths to 2e-2 (tests/test_models_smoke.py:101-104)
SERVE_RTOL = 5e-2
# the train path (phase 12): llama3.2-3b at full width, bf16, AdamW,
# attn_impl "ref", cut in depth only (PERF.md section 4 reckons the memory:
# the stacked axis keeps p = 8 gathered copies of every weight a layer saves
# for its backward).  FSDP over p = 8 data ranks stacked: 8 x 1024 tokens,
# one sequence a rank; 2 warm-up and 5 timed steps, one profiled step.  TP
# over p = 8 model ranks: 2 x 1024 tokens (activations replicated p times),
# 2 steps.
TRAIN_LAYERS = 8
TRAIN_BATCH, TRAIN_SEQ, TRAIN_TP_BATCH = 8, 1024, 2
TRAIN_WARMUP, TRAIN_STEPS, TRAIN_TP_STEPS = 2, 5, 2
# a tuned or forced step's loss and each gradient leaf against the default
# step's, max-norm relative: p roundings of 2**-7 (one bf16 step) for a ring
# that adds p partial sums where the default rounds once (section 2)
TRAIN_RTOL = P * 2 ** -7
# the measured replay of a recorded cell holds its operand on the card
# beside the trained state; a reduce-scatter's replay is p times its
# recorded payload (a cell's bytes are the per-rank input, which the bench
# takes as the per-chunk payload, as the JAX package does): the embedding
# gradient's 788 MB a rank would need 50 GB.  Cells whose replayed operand
# passes this cap are not tuned (logged) and keep the default.
TRAIN_REPLAY_CAP = 8e9
TRAIN_FORCE = {"allgather_matmul": "fused_ring",
               "matmul_reducescatter": "fused_ring",
               "matmul_accumulate": "fused_ring",
               "allgather": "allgather_as_allreduce"}
# the data x model train path (phase 13): the (data 2, model 4) mesh
# stacked on the card, 2 x 1024 tokens a data rank (4 x 1024 a step), the
# same depth, dtype and optimizer as phase 12; the forced step adds the 2-D
# ring (both directions) to TRAIN_FORCE.  The row-parallel sites (w_o, the
# MLP's w_out) run matmul_reducescatter_2d: x [T, K] a lane, T = 2048,
# against its weight block [K, D_MODEL / 2], K = 768 (w_o) or 2048
MESH_D, MESH_Q = 2, 4
MESH_BATCH = 4
MESH_T = MESH_BATCH // MESH_D * TRAIN_SEQ
MESH_FORCE = dict(TRAIN_FORCE, matmul_reducescatter_2d="fused_ring2d")
MESH_SITES = {"w_o": HEADS * HEAD_DIM // MESH_Q, "mlp-down": D_FF // MESH_Q}
# the pod step of phase 13: the JAX package's three-axis mesh, pod x data x
# model, 8 lanes, parameters replicated over pod
POD_MESH = (2, 2, 2)


def log(*a):
    print(*a, flush=True)


def _example(name: str):
    """The module of ``examples/<name>.py`` (a script, not a package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


def main_path_kernels(pack, cmm, rdma, quant) -> dict:
    """The wrappers of the kernels the main path runs, by name."""
    return {"guideline_pack": pack.guideline_pack,
            "block_matmul": cmm.block_matmul,
            "ring_allgather_matmul_rdma": rdma.ring_allgather_matmul_rdma,
            "quant_pack": quant.quant_pack,
            "dequant_unpack": quant.dequant_unpack}


def counts(wrappers: dict) -> dict:
    return {k: f.launches for k, f in wrappers.items()}


def zero_counts(wrappers: dict) -> None:
    for f in wrappers.values():
        f.launches = 0
        if hasattr(f, "launches_by_path"):
            f.launches_by_path = dict.fromkeys(f.launches_by_path, 0)


def path_delta(fn, before: dict) -> dict:
    """The launches of ``fn`` by path since the snapshot ``before``."""
    return {k: v - before.get(k, 0) for k, v in fn.launches_by_path.items()}


def require_launched(phase: str, before: dict, after: dict) -> dict:
    delta = {k: after[k] - before[k] for k in after}
    log(f"[{phase}] kernel launches: {json.dumps(delta)}")
    missing = [k for k, v in delta.items() if v <= 0]
    if missing:
        raise RuntimeError(f"{phase}: kernels never launched: {missing}")
    return delta


def profile_call(torch, label: str, fn, tag: str = "9",
                 needles: tuple = ()) -> dict:
    """Host time of one call of ``fn`` and its device time by kernel name,
    from ``torch.profiler``; with ``needles``, also the share of the
    device time spent in kernels whose name contains each (returned)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    log(f"[{tag}] {label}: host {host:.4f} ms, device busy {busy:.4f} ms in "
        f"{sum(e.count for e in rows)} kernels")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[{tag}]   {e.self_device_time_total / 1e3:9.4f} ms "
            f"x{e.count:4d} {e.key[:90]}")
    shares = {}
    for needle in needles:
        mine = sum(e.self_device_time_total for e in rows
                   if needle in e.key) / 1e3
        shares[needle] = mine / busy if busy else float("nan")
        log(f"[{tag}] {label}: {needle} {mine:.4f} ms = "
            f"{100 * shares[needle]:.2f} % of the device time")
    return shares


def flash_work(n, sq, hk, g, dh, q0, kv_len, causal, window, itemsize):
    """(operations, bytes) that one flash-attention call's data needs: 4·dh
    per visible (query, key) pair (QK^T and PV), and q, out and the keys
    and values some query sees, each moved once."""
    pairs, lo_all, hi_all = 0, kv_len, 0
    for i in range(sq):
        qpos = q0 + i
        hi = min(kv_len, qpos + 1) if causal else kv_len
        lo = max(0, qpos - window + 1) if window else 0
        if hi > lo:
            pairs += hi - lo
            lo_all, hi_all = min(lo_all, lo), max(hi_all, hi)
    keys = max(0, hi_all - lo_all)
    flops = 4 * dh * pairs * n * hk * g
    byts = (2 * n * sq * hk * g * dh + 2 * n * keys * hk * dh) * itemsize
    return flops, byts


def check_flash(torch, fa, randn) -> dict:
    """Phase 3 for flash attention: the kernel against its plain version at
    the serve path's shapes, the TPU kernel's test cases and ragged
    lengths; times, bound and ``scaled_dot_product_attention`` at the
    prefill and decode shapes.  Returns the kernels-line record (prefill)
    and the decode numbers."""
    from repro_torch.kernels.variants import device_ms
    sdpa = torch.nn.functional.scaled_dot_product_attention
    name_dt = {torch.bfloat16: "bfloat16", torch.float32: "float32"}
    last_path = [None]             # the path of the last check's call

    def held(got, q, k, v, **kw):
        """(max |got - plain|, its largest share of the elementwise limit
        ``fa.tolerance``: 3e-5 in float32; in bfloat16 one step of each
        p, 2^-7 of the attention-weighted |v|, and 2^-6 of |out|)."""
        want = fa.flash_attention_plain(q, k, v, **kw)
        diff = (got.float() - want.float()).abs()
        return (float(diff.max()),
                float((diff / fa.tolerance(q, k, v, want, **kw)).max()))

    def check(label, q, k, v, **kw):
        before = dict(fa.flash_attention.launches_by_path)
        got = fa.flash_attention(q, k, v, **kw)
        took = [k_ for k_, n_ in path_delta(fa.flash_attention,
                                            before).items() if n_]
        last_path[0] = took[0] if len(took) == 1 else str(took)
        err, share = held(got, q, k, v, **kw)
        if tuple(got.shape) != tuple(q.shape) or not share <= 1.0 or not bool(
                torch.isfinite(got.float()).all()):
            raise RuntimeError(f"flash_attention {label}: error {err} is "
                               f"{share:.3f} of the limit")
        return err, share

    def planted(label, q, k, v, bad, **kw):
        """The limit must reject the kernel run with a fault's arguments
        ``bad`` against the plain version with the right ones."""
        err, share = held(fa.flash_attention(q, k, v, **bad), q, k, v, **kw)
        log(f"[3] flash_attention planted fault, {label}: max_abs_err "
            f"{err:.3e}, {share:.2f} of the limit")
        if not share > 1.0:
            raise RuntimeError(f"flash_attention: the limit passes the "
                               f"planted fault {label}")

    def timed(label, q, k, v, lib, **kw):
        err, share = check(label, q, k, v, **kw)
        n, sq, hk, g, dh = q.shape
        flops, byts = flash_work(n, sq, hk, g, dh, kw.get("q0", 0),
                                 kw.get("kv_len") or k.shape[1],
                                 kw.get("causal", True), kw.get("window", 0),
                                 q.element_size())
        t_b, t_f = byts / H100_BYTES_PER_S, flops / H100_FLOPS[
            name_dt[q.dtype]]
        # the kernel's device time (torch.profiler) is the ms of record;
        # the events mean over back-to-back calls also holds the host
        # time of each call, which a decode launch does not hide
        events_ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, **kw))
        rec = dict(
            name="flash_attention", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:88",
            max_abs_err=err,
            ms=device_ms(lambda: fa.flash_attention(q, k, v, **kw),
                         "fa_"),
            plain_ms=time_ms(torch, lambda: fa.flash_attention_plain(
                q, k, v, **kw), iters=5),
            bound_ms=max(t_b, t_f) * 1e3,
            bound_by="bytes" if t_b > t_f else "operations",
            library_ms=time_ms(torch, lib))
        rec["path"] = last_path[0]
        rec["events_ms"] = events_ms
        log(f"[3] flash_attention {label} q{list(q.shape)} k{list(k.shape)} "
            f"{name_dt[q.dtype]} {kw} path {rec['path']}: max_abs_err "
            f"{err:.3e} ({share:.3f} of the limit) kernel device time "
            f"{rec['ms']:.4f} ms (events mean {events_ms:.4f} ms) plain "
            f"{rec['plain_ms']:.4f} ms "
            f"scaled_dot_product_attention {rec['library_ms']:.4f} ms bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}: {flops / 1e9:.2f} "
            f"GFLOP, {byts / 1e6:.2f} MB) = {flops / rec['ms'] / 1e9:.1f} "
            f"TFLOP/s, {byts / rec['ms'] / 1e6:.1f} GB/s")
        return rec

    n_fold, g_loc = P * SERVE_BATCH, HEADS // P       # 32 rows, 3 q heads
    # the serve path's prefill: every rank's 4 x 1024 tokens in one launch
    q = randn(n_fold, SERVE_PROMPT, 1, g_loc, HEAD_DIM)
    k = randn(n_fold, SERVE_PROMPT, 1, HEAD_DIM)
    v = randn(n_fold, SERVE_PROMPT, 1, HEAD_DIM)
    qb = q.permute(0, 2, 3, 1, 4).reshape(n_fold, g_loc, SERVE_PROMPT,
                                          HEAD_DIM)
    kb, vb = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    prefill = timed("serve prefill", q, k, v,
                    lambda: sdpa(qb, kb, vb, is_causal=True,
                                 enable_gqa=True), causal=True)
    # its decode: one token per request against the filled part of a
    # 2048-slot cache, kv_len 1025 ... 1056
    q1 = randn(n_fold, 1, 1, g_loc, HEAD_DIM)
    kc = randn(n_fold, SERVE_SLOTS, 1, HEAD_DIM)
    vc = randn(n_fold, SERVE_SLOTS, 1, HEAD_DIM)
    worst = (0.0, 0.0)
    for kv_len in range(SERVE_PROMPT + 1, SERVE_PROMPT + SERVE_DECODE + 1):
        worst = tuple(map(max, worst, check(
            f"decode kv_len {kv_len}", q1, kc, vc, q0=kv_len - 1,
            kv_len=kv_len)))
    log(f"[3] flash_attention serve decode q{list(q1.shape)} "
        f"k{list(kc.shape)} bf16, kv_len {SERVE_PROMPT + 1}..."
        f"{SERVE_PROMPT + SERVE_DECODE} path {last_path[0]}: max_abs_err "
        f"{worst[0]:.3e} ({worst[1]:.3f} of the limit)")
    # the limit is fine enough to see the faults it guards against: the
    # causal edge one key late, the first 128-key block (the prefill
    # kernel's block width) dropped for the last rows, the last filled
    # slot left out
    planted("causal edge one key late", q, k, v, dict(q0=1))
    planted("first 128-key block dropped for the last rows", q, k, v,
            dict(window=SERVE_PROMPT - 128))
    planted("last filled slot left out", q1, kc, vc,
            dict(q0=SERVE_PROMPT, kv_len=SERVE_PROMPT),
            q0=SERVE_PROMPT, kv_len=SERVE_PROMPT + 1)
    decode = {}
    for kv_len in (SERVE_PROMPT + 1, SERVE_PROMPT + SERVE_DECODE):
        q1b = q1.reshape(n_fold, g_loc, 1, HEAD_DIM)
        kcb = kc[:, :kv_len].transpose(1, 2)
        vcb = vc[:, :kv_len].transpose(1, 2)
        decode[kv_len] = timed(
            f"serve decode kv_len {kv_len}", q1, kc, vc,
            lambda: sdpa(q1b, kcb, vcb, enable_gqa=True), q0=kv_len - 1,
            kv_len=kv_len)
    # the TPU kernel's test cases (tests/test_kernels.py:22-70), through
    # its layout [B, H, S, dh]
    for dt in (torch.float32, torch.bfloat16):
        for b, hq, hkv, s_, d in ((1, 2, 2, 128, 64), (2, 4, 2, 256, 64),
                                  (1, 8, 1, 128, 128), (1, 2, 2, 192, 32)):
            qm, km, vm = fa.to_model_layout(randn(b, hq, s_, d, dtype=dt),
                                            randn(b, hkv, s_, d, dtype=dt),
                                            randn(b, hkv, s_, d, dtype=dt))
            err, share = check("pallas case", qm, km, vm)
            log(f"[3] flash_attention TPU-test case B{b} Hq{hq} Hkv{hkv} "
                f"S{s_} dh{d} {name_dt[dt]}: max_abs_err {err:.3e} "
                f"({share:.3f} of the limit)")
    for window, cap, sc in ((32, 0.0, 1.0), (64, 0.0, 1.0), (100, 0.0, 1.0),
                            (0, 30.0, 4.0)):
        s_ = 128 if cap else 256
        qm, km, vm = fa.to_model_layout(
            randn(1, 2, s_, 64, dtype=torch.float32, scale=sc),
            randn(1, 2, s_, 64, dtype=torch.float32, scale=sc),
            randn(1, 2, s_, 64, dtype=torch.float32))
        err, share = check("pallas window/softcap", qm, km, vm,
                           window=window, softcap=cap)
        log(f"[3] flash_attention TPU-test case window {window} softcap "
            f"{cap} float32: max_abs_err {err:.3e} ({share:.3f} of the "
            f"limit)")
    # ragged: a 1000-token prefill, a decode at kv_len 777, a head dim that
    # is not a multiple of 8 (element-wise loads)
    for label, shapes, dt, kw in (
            ("ragged prefill", ((4, 1000, 1, 3, 128), (4, 1000, 1, 128)),
             torch.bfloat16, {}),
            ("ragged decode", ((8, 1, 2, 3, 128), (8, 1000, 2, 128)),
             torch.bfloat16, dict(q0=776, kv_len=777)),
            ("ragged head dim", ((2, 33, 1, 3, 40), (2, 33, 1, 40)),
             torch.float32, dict(window=9))):
        err, share = check(label, randn(*shapes[0], dtype=dt),
                         randn(*shapes[1], dtype=dt),
                         randn(*shapes[1], dtype=dt), **kw)
        log(f"[3] flash_attention {label} q{list(shapes[0])} "
            f"k{list(shapes[1])} {name_dt[dt]} {kw}: max_abs_err {err:.3e} "
            f"({share:.3f} of the limit)")
    # zamba2-1.2b's shared attention at TP 8: 4 heads and 4 KV heads of 64
    # per rank (G = 1), its prefill and decode in the 2048-slot cache
    hz = ZAMBA_ATTN_HEADS // P
    qz, kz, vz = (randn(n_fold, SERVE_PROMPT, hz, *d)
                  for d in ((1, 64), (64,), (64,)))
    err, share = check("zamba2 prefill", qz, kz, vz)
    zamba_ms = device_ms(lambda: fa.flash_attention(qz, kz, vz), "fa_")
    log(f"[3] flash_attention zamba2 shared block prefill q{list(qz.shape)} "
        f"k{list(kz.shape)} bf16 causal path {last_path[0]}: max_abs_err "
        f"{err:.3e} ({share:.3f} of the limit) kernel device time "
        f"{zamba_ms:.4f} ms")
    q1z = randn(n_fold, 1, hz, 1, 64)
    kcz, vcz = (randn(n_fold, SERVE_SLOTS, hz, 64) for _ in range(2))
    for kv_len in (SERVE_PROMPT + 1, SERVE_PROMPT + SERVE_DECODE):
        kw = dict(q0=kv_len - 1, kv_len=kv_len)
        err, share = check(f"zamba2 decode kv_len {kv_len}", q1z, kcz, vcz,
                           **kw)
        zd_ms = device_ms(lambda: fa.flash_attention(q1z, kcz, vcz,
                                                            **kw), "fa_")
        log(f"[3] flash_attention zamba2 shared block decode "
            f"q{list(q1z.shape)} k{list(kcz.shape)} kv_len {kv_len} path "
            f"{last_path[0]}: max_abs_err {err:.3e} ({share:.3f} of the "
            f"limit) kernel device time {zd_ms:.4f} ms")
    # phi3.5-moe-42b-a6.6b's attention at TP 8 (the MoE serve, phase 15):
    # 4 q heads over 1 KV head of 128 per rank (G = 4), its prefill on the
    # wgmma path and every decode step's kv_len on split_kv
    from repro_torch.configs import get_config
    mc = get_config(MOE_ARCH)
    hk_m, g_m = mc.n_kv_heads // P, mc.n_heads // mc.n_kv_heads

    def on_path(label, want):
        if last_path[0] != want:
            raise RuntimeError(f"flash_attention {label}: path "
                               f"{last_path[0]}, not {want}")

    qm, km, vm = (randn(n_fold, SERVE_PROMPT, hk_m, *d)
                  for d in ((g_m, mc.hd), (mc.hd,), (mc.hd,)))
    err, share = check("phi3.5 prefill", qm, km, vm)
    on_path("phi3.5 prefill", "wgmma")
    moe_ms = device_ms(lambda: fa.flash_attention(qm, km, vm), "fa_")
    log(f"[3] flash_attention phi3.5-moe prefill q{list(qm.shape)} "
        f"k{list(km.shape)} bf16 causal path {last_path[0]}: max_abs_err "
        f"{err:.3e} ({share:.3f} of the limit) kernel device time "
        f"{moe_ms:.4f} ms")
    q1m = randn(n_fold, 1, hk_m, g_m, mc.hd)
    kcm, vcm = (randn(n_fold, SERVE_SLOTS, hk_m, mc.hd) for _ in range(2))
    worst = (0.0, 0.0)
    for kv_len in range(SERVE_PROMPT + 1, SERVE_PROMPT + SERVE_DECODE + 1):
        label = f"phi3.5 decode kv_len {kv_len}"
        worst = tuple(map(max, worst, check(label, q1m, kcm, vcm,
                                            q0=kv_len - 1, kv_len=kv_len)))
        on_path(label, "split_kv")
    log(f"[3] flash_attention phi3.5-moe decode q{list(q1m.shape)} "
        f"k{list(kcm.shape)} bf16, kv_len {SERVE_PROMPT + 1}..."
        f"{SERVE_PROMPT + SERVE_DECODE} path {last_path[0]}: max_abs_err "
        f"{worst[0]:.3e} ({worst[1]:.3f} of the limit)")
    return {"prefill": prefill, "decode": decode, "zamba2_prefill_ms":
            zamba_ms, "moe_prefill_ms": moe_ms}


def rwkv_work(n, s, h, hd, itemsize, with_s0):
    """(operations, bytes) of one rwkv6_scan call: per chunk of Lc rows and
    (n, h), 3·hd per pair s < t (r·k·exp, its sum) and per bonus row, and
    one exp per pair and channel; 2·hd² per row (the inter-chunk
    product), 2·hd per pair s <= t (A·v) and 2·hd² per row for the state
    update.  Bytes: r, k, v in their type, w and y in float32, u, and s0
    and s_fin where there is an s0 (s_fin always written)."""
    ops = 0
    for c0 in range(0, s, RWKV_CHUNK):
        lc = min(RWKV_CHUNK, s - c0)
        pairs = lc * (lc - 1) // 2
        ops += (4 * hd * pairs + 3 * hd * lc + 2 * hd * hd * lc
                + 2 * hd * (pairs + lc) + 2 * hd * hd * lc)
    ops *= n * h
    byts = (n * s * h * hd * (3 * itemsize + 4 + 4) + P * h * hd * 4
            + n * h * hd * hd * 4 * (2 if with_s0 else 1))
    return ops, byts


def ssd_work(n, s, h, p_, ns, itemsize, with_s0, cb_per_head=False):
    """(C·Bᵀ operations, the other operations, bytes) of one ssd_scan
    call: per chunk of Lc rows, 2·Ns per pair s <= t (C·Bᵀ) once per row n
    (B and C are shared by its heads; ``cb_per_head``: once per (n, h),
    the count of PRs 15-17), and per (n, h) one exp per pair, 2·P per pair
    (M·xb) and 2·Ns·P per row twice (the inter-chunk term, the state
    update), float32.  Bytes: x, B and C in their type (B and C once per
    row), dt and y in float32, and s0 / s_fin."""
    cb = ops = 0
    for c0 in range(0, s, SSD_CHUNK):
        lc = min(SSD_CHUNK, s - c0)
        pairs = lc * (lc + 1) // 2
        cb += 2 * ns * pairs * (h if cb_per_head else 1)
        ops += h * (pairs + 2 * p_ * pairs + 4 * ns * p_ * lc)
    byts = (n * s * (h * p_ * itemsize + 2 * ns * itemsize + h * 4
                     + h * p_ * 4)
            + n * h * ns * p_ * 4 * (2 if with_s0 else 1))
    return n * cb, n * ops, byts


def ssd_bound(work, bc_dtype):
    """(bound_ms, bound_by) of ``ssd_work``: the largest of the bytes over
    the memory rate, C·Bᵀ over the peak rate of B's and C's type (products
    of two bf16 are exact in float32, so the kernel forms them on the
    tensor cores) and the rest over the float32 rate."""
    cb, ops, byts = work
    t_b = byts / H100_BYTES_PER_S
    t_f = max(cb / H100_FLOPS[str(bc_dtype).removeprefix("torch.")],
              ops / H100_FLOPS["float32"])
    return max(t_b, t_f) * 1e3, "bytes" if t_b > t_f else "operations"


def check_scans(torch, rw, ssd, randn, dev) -> dict:
    """Phase 3 for the two scans: each kernel against its plain version,
    held to its elementwise limit (``rwkv6_scan.tolerance``,
    ``ssd_mamba2.tolerance``: 2^-20·(hd + L, or L + Ns) plus 2^-20·L·the
    largest log-decay, times the sum of the terms' absolute values), at the
    serve path's prefill and decode (S = 1 from the prefill's non-zero
    final state), the TPU kernels' test cases (with the strong decay), a
    ragged length, and four planted faults that the limit must reject.
    Returns the kernels-line records (serve prefill) with the kernels'
    device times (torch.profiler), the events means beside them."""
    from repro_torch.kernels.variants import device_ms
    g = torch.Generator(device=dev).manual_seed(SEED + 1)

    def uni(*shape, lo=0.0, hi=1.0):
        return torch.rand(*shape, generator=g, device=dev) * (
            hi - lo) + lo

    def held(label, fn, plain, lim, ins, quiet=False, path=None):
        before = dict(fn.launches_by_path)
        (y, sf), (yp, sp), (yl, sl) = fn(*ins), plain(*ins), lim(*ins)
        took = [k for k, v in path_delta(fn, before).items() if v]
        share = max(float(((y - yp).abs() / yl).max()),
                    float(((sf - sp).abs() / sl).max()))
        err = max(float((y - yp).abs().max()), float((sf - sp).abs().max()))
        if not share <= 1.0 or not bool(torch.isfinite(y).all()):
            raise RuntimeError(f"{label}: error {err} is {share:.3f} of the "
                               "limit")
        if path is not None and took != [path]:
            raise RuntimeError(f"{label}: took the paths {took}, not {path}")
        if not quiet:
            log(f"[3] {label}: path {'/'.join(took)}, max_abs_err {err:.3e} "
                f"({share:.4f} of the limit)")
        return err, (y, sf)

    def planted(label, want, lim, bad):
        share = float(((bad - want).abs() / lim).max())
        log(f"[3] planted fault, {label}: {share:.2f} of the limit")
        if not share > 1.0:
            raise RuntimeError(f"the limit passes the planted fault {label}")

    recs = {}
    # ---- rwkv6_scan: rwkv6-3b at TP 8 stacked, 4 requests -> N = 32 rows,
    # 5 heads of 64 per rank; w = exp(-exp(~N(0, 0.5))) as the model makes
    n, h, hd = P * SERVE_BATCH, RWKV_HEADS // P, 64

    def rwkv_in(s, dt=torch.bfloat16, with_s0=None, nu=P):
        w = torch.exp(-torch.exp(randn(n, s, h, hd, dtype=torch.float32,
                                       scale=0.5)))
        return (randn(n, s, h, hd, dtype=dt), randn(n, s, h, hd, dtype=dt),
                randn(n, s, h, hd, dtype=dt), w,
                randn(nu, h, hd, dtype=torch.float32, scale=0.5), with_s0)

    ins = rwkv_in(SERVE_PROMPT)
    p0 = dict(rw.rwkv6_scan.launches_by_path)
    err, (_, s_fin) = held("rwkv6_scan serve prefill", rw.rwkv6_scan,
                           rw.rwkv6_scan_plain, rw.tolerance, ins)
    p1 = dict(rw.rwkv6_scan.launches_by_path)
    dec = rwkv_in(1, with_s0=s_fin)
    held("rwkv6_scan serve decode (S = 1, s0 = the prefill's state)",
         rw.rwkv6_scan, rw.rwkv6_scan_plain, rw.tolerance, dec)
    took = {label: [k for k in b if b[k] != a[k]] for label, a, b in (
        ("prefill", p0, p1),
        ("decode", p1, dict(rw.rwkv6_scan.launches_by_path)))}
    log(f"[3] rwkv6_scan paths: {json.dumps(took)}")
    if took != {"prefill": ["chunked"], "decode": ["decode"]}:
        raise RuntimeError(f"rwkv6_scan took the paths {took}")
    # the decode step in place, as the cache takes it: the same numbers
    cache = s_fin.clone()
    y_in, _ = rw.rwkv6_scan(*dec[:5], cache, out_state=cache)
    y_out, s_out = rw.rwkv6_scan(*dec)
    if not (torch.equal(y_in, y_out) and torch.equal(cache, s_out)):
        raise RuntimeError("rwkv6_scan decode in place differs")
    flops, byts = rwkv_work(n, SERVE_PROMPT, h, hd, 2, False)
    t_b, t_f = byts / H100_BYTES_PER_S, flops / H100_FLOPS["float32"]
    recs["rwkv6_scan"] = dict(
        name="rwkv6_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/rwkv6_scan.cu",
        replaces="src/repro/kernels/rwkv6_scan.py:81", max_abs_err=err,
        ms=device_ms(lambda: rw.rwkv6_scan(*ins), "rwkv6_chunk"),
        plain_ms=time_ms(torch, lambda: rw.rwkv6_scan_plain(*ins), iters=3),
        bound_ms=max(t_b, t_f) * 1e3,
        bound_by="bytes" if t_b > t_f else "operations", library_ms=None,
        events_ms=time_ms(torch, lambda: rw.rwkv6_scan(*ins)))
    d_ops, d_byts = rwkv_work(n, 1, h, hd, 2, True)
    d_ms = device_ms(lambda: rw.rwkv6_scan(*dec), "rwkv6_decode")
    d_ev = time_ms(torch, lambda: rw.rwkv6_scan(*dec))
    d_bound = max(d_byts / H100_BYTES_PER_S,
                  d_ops / H100_FLOPS["float32"]) * 1e3
    rec = recs["rwkv6_scan"]
    log(f"[3] rwkv6_scan serve prefill r[{n},{SERVE_PROMPT},{h},{hd}] bf16: "
        f"kernel device time {rec['ms']:.4f} ms (events mean "
        f"{rec['events_ms']:.4f} ms) plain {rec['plain_ms']:.4f} ms bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}: {flops / 1e9:.2f} "
        f"GFLOP, {byts / 1e6:.2f} MB) = {flops / rec['ms'] / 1e9:.1f} "
        f"TFLOP/s, {byts / rec['ms'] / 1e6:.1f} GB/s; library none (no "
        f"one-call equivalent)")
    log(f"[3] rwkv6_scan serve decode r[{n},1,{h},{hd}] path decode: kernel "
        f"device time {d_ms:.4f} ms (events mean {d_ev:.4f} ms) bound "
        f"{d_bound:.4f} ms ({d_byts / 1e6:.2f} MB); in place bit-equal")
    recs["rwkv6_decode"] = {"ms": d_ms, "events_ms": d_ev,
                            "bound_ms": d_bound, "path": "decode"}
    # the TPU kernel's cases (tests/test_kernels.py:78-108), its layout
    for bh, s_, d_, decay in ((2, 64, 16, None), (1, 128, 32, None),
                              (3, 96, 64, None), (1, 32, 8, None),
                              (1, 64, 16, 1e-3)):
        r, k, v = (randn(bh, s_, d_, dtype=torch.float32) for _ in range(3))
        w = (torch.full((bh, s_, d_), decay, device=dev) if decay
             else uni(bh, s_, d_, lo=0.4, hi=0.95))
        u = randn(bh, d_, dtype=torch.float32)
        held(f"rwkv6_scan TPU-test case BH{bh} S{s_} hd{d_} w "
             f"{decay or 'in (0.4, 0.95)'}", rw.rwkv6_scan,
             rw.rwkv6_scan_plain, rw.tolerance,
             rw.to_model_layout(r, k, v, w, u) + (None,))
        y, _ = rw.rwkv6_scan_bhsd(r, k, v, w, u)
        yo, _ = rw.rwkv6_ref(r, k, v, w, u)
        if not float((y - yo).abs().max()) <= 2e-4:
            raise RuntimeError("rwkv6_scan differs from the oracle by more "
                               "than the reference test's 2e-4")
    # ragged, from a non-zero state; the planted faults there
    s_r = SERVE_PROMPT - 24
    ins_r = rwkv_in(s_r, with_s0=s_fin)
    _, (y_r, _) = held(f"rwkv6_scan ragged S {s_r} from s0", rw.rwkv6_scan,
                       rw.rwkv6_scan_plain, rw.tolerance, ins_r)
    held("rwkv6_scan ragged S 75 float32 hd 40", rw.rwkv6_scan,
         rw.rwkv6_scan_plain, rw.tolerance,
         (*(randn(3, 75, 2, 40, dtype=torch.float32) for _ in range(3)),
          uni(3, 75, 2, 40, lo=0.3, hi=0.99),
          randn(1, 2, 40, dtype=torch.float32), None))
    want = rw.rwkv6_scan_plain(*ins_r)[0]
    lim = rw.tolerance(*ins_r)[0]
    r_, k_, v_, w_, u_, s0_ = ins_r
    L = rw.CHUNK
    planted("rwkv6_scan inter-chunk state carry dropped", want, lim,
            torch.cat([rw.rwkv6_scan(r_[:, c:c + L], k_[:, c:c + L],
                                     v_[:, c:c + L], w_[:, c:c + L], u_,
                                     s0_ if c == 0 else None)[0]
                       for c in range(0, s_r, L)], 1))
    planted("rwkv6_scan bonus u left out", want, lim, rw.rwkv6_scan(
        r_, k_, v_, w_, torch.zeros_like(u_), s0_)[0])
    last = y_r.clone()
    last[:, -1] = 0
    planted("rwkv6_scan ragged last row left out", want, lim, last)

    # ---- ssd_scan: zamba2-1.2b at TP 8: 8 heads of 64 per rank, state 64;
    # dt = softplus(~N(0, 1)), a = exp(~N(0, 0.5)) as the model makes
    h2, p_, ns = ZAMBA_HEADS // P, 64, 64

    def ssd_in(s, dt=torch.bfloat16, with_s0=None, na=P):
        bc = randn(n, s, 2 * ns, dtype=dt)
        return (randn(n, s, h2, p_, dtype=dt),
                torch.nn.functional.softplus(randn(n, s, h2,
                                                   dtype=torch.float32)),
                torch.exp(randn(na, h2, dtype=torch.float32, scale=0.5)),
                bc[..., :ns], bc[..., ns:], with_s0)

    ins = ssd_in(SERVE_PROMPT)
    err, (_, s_fin) = held("ssd_scan serve prefill", ssd.ssd_scan,
                           ssd.ssd_scan_plain, ssd.tolerance, ins,
                           path="chunked")
    dec = ssd_in(1, with_s0=s_fin)
    held("ssd_scan serve decode (S = 1, s0 = the prefill's state)",
         ssd.ssd_scan, ssd.ssd_scan_plain, ssd.tolerance, dec, path="decode")
    cache = s_fin.clone()
    y_in, _ = ssd.ssd_scan(*dec[:5], cache, out_state=cache)
    y_out, s_out = ssd.ssd_scan(*dec)
    if not (torch.equal(y_in, y_out) and torch.equal(cache, s_out)):
        raise RuntimeError("ssd_scan decode in place differs")
    work = ssd_work(n, SERVE_PROMPT, h2, p_, ns, 2, False)
    cb_flops, flops, byts = work
    bound_ms, bound_by = ssd_bound(work, ins[3].dtype)
    old_flops = sum(ssd_work(n, SERVE_PROMPT, h2, p_, ns, 2, False,
                             cb_per_head=True)[:2])
    recs["ssd_scan"] = dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_mamba2.py:73", max_abs_err=err,
        ms=device_ms(lambda: ssd.ssd_scan(*ins), "ssd_chunk"),
        plain_ms=time_ms(torch, lambda: ssd.ssd_scan_plain(*ins), iters=3),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        events_ms=time_ms(torch, lambda: ssd.ssd_scan(*ins)))
    d_work = ssd_work(n, 1, h2, p_, ns, 2, True)
    d_ms = device_ms(lambda: ssd.ssd_scan(*dec), "ssd_decode")
    d_ev = time_ms(torch, lambda: ssd.ssd_scan(*dec))
    d_bound = ssd_bound(d_work, dec[3].dtype)[0]
    rec = recs["ssd_scan"]
    log(f"[3] ssd_scan serve prefill x[{n},{SERVE_PROMPT},{h2},{p_}] B,C "
        f"[{n},{SERVE_PROMPT},{ns}] bf16: kernel device time {rec['ms']:.4f} "
        f"ms (events mean {rec['events_ms']:.4f} ms) plain "
        f"{rec['plain_ms']:.4f} ms bound {rec['bound_ms']:.4f} ms "
        f"({rec['bound_by']}: C·Bᵀ {cb_flops / 1e9:.2f} GFLOP at the bf16 "
        f"rate, {flops / 1e9:.2f} GFLOP float32, {byts / 1e6:.2f} MB) = "
        f"{(cb_flops + flops) / rec['ms'] / 1e9:.1f} TFLOP/s, "
        f"{byts / rec['ms'] / 1e6:.1f} GB/s; with C·Bᵀ counted per head, "
        f"all at the float32 rate (PRs 15-17) {old_flops / 1e9:.2f} GFLOP, "
        f"bound {old_flops / H100_FLOPS['float32'] * 1e3:.4f} ms; library "
        f"none (no one-call equivalent)")
    log(f"[3] ssd_scan serve decode x[{n},1,{h2},{p_}] path decode: kernel "
        f"device time {d_ms:.4f} ms (events mean {d_ev:.4f} ms) bound "
        f"{d_bound:.4f} ms ({d_work[2] / 1e6:.2f} MB); in place bit-equal")
    recs["ssd_decode"] = {"ms": d_ms, "events_ms": d_ev, "bound_ms": d_bound,
                          "path": "decode"}
    # the TPU kernel's cases (tests/test_kernels.py:116-140), its layout
    for bh, s_, pp, nn in ((2, 64, 32, 16), (1, 128, 64, 64),
                           (4, 96, 16, 8)):
        x = randn(bh, s_, pp, dtype=torch.float32)
        dtt = uni(bh, s_, lo=0.05, hi=0.85)
        a = uni(bh, lo=0.3, hi=2.3)
        B, C = (randn(bh, s_, nn, dtype=torch.float32) for _ in range(2))
        held(f"ssd_scan TPU-test case BH{bh} S{s_} P{pp} N{nn}",
             ssd.ssd_scan, ssd.ssd_scan_plain, ssd.tolerance,
             ssd.to_model_layout(x, dtt, a, B, C) + (None,),
             path="chunked" if pp == nn == 64 else "general")
        y, _ = ssd.ssd_scan_bhsd(x, dtt, a, B, C)
        yo, _ = ssd.ssd_ref(x, dtt, a, B, C)
        if not float((y - yo).abs().max()) <= 3e-4:
            raise RuntimeError("ssd_scan differs from the oracle by more "
                               "than the reference test's 3e-4")
    s_r = SERVE_PROMPT - 24
    ins_r = ssd_in(s_r, with_s0=s_fin)
    _, (y_r, _) = held(f"ssd_scan ragged S {s_r} from s0", ssd.ssd_scan,
                       ssd.ssd_scan_plain, ssd.tolerance, ins_r,
                       path="chunked")
    bc = randn(3, 130, 80, dtype=torch.float32)
    held("ssd_scan ragged S 130 float32 P 24 N 40", ssd.ssd_scan,
         ssd.ssd_scan_plain, ssd.tolerance,
         (randn(3, 130, 2, 24, dtype=torch.float32),
          uni(3, 130, 2, lo=0.05, hi=0.85), uni(1, 2, lo=0.3, hi=2.3),
          bc[..., :40], bc[..., 40:], None), path="general")
    want = ssd.ssd_scan_plain(*ins_r)[0]
    lim = ssd.tolerance(*ins_r)[0]
    x_, dt_, a_, B_, C_, s0_ = ins_r
    L = ssd.CHUNK
    planted("ssd_scan inter-chunk state carry dropped", want, lim,
            torch.cat([ssd.ssd_scan(x_[:, c:c + L], dt_[:, c:c + L], a_,
                                    B_[:, c:c + L], C_[:, c:c + L],
                                    s0_ if c == 0 else None)[0]
                       for c in range(0, s_r, L)], 1))
    diag = (C_.float() * B_.float()).sum(-1)[..., None, None] * \
        dt_[..., None] * x_.float()
    planted("ssd_scan diagonal of the mask dropped", want, lim, y_r - diag)
    last = y_r.clone()
    last[:, -1] = 0
    planted("ssd_scan ragged last row left out", want, lim, last)
    return recs


def per_serve_launches(lm, cfg, n_tokens: int) -> dict:
    """The launches one serve must make of each model kernel: one per
    block of its kind and forward (the prefill and n_tokens - 1 decode
    steps)."""
    kinds = [k for g in lm.stack_plan(cfg) for k in g.unit * g.n_rep]
    return {"flash_attention": n_tokens * sum(
                k in ("attn", "attn_local", "shared_attn") for k in kinds),
            "rwkv6_scan": n_tokens * kinds.count("rwkv"),
            "ssd_scan": n_tokens * kinds.count("mamba")}


def serve_phase(torch, dev, out_dir: pathlib.Path, wrappers: dict,
                arch: str, tag: str, needles: tuple) -> dict:
    """Serve ``arch`` at full width on the card, record -> ``tune_trace``
    (measured) -> re-serve, with launch counts of every kernel in
    ``wrappers`` zeroed just before the serve path and read around each
    serve; each model kernel must launch exactly once per block of its
    kind and forward.  Then ``torch.profiler`` over one prefill and one
    decode step: the device share of the kernels named by ``needles``."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import api, profiles, trace, tuner
    from repro_torch.core._axis import StackedAxis
    from repro_torch.dist.axes import bind
    from repro_torch.launch import serve as sv
    from repro_torch.models import lm
    from repro_torch.models.params import init_tree

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), attn_impl="flash")
    axis = StackedAxis(P, dev)
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_tree(lm.model_specs(cfg, P), gen, axis)
    torch.cuda.synchronize()
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, list):
            for v in t:
                walk(v)
        else:
            leaves.append(t)
    walk(params)
    w_bytes = sum(t.numel() * t.element_size() for t in leaves)
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} layers {cfg.layer_pattern}"
        f"{f' + shared attention every {cfg.hybrid_period}' if cfg.hybrid_period else ''}"
        f", d_model {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} "
        f"KV heads x {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}, attn_impl {cfg.attn_impl}; TP {P} stacked; weights "
        f"{w_bytes / 1e9:.3f} GB ({cfg.param_count() / 1e9:.3f} B params) "
        f"drawn in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    prompts = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT)), device=dev)
    n_tokens = 1 + SERVE_DECODE
    per_serve = per_serve_launches(lm, cfg, n_tokens)
    sv.serve(cfg, axis, params, prompts, SERVE_SLOTS, 2)   # warm-up
    torch.cuda.reset_peak_memory_stats(dev)

    zero_counts(wrappers)               # the serve path starts here
    by_path = {k: wrappers[k] for k in ("flash_attention", "rwkv6_scan",
                                        "ssd_scan")}

    def paths():
        return {k: dict(f.launches_by_path) for k, f in by_path.items()}
    c0, p0 = counts(wrappers), paths()
    first = sv.serve(cfg, axis, params, prompts, SERVE_SLOTS, n_tokens)
    c1, p1 = counts(wrappers), paths()
    rec = trace.Trace.from_context(first.ctx)
    rec.save(out_dir / f"serve_trace_{cfg.name}.jsonl")
    for ln in rec.summary().splitlines():
        log(f"[{tag}] {ln}")
    t0 = time.perf_counter()
    rep = tuner.tune_trace(rec, tuner.MeasuredBackend(P, dev, max_nrep=20))
    log(f"[{tag}] tune_trace in {time.perf_counter() - t0:.1f} s")
    for m in rep.measurements:
        log(f"[{tag}] measured {m.op} {m.nbytes}B {m.impl}: "
            f"{m.latency * 1e3:.4f} ms (nrep {m.nrep})")
    for ln in rep.summary().splitlines():
        log(f"[{tag}] {ln}")
    prof_dir = out_dir / f"serve_profiles_{cfg.name}"
    shutil.rmtree(prof_dir, ignore_errors=True)
    rep.save(prof_dir)
    _, phases = profiles.resolve_stores(prof_dir)
    log(f"[{tag}] per-phase profiles saved to {prof_dir} and reloaded: "
        f"{ {ph: len(st) for ph, st in phases.items()} }")
    c2, p2 = counts(wrappers), paths()
    second = sv.serve(cfg, axis, params, prompts, SERVE_SLOTS, n_tokens,
                      phase_profiles=phases)
    c3, p3 = counts(wrappers), paths()
    peak = torch.cuda.max_memory_allocated(dev)
    for label, a, b in (("default serve", c0, c1), ("tune_trace", c1, c2),
                        ("re-serve", c2, c3)):
        log(f"[{tag} {label}] kernel launches: "
            f"{json.dumps({k: b[k] - a[k] for k in b})}")
    log(f"[{tag}] required per serve: {json.dumps(per_serve)}")
    for label, a, b in (("default serve", c0, c1), ("re-serve", c2, c3)):
        for k, want in per_serve.items():
            if b[k] - a[k] != want:
                raise RuntimeError(f"{cfg.name} {label}: {k} launched "
                                   f"{b[k] - a[k]} times, not {want}")
    # flash: each attention block's prefill on the wgmma path, its decode
    # steps on the split-KV path; each scan: each block's prefill on the
    # chunked kernel, its decode steps (S = 1) on the decode kernel, and
    # no other path
    for name, prefill, decode in (("flash_attention", "wgmma", "split_kv"),
                                  ("rwkv6_scan", "chunked", "decode"),
                                  ("ssd_scan", "chunked", "decode")):
        n_blk = per_serve[name] // n_tokens
        want_paths = dict.fromkeys(by_path[name].launches_by_path, 0)
        want_paths.update({prefill: n_blk, decode: n_blk * (n_tokens - 1)})
        for label, a, b in (("default serve", p0, p1), ("re-serve", p2, p3)):
            got_paths = {k: b[name][k] - a[name][k] for k in b[name]}
            if n_blk:
                log(f"[{tag} {label}] {name} launches by path: "
                    f"{json.dumps(got_paths)}")
            if got_paths != want_paths:
                raise RuntimeError(f"{cfg.name} {label}: {name} paths "
                                   f"{got_paths}, not {want_paths}")
    check = sv.check_serves(first, second, SERVE_RTOL)
    log(f"[{tag}] re-served logits vs the default serve: {check['steps']} "
        f"steps, max-norm relative error {check['max_rel_err']:.4e} "
        f"(tolerance {SERVE_RTOL}), tokens diverged at "
        f"{check['diverged_at']}")
    for label, res in (("default", first), ("tuned", second)):
        toks = res.tokens.cpu()
        if tuple(toks.shape) != (SERVE_BATCH, n_tokens) or not bool(
                all(torch.isfinite(lg).all() for lg in res.logits)):
            raise RuntimeError(f"{cfg.name} {label} serve: bad output")
        log(f"[{tag}] {label} tokens, request 0: {toks[0].tolist()}")
        log(f"[{tag}] {cfg.name} {label} serve: prefill "
            f"{res.prefill_s * 1e3:.2f} ms "
            f"({SERVE_BATCH * SERVE_PROMPT / res.prefill_s:.0f} tokens/s), "
            f"decode {res.decode_s_per_token * 1e3:.3f} ms/token "
            f"({SERVE_BATCH / res.decode_s_per_token:.1f} tokens/s over "
            f"{SERVE_BATCH} requests), {SERVE_BATCH * n_tokens} tokens in "
            f"{(res.prefill_s + res.decode_s) * 1e3:.1f} ms")
    for ln in api.format_footer(second.ctx).splitlines():
        log(f"[{tag}] {ln}")
    log(f"[{tag}] {cfg.name} peak device memory {peak / 1e9:.3f} GB")
    launches = {k: c3[k] - c0[k] for k in c3}
    log(f"[serve path {cfg.name}] kernel launches: {json.dumps(launches)}")
    log(f"[{tag}] weights, warm-up, serve, tune_trace, re-serve in "
        f"{time.perf_counter() - t_phase:.1f} s")

    # where a step's device time goes (after the serve path's counts)
    with bind(model=axis):
        caches = lm.init_caches(cfg, SERVE_BATCH, SERVE_SLOTS)
    pf, dc = sv.build_prefill(cfg, axis), sv.build_decode(cfg, axis)
    tok = prompts[:, :1]
    shares = {
        "prefill": profile_call(torch, f"{cfg.name} one prefill", lambda: pf(
            params, {"tokens": prompts}, caches), tag, needles),
        "decode": profile_call(torch, f"{cfg.name} one decode step",
                               lambda: dc(params, tok, caches, SERVE_PROMPT),
                               tag, needles)}
    return {"launches": launches, "shares": shares, "check": check,
            "peak_bytes": peak, "per_serve": per_serve,
            "paths": {name: {k: p3[name][k] - p0[name][k] for k in f}
                      for name, f in p3.items()},
            "serves": {label: {"prefill_ms": r.prefill_s * 1e3,
                               "decode_ms_per_token":
                                   r.decode_s_per_token * 1e3,
                               "tokens": r.tokens.cpu().tolist()}
                       for label, r in (("default", first),
                                        ("tuned", second))}}


def state_carry_check(torch, dev, wrappers: dict, arch: str) -> float:
    """Prefill(S - 1) + decode(1) against the full forward at the last
    position: full width, float32 weights, 2 layers (zamba2: 2 mamba
    layers with ``hybrid_period`` cut to 2 with the depth, so that one
    shared attention block follows them), TP P stacked, S =
    ``CARRY_PROMPT`` (S - 1 is a multiple of neither chunk), through the
    kernels: the check of the scans' s0 input and s_fin output.  Returns
    the max-norm relative error; raises above ``CARRY_RTOL``."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core._axis import StackedAxis
    from repro_torch.dist.axes import bind
    from repro_torch.models import lm
    from repro_torch.models.params import init_tree

    cut = {"hybrid_period": 2} if arch == "zamba2-1.2b" else {}
    cfg = dataclasses.replace(get_config(arch), attn_impl="flash",
                              dtype="float32", n_layers=2, **cut)
    axis = StackedAxis(P, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    params = init_tree(lm.model_specs(cfg, P), gen, axis)
    toks = torch.as_tensor(np.random.default_rng(SEED + 2).integers(
        0, cfg.vocab_size, (2, CARRY_PROMPT)), device=dev)
    scan = "rwkv6_scan" if arch == "rwkv6-3b" else "ssd_scan"
    before, p_before = counts(wrappers), dict(
        wrappers[scan].launches_by_path)
    with bind(model=axis):
        full = lm.forward(params, cfg, {"tokens": toks})[0][:, :, -1]
        caches = lm.init_caches(cfg, 2, CARRY_PROMPT + 8)
        _, caches = lm.prefill(params, cfg, {"tokens": toks[:, :-1]}, caches)
        last, _ = lm.decode_step(params, cfg, toks[:, -1:], caches,
                                 CARRY_PROMPT - 1)
    torch.cuda.synchronize()
    after = counts(wrappers)
    kinds = [k for g in lm.stack_plan(cfg) for k in g.unit * g.n_rep]
    rel = float((last[:, :, 0] - full).abs().max() / full.abs().max())
    launched = {k: after[k] - before[k] for k in after}
    split = path_delta(wrappers[scan], p_before)
    log(f"[11] state carry {cfg.name} (2 layers {kinds}, float32, TP {P}): "
        f"prefill {CARRY_PROMPT - 1} + decode 1 vs forward over "
        f"{CARRY_PROMPT}: max-norm relative error {rel:.3e} (tolerance "
        f"{CARRY_RTOL}); launches {json.dumps(launched)}, {scan} by path "
        f"{json.dumps(split)}")
    n_blk = kinds.count("rwkv" if arch == "rwkv6-3b" else "mamba")
    want = dict.fromkeys(split, 0)
    want.update(chunked=2 * n_blk, decode=n_blk)   # forward, prefill; step
    if launched[scan] != 3 * n_blk or split != want:
        raise RuntimeError(f"state carry {cfg.name}: {scan} launched "
                           f"{launched[scan]} times, by path {split}, not "
                           f"{want}")
    if not rel <= CARRY_RTOL or not bool(torch.isfinite(last).all()):
        raise RuntimeError(f"state carry {cfg.name}: error {rel} > "
                           f"{CARRY_RTOL}")
    return rel


def grads_rel_err(torch, got, want) -> tuple[float, str]:
    """Largest max-norm relative error over gradient leaves, and the path
    of the leaf where it is; both trees are ``{path: tensor}``."""
    worst, where = 0.0, ""
    for k, w in want.items():
        den = float(w.float().abs().max())
        err = float((got[k].float() - w.float()).abs().max())
        err = err / den if den else err
        if err > worst:
            worst, where = err, k
    return worst, where


def dispatch_counts(rec) -> dict:
    """``{"op phase": n}`` of a dispatch record."""
    out: dict = {}
    for r in rec:
        key = f"{r.cell.op} {r.phase}"
        out[key] = out.get(key, 0) + 1
    return dict(sorted(out.items()))


def footer_by_phase(rec) -> dict:
    """The ``#@pgmpi`` picks of a record, per phase (one line per
    distinct (op, bytes, impl))."""
    from repro_torch.core.profiles import OP_TO_MPI
    out: dict = {}
    for r in rec:
        line = (f"#@pgmpi alg {OP_TO_MPI.get(r.cell.op, r.cell.op)} "
                f"{r.cell.nbytes} {r.impl}")
        lines = out.setdefault(r.phase, [])
        if line not in lines:
            lines.append(line)
    return out


def timed_steps(torch, tr, params, opt, batches, tag: str, sub: str = "a"):
    """``TRAIN_WARMUP`` warm-up and ``TRAIN_STEPS`` timed steps of ``tr``,
    then one step under ``torch.profiler`` (device busy share, the top
    kernels): ``(params, opt, losses, times, step_rec, profiled)``, with
    ``step_rec`` the dispatches of the last timed step; logged as
    ``[{tag}{sub}]``."""
    from torch.profiler import ProfilerActivity, profile
    losses, times, step_rec = [], [], None
    n_a = TRAIN_WARMUP + TRAIN_STEPS + 1
    for i in range(n_a - 1):
        torch.cuda.synchronize()
        n0 = len(tr.record)
        t0 = time.perf_counter()
        params, opt, m = tr.step(params, opt, batches[i], i)
        losses.append(float(m["loss"]))          # waits for the step
        dt = time.perf_counter() - t0
        if i >= TRAIN_WARMUP:
            times.append(dt)
        step_rec = tr.record[n0:]
        log(f"[{tag}{sub}] step {i}: loss {losses[-1]:.6f} grad_norm "
            f"{float(m['grad_norm']):.4f} lr {float(m['lr']):.3e} "
            f"{dt * 1e3:.2f} ms{' (warm-up)' if i < TRAIN_WARMUP else ''}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, m = tr.step(params, opt, batches[n_a - 1], n_a - 1)
        losses.append(float(m["loss"]))
        wall = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages() if str(getattr(
        e, "device_type", "")).endswith("CUDA")]
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    profiled = {"wall_ms": wall, "device_busy_ms": busy,
                "busy_share": busy / wall,
                "kernels": sum(e.count for e in rows)}
    log(f"[{tag}{sub}] profiled step: wall {wall:.2f} ms, device busy "
        f"{busy:.2f} ms in {profiled['kernels']} kernels = "
        f"{100 * busy / wall:.1f} % busy")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[{tag}{sub}]   {e.self_device_time_total / 1e3:9.3f} ms "
            f"x{e.count:5d} {e.key[:90]}")
    if not all(map(math.isfinite, losses)):
        raise RuntimeError(f"[{tag}] non-finite loss {losses}")
    return params, opt, losses, times, step_rec, profiled


def retune_step(torch, tr, params, batch, backend, tag: str, **trainer_kw):
    """(b) of the train phases: record one step's gradients (and take them
    again: the default's own run-to-run difference), ``tune_trace`` the
    trace's fwd and bwd phases on ``backend`` (cells whose replay passes
    ``TRAIN_REPLAY_CAP`` held out, the quantized wire demoted: it is
    approximate), save and reload the per-phase profiles, and take the
    same gradients under them, within ``TRAIN_RTOL`` of the default's.
    Returns ``(report, loss0, g0)`` with the default's loss and named
    gradients."""
    import tempfile
    from repro_torch.core import collectives as C
    from repro_torch.core import profiles, trace, tuner
    from repro_torch.models.params import tree_paths
    from repro_torch.train import Trainer

    rec_b: list = []
    tr.record = rec_b
    loss0, g0 = tr.grads(params, batch)
    g0 = dict(tree_paths(g0))
    # the default step against itself: the embedding's backward (an
    # index_add in bf16 on the card) adds its rows in no fixed order
    tr.record = []
    _, g_again = tr.grads(params, batch)
    err_dd, leaf_dd = grads_rel_err(torch, dict(tree_paths(g_again)), g0)
    del g_again
    log(f"[{tag}b] default step vs itself: gradients max-norm relative "
        f"{err_dd:.3e} ({leaf_dd})")
    rtrace = trace.Trace.from_record(rec_b)
    for ln in rtrace.summary().splitlines():
        log(f"[{tag}b] {ln}")
    fits, held = [], []
    for e in rtrace.entries:
        (fits if replay_bytes(e.cell) <= TRAIN_REPLAY_CAP else held).append(e)
    for e in held:
        log(f"[{tag}b] not replayed (operand over {TRAIN_REPLAY_CAP / 1e9:.0f}"
            f" GB): {e.phase} {e.op} {e.nbytes} B x{e.count}")
    before = C.demotions()
    t0 = time.perf_counter()
    try:
        for op, impls in C.REGISTRY.items():
            for nm, impl in impls.items():
                if impl.wire_dtype is not None:
                    C.demote(op, nm, "training needs exact gradients")
        rep = tuner.tune_trace(trace.Trace(fits), backend)
    finally:
        C.clear_demotions()
        for (op, nm), why in before.items():
            C.demote(op, nm, why)
    log(f"[{tag}b] tune_trace in {time.perf_counter() - t0:.1f} s")
    for ln in rep.summary().splitlines():
        log(f"[{tag}b] {ln}")
    for m_ in rep.measurements:
        if m_.op == "matmul_reducescatter_2d":
            log(f"[{tag}b] measured {m_.op} {m_.cell.mm_role} p={m_.cell.p} "
                f"p2={m_.cell.p2} k={m_.cell.mm_k} {m_.impl}: "
                f"{m_.latency * 1e3:.4f} ms (nrep {m_.nrep})")
    with tempfile.TemporaryDirectory() as tmp:
        rep.save(pathlib.Path(tmp) / "profiles")
        _, phases = profiles.resolve_stores(pathlib.Path(tmp) / "profiles")
    log(f"[{tag}b] per-phase profiles saved and reloaded: "
        f"{ {ph: len(st) for ph, st in phases.items()} }")
    rec_t: list = []
    tuned = Trainer(tr.cfg, phase_profiles=phases, record=rec_t,
                    **trainer_kw)
    loss1, g1 = tuned.grads(params, batch)
    err_t, leaf_t = grads_rel_err(torch, dict(tree_paths(g1)), g0)
    lerr_t = abs(float(loss1) - float(loss0)) / abs(float(loss0))
    del g1
    for ph, lines in footer_by_phase(rec_t).items():
        for ln in lines:
            log(f"[{tag}b] tuned {ph}: {ln}")
    log(f"[{tag}b] tuned step vs default: loss {float(loss1):.6f} vs "
        f"{float(loss0):.6f} (rel {lerr_t:.3e}), gradients max-norm "
        f"relative {err_t:.3e} ({leaf_t}; tolerance {TRAIN_RTOL}; the "
        f"default against itself {err_dd:.3e})")
    if not (err_t <= TRAIN_RTOL and lerr_t <= TRAIN_RTOL):
        raise RuntimeError(f"[{tag}] tuned training step differs: grads "
                           f"{err_t}, loss {lerr_t}")
    return ({"default_vs_default": {"grad_rel_err": err_dd,
                                    "leaf": leaf_dd},
             "tuned": {"grad_rel_err": err_t, "leaf": leaf_t,
                       "loss_rel_err": lerr_t,
                       "picks": footer_by_phase(rec_t)}}, loss0, g0)


def train_phase(torch, dev, wrappers: dict, tag: str = "12") -> dict:
    """Train llama3.2-3b at full width (depth ``TRAIN_LAYERS``) on the
    card: (a) FSDP over p = 8 stacked data ranks, timed; (b) record one
    step's gradients, ``tune_trace`` its fwd and bwd phases (measured),
    save and reload the per-phase profiles and take the same gradients
    under them; (c) the same gradients under ``TRAIN_FORCE``, which must
    launch ``block_matmul``, ``agmm_ring`` and ``guideline_pack`` with
    ``fused_ring`` dispatches in the bwd phase; (e) a checkpoint of (a)'s
    state restored into a fresh trainer takes the next step with the
    same loss; (d) TP over p = 8 stacked model ranks, 2 steps and a forced
    step.  Launch counts of every kernel in ``wrappers`` are zeroed just
    before and read just after."""
    import tempfile
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.configs import get_config
    from repro_torch.core import tuner
    from repro_torch.data import make_batch
    from repro_torch.dist import ops
    from repro_torch.models.params import tree_nbytes, tree_paths
    from repro_torch.optim import state_specs
    from repro_torch.train import Trainer

    def named(tree) -> dict:
        return dict(tree_paths(tree))

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("llama3.2-3b"),
                              n_layers=TRAIN_LAYERS, attn_impl="ref")
    out: dict = {"layers": TRAIN_LAYERS, "full_layers": get_config(
        "llama3.2-3b").n_layers}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts(wrappers)                       # the train path starts here
    c_start = counts(wrappers)
    bm, ring = wrappers["block_matmul"], wrappers[
        "ring_allgather_matmul_rdma"]
    paths0 = (dict(bm.launches_by_path), dict(ring.launches_by_path))
    copies0 = (ops._contig.copies, ops._contig.bytes)

    # -- (a) FSDP, p = 8 data ranks ----------------------------------------
    rec: list = []
    tr = Trainer(cfg, mesh=(P, 1), device=dev, record=rec)
    t0 = time.perf_counter()
    params, opt = tr.init(SEED)
    torch.cuda.synchronize()
    nbytes = tree_nbytes(tr.specs)
    obytes = tree_nbytes(state_specs(cfg.optimizer, tr.specs))
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} of {out['full_layers']} "
        f"layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV heads x "
        f"{cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, tied, "
        f"{cfg.dtype}, {cfg.optimizer}, attn_impl {cfg.attn_impl}; FSDP {P} "
        f"stacked; params {nbytes / 1e9:.3f} GB + optimizer state "
        f"{obytes / 1e9:.3f} GB, drawn in {time.perf_counter() - t0:.1f} s")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n_a = TRAIN_WARMUP + TRAIN_STEPS + 1
    batches = [tr.put_batch(make_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, i))
               for i in range(n_a + 1)]
    params, opt, losses, times, step_rec, out["profiled_step"] = \
        timed_steps(torch, tr, params, opt, batches, tag)
    med = sorted(times)[len(times) // 2]
    peak = torch.cuda.max_memory_allocated(dev)
    out["fsdp"] = {"step_ms": [t * 1e3 for t in times],
                   "median_step_ms": med * 1e3, "tokens_per_s": tokens / med,
                   "losses": losses, "peak_bytes": peak,
                   "dispatches": dispatch_counts(step_rec)}
    log(f"[{tag}a] FSDP p={P}: median step {med * 1e3:.2f} ms over "
        f"{TRAIN_STEPS} steps ({tokens / med:.0f} tokens/s), peak device "
        f"memory {peak / 1e9:.3f} GB, losses {losses}")
    log(f"[{tag}a] dispatches of one step (op phase: n): "
        f"{json.dumps(out['fsdp']['dispatches'])}")

    # -- (b) record -> tune_trace -> the same step under the profiles -----
    batch = batches[n_a]
    backend = tuner.MeasuredBackend(P, dev, max_nrep=10)
    got, loss0, g0 = retune_step(torch, tr, params, batch, backend, tag,
                                 mesh=(P, 1), device=dev)
    out.update(got)

    # -- (c) one forced step through the kernels ---------------------------
    rec_c: list = []
    forced = Trainer(cfg, mesh=(P, 1), device=dev, force=TRAIN_FORCE,
                     record=rec_c)
    c0, bm0 = counts(wrappers), dict(bm.launches_by_path)
    loss2, g2 = forced.grads(params, batch)
    torch.cuda.synchronize()
    c1 = counts(wrappers)
    log(f"[{tag}c] forced step: block_matmul launches by path "
        f"{json.dumps(path_delta(bm, bm0))}")
    need = ("block_matmul", "ring_allgather_matmul_rdma", "guideline_pack")
    require_launched(f"{tag}c forced step", {k: c0[k] for k in need},
                     {k: c1[k] for k in need})
    bwd_ring = sorted({r.cell.op for r in rec_c if r.phase == "bwd"
                       and r.impl == "fused_ring"})
    log(f"[{tag}c] fused_ring dispatches in the bwd phase: {bwd_ring}")
    if not bwd_ring:
        raise RuntimeError("forced step: no fused_ring dispatch in bwd")
    for ph, lines in footer_by_phase(rec_c).items():
        for ln in lines:
            log(f"[{tag}c] forced {ph}: {ln}")
    err_f, leaf_f = grads_rel_err(torch, named(g2), g0)
    lerr_f = abs(float(loss2) - float(loss0)) / abs(float(loss0))
    del g2, g0
    log(f"[{tag}c] forced step vs default: loss {float(loss2):.6f} vs "
        f"{float(loss0):.6f} (rel {lerr_f:.3e}), gradients max-norm "
        f"relative {err_f:.3e} ({leaf_f}; tolerance {TRAIN_RTOL})")
    if not (err_f <= TRAIN_RTOL and lerr_f <= TRAIN_RTOL):
        raise RuntimeError(f"forced training step differs: grads {err_f}, "
                           f"loss {lerr_f}")
    out["peak_bytes_a_to_c"] = torch.cuda.max_memory_allocated(dev)
    log(f"[{tag}c] peak device memory through (a)-(c): "
        f"{out['peak_bytes_a_to_c'] / 1e9:.3f} GB")
    out["forced"] = {"grad_rel_err": err_f, "leaf": leaf_f,
                     "loss_rel_err": lerr_f,
                     "dispatches": dispatch_counts(rec_c),
                     "bwd_fused_ring": bwd_ring}

    # -- (e) checkpoint after (a), restore into a fresh trainer ------------
    k = n_a
    ckdir = pathlib.Path(tempfile.mkdtemp(prefix="train_ckpt_"))
    try:
        t0 = time.perf_counter()
        ck.save(ckdir, k, tr.to_global(params, opt))
        t_save = time.perf_counter() - t0
        params, opt, m = tr.step(params, opt, batch, k)
        loss_a = float(m["loss"])
        del params, opt, m, tr, forced
        torch.cuda.empty_cache()
        fresh = Trainer(cfg, mesh=(P, 1), device=dev)
        t0 = time.perf_counter()
        params, opt = fresh.from_global(ck.restore(ckdir, k,
                                                   fresh.global_specs()))
        t_restore = time.perf_counter() - t0
        params, opt, m = fresh.step(params, opt, batch, k)
        loss_b = float(m["loss"])
        size = sum(f.stat().st_size for f in ckdir.rglob("*") if f.is_file())
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    log(f"[{tag}e] checkpoint of step {k}: {size / 1e9:.3f} GB saved in "
        f"{t_save:.1f} s, restored in {t_restore:.1f} s; next step's loss "
        f"{loss_b:.6f} restored vs {loss_a:.6f} never stopped")
    if loss_a != loss_b:
        raise RuntimeError(f"restored step's loss {loss_b} != {loss_a}")
    out["ckpt"] = {"bytes": size, "save_s": t_save, "restore_s": t_restore,
                   "loss": loss_b}
    del params, opt, m, fresh
    torch.cuda.empty_cache()

    # -- (d) TP, p = 8 model ranks -----------------------------------------
    torch.cuda.reset_peak_memory_stats(dev)
    rec_d: list = []
    trp = Trainer(cfg, mesh=(1, P), device=dev, record=rec_d)
    params, opt = trp.init(SEED)
    tp_losses, tp_times = [], []
    for i in range(TRAIN_TP_STEPS):
        b = trp.put_batch(make_batch(cfg, TRAIN_TP_BATCH, TRAIN_SEQ, i))
        torch.cuda.synchronize()
        n0 = len(rec_d)
        t0 = time.perf_counter()
        params, opt, m = trp.step(params, opt, b, i)
        tp_losses.append(float(m["loss"]))
        tp_times.append(time.perf_counter() - t0)
        tp_rec = rec_d[n0:]
    b = trp.put_batch(make_batch(cfg, TRAIN_TP_BATCH, TRAIN_SEQ,
                                 TRAIN_TP_STEPS))
    if not all(map(math.isfinite, tp_losses)):
        raise RuntimeError(f"TP train: non-finite loss {tp_losses}")
    loss0, g0 = trp.grads(params, b)
    g0 = named(g0)
    tp_force = dict(TRAIN_FORCE, allreduce="allreduce_as_rsb_allgather")
    rec_df: list = []
    trf = Trainer(cfg, mesh=(1, P), device=dev, force=tp_force, record=rec_df)
    loss2, g2 = trf.grads(params, b)
    err_d, leaf_d = grads_rel_err(torch, named(g2), g0)
    lerr_d = abs(float(loss2) - float(loss0)) / abs(float(loss0))
    forced_bwd = sorted({(r.cell.op, r.impl) for r in rec_df
                         if r.phase == "bwd"})
    peak_tp = torch.cuda.max_memory_allocated(dev)
    log(f"[{tag}d] TP p={P}: {TRAIN_TP_BATCH} x {TRAIN_SEQ} tokens, steps "
        f"{[f'{t * 1e3:.2f} ms' for t in tp_times]}, losses {tp_losses}, "
        f"peak device memory {peak_tp / 1e9:.3f} GB")
    log(f"[{tag}d] dispatches of one step (op phase: n): "
        f"{json.dumps(dispatch_counts(tp_rec))}")
    log(f"[{tag}d] forced step ({forced_bwd} in bwd) vs default: loss rel "
        f"{lerr_d:.3e}, gradients max-norm relative {err_d:.3e} "
        f"({leaf_d}; tolerance {TRAIN_RTOL})")
    if ("allreduce", "allreduce_as_rsb_allgather") not in forced_bwd:
        raise RuntimeError("TP forced step: the forced allreduce did not "
                           "serve the bwd phase")
    if not (err_d <= TRAIN_RTOL and lerr_d <= TRAIN_RTOL):
        raise RuntimeError(f"TP forced step differs: grads {err_d}, loss "
                           f"{lerr_d}")
    out["tp"] = {"step_ms": [t * 1e3 for t in tp_times],
                 "losses": tp_losses, "peak_bytes": peak_tp,
                 "dispatches": dispatch_counts(tp_rec),
                 "forced_grad_rel_err": err_d}
    del params, opt, g0, g2, trp, trf
    torch.cuda.empty_cache()

    c_end = counts(wrappers)
    out["launches"] = {k: c_end[k] - c_start[k] for k in c_end}
    out["paths"] = {"block_matmul": path_delta(bm, paths0[0]),
                    "ring_allgather_matmul_rdma": path_delta(ring, paths0[1])}
    out["contig_copies"] = {"n": ops._contig.copies - copies0[0],
                            "bytes": ops._contig.bytes - copies0[1]}
    log(f"[train path] kernel launches: {json.dumps(out['launches'])}")
    log(f"[train path] launches by path: {json.dumps(out['paths'])}; "
        f"operands copied contiguous in dist.ops: "
        f"{json.dumps(out['contig_copies'])}")
    log(f"[{tag}] train phase in {time.perf_counter() - t_phase:.1f} s")
    return out


def replay_bytes(cell) -> int:
    """Bytes a measured replay of ``cell`` holds on the card: each operand
    of ``measure.problem_shapes`` on every lane of its world."""
    from repro_torch.core import measure
    shapes = measure.problem_shapes(cell)
    return (sum(math.prod(sh) for sh in shapes.values()) * cell.itemsize
            * cell.world())


def train_mesh_phase(torch, dev, wrappers: dict, tag: str = "13") -> dict:
    """Train llama3.2-3b at full width (depth ``TRAIN_LAYERS``) on the
    (data ``MESH_D``, model ``MESH_Q``) mesh stacked on the card: (a) the
    default step, timed; (b) record one step's gradients, ``tune_trace``
    its fwd and bwd phases (measured, each cell at its own world), save
    and reload the per-phase profiles and take the same gradients under
    them; (c) the same gradients under ``MESH_FORCE`` (``fused_ring2d`` in
    both directions and the 1-D fused rings), which must launch
    ``block_matmul`` on ``wgmma`` and ``guideline_pack``, and the
    standalone 2-D pair (``dist.ops.matmul_reducescatter_2d``) at the w_o
    site, whose dx launches the ring; (d) a checkpoint of (a)'s state
    restored into a fresh trainer takes the next step with the same loss.
    Launch counts of every kernel in ``wrappers`` are zeroed just before
    and read just after."""
    import tempfile
    from repro_torch.ckpt import checkpoint as ck
    from repro_torch.configs import get_config
    from repro_torch.core import api, tuner
    from repro_torch.data import make_batch
    from repro_torch.dist import ops
    from repro_torch.dist.axes import bind
    from repro_torch.models.params import tree_nbytes, tree_paths
    from repro_torch.optim import state_specs
    from repro_torch.train import Trainer

    def named(tree) -> dict:
        return dict(tree_paths(tree))

    t_phase = time.perf_counter()
    mesh = (MESH_D, MESH_Q)
    cfg = dataclasses.replace(get_config("llama3.2-3b"),
                              n_layers=TRAIN_LAYERS, attn_impl="ref")
    out: dict = {"mesh": list(mesh), "layers": TRAIN_LAYERS}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts(wrappers)                   # the mesh train path starts here
    c_start = counts(wrappers)
    bm, ring = wrappers["block_matmul"], wrappers[
        "ring_allgather_matmul_rdma"]
    paths0 = (dict(bm.launches_by_path), dict(ring.launches_by_path))

    # -- (a) the default step ------------------------------------------------
    rec: list = []
    tr = Trainer(cfg, mesh=mesh, device=dev, record=rec)
    params, opt = tr.init(SEED)
    torch.cuda.synchronize()
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} layers at full width, "
        f"{cfg.dtype}, {cfg.optimizer}, attn_impl {cfg.attn_impl}; mesh data "
        f"{MESH_D} x model {MESH_Q} stacked ({MESH_D * MESH_Q} lanes); "
        f"params {tree_nbytes(tr.specs) / 1e9:.3f} GB + optimizer state "
        f"{tree_nbytes(state_specs(cfg.optimizer, tr.specs)) / 1e9:.3f} GB;"
        f" {MESH_BATCH} x {TRAIN_SEQ} tokens a step")
    tokens = MESH_BATCH * TRAIN_SEQ
    n_a = TRAIN_WARMUP + TRAIN_STEPS + 1
    batches = [tr.put_batch(make_batch(cfg, MESH_BATCH, TRAIN_SEQ, i))
               for i in range(n_a + 1)]
    params, opt, losses, times, step_rec, out["profiled_step"] = \
        timed_steps(torch, tr, params, opt, batches, tag)
    med = sorted(times)[len(times) // 2]
    peak = torch.cuda.max_memory_allocated(dev)
    out["default"] = {"step_ms": [t * 1e3 for t in times],
                      "median_step_ms": med * 1e3,
                      "tokens_per_s": tokens / med, "losses": losses,
                      "peak_bytes": peak,
                      "dispatches": dispatch_counts(step_rec)}
    log(f"[{tag}a] mesh {MESH_D}x{MESH_Q}: median step {med * 1e3:.2f} ms "
        f"over {TRAIN_STEPS} steps ({tokens / med:.0f} tokens/s), peak "
        f"device memory {peak / 1e9:.3f} GB, losses {losses}")
    log(f"[{tag}a] dispatches of one step (op phase: n): "
        f"{json.dumps(out['default']['dispatches'])}")

    # -- (b) record -> tune_trace -> the same step under the profiles -----
    batch = batches[n_a]
    backend = tuner.MeasuredBackend(None, dev, max_nrep=10)
    got, loss0, g0 = retune_step(torch, tr, params, batch, backend, tag,
                                 mesh=mesh, device=dev)
    out.update(got)

    # -- (c) the forced step through the kernels -----------------------------
    rec_c: list = []
    forced = Trainer(cfg, mesh=mesh, device=dev, force=MESH_FORCE,
                     record=rec_c)
    c0, bm0 = counts(wrappers), dict(bm.launches_by_path)
    loss2, g2 = forced.grads(params, batch)
    torch.cuda.synchronize()
    c1 = counts(wrappers)
    bm_paths = path_delta(bm, bm0)
    log(f"[{tag}c] forced step: block_matmul launches by path "
        f"{json.dumps(bm_paths)}; kernel launches "
        f"{json.dumps({k: c1[k] - c0[k] for k in c1})}")
    need = ("block_matmul", "guideline_pack")
    require_launched(f"{tag}c forced step", {k: c0[k] for k in need},
                     {k: c1[k] for k in need})
    if bm_paths["wgmma"] != c1["block_matmul"] - c0["block_matmul"]:
        raise RuntimeError(f"forced mesh step: block_matmul off wgmma "
                           f"{bm_paths}")
    ring2d = sorted({(r.cell.mm_role, r.phase) for r in rec_c
                     if r.impl == "fused_ring2d"})
    log(f"[{tag}c] fused_ring2d dispatches (role, phase): {ring2d}")
    if ring2d != [("2d", "fwd"), ("2dT", "bwd")]:
        raise RuntimeError(f"forced mesh step: fused_ring2d served {ring2d}")
    for ph, lines in footer_by_phase(rec_c).items():
        for ln in lines:
            log(f"[{tag}c] forced {ph}: {ln}")
    err_f, leaf_f = grads_rel_err(torch, named(g2), g0)
    lerr_f = abs(float(loss2) - float(loss0)) / abs(float(loss0))
    del g2
    log(f"[{tag}c] forced step vs default: loss {float(loss2):.6f} vs "
        f"{float(loss0):.6f} (rel {lerr_f:.3e}), gradients max-norm "
        f"relative {err_f:.3e} ({leaf_f}; tolerance {TRAIN_RTOL})")
    if not (err_f <= TRAIN_RTOL and lerr_f <= TRAIN_RTOL):
        raise RuntimeError(f"forced mesh step differs: grads {err_f}, loss "
                           f"{lerr_f}")
    # the standalone 2-D pair at the w_o site: forward, and a backward
    # whose dx is allgather_matmul over the model axis (the ring)
    k_ = MESH_SITES["w_o"]
    L = MESH_D * MESH_Q
    gen = torch.Generator(device=dev).manual_seed(SEED)
    xs = torch.randn(L, MESH_T, k_, generator=gen, device=dev).to(
        torch.bfloat16)
    ws = (torch.randn(L, k_, D_MODEL // MESH_D, generator=gen, device=dev)
          * (MESH_Q * k_) ** -0.5).to(torch.bfloat16)
    cot = torch.randn(L, MESH_T // MESH_Q, D_MODEL, generator=gen,
                      device=dev).to(torch.bfloat16)
    pair = {}
    for label, force in (("default", {}), ("forced", MESH_FORCE)):
        x_ = xs.clone().requires_grad_(True)
        w_ = ws.clone().requires_grad_(True)
        c2 = counts(wrappers)
        with bind(data=forced.axis["data"], model=forced.axis["model"]), \
                api.tuned(force=force) as ctx:
            y = ops.matmul_reducescatter_2d(x_, w_)
            y.backward(cot)
        torch.cuda.synchronize()
        pair[label] = ({"y": y.detach(), "dx": x_.grad, "dw": w_.grad},
                       {k: v - c2[k] for k, v in counts(wrappers).items()},
                       sorted({(r.cell.op, r.impl, r.phase)
                               for r in ctx.record}))
    err_p, leaf_p = grads_rel_err(torch, pair["forced"][0], pair["default"][0])
    log(f"[{tag}c] 2-D pair at w_o (x [{MESH_T},{k_}] a lane): forced "
        f"{pair['forced'][2]} launches {json.dumps(pair['forced'][1])}; vs "
        f"default max-norm relative {err_p:.3e} ({leaf_p}; tolerance "
        f"{TRAIN_RTOL})")
    pair_need = ("block_matmul", "ring_allgather_matmul_rdma")
    require_launched(f"{tag}c 2-D pair", dict.fromkeys(pair_need, 0),
                     {k: pair["forced"][1][k] for k in pair_need})
    if not err_p <= TRAIN_RTOL:
        raise RuntimeError(f"2-D pair differs from the default: {err_p}")
    del pair, xs, ws, cot, x_, w_, y
    out["forced"] = {"grad_rel_err": err_f, "leaf": leaf_f,
                     "loss_rel_err": lerr_f, "block_matmul_paths": bm_paths,
                     "fused_ring2d": ring2d,
                     "dispatches": dispatch_counts(rec_c),
                     "pair_rel_err": err_p}
    out["peak_bytes_a_to_c"] = torch.cuda.max_memory_allocated(dev)
    log(f"[{tag}c] peak device memory through (a)-(c): "
        f"{out['peak_bytes_a_to_c'] / 1e9:.3f} GB")
    del forced, g0

    # -- (d) checkpoint after (a), restore into a fresh trainer ------------
    k = n_a
    ckdir = pathlib.Path(tempfile.mkdtemp(prefix="mesh_ckpt_"))
    try:
        t0 = time.perf_counter()
        ck.save(ckdir, k, tr.to_global(params, opt))
        t_save = time.perf_counter() - t0
        params, opt, m = tr.step(params, opt, batch, k)
        loss_a = float(m["loss"])
        del params, opt, m, tr
        torch.cuda.empty_cache()
        fresh = Trainer(cfg, mesh=mesh, device=dev)
        t0 = time.perf_counter()
        params, opt = fresh.from_global(ck.restore(ckdir, k,
                                                   fresh.global_specs()))
        t_restore = time.perf_counter() - t0
        params, opt, m = fresh.step(params, opt, batch, k)
        loss_b = float(m["loss"])
        size = sum(f.stat().st_size for f in ckdir.rglob("*") if f.is_file())
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    log(f"[{tag}d] checkpoint of step {k}: {size / 1e9:.3f} GB saved in "
        f"{t_save:.1f} s, restored in {t_restore:.1f} s; next step's loss "
        f"{loss_b!r} restored vs {loss_a!r} never stopped")
    if loss_a != loss_b:
        raise RuntimeError(f"restored mesh step's loss {loss_b} != {loss_a}")
    out["ckpt"] = {"bytes": size, "save_s": t_save, "restore_s": t_restore,
                   "loss": loss_b}
    del params, opt, m, fresh
    torch.cuda.empty_cache()
    out["pod"] = pod_step(torch, dev, cfg, tag)

    c_end = counts(wrappers)
    out["launches"] = {k: c_end[k] - c_start[k] for k in c_end}
    out["paths"] = {"block_matmul": path_delta(bm, paths0[0]),
                    "ring_allgather_matmul_rdma": path_delta(ring, paths0[1])}
    log(f"[mesh train path] kernel launches: {json.dumps(out['launches'])}")
    log(f"[mesh train path] launches by path: {json.dumps(out['paths'])}")
    log(f"[{tag}] mesh train phase in {time.perf_counter() - t_phase:.1f} s")
    return out


# the train-through-the-kernels path (phase 14): (a) llama3.2-3b with
# attn_impl "flash" in phase 12's layout (FSDP p = 8, 8 x 1024 tokens);
# (b) rwkv6-3b and (c) zamba2-1.2b at full width, TP over SSM_TP stacked
# model ranks, 2 x 1024 tokens.  zamba2's 12 layers are two hybrid periods
# (6 Mamba2 blocks, then the shared attention block), so the shared
# block trains twice.
SSM_TRAIN_LAYERS = {"rwkv6-3b": 8, "zamba2-1.2b": 12}
SSM_TP, SSM_BATCH = 4, 2
# (b) and (c) hold the float32 step through the kernels to the plain
# versions in two parts.  Each kernel call's output is held to its plain
# version at the model's own inputs, elementwise within the kernel's
# ``tolerance`` (``kernel_outputs``).  The loss and each gradient leaf are
# held within TRAIN_RTOL to the step taken through the plain versions under
# autograd with each call's value pinned to the kernel's output
# (``plain_recurrences(pins=...)``), so the two steps see the same values
# and differ only where the Functions' wiring or backward would.  The
# unpinned plain step is read beside it, not held: on these models at
# random init some leaves' gradients are sums with cancellation that move
# by up to O(1) when the scans' outputs move by 2^-20 relative
# (scripts/torch_grad_noise.py), a property of the model and the batch,
# not of a kernel.


class _PlainFlash:
    """The check's own plain step: attention through
    ``flash_attention_plain`` under autograd (no kernel)."""

    @staticmethod
    def apply(q, k, v, causal, window, softcap, q0, kv_len):
        from repro_torch.kernels import flash_attention as fa
        return _pinned(fa.flash_attention_plain(
            q, k, v, causal=causal, window=window, softcap=softcap, q0=q0,
            kv_len=kv_len))


class _PlainRWKV:
    @staticmethod
    def apply(r, k, v, logw, u):
        from repro_torch.kernels import rwkv6_scan as rw
        return _pinned(rw.rwkv6_scan_plain_log(r, k, v, logw, u)[0])


class _PlainSSD:
    @staticmethod
    def apply(x, dt, a, B, C):
        from repro_torch.kernels import ssd_mamba2 as ssd
        return _pinned(ssd.ssd_scan_plain(x, dt, a, B, C)[0])


def _pinned(y):
    """``y`` with the next pinned value (``plain_recurrences.pins``), its
    gradient ``y``'s: ``y - y.detach()`` is exactly 0."""
    pins = plain_recurrences.pins
    if pins is None:
        return y
    if not pins:
        raise RuntimeError("the plain step made more calls than the step "
                           "through the kernels")
    want = pins.pop(0)
    if want.shape != y.shape or want.dtype != y.dtype:
        raise RuntimeError(f"pinned value {tuple(want.shape)} {want.dtype} "
                           f"for a plain output {tuple(y.shape)} {y.dtype}")
    return y - y.detach() + want


class plain_recurrences:
    """Within: the model's three autograd Functions replaced by autograd
    straight through the plain versions (``_PlainFlash``, ``_PlainRWKV``,
    ``_PlainSSD``), the independent step a training step through the
    kernels is held to; with ``pins`` (the outputs ``kernel_outputs``
    recorded, consumed in call order) each call's value is the pinned
    one and its gradient the plain version's."""
    pins = None

    def __init__(self, pins=None):
        self.given = pins

    def __enter__(self):
        from repro_torch.models import attention, ssm
        self.saved = (attention.FlashAttention, ssm.RWKV6Scan, ssm.SSDScan)
        attention.FlashAttention = _PlainFlash
        ssm.RWKV6Scan, ssm.SSDScan = _PlainRWKV, _PlainSSD
        plain_recurrences.pins = (None if self.given is None
                                  else list(self.given))
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention, ssm
        attention.FlashAttention, ssm.RWKV6Scan, ssm.SSDScan = self.saved
        self.left = plain_recurrences.pins
        plain_recurrences.pins = None


class kernel_outputs:
    """Within: the model's three autograd Functions as they are (the
    kernels on the card), each call's output recorded in call order
    (``outputs``) and held to its plain version at the same inputs: the
    largest ``|kernel - plain| / tolerance`` of each call in ``shares``,
    as ``(name, share)``."""

    def __enter__(self):
        import torch
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import rwkv6_scan as rw
        from repro_torch.kernels import ssd_mamba2 as ssd
        from repro_torch.models import attention, ssm
        self.saved = (attention.FlashAttention, ssm.RWKV6Scan, ssm.SSDScan)
        self.outputs, self.shares = [], []
        flash, rwkv, scan = self.saved
        held = self._held

        class Flash:
            @staticmethod
            def apply(q, k, v, causal, window, softcap, q0, kv_len):
                kw = dict(causal=causal, window=window, softcap=softcap,
                          q0=q0, kv_len=kv_len)
                return held("flash_attention", flash.apply(
                    q, k, v, causal, window, softcap, q0, kv_len), (q, k, v),
                    lambda *t: fa.flash_attention_plain(*t, **kw),
                    lambda ins, want: fa.tolerance(*ins, want, **kw))

        class RWKV:
            @staticmethod
            def apply(r, k, v, logw, u):
                return held(
                    "rwkv6_scan", rwkv.apply(r, k, v, logw, u),
                    (r, k, v, logw, u),
                    lambda *t: rw.rwkv6_scan_plain_log(*t)[0],
                    lambda ins, want: rw.tolerance(
                        *ins[:3], torch.exp(ins[3]), ins[4])[0])

        class SSD:
            @staticmethod
            def apply(x, dt, a, B, C):
                return held("ssd_scan", scan.apply(x, dt, a, B, C),
                            (x, dt, a, B, C),
                            lambda *t: ssd.ssd_scan_plain(*t)[0],
                            lambda ins, want: ssd.tolerance(*ins)[0])

        attention.FlashAttention = Flash
        ssm.RWKV6Scan, ssm.SSDScan = RWKV, SSD
        return self

    def _held(self, name, y, ins, plain, lim_of):
        import torch
        with torch.no_grad():
            ins = [t.detach() for t in ins]
            want = plain(*ins)
            lim = lim_of(ins, want)
            self.shares.append((name, float(
                ((y.detach().float() - want.float()).abs() / lim).max())))
        self.outputs.append(y.detach().clone())
        return y

    def __exit__(self, *exc):
        from repro_torch.models import attention, ssm
        attention.FlashAttention, ssm.RWKV6Scan, ssm.SSDScan = self.saved


def function_checks(torch, dev, fa, rw, ssd, tag: str) -> dict:
    """Each autograd Function at the training shapes of phase 14 against
    autograd straight through its plain version, from the same inputs and
    cotangent: the output held to the kernel's elementwise ``tolerance``,
    each input gradient to the same limit taken max-norm relative (the
    largest limit over the largest plain output); the backward
    differentiates the plain version in both, so the gradients differ by
    summation order only.  These launches are not the path's."""
    g = torch.Generator(device=dev).manual_seed(SEED + 14)

    def rnd(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(
            dtype)

    def held(label, fn, plain, ins, lim_of):
        ins = [t.requires_grad_(True) for t in ins]
        y = fn(*ins)
        gy = rnd(*y.shape)
        got = torch.autograd.grad(y, ins, gy)
        xs = [t.detach().clone().requires_grad_(True) for t in ins]
        yp = plain(*xs)
        want = torch.autograd.grad(yp, xs, gy)
        lim = lim_of([t.detach() for t in ins], yp.detach())
        share = float(((y.detach() - yp.detach()).abs() / lim).max())
        rel_lim = float(lim.max()) / max(float(yp.detach().abs().max()),
                                         1e-30)
        errs = [float((a.float() - b.float()).abs().max())
                / max(float(b.float().abs().max()), 1e-30)
                for a, b in zip(got, want)]
        log(f"[{tag}] {label}: output {share:.4f} of its limit; input "
            f"gradients max-norm relative {['%.2e' % e for e in errs]} "
            f"(limit {rel_lim:.2e})")
        if not (share <= 1.0 and all(e <= rel_lim for e in errs)
                and all(bool(torch.isfinite(a).all()) for a in got)):
            raise RuntimeError(f"{label}: the Function differs from autograd "
                               f"through its plain version")
        return {"output_share": share, "grad_rel_err": errs,
                "grad_limit": rel_lim}

    out = {}
    for label, (n, hk, gq, dh) in (
            ("llama3.2-3b flash", (P, 8, 3, HEAD_DIM)),
            ("zamba2-1.2b shared flash", (SSM_TP * SSM_BATCH,
                                          ZAMBA_ATTN_HEADS // SSM_TP, 1,
                                          64))):
        q = rnd(n, TRAIN_SEQ, hk, gq, dh, dtype=torch.bfloat16)
        k, v = (rnd(n, TRAIN_SEQ, hk, dh, dtype=torch.bfloat16)
                for _ in range(2))
        args = (True, 0, 0.0, 0, None)
        out[label] = held(
            label, lambda *t: fa.FlashAttention.apply(*t, *args),
            lambda *t: fa.flash_attention_plain(*t),
            [q, k, v], lambda ins, want: fa.tolerance(*ins, want))
    n, h = SSM_TP * SSM_BATCH, RWKV_HEADS // SSM_TP
    r, k, v = (rnd(n, TRAIN_SEQ, h, 64, dtype=torch.bfloat16, scale=0.5)
               for _ in range(3))
    logw = -torch.exp(rnd(n, TRAIN_SEQ, h, 64, scale=0.5))
    u = rnd(SSM_TP, h, 64, scale=0.5)
    out["rwkv6-3b rwkv6_scan"] = held(
        "rwkv6-3b rwkv6_scan", rw.RWKV6Scan.apply,
        lambda *t: rw.rwkv6_scan_plain_log(*t)[0], [r, k, v, logw, u],
        lambda ins, want: rw.tolerance(*ins[:3], torch.exp(ins[3]),
                                       ins[4])[0])
    h = ZAMBA_HEADS // SSM_TP
    x = rnd(n, TRAIN_SEQ, h, 64, dtype=torch.bfloat16)
    bc = rnd(n, TRAIN_SEQ, 128, dtype=torch.bfloat16)
    dt = torch.nn.functional.softplus(rnd(n, TRAIN_SEQ, h))
    a = torch.exp(rnd(SSM_TP, h, scale=0.5))
    out["zamba2-1.2b ssd_scan"] = held(
        "zamba2-1.2b ssd_scan",
        lambda x_, dt_, a_, bc_: ssd.SSDScan.apply(x_, dt_, a_, bc_[..., :64],
                                                   bc_[..., 64:]),
        lambda x_, dt_, a_, bc_: ssd.ssd_scan_plain(
            x_, dt_, a_, bc_[..., :64], bc_[..., 64:])[0],
        [x, dt, a, bc],
        lambda ins, want: ssd.tolerance(*ins[:3], ins[3][..., :64],
                                        ins[3][..., 64:])[0])
    return out


def train_kernels_phase(torch, dev, wrappers: dict, ref12: dict,
                        tag: str = "14") -> dict:
    """Train through the kernels' autograd Functions on the card: each
    Function at the training shapes against autograd through its plain
    version (``function_checks``, before the counts are zeroed); then (a)
    llama3.2-3b with ``attn_impl="flash"`` in phase 12's FSDP layout,
    timed beside phase 12's ``ref`` step (``ref12``), its loss and
    gradients within ``TRAIN_RTOL`` of the ``ref`` step's from the same
    weights and batch; (b) rwkv6-3b and (c) zamba2-1.2b at full width,
    TP over ``SSM_TP`` stacked ranks, timed in bf16, then in float32
    each kernel call's output held to its plain version
    (``kernel_outputs``) and the loss and gradients within
    ``TRAIN_RTOL`` of the same step taken through the plain versions
    under autograd, pinned to the kernels' outputs
    (``plain_recurrences``).  Flash's ``wgmma``
    launches and the scans' ``chunked`` launches are counted inside the
    steps."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.kernels import ssd_mamba2 as ssd
    from repro_torch.models.params import (tree_leaves, tree_nbytes,
                                           tree_paths, tree_unflatten)
    from repro_torch.optim import state_specs
    from repro_torch.train import Trainer

    def named(tree) -> dict:
        return dict(tree_paths(tree))

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    out: dict = {"functions": function_checks(torch, dev, fa, rw, ssd, tag)}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts(wrappers)              # the path starts here
    c_start = counts(wrappers)
    kernel_of = {"llama3.2-3b": {"flash_attention": "wgmma"},
                 "rwkv6-3b": {"rwkv6_scan": "chunked"},
                 "zamba2-1.2b": {"ssd_scan": "chunked",
                                 "flash_attention": "wgmma"}}
    n_a = TRAIN_WARMUP + TRAIN_STEPS + 1

    def launched(label, need, fn):
        """``fn()``, requiring each kernel of ``need`` (name -> path) to
        launch on that path inside it; returns ``(fn(), launches by
        path)``."""
        before = {k: dict(wrappers[k].launches_by_path) for k in need}
        c0 = counts(wrappers)
        got = fn()
        torch.cuda.synchronize()
        took = {k: path_delta(wrappers[k], before[k]) for k in need}
        require_launched(f"{tag}{label}", {k: c0[k] for k in need},
                         {k: counts(wrappers)[k] for k in need})
        for k, path in need.items():
            if took[k][path] <= 0:
                raise RuntimeError(f"{label}: {k} off its {path} path "
                                   f"{took[k]}")
        return got, took

    def compare(label, tr, other, params, batch, need):
        """The loss and every gradient leaf of ``tr`` against ``other``
        (a trainer, or None: ``tr`` under ``plain_recurrences`` pinned to
        the kernels' outputs, each of which is held to its plain version
        at the same inputs), with each kernel of ``need`` launched on its
        path inside ``tr``'s step.  The first step's gradients wait on
        the host."""
        rec = kernel_outputs() if other is None else contextlib.nullcontext()
        with rec:
            (loss0, g0), took = launched(f"{label} step", need,
                                         lambda: tr.grads(params, batch))
        g0 = {k: v.cpu() for k, v in named(g0).items()}
        c1 = counts(wrappers)
        got = {}
        if other is None:
            name, share = max(rec.shares, key=lambda t: t[1])
            log(f"[{tag}{label}] each kernel call's output against its "
                f"plain version at the model's inputs: {len(rec.shares)} "
                f"calls, the largest {share:.4f} of its tolerance "
                f"({name})")
            if not share <= 1.0:
                raise RuntimeError(f"{label}: {name} in the step differs "
                                   f"from its plain version: {share:.4f} "
                                   f"of its tolerance")
            with plain_recurrences(pins=rec.outputs) as pl:
                loss1, g1 = tr.grads(params, batch)
            if pl.left:
                raise RuntimeError(f"{label}: the plain step made "
                                   f"{len(rec.outputs) - len(pl.left)} of "
                                   f"the {len(rec.outputs)} calls")
            with plain_recurrences():
                _, g2 = tr.grads(params, batch)
            un, un_leaf = grads_rel_err(torch, g0, {
                k: w.cpu() for k, w in named(g2).items()})
            del g2
            log(f"[{tag}{label}] read, not held: the unpinned plain step's "
                f"gradients max-norm relative {un:.3e} from the kernels' at "
                f"{un_leaf}")
            if counts(wrappers) != c1:
                raise RuntimeError("the plain step launched a kernel")
            got = {"output_share": share, "output_share_of": name,
                   "unpinned_grad_rel_err": un, "unpinned_leaf": un_leaf}
        else:
            loss1, g1 = other.grads(params, batch)
        g1 = named(g1)
        errs = {}
        for k, w in g1.items():
            errs[k] = grads_rel_err(torch, {k: g0[k].to(w.device)},
                                    {k: w})[0]
        del g0, g1
        leaf = max(errs, key=errs.get)
        err = errs[leaf]
        lerr = abs(float(loss0) - float(loss1)) / abs(float(loss1))
        worst = sorted(errs, key=errs.get, reverse=True)[:5]
        log(f"[{tag}{label}] the five leaves farthest apart (max-norm "
            f"relative): {', '.join(f'{k} {errs[k]:.3e}' for k in worst)}")
        log(f"[{tag}{label}] step through the kernels vs "
            f"{'ref attention' if other is not None else 'the plain versions pinned to the kernels outputs'}"
            f" ({tr.cfg.dtype}): loss {float(loss0):.6f} vs {float(loss1):.6f}"
            f" (rel {lerr:.3e}), gradients max-norm relative {err:.3e} at "
            f"{leaf} (tolerance {TRAIN_RTOL}); launches by path in the step "
            f"{json.dumps(took)}")
        if not (err <= TRAIN_RTOL and lerr <= TRAIN_RTOL):
            raise RuntimeError(f"{label}: the step through the kernels "
                               f"differs: grads {err} at {leaf}, loss "
                               f"{lerr}")
        return {"dtype": tr.cfg.dtype, "grad_rel_err": err, "leaf": leaf,
                "loss_rel_err": lerr, "launches_by_path": took, **got}

    def timed(label, tr, params, opt, cfg, batch_rows):
        torch.cuda.synchronize()
        batches = [tr.put_batch(make_batch(cfg, batch_rows, TRAIN_SEQ, i))
                   for i in range(n_a + 1)]
        (params, opt, losses, times, step_rec, prof), took = launched(
            f"{label} timed steps", kernel_of[cfg.name], lambda: timed_steps(
                torch, tr, params, opt, batches, tag, label))
        med = sorted(times)[len(times) // 2]
        peak = torch.cuda.max_memory_allocated(dev)
        tokens = batch_rows * TRAIN_SEQ
        got = {"step_ms": [t * 1e3 for t in times],
               "median_step_ms": med * 1e3, "tokens_per_s": tokens / med,
               "losses": losses, "peak_bytes": peak, "profiled_step": prof,
               "dispatches": dispatch_counts(step_rec),
               "timed_launches_by_path": took}
        log(f"[{tag}{label}] {cfg.name}: median step {med * 1e3:.2f} ms over "
            f"{TRAIN_STEPS} steps ({tokens / med:.0f} tokens/s), peak device "
            f"memory {peak / 1e9:.3f} GB, losses {losses}; launches by path "
            f"in the {n_a} steps {json.dumps(took)}")
        return params, opt, batches[n_a], got

    # -- (a) llama3.2-3b through flash, phase 12's FSDP layout ---------------
    base = dataclasses.replace(get_config("llama3.2-3b"),
                               n_layers=TRAIN_LAYERS)
    cfg = dataclasses.replace(base, attn_impl="flash")
    tr = Trainer(cfg, mesh=(P, 1), device=dev, record=[])
    params, opt = tr.init(SEED)
    log(f"[{tag}a] {cfg.name}: {cfg.n_layers} layers at full width, "
        f"attn_impl flash, FSDP {P} stacked, {TRAIN_BATCH} x {TRAIN_SEQ} "
        f"tokens a step")
    params, opt, batch, got = timed("a", tr, params, opt, cfg, TRAIN_BATCH)
    ref_a = ref12["fsdp"]
    log(f"[{tag}a] flash vs ref (phase 12, this run): median step "
        f"{got['median_step_ms']:.2f} vs {ref_a['median_step_ms']:.2f} ms "
        f"({got['tokens_per_s']:.0f} vs {ref_a['tokens_per_s']:.0f} "
        f"tokens/s), peak device memory {got['peak_bytes'] / 1e9:.3f} vs "
        f"{ref_a['peak_bytes'] / 1e9:.3f} GB")
    del opt
    torch.cuda.empty_cache()
    ref_tr = Trainer(dataclasses.replace(base, attn_impl="ref"), mesh=(P, 1),
                     device=dev)
    got.update(compare("a", tr, ref_tr, params, batch, kernel_of[cfg.name]))
    out["llama3.2-3b"] = got
    del tr, ref_tr, params, batch
    torch.cuda.empty_cache()

    # -- (b), (c): the SSM family, TP over SSM_TP stacked ranks ----------------
    for label, arch in (("b", "rwkv6-3b"), ("c", "zamba2-1.2b")):
        torch.cuda.reset_peak_memory_stats(dev)
        cfg = dataclasses.replace(get_config(arch), attn_impl="flash",
                                  n_layers=SSM_TRAIN_LAYERS[arch])
        tr = Trainer(cfg, mesh=(1, SSM_TP), device=dev, record=[])
        params, opt = tr.init(SEED)
        log(f"[{tag}{label}] {arch}: {cfg.n_layers} of "
            f"{get_config(arch).n_layers} layers at full width (d_model "
            f"{cfg.d_model}, vocab {cfg.vocab_size}, attn_impl flash), "
            f"{cfg.dtype}, "
            f"{cfg.optimizer}, TP {SSM_TP} stacked; params "
            f"{tree_nbytes(tr.specs) / 1e9:.3f} GB + optimizer state "
            f"{tree_nbytes(state_specs(cfg.optimizer, tr.specs)) / 1e9:.3f}"
            f" GB; {SSM_BATCH} x {TRAIN_SEQ} tokens a step")
        params, opt, batch, got = timed(label, tr, params, opt, cfg,
                                        SSM_BATCH)
        del opt, tr
        # the gradient check in float32: in bf16 a leaf's gradient (a sum
        # with cancellation, d_skip or w_dt) moves by O(1) when the
        # recurrence's output moves by 1e-6 (scripts/torch_grad_noise.py),
        # so kernel and plain would differ by bf16 noise, not by kernel
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        tr32 = Trainer(cfg32, mesh=(1, SSM_TP), device=dev)
        params = tree_unflatten(params,
                                [t.float() for t in tree_leaves(params)])
        torch.cuda.empty_cache()
        got.update(compare(label, tr32, None, params, batch, {
            k: "f32" if k == "flash_attention" else path
            for k, path in kernel_of[arch].items()}))
        out[arch] = got
        del tr32, params, batch
        torch.cuda.empty_cache()

    c_end = counts(wrappers)
    out["launches"] = {k: c_end[k] - c_start[k] for k in c_end}
    out["paths"] = {k: dict(wrappers[k].launches_by_path)
                    for k in ("flash_attention", "rwkv6_scan", "ssd_scan")}
    log(f"[kernel train path] kernel launches: {json.dumps(out['launches'])}")
    log(f"[kernel train path] launches by path: {json.dumps(out['paths'])}")
    for k in ("flash_attention", "rwkv6_scan", "ssd_scan"):
        if out["launches"][k] <= 0:
            raise RuntimeError(f"phase {tag}: {k} never launched")
    log(f"[{tag}] kernel train phase in {time.perf_counter() - t_phase:.1f} s")
    return out


def pod_step(torch, dev, cfg, tag: str) -> dict:
    """(e) of phase 13: one step of ``cfg`` on the ``POD_MESH`` pod x data
    x model mesh stacked on the card, ``MESH_BATCH`` x ``TRAIN_SEQ``
    tokens (one sequence a data-parallel rank).  Dispatch stamps each cell
    with its axis's tier (``api.set_mesh_topo``: the pod axis on a tier of
    its own), so the footer shows the cross-pod all-reduces: every leaf's
    gradient in the bwd phase."""
    from repro_torch.core import api, costmodel
    from repro_torch.data import make_batch
    from repro_torch.models.params import tree_leaves
    from repro_torch.train import Trainer

    stacked = costmodel.Topo("stacked", alpha=0.0, link_bw=1.0, gamma=0.0)
    tiers = costmodel.MeshTopo.of(pod=stacked.scaled(name="pod"),
                                  data=stacked, model=stacked)
    torch.cuda.reset_peak_memory_stats(dev)
    rec: list = []
    tr = Trainer(cfg, mesh=POD_MESH, device=dev, record=rec)
    params, opt = tr.init(SEED)
    batch = tr.put_batch(make_batch(cfg, MESH_BATCH, TRAIN_SEQ, 0))
    api.set_mesh_topo(tiers)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = tr.step(params, opt, batch, 0)
        loss = float(m["loss"])
        dt = time.perf_counter() - t0
    finally:
        api.set_mesh_topo(None)
    peak = torch.cuda.max_memory_allocated(dev)
    pod = [r for r in rec if r.cell.tier == "pod"]
    by_phase = {ph: sum(r.phase == ph for r in pod) for ph in ("fwd", "bwd")}
    n_leaves = len(tree_leaves(tr.specs))
    log(f"[{tag}e] pod x data x model {POD_MESH} ({math.prod(POD_MESH)} "
        f"lanes): one step {dt * 1e3:.2f} ms (the first, no warm-up), "
        f"loss {loss:.6f}, peak device memory {peak / 1e9:.3f} GB; "
        f"dispatches over pod {json.dumps(dispatch_counts(pod))}")
    for ph, lines in footer_by_phase(pod).items():
        for ln in lines:
            log(f"[{tag}e] pod {ph}: {ln}")
    if not math.isfinite(loss) or by_phase["bwd"] < n_leaves or not all(
            r.cell.op == "allreduce" for r in pod):
        raise RuntimeError(f"pod step: {by_phase} pod dispatches for "
                           f"{n_leaves} leaves, loss {loss}")
    del tr, params, opt, m, batch
    torch.cuda.empty_cache()
    return {"mesh": list(POD_MESH), "step_ms": dt * 1e3, "loss": loss,
            "peak_bytes": peak, "pod_dispatches": by_phase,
            "leaves": n_leaves}


# ---------------------------------------------------------------------------
# the MoE serve (phase 15)
# ---------------------------------------------------------------------------

# phi3.5-moe-42b-a6.6b (src/repro/configs/phi3_5_moe.py) at full width:
# d_model 4096, 32 heads and 8 KV heads of 128, 16 experts of d_ff 6400,
# top-2, capacity factor 1.25, vocab 32064, untied head; cut in depth only,
# to 16 of its 32 layers.  One layer is 1.30 B parameters (the experts
# 16 x 3 x 4096 x 6400 = 1.258 B, attention 41.9 M), 2.60 GB in bf16: all
# 32 would be 83.2 GB, more than the card holds; 16 are 41.6 GB, plus
# 0.53 GB of embedding and head.  TP P stacked: 2 experts, 4 q heads and
# 1 KV head per rank; the requests of phase 10.
MOE_ARCH, MOE_LAYERS = "phi3.5-moe-42b-a6.6b", 16
# the forced serve: alltoall on a mock-up whatever the tuner picked
MOE_FORCE = "alltoall:alg=alltoall_as_ppermute"
# the router readings: prefill-only serves with the allreduce forced to
# each mock-up that adds the p bf16 partial sums in another order
# (MOE_REORDERS: recursive doubling rounds at each of its log2(p) rounds
# where the default rounds once), so the residual stream and the float32
# router probabilities move a little and near-ties among the routes may
# flip; to each quantized wire (MOE_LOSSY, accuracy-conditional: read,
# not held); and to the planted wrong allreduce MOE_PLANTED (each rank's
# own partial sum left out), which the bound must refuse
MOE_REORDERS = ("allreduce_as_reduce_bcast", "allreduce_as_tree_reduce_bcast",
                "allreduce_as_rsb_allgather", "allreduce_as_rs_allgatherv",
                "allreduce_as_doubling")
MOE_LOSSY = ("wire_q8", "wire_fp8")
MOE_PLANTED = "planted_own_partial_left_out"
# the largest move of a router probability between two serves that
# ``route_changes`` takes for a change of rounding order, not a fault.
# Readings at layer 0 of the prefill (router_readings, NVIDIA H100 80GB
# HBM3, 700.00 W): allreduce_as_doubling 3.257e-03; wire_fp8 6.998e-02
# and wire_q8 2.005e-01; the planted fault 4.286e-01.  The bound sits
# ~10x above the reordering and ~2x below the nearest of the others.
ROUTE_MOVE_BOUND = 2.0 ** -5
# moe_block on the card against the same call on the CPU, float32, one
# layer's weights at the serve's prefill shape: float32 products of K =
# 4096 and 6400 in another order differ by ~1e-6 of the output's
# max-norm; a choice dropped or sent to another expert moves its row by
# O(1)
MOE_CHECK_RTOL = 1e-4


class RouteProbe:
    """Records rank 0's routing of every ``moe_block`` call while active:
    the router probabilities ``[T, E]``, the expert ids ``[T, k]`` and the
    keep decision ``[T*k]`` (on the device), and whether every lane chose
    the same ids.  It wraps ``models.moe._route`` and ``_keep``, which
    ``moe_block`` looks up at call time."""

    def __init__(self, moe):
        self.moe = moe
        self.real = (moe._route, moe._keep)
        self.calls: list[dict] = []

    def __enter__(self):
        real_route, real_keep = self.real

        def route(p, cfg, xt):
            probs, gates, ids = real_route(p, cfg, xt)
            self.calls.append({"probs": probs[0], "ids": ids[0],
                               "lanes_agree": (ids == ids[:1]).all()})
            return probs, gates, ids

        def keep(cfg, flat_e, t):
            out = real_keep(cfg, flat_e, t)
            self.calls[-1]["keep"] = out[1][0]
            return out
        self.moe._route, self.moe._keep = route, keep
        return self

    def __exit__(self, *exc):
        self.moe._route, self.moe._keep = self.real

    def host(self) -> list[dict]:
        return [{k: (v.cpu() if k != "lanes_agree" else bool(v))
                 for k, v in c.items()} for c in self.calls]


def route_changes(torch, a: list, b: list, n_layers: int, batch: int,
                  prompt: int, k: int, rtol: float) -> dict:
    """Compare two serves' routes, call by call (``n_layers`` prefill calls
    over ``batch * prompt`` tokens, then ``n_layers`` per decode step, one
    token a request).  A route is the set of a (layer, token)'s k experts
    and which of its choices were kept.  For each request, the first call
    where any of its routes changed.  In each call, the perturbation is
    the largest move of a router probability between the two serves over
    the routes of requests not changed before; it must stay below
    ``rtol``, and every route that changed there must have been a
    near-tie in ``a``: the gap between its k-th and (k+1)-th router
    probability at most twice the perturbation.  A kept set that changed
    with no route change of its own must follow a changed route earlier
    in the same call (the capacity order).  Routes after a request's first
    change see other inputs and are not held.  Returns ``{"changed":
    [...], "first": {request: (call, step)}, "held_steps": [...],
    "max_move": x, "differ": n}`` (``differ``: the routes whose experts
    differ over all calls, downstream ones included); raises on a
    breach."""
    first: dict[int, tuple[int, int]] = {}
    changed, max_move, differ = [], 0.0, 0
    for ci, (ca, cb) in enumerate(zip(a, b)):
        step = 0 if ci < n_layers else 1 + (ci - n_layers) // n_layers
        layer = ci % n_layers
        rows = batch * prompt if step == 0 else batch
        req = (torch.arange(rows) // prompt if step == 0
               else torch.arange(rows))
        ids_a = torch.sort(ca["ids"], -1).values
        ids_b = torch.sort(cb["ids"], -1).values
        moved = (ids_a != ids_b).any(-1)                            # [T]
        kept = (ca["keep"] != cb["keep"]).view(rows, k).any(-1)    # [T]
        differ += int(moved.sum())
        live = torch.tensor([int(r) not in first for r in req])
        move = float((ca["probs"] - cb["probs"]).abs().amax(-1)[live].max()
                     ) if bool(live.any()) else 0.0
        max_move = max(max_move, move)
        if move > rtol:
            raise RuntimeError(f"call {ci} (layer {layer}, step {step}): the "
                               f"router moved by {move:.3e} > {rtol}")
        new = (moved | kept) & live
        if not bool(new.any()):
            continue
        top = torch.topk(ca["probs"], k + 1, dim=-1).values
        gap = top[:, k - 1] - top[:, k]
        for t in new.nonzero().flatten().tolist():
            r = int(req[t])
            if bool(moved[t]):
                entry = {"call": ci, "layer": layer, "step": step,
                         "token": t, "request": r,
                         "ids": [ids_a[t].tolist(), ids_b[t].tolist()],
                         "gap": float(gap[t]), "bound": 2 * move}
                changed.append(entry)
                if not entry["gap"] <= 2 * move:
                    raise RuntimeError(f"route changed where it was no "
                                       f"near-tie: {entry}")
            elif not bool(moved[:t].any()):
                raise RuntimeError(f"call {ci}: the kept set of token {t} "
                                   "changed with no route change before it")
        for r in set(req[new].tolist()):
            first[int(r)] = (ci, step)
    n_steps = 1 + (len(a) - n_layers) // n_layers
    held_steps = [first[r][1] if r in first else n_steps
                  for r in range(batch)]
    return {"changed": changed, "first": first, "held_steps": held_steps,
            "max_move": max_move, "differ": differ}


def check_held(sv, torch, ref, got, held_steps: list, rtol: float) -> dict:
    """``launch.serve.check_serves`` request by request, over the steps
    whose logits no changed route reached (a route changed at step s
    reaches the logits of step s on: the prefill's position for s = 0)."""
    out = {}
    for r, h in enumerate(held_steps):
        if not h:
            out[r] = None
            continue
        sub = [sv.ServeResult(x.tokens[r:r + 1, :h],
                              [lg[r:r + 1] for lg in x.logits[:h]], 0.0, 0.0,
                              None) for x in (ref, got)]
        out[r] = sv.check_serves(*sub, rtol)
    return out


@contextlib.contextmanager
def forced_env(spec: str):
    """``PGTUNE_MODULE=spec`` for the calls inside (the dispatcher's
    environment force, which every ``api.tuned`` context honours)."""
    old = os.environ.get("PGTUNE_MODULE")
    os.environ["PGTUNE_MODULE"] = spec
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("PGTUNE_MODULE")
        else:
            os.environ["PGTUNE_MODULE"] = old


def hold_routes(torch, sv, cfg, tag: str, label: str, ref, ref_routes,
                got, got_routes) -> dict:
    """``route_changes`` between the default serve ``ref`` and ``got``
    (both probed), printed, then ``check_held`` on the logits no changed
    route reached; returns the summary."""
    n_tokens = len(ref.logits)
    for name, calls in (("default", ref_routes), (label, got_routes)):
        if len(calls) != cfg.n_layers * n_tokens:
            raise RuntimeError(f"{cfg.name} {name}: {len(calls)} routed "
                               f"calls, not {cfg.n_layers * n_tokens}")
        # an allreduce impl may leave the ranks' copies of the residual a
        # rounding apart; each rank then routes its own copy, as in the
        # JAX package, and the check reads rank 0's routes
        apart = sum(not c["lanes_agree"] for c in calls)
        log(f"[{tag}] {name} serve: ranks routed apart in {apart} of "
            f"{len(calls)} calls")
    rc = route_changes(torch, ref_routes, got_routes, cfg.n_layers,
                       SERVE_BATCH, SERVE_PROMPT, cfg.moe.top_k,
                       ROUTE_MOVE_BOUND)
    n_routes = cfg.n_layers * SERVE_BATCH * (SERVE_PROMPT + n_tokens - 1)
    by_step = {}
    for e in rc["changed"]:
        by_step[e["step"]] = by_step.get(e["step"], 0) + 1
    log(f"[{tag}] routes (layer, token) that changed between the default "
        f"and the {label} serve: {len(rc['changed'])} of {n_routes} (by "
        f"step, 0 = prefill: {by_step}); first change per request (call, "
        f"step): {rc['first']}; the router moved by at most "
        f"{rc['max_move']:.3e} on the routes of requests not changed "
        f"before (bound {ROUTE_MOVE_BOUND})")
    log(f"[{tag}] routes whose experts differ in all, downstream of the "
        f"first changes too: {rc['differ']} of {n_routes}")
    for e in rc["changed"][:12]:
        log(f"[{tag}]   changed: layer {e['layer']} step {e['step']} request "
            f"{e['request']} token {e['token']} experts {e['ids'][0]} -> "
            f"{e['ids'][1]}, gap {e['gap']:.3e} <= {e['bound']:.3e}")
    held = check_held(sv, torch, ref, got, rc["held_steps"], SERVE_RTOL)
    drift = {}
    for r, h in enumerate(rc["held_steps"]):
        if h == n_tokens:
            continue
        # not held: what the changed routes did to the request's logits,
        # step by step until its greedy tokens part
        errs, parted = [], None
        for i, (la, lb) in enumerate(zip(ref.logits, got.logits)):
            la, lb = la[r].float(), lb[r].float()
            errs.append(float((la - lb).abs().max() / la.abs().max()))
            if not bool(torch.equal(ref.tokens[r, i], got.tokens[r, i])):
                parted = i
                break
        drift[str(r)] = {"max_rel_err": max(errs), "tokens_parted_at": parted}
        log(f"[{tag}] {label}, request {r} (not held): logits max-norm "
            f"relative error {max(errs):.4e} over steps 0..{len(errs) - 1}, "
            f"greedy tokens parted at step {parted}")
    for r, res in held.items():
        log(f"[{tag}] {label}, request {r}: logits held over "
            f"{rc['held_steps'][r]} of {n_tokens} steps"
            + ("" if res is None else
               f", max-norm relative error {res['max_rel_err']:.4e} "
               f"(tolerance {SERVE_RTOL}), tokens diverged at "
               f"{res['diverged_at']}"))
    return {"changed": len(rc["changed"]), "changed_by_step": by_step,
            "max_move": rc["max_move"], "first": {str(r): v for r, v in
                                                  rc["first"].items()},
            "held_steps": rc["held_steps"], "differ": rc["differ"],
            "held": {str(r): v for r, v in held.items()}, "drift": drift,
            "gaps": [e["gap"] for e in rc["changed"]]}


def router_readings(torch, sv, moe, cfg, axis, params, prompts, ref,
                    ref_routes, tag: str) -> dict:
    """Prefill-only serves, probed, with the allreduce forced to each of
    ``MOE_REORDERS``, ``MOE_LOSSY`` and the planted ``MOE_PLANTED``: the
    move of the router probabilities at layer 0 (the first ``moe_block``
    call, whose input differs from the default serve ``ref``'s by one
    allreduce, the attention's) for each.  Each reordering serve is held
    by ``hold_routes`` against ``ref``'s prefill; the lossy ones are only
    read; the planted one must read above ``ROUTE_MOVE_BOUND``, and
    ``route_changes`` must refuse it."""
    from repro_torch.core import collectives as C

    n = cfg.n_layers
    real = C.REGISTRY["allreduce"]["default"]
    C.REGISTRY["allreduce"][MOE_PLANTED] = dataclasses.replace(
        real, name=MOE_PLANTED, guideline="EXT",
        fn=lambda x, ax, **kw: real.fn(x, ax, **kw) - x)
    read = {}
    try:
        for impl in MOE_REORDERS + MOE_LOSSY + (MOE_PLANTED,):
            with forced_env(f"allreduce:alg={impl}"), RouteProbe(
                    moe) as probe:
                res = sv.serve(cfg, axis, params, prompts, SERVE_SLOTS, 1)
            got = {r.impl for r in res.ctx.record if r.cell.op == "allreduce"}
            if got != {impl}:
                raise RuntimeError(f"{cfg.name} allreduce {impl}: ran {got}")
            calls = probe.host()
            move = float((ref_routes[0]["probs"] - calls[0]["probs"]).abs()
                         .max())
            log(f"[{tag}] router reading, allreduce {impl}: the router "
                f"probabilities moved by {move:.3e} at layer 0 of the "
                f"prefill (bound {ROUTE_MOVE_BOUND:.3e})")
            read[impl] = (res, calls, move)
    finally:
        del C.REGISTRY["allreduce"][MOE_PLANTED]
    _, calls, move = read.pop(MOE_PLANTED)
    if not move > ROUTE_MOVE_BOUND:
        raise RuntimeError(f"the router move bound passes the planted "
                           f"wrong allreduce ({move:.3e})")
    try:
        route_changes(torch, ref_routes[:n], calls, n, SERVE_BATCH,
                      SERVE_PROMPT, cfg.moe.top_k, ROUTE_MOVE_BOUND)
    except RuntimeError as e:
        if "router moved" not in str(e):
            raise
    else:
        raise RuntimeError("route_changes passes the planted wrong allreduce")
    out = {MOE_PLANTED: {"move_layer0": move}}
    out.update({impl: {"move_layer0": read.pop(impl)[2]}
                for impl in MOE_LOSSY})
    pre = sv.ServeResult(ref.tokens[:, :1], ref.logits[:1], ref.prefill_s,
                         0.0, ref.ctx)
    for impl, (res, calls, move) in read.items():
        out[impl] = hold_routes(torch, sv, cfg, tag, f"{impl} prefill", pre,
                                ref_routes[:n], res, calls)
        out[impl]["move_layer0"] = move
    return out


def moe_block_check(torch, dev, cfg, card: str, tag: str) -> dict:
    """``moe_block`` at the serve's prefill shape on the card against the
    same call on the CPU, from the same float32 weights (one layer drawn
    on the card): the same expert ids and kept choices first, then the
    outputs within ``MOE_CHECK_RTOL`` of their max-norm and the aux.  The
    tokens share one random offset, as a residual stream's do, so the
    router favours some experts and choices are dropped over capacity
    (the drop bin of the dispatch is written); it fails if none is."""
    from repro_torch.core._axis import StackedAxis
    from repro_torch.dist.axes import bind
    from repro_torch.models import moe
    from repro_torch.models.params import init_tree

    c32 = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    params = init_tree(moe.moe_specs(c32), gen, StackedAxis(P, dev))
    x1 = torch.randn(1, SERVE_BATCH, SERVE_PROMPT, cfg.d_model,
                     generator=gen, device=dev) + 0.5 * torch.randn(
                         cfg.d_model, generator=gen, device=dev)
    out = []
    for where in (dev, torch.device("cpu")):
        axis = StackedAxis(P, where)
        p = {k: v.to(where) for k, v in params.items()}
        x = x1.to(where).expand(P, *x1.shape[1:])
        t0 = time.perf_counter()
        with bind(model=axis), RouteProbe(moe) as probe:
            y, aux = moe.moe_block(p, c32, x)
        if where.type == "cuda":
            torch.cuda.synchronize()
        out.append((probe.host()[0], y.cpu(), aux.cpu(),
                    time.perf_counter() - t0))
        del p, x, y
    (pa, ya, aa, ta), (pb, yb, ab, tb) = out
    same = torch.equal(pa["ids"], pb["ids"])
    err = float((ya - yb).abs().max() / yb.abs().max())
    aux_err = float((aa - ab).abs().max() / ab.abs().max())
    log(f"[{tag}] moe_block float32 at [{P}, {SERVE_BATCH}, {SERVE_PROMPT}, "
        f"{cfg.d_model}] (TP {P}, {cfg.moe.n_experts} experts, capacity "
        f"{moe._capacity(SERVE_BATCH * SERVE_PROMPT, cfg)}): {card} "
        f"{ta:.2f} s, CPU {tb:.2f} s; expert ids equal: {same}; kept "
        f"choices {int(pa['keep'].sum())} of {pa['keep'].numel()}; output "
        f"max-norm relative error {err:.3e} (tolerance {MOE_CHECK_RTOL}), "
        f"aux {aa[0].item():.6f} vs {ab[0].item():.6f}")
    if bool(pa["keep"].all()):
        raise RuntimeError("moe_block check: no choice was dropped")
    if not same or not torch.equal(pa["keep"], pb["keep"]):
        bad = (pa["ids"] != pb["ids"]).any(-1).nonzero().flatten()[:8]
        raise RuntimeError(f"moe_block: expert ids differ between the card "
                           f"and the CPU at tokens {bad.tolist()}")
    if not (err <= MOE_CHECK_RTOL and aux_err <= MOE_CHECK_RTOL):
        raise RuntimeError(f"moe_block: card vs CPU {err:.3e}, aux "
                           f"{aux_err:.3e} > {MOE_CHECK_RTOL}")
    del params
    return {"max_rel_err": err, "aux_rel_err": aux_err, "card_s": ta,
            "cpu_s": tb}


def moe_serve_phase(torch, dev, out_dir: pathlib.Path, wrappers: dict,
                    card: str, tag: str = "15") -> dict:
    """Serve phi3.5-moe-42b-a6.6b (``MOE_LAYERS`` layers, full width) on
    the card: (a) the default serve, recording, with rank 0's routes
    probed; ``tune_trace`` of the trace (measured; the alltoall cells
    among them), the per-phase profiles saved and reloaded; (b) the tuned
    re-serve, probed: every changed route a near-tie, the logits of every
    request no changed route reached within ``SERVE_RTOL``; (c) the
    default serve again, unprobed (the times of record): logits bit-equal
    to (a)'s; (d) the serve with ``MOE_FORCE``: logits bit-equal to (a)'s;
    Flash must launch once per layer and forward in each serve (``wgmma``
    at prefill, ``split_kv`` at decode).  (e) ``router_readings``, then
    ``torch.profiler`` over one prefill and one decode step, and
    ``moe_block_check``.  The times,
    rates and memory sizes it prints name ``card`` (``nvidia-smi``'s name
    and power limit)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import api, profiles, trace, tuner
    from repro_torch.core._axis import StackedAxis
    from repro_torch.dist.axes import bind
    from repro_torch.launch import serve as sv
    from repro_torch.models import lm, moe
    from repro_torch.models.params import init_tree, tree_leaves

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(MOE_ARCH), attn_impl="flash",
                              n_layers=MOE_LAYERS)
    m = cfg.moe
    axis = StackedAxis(P, dev)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_tree(lm.model_specs(cfg, P), gen, axis)
    torch.cuda.synchronize()
    w_bytes = sum(t.numel() * t.element_size()
                  for t in tree_leaves(params))
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} of 32 layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV heads x "
        f"{cfg.hd}, {m.n_experts} experts of d_ff {m.d_ff_expert}, top-"
        f"{m.top_k}, capacity factor {m.capacity_factor}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}, attn_impl {cfg.attn_impl}; TP {P} "
        f"stacked ({m.n_experts // P} experts, {cfg.n_heads // P} q heads "
        f"per rank); weights {w_bytes / 1e9:.3f} GB "
        f"({cfg.param_count() / 1e9:.3f} B params) drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    cap = {"prefill": moe._capacity(SERVE_BATCH * SERVE_PROMPT, cfg),
           "decode": moe._capacity(SERVE_BATCH, cfg)}
    log(f"[{tag}] capacity per expert: {cap}; dispatch buffer "
        f"[{m.n_experts * cap['prefill'] + 1}, {cfg.d_model}] a lane at "
        f"prefill; router: ops.matmul_accumulate over the unbound data axis, "
        f"a plain float32 torch.matmul [{P}, {SERVE_BATCH * SERVE_PROMPT}, "
        f"{cfg.d_model}] @ [{P}, {cfg.d_model}, {m.n_experts}] (nothing "
        f"dispatched, no block_matmul)")
    rng = np.random.default_rng(SEED)
    prompts = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT)), device=dev)
    n_tokens = 1 + SERVE_DECODE
    per_serve = per_serve_launches(lm, cfg, n_tokens)
    sv.serve(cfg, axis, params, prompts, SERVE_SLOTS, 2)   # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    fa = wrappers["flash_attention"]

    zero_counts(wrappers)               # the MoE serve path starts here
    c0 = counts(wrappers)

    def one(label, **kw):
        before, p_before = counts(wrappers), dict(fa.launches_by_path)
        res = sv.serve(cfg, axis, params, prompts, SERVE_SLOTS, n_tokens,
                       **kw)
        after = counts(wrappers)
        got = {k: after[k] - before[k] for k in after}
        paths = path_delta(fa, p_before)
        log(f"[{tag} {label}] kernel launches: {json.dumps(got)}; "
            f"flash_attention by path {json.dumps(paths)}")
        for kname, want in per_serve.items():
            if got[kname] != want:
                raise RuntimeError(f"{cfg.name} {label}: {kname} launched "
                                   f"{got[kname]} times, not {want}")
        want_paths = dict.fromkeys(paths, 0)
        want_paths.update(wgmma=cfg.n_layers,
                          split_kv=cfg.n_layers * (n_tokens - 1))
        if paths != want_paths:
            raise RuntimeError(f"{cfg.name} {label}: flash paths {paths}, "
                               f"not {want_paths}")
        return res

    with RouteProbe(moe) as probe_a:
        first = one("default serve")
    serve_peak = torch.cuda.max_memory_allocated(dev)
    rec = trace.Trace.from_context(first.ctx)
    rec.save(out_dir / f"serve_trace_{cfg.name}.jsonl")
    for ln in rec.summary().splitlines():
        log(f"[{tag}] {ln}")
    a2a = [r for r in first.ctx.record if r.cell.op == "alltoall"]
    a2a_bytes = {ph: max(r.cell.nbytes for r in a2a if r.phase == ph)
                 for ph in ("prefill", "decode")}
    log(f"[{tag}] alltoall dispatches of the default serve: {len(a2a)} "
        f"(bytes a rank: {a2a_bytes})")
    want_a2a = 2 * cfg.n_layers * n_tokens
    if len(a2a) != want_a2a or any(r.cell.op == "matmul_accumulate"
                                   for r in first.ctx.record):
        raise RuntimeError(f"{cfg.name}: {len(a2a)} alltoall dispatches, not "
                           f"{want_a2a}, or the router dispatched")
    t0 = time.perf_counter()
    rep = tuner.tune_trace(rec, tuner.MeasuredBackend(P, dev, max_nrep=20))
    log(f"[{tag}] tune_trace in {time.perf_counter() - t0:.1f} s")
    a2a_cells = {}
    for mm in rep.measurements:
        log(f"[{tag}] measured {mm.op} {mm.nbytes}B {mm.impl}: "
            f"{mm.latency * 1e3:.4f} ms (nrep {mm.nrep})")
        if mm.op == "alltoall":
            a2a_cells.setdefault(mm.nbytes, {})[mm.impl] = mm.latency * 1e3
    for nb, lat in sorted(a2a_cells.items()):
        log(f"[{tag}] alltoall cell {nb} B a rank (ms, replayed at {P} x "
            f"its bytes; {card}): " + ", ".join(
            f"{k} {v:.4f}" for k, v in lat.items()) + "; mock-up / default "
            + ", ".join(f"{k} {v / lat['default']:.3f}" for k, v in
                        lat.items() if k != "default"))
    if not a2a_cells:
        raise RuntimeError(f"{cfg.name}: tune_trace measured no alltoall cell")
    for ln in rep.summary().splitlines():
        log(f"[{tag}] {ln}")
    prof_dir = out_dir / f"serve_profiles_{cfg.name}"
    shutil.rmtree(prof_dir, ignore_errors=True)
    rep.save(prof_dir)
    _, phases = profiles.resolve_stores(prof_dir)
    log(f"[{tag}] per-phase profiles saved to {prof_dir} and reloaded: "
        f"{ {ph: len(st) for ph, st in phases.items()} }")
    with RouteProbe(moe) as probe_b:
        second = one("tuned re-serve", phase_profiles=phases)
    footer = api.format_footer(second.ctx)
    for ln in footer.splitlines():
        log(f"[{tag}] {ln}")
    if "MPI_Alltoall" not in footer:
        raise RuntimeError(f"{cfg.name}: no alltoall in the tuned footer")
    picks = sorted({(r.cell.op, r.phase, r.impl) for r in second.ctx.record})
    log(f"[{tag}] tuned picks (op, phase, impl): {picks}")

    # (b) routes, then the logits they did not reach
    ra = probe_a.host()
    routes = {"tuned": hold_routes(torch, sv, cfg, tag, "tuned", first, ra,
                                   second, probe_b.host())}

    # (c) the default serve again, unprobed: bit for bit
    third = one("default serve again")
    same = all(torch.equal(a, b) for a, b in zip(first.logits,
                                                   third.logits))
    log(f"[{tag}] default serve repeated: logits bit-equal {same}, tokens "
        f"equal {torch.equal(first.tokens, third.tokens)}")
    if not same or not torch.equal(first.tokens, third.tokens):
        raise RuntimeError(f"{cfg.name}: the default serve does not repeat")

    # (d) alltoall forced to a mock-up
    with forced_env(MOE_FORCE):
        forced = one("forced serve")
    f_impls = {r.impl for r in forced.ctx.record if r.cell.op == "alltoall"}
    f_same = all(torch.equal(a, b) for a, b in zip(first.logits,
                                                     forced.logits))
    log(f"[{tag}] forced serve ({MOE_FORCE}): alltoall impls {f_impls}, "
        f"logits bit-equal to the default serve's {f_same}")
    if f_impls != {"alltoall_as_ppermute"} or not f_same:
        raise RuntimeError(f"{cfg.name}: forced serve {f_impls}, bit-equal "
                           f"{f_same}")

    peak = torch.cuda.max_memory_allocated(dev)
    c1 = counts(wrappers)
    launches = {k: c1[k] - c0[k] for k in c1}
    log(f"[moe serve path {cfg.name}] kernel launches: "
        f"{json.dumps(launches)}")

    # (e) the router readings (after the path's counts)
    routes.update(router_readings(torch, sv, moe, cfg, axis, params,
                                  prompts, first, ra, tag))

    # drops at prefill, per layer, from the default serve's routes
    drops = [int((~c["keep"]).sum()) for c in ra[:cfg.n_layers]]
    both = [int((~c["keep"].view(-1, m.top_k)).all(-1).sum())
            for c in ra[:cfg.n_layers]]
    log(f"[{tag}] choices dropped over capacity {cap['prefill']} at prefill, "
        f"per layer (of {SERVE_BATCH * SERVE_PROMPT * m.top_k}): {drops}; "
        f"tokens with both choices dropped: {both}")
    serves = {}
    for label, res in (("default", first), ("tuned", second),
                       ("default again", third), ("forced", forced)):
        toks = res.tokens.cpu()
        if tuple(toks.shape) != (SERVE_BATCH, n_tokens) or not bool(
                all(torch.isfinite(lg).all() for lg in res.logits)):
            raise RuntimeError(f"{cfg.name} {label} serve: bad output")
        log(f"[{tag}] {cfg.name} {label} serve ({card}): prefill "
            f"{res.prefill_s * 1e3:.2f} ms "
            f"({SERVE_BATCH * SERVE_PROMPT / res.prefill_s:.0f} tokens/s), "
            f"decode {res.decode_s_per_token * 1e3:.3f} ms/token "
            f"({SERVE_BATCH / res.decode_s_per_token:.1f} tokens/s over "
            f"{SERVE_BATCH} requests), {SERVE_BATCH * n_tokens} tokens in "
            f"{(res.prefill_s + res.decode_s) * 1e3:.1f} ms")
        serves[label] = {"prefill_ms": res.prefill_s * 1e3,
                         "decode_ms_per_token": res.decode_s_per_token * 1e3,
                         "tokens": toks.tolist()}
    log(f"[{tag}] default tokens, request 0: {first.tokens[0].tolist()}")
    log(f"[{tag}] {cfg.name} peak device memory ({card}): the default "
        f"serve {serve_peak / 1e9:.3f} GB, with tune_trace's replay "
        f"{peak / 1e9:.3f} GB")

    # where a step's device time goes (after the path's counts)
    with bind(model=axis):
        caches = lm.init_caches(cfg, SERVE_BATCH, SERVE_SLOTS)
    pf, dc = sv.build_prefill(cfg, axis), sv.build_decode(cfg, axis)
    tok = prompts[:, :1]
    needles = ("fa_wgmma_kernel", "fa_split_kernel", "nvjet", "gemm",
               "index", "scan")
    shares = {
        "prefill": profile_call(torch, f"{cfg.name} one prefill", lambda: pf(
            params, {"tokens": prompts}, caches), tag, needles),
        "decode": profile_call(torch, f"{cfg.name} one decode step",
                               lambda: dc(params, tok, caches, SERVE_PROMPT),
                               tag, needles)}
    del params, caches, first, second, third, forced
    torch.cuda.empty_cache()
    block = moe_block_check(torch, dev, cfg, card, tag)
    log(f"[{tag}] MoE serve phase in {time.perf_counter() - t_phase:.1f} s "
        f"({card})")
    return {"launches": launches, "per_serve": per_serve,
            "peak_bytes": peak, "serve_peak_bytes": serve_peak,
            "weights_bytes": w_bytes, "capacity": cap,
            "drops_prefill": drops, "both_dropped_prefill": both,
            "alltoall_ms": {str(k): v for k, v in a2a_cells.items()},
            "picks": picks, "routes": routes,
            "shares": shares, "serves": serves, "moe_block": block}


def block(api, axis, torch, x, wv, wo, wgu, wd):
    """One llama3.2-3b sequence-parallel block on stacked ranks.

    x ``[p, T/p, D]`` is the sequence-sharded residual.  The attention is
    stood in by its value projection (a plain torch.matmul; the slice has
    no attention kernel), whose ``[T, 384]`` per-rank output feeds the
    attn-out matmul-reducescatter.  The MLP is llama's SwiGLU: the gate and
    up projections are one allgather-matmul (``wgu [p, D, 2F/p]``, gate
    then up), and ``silu(g) * u`` feeds the MLP-down
    matmul-reducescatter."""
    h = api.allgather(x, axis)                                # [p, T, D]
    o = api.matmul_reducescatter(torch.matmul(h, wv), wo, axis)
    x2 = x + o
    g, u = api.allgather_matmul(x2, wgu, axis).chunk(2, dim=-1)
    u = torch.nn.functional.silu(g) * u                       # [p, T, F/p]
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
    from repro_torch.kernels import collective_matmul_rdma as rdma
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import quant
    from repro_torch.kernels import rwkv6_scan as rw
    from repro_torch.kernels import ssd_mamba2 as ssd
    from repro_torch.kernels.variants import call_device_ms, device_ms

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

    def nvcc_build(mod):
        try:
            mod.build()
        except BaseException as e:      # re-raised below, in this thread
            errs.append(e)

    threads = [threading.Thread(target=nvcc_build, args=(m,))
               for m in (cmm, rdma, fa, rw, ssd)]  # one nvcc per source
    for th in threads:
        th.start()
    for dt in (torch.float32, torch.bfloat16):     # Triton JIT per dtype
        pack.guideline_pack(torch.ones(1, 4, 4, dtype=dt, device=dev),
                            torch.zeros(1, dtype=torch.int32, device=dev), 2)
    quant.build()
    for th in threads:
        th.join()
    if errs:
        raise errs[0]
    torch.cuda.synchronize()
    log(f"[2] kernels built in {time.perf_counter() - t0:.1f} s")
    for lib in ("block_matmul", "agmm_ring", "flash_attention",
                "rwkv6_scan", "ssd_scan"):
        for ln in _build.build_log(lib).splitlines():
            if "Function properties for" in ln:
                log(f"[2] ptxas {lib}: {ln.split('for ', 1)[1][:100]}")
            elif "registers" in ln or "spill" in ln or "smem" in ln:
                log(f"[2] ptxas {lib}:   {ln.strip()}")
    for dt in (torch.bfloat16, torch.float32):
        log(f"[2] agmm_ring blocks per rank at p={P}, n={TOKENS // P}, "
            f"m={2 * D_FF // P}, {dt}: "
            f"{rdma.blocks_per_rank(dt, P, TOKENS // P, 2 * D_FF // P)}")

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
        ms=device_ms(lambda: pack.guideline_pack(xs, idx, P), "_pack_kernel"),
        plain_ms=time_ms(torch, lambda: pack.guideline_pack_plain(xs, idx,
                                                                   P)),
        bound_ms=nbytes / H100_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None,
        events_ms=time_ms(torch, lambda: pack.guideline_pack(xs, idx, P)))
    log(f"[3] guideline_pack x{list(xs.shape)} bf16 p={P}: max_abs_err "
        f"{err} (tolerance 0: a copy) kernel device time "
        f"{kernels['guideline_pack']['ms']:.4f} ms (events mean "
        f"{kernels['guideline_pack']['events_ms']:.4f} ms) plain "
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

    def mm_err(label, got, want):
        """Max error of a float32-accumulated product against its plain
        version: 1e-5 of the output's magnitude in float32, one rounding
        step (2**-7) in a 16-bit type."""
        err = float((got.float() - want.float()).abs().max())
        scale = max(1.0, float(want.float().abs().max()))
        tol = (2.0 ** -7 if got.dtype != torch.float32 else 1e-5) * scale
        if tuple(got.shape) != tuple(want.shape) or not err <= tol:
            raise RuntimeError(f"{label}: error {err} > tolerance {tol} "
                               f"(shape {tuple(got.shape)})")
        return err, tol

    def mm_case(B, m, k, n, dt, shared_w=False):
        x = randn(B, m, k, dtype=dt)
        w = randn(*(() if shared_w else (B,)), k, n, dtype=dt,
                  scale=k ** -0.5)
        before = dict(cmm.block_matmul.launches_by_path)
        got = cmm.block_matmul(x, w)
        path = "/".join(k_ for k_, n_ in path_delta(
            cmm.block_matmul, before).items() if n_)
        err, tol = mm_err(f"block_matmul {B}x{m}x{k}x{n} {dt}", got,
                          cmm.block_matmul_plain(x, w))
        return x, w, err, tol, path

    # the main path's ring steps, all 8 ranks in one launch: MLP-down and
    # attn-out (matmul-reducescatter), the K/V accumulate at 4096 and 512
    # rows; the kernel's device time (torch.profiler) is the ms of record,
    # the events mean over back-to-back calls (with the wrapper's host
    # time) beside it, torch.matmul's device time the library's
    name_dt = {torch.bfloat16: "bfloat16", torch.float32: "float32"}
    needle = {"wgmma": "bm_wgmma", "wmma": "mm_tc", "f32": "mm_f32"}
    report["block_matmul"] = {}
    for label, (m, k, n) in (
            ("mlp-down", (TOKENS // P, D_FF // P, D_MODEL)),
            ("attn-out", (TOKENS // P, HEADS * HEAD_DIM // P, D_MODEL)),
            ("K/V accumulate", (TOKENS, D_MODEL // P, KV)),
            ("K/V accumulate 512 rows", (TOKENS // P, D_MODEL // P, KV))):
        for dt in (torch.bfloat16, torch.float32):
            if dt == torch.float32 and label.startswith("K/V"):
                continue
            x, w, err, tol, path = mm_case(P, m, k, n, dt)
            if dt == torch.bfloat16 and path != "wgmma":
                raise RuntimeError(f"block_matmul {label} bf16 took {path}")
            flops = 2 * P * m * k * n
            byts = (x.numel() + w.numel() + P * m * n) * x.element_size()
            t_b, t_f = byts / H100_BYTES_PER_S, flops / H100_FLOPS[name_dt[dt]]
            rec = dict(
                name="block_matmul", route="cuda",
                source="src/repro_torch/kernels/csrc/block_matmul.cu",
                replaces="src/repro/kernels/collective_matmul.py:124",
                max_abs_err=err,
                ms=device_ms(lambda: cmm.block_matmul(x, w), needle[path]),
                plain_ms=time_ms(torch, lambda: cmm.block_matmul_plain(x, w)),
                bound_ms=max(t_b, t_f) * 1e3,
                bound_by="bytes" if t_b > t_f else "operations",
                library_ms=call_device_ms(lambda: torch.matmul(x, w)),
                events_ms=time_ms(torch, lambda: cmm.block_matmul(x, w)),
                path=path)
            tile = (f", tile 128x{cmm.block_matmul_tile_n(P, m, n)}"
                    if path == "wgmma" else "")
            log(f"[3] block_matmul {label} [{P},{m},{k}]@[{P},{k},{n}] "
                f"{name_dt[dt]} path {path}{tile}: max_abs_err {err:.3e} "
                f"(tolerance {tol:.3e}) kernel device time {rec['ms']:.4f} "
                f"ms (events mean {rec['events_ms']:.4f} ms) plain "
                f"{rec['plain_ms']:.4f} ms torch.matmul device time "
                f"{rec['library_ms']:.4f} ms bound {rec['bound_ms']:.4f} ms "
                f"({rec['bound_by']}) = "
                f"{flops / rec['ms'] / 1e9:.1f} TFLOP/s")
            report["block_matmul"][f"{label} {name_dt[dt]}"] = rec
            if label == "mlp-down" and dt == torch.bfloat16:
                kernels["block_matmul"] = rec
    # the 2-D ring's chunk products at the data x model step (phase 13),
    # all 8 lanes of the (data 2, model 4) mesh in one launch: forward, x's
    # row block [512, K] against the weight block [K, 1536]; transpose, the
    # cotangent's column slice [1536, 512] against x's row block [512, K]
    t_loc, m_loc = MESH_T // MESH_Q, D_MODEL // MESH_D
    for site, k_ in MESH_SITES.items():
        for label, (m, k, n) in ((f"2d {site} fwd", (t_loc, k_, m_loc)),
                                 (f"2d {site} dw", (m_loc, t_loc, k_))):
            x, w, err, tol, path = mm_case(MESH_D * MESH_Q, m, k, n,
                                           torch.bfloat16)
            if path != "wgmma":
                raise RuntimeError(f"block_matmul {label} took {path}")
            L = MESH_D * MESH_Q
            flops = 2 * L * m * k * n
            byts = (x.numel() + w.numel() + L * m * n) * x.element_size()
            t_b, t_f = byts / H100_BYTES_PER_S, flops / H100_FLOPS["bfloat16"]
            rec = dict(ms=device_ms(lambda: cmm.block_matmul(x, w),
                                    needle[path]),
                       plain_ms=time_ms(torch, lambda: cmm.block_matmul_plain(
                           x, w)),
                       bound_ms=max(t_b, t_f) * 1e3,
                       library_ms=call_device_ms(lambda: torch.matmul(x, w)),
                       max_abs_err=err, path=path)
            report["block_matmul"][label] = rec
            log(f"[3] block_matmul {label} [{L},{m},{k}]@[{L},{k},{n}] "
                f"bfloat16 path {path}, tile 128x"
                f"{cmm.block_matmul_tile_n(L, m, n)}: max_abs_err {err:.3e} "
                f"(tolerance {tol:.3e}) kernel device time {rec['ms']:.4f} "
                f"ms plain {rec['plain_ms']:.4f} ms torch.matmul device "
                f"time {rec['library_ms']:.4f} ms bound {rec['bound_ms']:.4f}"
                f" ms = {flops / rec['ms'] / 1e9:.1f} TFLOP/s")
    for B, m, k, n, dt, shared in ((2, 100, 33, 17, torch.bfloat16, False),
                                   (3, 5, 256, 130, torch.float32, True),
                                   (1, 129, 72, 200, torch.float16, False),
                                   (2, 100, 72, 200, torch.bfloat16, False),
                                   (3, 130, 72, 136, torch.bfloat16, True),
                                   (8, 512, 1000, 3000, torch.bfloat16,
                                    True)):
        _, _, err, tol, path = mm_case(B, m, k, n, dt, shared)
        log(f"[3] block_matmul ragged [{B},{m},{k}]@[{k},{n}] {dt} "
            f"shared_w={shared} path {path}: max_abs_err {err:.3e} "
            f"(tolerance {tol:.3e})")
    log(f"[3] block_matmul launches by path: "
        f"{json.dumps(cmm.block_matmul.launches_by_path)}")

    # the all-gather-matmul ring (kernel 3) and its block tier (kernel 4):
    # the gathered rows must be bit-equal, the product within mm_err's rule
    def ring_case(p_, n, k, m, dt, shared_w):
        x = randn(p_, n, k, dtype=dt)
        w = randn(*(() if shared_w else (p_,)), k, m, dtype=dt,
                  scale=k ** -0.5)
        ax = StackedAxis(p_, dev)
        before = dict(rdma.ring_allgather_matmul_rdma.launches_by_path)
        out, gath = rdma.ring_allgather_matmul_rdma(x, w, ax,
                                                    return_gathered=True)
        path = [k_ for k_, n_ in path_delta(
            rdma.ring_allgather_matmul_rdma, before).items() if n_]
        want, want_g = rdma.ring_allgather_matmul_rdma_plain(
            x, w, return_gathered=True)
        label = (f"ring_allgather_matmul_rdma p={p_} [{n},{k}]@[{k},{m}] "
                 f"{dt} shared_w={shared_w}")
        if not torch.equal(gath, want_g):
            raise RuntimeError(f"{label}: gathered rows differ")
        err, tol = mm_err(label, out, want)
        log(f"[3] {label} path {'/'.join(path) or 'block_matmul'}: "
            f"gathered exact, max_abs_err "
            f"{err:.3e} (tolerance {tol:.3e})")
        return x, w, ax, err

    def blocks_case(x_all, w, my):
        out, gath = rdma.ring_allgather_matmul_blocks(x_all, w, my)
        want, want_g = rdma.ring_allgather_matmul_blocks_plain(x_all, w, my)
        label = (f"ring_allgather_matmul_blocks my={my} "
                 f"x_all{list(x_all.shape)} {x_all.dtype}")
        if not torch.equal(gath, want_g):
            raise RuntimeError(f"{label}: gathered rows differ")
        return mm_err(label, out, want)

    n_r, m_r = TOKENS // P, 2 * D_FF // P      # the gate/up GEMM per rank
    ring_paths0 = dict(rdma.ring_allgather_matmul_rdma.launches_by_path)
    for dt in (torch.bfloat16, torch.float32):
        x, w, ax, err = ring_case(P, n_r, D_MODEL, m_r, dt, False)
        gathered = rdma.ring_allgather_matmul_rdma(x, w, ax,
                                                   return_gathered=True)[1]
        flops = 2 * P * (P * n_r) * D_MODEL * m_r
        byts = (x.numel() + w.numel() + P * P * n_r * m_r) * x.element_size()
        t_b, t_f = byts / H100_BYTES_PER_S, flops / H100_FLOPS[name_dt[dt]]
        # the events mean over back-to-back calls holds each call's read of
        # the error words (a host round trip); the profiler gives the
        # kernel's own device time, the ms of record
        events_ms = time_ms(torch, lambda: rdma.ring_allgather_matmul_rdma(
            x, w, ax))
        rec = dict(
            name="ring_allgather_matmul_rdma", route="cuda",
            source="src/repro_torch/kernels/csrc/agmm_ring.cu",
            replaces="src/repro/kernels/collective_matmul_rdma.py:157",
            max_abs_err=err,
            ms=device_ms(lambda: rdma.ring_allgather_matmul_rdma(
                x, w, ax), "agmm_ring"),
            plain_ms=time_ms(torch,
                             lambda: rdma.ring_allgather_matmul_rdma_plain(
                                 x, w)),
            bound_ms=max(t_b, t_f) * 1e3,
            bound_by="bytes" if t_b > t_f else "operations",
            library_ms=time_ms(torch, lambda: torch.matmul(gathered, w)))
        default_ms = time_ms(torch, lambda: C.REGISTRY["allgather_matmul"][
            "default"].fn(x, ax, w=w))
        log(f"[3] ring_allgather_matmul_rdma p={P} [{n_r},{D_MODEL}]@"
            f"[{P},{D_MODEL},{m_r}] {name_dt[dt]}: kernel device time "
            f"{rec['ms']:.4f} ms (torch.profiler; events mean over "
            f"back-to-back calls {events_ms:.4f} ms) "
            f"plain {rec['plain_ms']:.4f} ms torch.matmul(gathered) "
            f"{rec['library_ms']:.4f} ms bound {rec['bound_ms']:.4f} ms "
            f"({rec['bound_by']}) = {flops / rec['ms'] / 1e9:.1f} TFLOP/s")
        log(f"[3] allgather_matmul default (stacked all-gather + "
            f"torch.matmul) {name_dt[dt]}: {default_ms:.4f} ms")
        if dt == torch.bfloat16:
            kernels["ring_allgather_matmul_rdma"] = rec
            report["ring_events_ms"] = events_ms
    for p_, n, k, m, dt, shared in (
            (1, 37, 100, 50, torch.float16, True),
            (2, 5, 7, 9, torch.bfloat16, False),
            (3, 100, 33, 17, torch.float16, False),
            (5, 129, 72, 200, torch.float32, True),
            (5, 61, 3000, 1000, torch.float16, False),
            (2, 61, 72, 200, torch.bfloat16, False),
            (3, 129, 72, 200, torch.bfloat16, False),
            (8, 129, 72, 200, torch.float16, True),
            (2, n_r, D_MODEL, m_r, torch.bfloat16, True)):
        ring_case(p_, n, k, m, dt, shared)
    ring_paths = path_delta(rdma.ring_allgather_matmul_rdma, ring_paths0)
    log(f"[3] ring_allgather_matmul_rdma launches by path: "
        f"{json.dumps(ring_paths)}")
    blocks0 = rdma.ring_allgather_matmul_blocks.launches
    xs4 = randn(5, 37, 100, dtype=torch.bfloat16)
    ws4 = randn(100, 50, dtype=torch.bfloat16, scale=0.1)
    for my in range(5):
        err, tol = blocks_case(xs4, ws4, my)
        log(f"[3] ring_allgather_matmul_blocks p=5 [37,100]@[100,50] bf16 "
            f"my={my}: gathered exact, max_abs_err {err:.3e} "
            f"(tolerance {tol:.3e})")
    x4 = randn(P, n_r, D_MODEL)
    w4 = randn(D_MODEL, m_r, scale=D_MODEL ** -0.5)
    err, tol = blocks_case(x4, w4, 0)
    flops = 2 * P * n_r * D_MODEL * m_r
    byts = (2 * x4.numel() + w4.numel() + P * n_r * m_r) * x4.element_size()
    t_b, t_f = byts / H100_BYTES_PER_S, flops / H100_FLOPS["bfloat16"]
    kernels["ring_allgather_matmul_blocks"] = dict(
        name="ring_allgather_matmul_blocks", route="cuda",
        source="src/repro_torch/kernels/csrc/agmm_ring.cu",
        replaces="src/repro/kernels/collective_matmul_rdma.py:232",
        max_abs_err=err,
        ms=device_ms(lambda: rdma.ring_allgather_matmul_blocks(
            x4, w4, 0), "agmm_ring"),
        plain_ms=time_ms(torch,
                         lambda: rdma.ring_allgather_matmul_blocks_plain(
                             x4, w4, 0)),
        bound_ms=max(t_b, t_f) * 1e3,
        bound_by="bytes" if t_b > t_f else "operations",
        library_ms=time_ms(torch, lambda: torch.matmul(
            x4.view(P * n_r, D_MODEL), w4)))
    kernels["ring_allgather_matmul_blocks"]["launches"] = (
        rdma.ring_allgather_matmul_blocks.launches - blocks0)
    rec = kernels["ring_allgather_matmul_blocks"]
    log(f"[3] ring_allgather_matmul_blocks launches by path: "
        f"{json.dumps(rdma.ring_allgather_matmul_blocks.launches_by_path)}")
    log(f"[3] ring_allgather_matmul_blocks my=0 x_all[{P},{n_r},{D_MODEL}] "
        f"@[{D_MODEL},{m_r}] bf16 (device time, torch.profiler): "
        f"max_abs_err {err:.3e} (tolerance "
        f"{tol:.3e}) kernel {rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} "
        f"ms torch.matmul {rec['library_ms']:.4f} ms bound "
        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")

    # the wire kernels (5 and 6): q bytes, scales and dequantized values
    # bit-equal with the plain versions (tolerance 0)
    def wire_case(x, wd, out_dtype, quiet=False):
        q, s = quant.quant_pack(x, wd)
        wq, ws = quant.quant_pack_plain(x, wd)
        out = quant.dequant_unpack(q, s, out_dtype)
        want = quant.dequant_unpack_plain(q, s, out_dtype)
        mism = int((q.view(torch.uint8) != wq.view(torch.uint8)).sum())
        ulp = int((s.view(torch.int32) - ws.view(torch.int32)).abs().max())
        deq_equal = bool(torch.equal(out, want))
        label = (f"quant_pack/dequant_unpack {wd} x{list(x.shape)} "
                 f"{x.dtype} -> {out_dtype}")
        if not quiet:
            log(f"[3] {label}: q mismatches {mism}, scales max ulp {ulp}, "
                f"dequant bit-equal {deq_equal}")
        if mism or ulp or not deq_equal:
            raise RuntimeError(f"{label} differs from plain")
        q_err = float((q.float() - wq.float()).abs().max())
        deq_err = float((out.float() - want.float()).abs().max())
        return q, s, q_err, deq_err

    wire_rec = {}
    for label, xw in (("allgather payload", randn(P, TOKENS // P, D_MODEL)),
                      ("MLP-down accumulator",
                       randn(P, TOKENS // P, D_MODEL, dtype=torch.float32,
                             scale=30.0))):
        for wd in quant.WIRE_DTYPES:
            q, s, q_err, deq_err = wire_case(xw, wd, xw.dtype)
            q_bytes = xw.numel() * (xw.element_size() + 1) + s.numel() * 4
            q_ev = time_ms(torch, lambda: quant.quant_pack(xw, wd))
            q_ms = device_ms(lambda: quant.quant_pack(xw, wd),
                             "_quant_kernel")
            q_plain = time_ms(torch, lambda: quant.quant_pack_plain(xw, wd))
            d_ev = time_ms(torch, lambda: quant.dequant_unpack(q, s,
                                                               xw.dtype))
            d_ms = device_ms(lambda: quant.dequant_unpack(q, s, xw.dtype),
                             "_dequant_kernel")
            d_plain = time_ms(torch, lambda: quant.dequant_unpack_plain(
                q, s, xw.dtype))
            bound = q_bytes / H100_BYTES_PER_S * 1e3
            log(f"[3] quant_pack {label} x{list(xw.shape)} {xw.dtype} -> "
                f"{wd}: kernel device time {q_ms:.4f} ms (events mean "
                f"{q_ev:.4f} ms) plain {q_plain:.4f} ms bound "
                f"{bound:.4f} ms (bytes) = "
                f"{q_bytes / q_ms / 1e6:.1f} GB/s; dequant_unpack kernel "
                f"device time {d_ms:.4f} ms (events mean {d_ev:.4f} ms) "
                f"plain {d_plain:.4f} ms bound {bound:.4f} ms")
            if label == "allgather payload" and wd == "int8":
                wire_rec["quant_pack"] = dict(
                    name="quant_pack", route="triton",
                    source="src/repro_torch/kernels/quant.py",
                    replaces="src/repro/kernels/quant.py:156",
                    max_abs_err=q_err, ms=q_ms, plain_ms=q_plain,
                    bound_ms=bound, bound_by="bytes", library_ms=None,
                    events_ms=q_ev)
                wire_rec["dequant_unpack"] = dict(
                    name="dequant_unpack", route="triton",
                    source="src/repro_torch/kernels/quant.py",
                    replaces="src/repro/kernels/quant.py:188",
                    max_abs_err=deq_err, ms=d_ms, plain_ms=d_plain,
                    bound_ms=bound, bound_by="bytes", library_ms=None,
                    events_ms=d_ev)
                # the cost model prices a whole call, host time included
                quant_bw = q_bytes / (q_ev * 1e-3)
    kernels.update(wire_rec)
    # the other shapes the main path gives them: the flat-op replay's
    # width-1 allgather payload (3 MiB bf16 per rank) and the accumulate
    # rings' K/V weight block [D_MODEL/P, KV] per rank
    for label, xw in (("replayed allgather payload",
                       randn(P, TOKENS // P * D_MODEL, 1)),
                      ("K/V weight block",
                       randn(P, D_MODEL // P, KV, scale=D_MODEL ** -0.5))):
        for wd in quant.WIRE_DTYPES:
            q, s, _, _ = wire_case(xw, wd, xw.dtype)
            q_ms = time_ms(torch, lambda: quant.quant_pack(xw, wd))
            d_ms = time_ms(torch, lambda: quant.dequant_unpack(q, s,
                                                               xw.dtype))
            log(f"[3] quant_pack {label} x{list(xw.shape)} -> {wd}: kernel "
                f"{q_ms:.4f} ms; dequant_unpack kernel {d_ms:.4f} ms")
    for p_ in (1, 3, 5):
        for n in (13, 3):
            for d in (5, 7):
                for dt in (torch.bfloat16, torch.float32):
                    for wd in quant.WIRE_DTYPES:
                        wire_case(randn(p_, n, d, dtype=dt, scale=10.0), wd,
                                  dt, quiet=True)
    log("[3] wire kernels ragged (p in 1,3,5; n in 13,3; d in 5,7; bf16, "
        "f32; int8, e4m3): q mismatches 0, scales max ulp 0, dequant "
        "bit-equal in all 48 cases")

    t0 = time.perf_counter()
    flash = check_flash(torch, fa, randn)
    log(f"[3] flash_attention checks in {time.perf_counter() - t0:.1f} s")
    kernels["flash_attention"] = flash["prefill"]
    report["flash_decode"] = flash["decode"]
    report["flash_zamba2_prefill_ms"] = flash["zamba2_prefill_ms"]
    report["flash_moe_prefill_ms"] = flash["moe_prefill_ms"]
    log(f"[3] flash_attention launches by path: "
        f"{json.dumps(fa.flash_attention.launches_by_path)}")
    t0 = time.perf_counter()
    scans = check_scans(torch, rw, ssd, randn, dev)
    log(f"[3] scan checks in {time.perf_counter() - t0:.1f} s")
    kernels["rwkv6_scan"] = scans["rwkv6_scan"]
    kernels["ssd_scan"] = scans["ssd_scan"]
    report["scan_decode"] = {"rwkv6_scan": scans["rwkv6_decode"],
                             "ssd_scan": scans["ssd_decode"]}

    # -- 4. selfcheck ----------------------------------------------------------
    for p_ in (P, 6):
        rep = selfcheck.run(p_, dev)
        log(f"[4] selfcheck p={p_}: {json.dumps(rep)}")
        log(f"[4] selfcheck p={p_}: {rep['total']} impls, demoted "
            f"{rep['demoted'] or 'none'}")
        if rep["failures"]:
            raise RuntimeError(f"selfcheck p={p_} failed: {rep['failures']}")
    rep = selfcheck.run_mesh((MESH_D, MESH_Q), dev)
    n_impls = sum(len(v) for v in C.REGISTRY.values())
    log(f"[4] selfcheck mesh {MESH_D}x{MESH_Q}: {json.dumps(rep)}")
    log(f"[4] selfcheck mesh {MESH_D}x{MESH_Q}: {rep['total']} checks over "
        f"{rep['impls']} of {n_impls} impls, demoted "
        f"{rep['demoted'] or 'none'}")
    if rep["failures"] or rep["impls"] != n_impls:
        raise RuntimeError(f"selfcheck mesh failed: {rep['failures']}, "
                           f"{rep['impls']} of {n_impls} impls")

    # -- 5. fit the h100-stacked Topo -------------------------------------------
    bench = measure.Bench(P, dev)
    sw_sizes = (1 << 10, 1 << 14, 1 << 18, 1 << 20, 1 << 22)
    ag = bench.sweep_axis("allgather", sw_sizes, count=9)
    ar = bench.sweep_axis("allreduce", sw_sizes, count=9)
    base = costmodel.Topo("h100-stacked", alpha=0.0, link_bw=1.0, gamma=0.0,
                          matmul_flops=H100_FLOPS["bfloat16"],
                          quant_bw=quant_bw)
    topo = costmodel.fit_topo(P, ag, ar, name="h100-stacked", base=base)
    log(f"[5] allgather sweep (bytes, s): {ag}")
    log(f"[5] allreduce sweep (bytes, s): {ar}")
    log(f"[5] fitted {topo.name}: alpha {topo.alpha:.4e} s, beta "
        f"{topo.beta:.4e} s/B (link_bw {topo.link_bw / 1e9:.1f} GB/s), "
        f"gamma {topo.gamma:.4e} s/B, quant_bw "
        f"{topo.quant_bw / 1e9:.1f} GB/s (quant_pack, phase 3)")
    report["topo"] = dataclasses.asdict(topo)
    del bench

    # ======== the main path: tune -> record -> replay -> dispatch ========
    wrappers = main_path_kernels(pack, cmm, rdma, quant)
    # every block_matmul launch's path and depth: a launch off the wgmma
    # path must be one that TMA cannot address (k % 8 != 0: the tuner's
    # NREP probes scale a matmul_accumulate cell down to k_loc = 1, ...)
    bm_calls: dict = {}
    path_of = cmm.block_matmul_path

    def recorded_path(dtype, k, vec_ok):
        path = path_of(dtype, k, vec_ok)
        key = (path, str(dtype).replace("torch.", ""), k, bool(vec_ok))
        bm_calls[key] = bm_calls.get(key, 0) + 1
        return path
    cmm.block_matmul_path = recorded_path
    zero_counts(wrappers)
    c0 = counts(wrappers)

    # -- 6. tune ---------------------------------------------------------------
    t0 = time.perf_counter()
    backend = tuner.MeasuredBackend(P, dev, max_nrep=20)
    trep = tuner.tune(list(C.FLAT_OPS), TUNE_SIZES, axis_size=P,
                      backend=backend)
    geo = trace.Trace([trace.TraceEntry(OpCell(
        "matmul_reducescatter", P, rows * k * 2, "bfloat16", k, rows,
        D_MODEL, "scatter")) for k in (HEADS * HEAD_DIM // P, D_FF // P)
        for rows in (TOKENS // 4, TOKENS)] + [trace.TraceEntry(OpCell(
            "allgather_matmul", P, rows // P * D_MODEL * 2, "bfloat16",
            D_MODEL, rows, 2 * D_FF // P, "gather"))
            for rows in (TOKENS // 4, TOKENS)] + [trace.TraceEntry(OpCell(
                "matmul_accumulate", P, D_MODEL // P * KV * 2, "bfloat16",
                D_MODEL, rows, KV, "contract"))
                for rows in (TOKENS // 8, TOKENS)])
    grep = tuner.tune_trace(geo, backend)
    store = trep.profiles
    for ph_store in grep.phase_profiles.values():
        for prof in ph_store:
            store.add(prof)
    log(f"[6] tune: {len(trep.measurements) + len(grep.measurements)} "
        f"measurements in {time.perf_counter() - t0:.1f} s")
    for m in grep.measurements:
        log(f"[6] measured {m.op} {m.nbytes}B {m.impl}: "
            f"{m.latency * 1e3:.4f} ms (nrep {m.nrep})")
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
    shutil.rmtree(prof_dir, ignore_errors=True)    # no profile of a past run
    store.save(prof_dir)
    reloaded = profiles.ProfileStore.load(prof_dir)
    if sorted(p.to_text() for p in reloaded) != sorted(
            p.to_text() for p in store):
        raise RuntimeError("profiles did not survive save/load")
    log(f"[6] {len(store)} profiles saved to {prof_dir} and reloaded")
    # the tuning CLI (examples/torch_tune_collectives.py, the PGMPITuneCLI
    # workflow) with the measured backend on the card at p = P; its
    # Listing-1 profiles are reloaded and dispatched under in phase 8
    cli_dir = out_dir / "cli_profiles"
    shutil.rmtree(cli_dir, ignore_errors=True)
    cli = _example("torch_tune_collectives")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--backend", "measured", "--axis-size", str(P),
                       "--device", str(dev), "--out", str(cli_dir)])
    t_cli = time.perf_counter() - t0
    (out_dir / "cli_tune.txt").write_text(buf.getvalue())
    cli_lines = buf.getvalue().splitlines()
    cli_store = profiles.ProfileStore.load(cli_dir)
    log(f"[6] tuning CLI --backend measured --axis-size {P}: rc {rc} in "
        f"{t_cli:.1f} s; {cli_lines[0]}; "
        f"{sum(ln.startswith('  ') for ln in cli_lines)} violation lines "
        f"({out_dir / 'cli_tune.txt'}); {cli_lines[-1]}")
    for ln in cli_lines[1:4]:
        log(f"[6] CLI {ln}")
    if rc != 0 or f"wrote {len(cli_store)} profiles" not in cli_lines[-1]:
        raise RuntimeError(f"tuning CLI: rc {rc}, {cli_lines[-1]}, "
                           f"{len(cli_store)} profiles reloaded")
    report["cli"] = {"seconds": t_cli, "profiles": len(cli_store),
                     "summary": cli_lines[:4]}
    c6 = counts(wrappers)
    require_launched("6 tune", c0, c6)
    del backend

    # -- 7. record the block ---------------------------------------------------
    axis = StackedAxis(P, dev)
    x = randn(P, TOKENS // P, D_MODEL)
    f_attn, f_ff = HEADS * HEAD_DIM // P, D_FF // P
    wv = randn(P, D_MODEL, f_attn, scale=D_MODEL ** -0.5)
    wo = randn(P, f_attn, D_MODEL, scale=(P * f_attn) ** -0.5)
    wgu = randn(P, D_MODEL, 2 * f_ff, scale=D_MODEL ** -0.5)
    wd = randn(P, f_ff, D_MODEL, scale=(P * f_ff) ** -0.5)
    ws = (x, wv, wo, wgu, wd)
    with api.tuned(profiles=reloaded) as ctx7:
        out7 = block(api, axis, torch, *ws)
    torch.cuda.synchronize()
    rec = trace.Trace.from_context(ctx7)
    rec.save(out_dir / "block_trace.jsonl")
    for ln in rec.summary().splitlines():
        log(f"[7] {ln}")
    for e in rec.entries:
        log(f"[7] {e.to_json()}")
    c7 = counts(wrappers)
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
    gu_bytes = TOKENS // P * D_MODEL * 2      # the gate/up allgather-matmul
    gu = {m.impl: m.latency * 1e3 for m in rrep.measurements
          if m.op == "allgather_matmul" and m.nbytes == gu_bytes}
    picked = [r.impl for st in rrep.phase_profiles.values() for prof in st
              if prof.op == "allgather_matmul" for r in prof.ranges
              if r.lo <= gu_bytes <= r.hi] or ["default"]
    log(f"[8] gate/up allgather_matmul cell ({gu_bytes} B per rank, "
        f"median ms): fused_ring {gu.get('fused_ring', float('nan')):.4f} "
        f"vs default {gu.get('default', float('nan')):.4f}; tune_trace "
        f"picked {'/'.join(picked)}")
    report["gate_up_cell"] = {"median_ms": gu, "picked": picked}
    shutil.rmtree(out_dir / "trace_profiles", ignore_errors=True)
    rrep.save(out_dir / "trace_profiles")
    _, phases = profiles.load_stores(out_dir / "trace_profiles")
    c8a = counts(wrappers)
    require_launched("8 replay", c7, c8a)

    with api.tuned(phase_profiles=phases, profiles=reloaded) as ctx8:
        out8 = block(api, axis, torch, *ws)
    with api.tuned(force={"allgather": "default",
                          "allgather_matmul": "default",
                          "matmul_reducescatter": "default"}):
        ref = block(api, axis, torch, *ws)
    with api.tuned(profiles=cli_store) as ctx_cli:      # the CLI's picks
        out_cli = block(api, axis, torch, *ws)
    for ln in api.format_footer(ctx_cli).splitlines():
        log(f"[8] under the CLI's profiles: {ln}")
    # matmul_accumulate at the K/V projection: every rank holds its own
    # 4096-token sequence and one K-block [384, 1024] of the weight
    xa = randn(P, TOKENS, D_MODEL)
    wkv = randn(P, D_MODEL // P, KV, scale=D_MODEL ** -0.5)
    with api.tuned() as ctxf:
        ag_forced = api.allgather(x, axis, impl="allgather_as_allreduce")
        h = api.allgather(x, axis)
        ag_wire = api.allgather(x, axis, impl="wire_q8")
        a = torch.matmul(h, wv)
        mm_forced = api.matmul_reducescatter(a, wo, axis, impl="fused_ring")
        mm_default = api.matmul_reducescatter(a, wo, axis, impl="default")
        agmm_forced = api.allgather_matmul(x, wgu, axis, impl="fused_ring")
        agmm_default = api.allgather_matmul(x, wgu, axis, impl="default")
        agmm_wire = api.allgather_matmul(x, wgu, axis, impl="wire_fp8")
        acc_forced = api.matmul_accumulate(xa, wkv, axis, impl="fused_ring")
        acc_default = api.matmul_accumulate(xa, wkv, axis, impl="default")
    torch.cuda.synchronize()
    c8b = counts(wrappers)
    require_launched("8 dispatch", c8a, c8b)
    for ln in api.format_footer(ctx8).splitlines():
        log(f"[8] {ln}")
    for ln in api.format_footer(ctxf).splitlines():
        log(f"[8] forced: {ln}")
    scale = max(1.0, float(ref.float().abs().max()))
    # bf16: a matmul-reducescatter ring rounds p partial sums where the
    # default rounds once, <= p * 2**-8 of the output each, two in series;
    # the allgather-matmul ring rounds each output once, like the default,
    # so its one bf16 step (2**-8 relative on g and u, 2**-7 on silu(g)*u)
    # reaches the output as <= 2**-7 of its magnitude through MLP-down
    tol = (2.0 ** -4 + 2.0 ** -7) * scale
    mm_tol = 2.0 ** -4 * scale
    agmm_tol = 2.0 ** -7 * max(1.0, float(agmm_default.float().abs().max()))
    # the accumulate ring adds its p partial products in bf16 where the
    # default rounds once: one bf16 step (2**-8) per partial sum
    acc_tol = P * 2.0 ** -8 * max(1.0, float(acc_default.float().abs().max()))
    # the wire impls: the gate's max-norm relative bound, wire_tol(dtype,
    # wire_hops(op, p)); the bf16 output rounds once more (2**-8)
    for label, got, want, wd, op in (
            ("allgather wire_q8", ag_wire, h, "int8", "allgather"),
            ("allgather_matmul wire_fp8", agmm_wire, agmm_default,
             "float8_e4m3fn", "allgather_matmul")):
        rel = float((got.float() - want.float()).abs().max()
                    / want.float().abs().max().clamp_min(1e-30))
        t = quant.wire_tol(wd, selfcheck.wire_hops(op, P))
        if op != "allgather":
            t += 2.0 ** -8
        log(f"[8] {label} vs default: max-norm relative error {rel:.4e} "
            f"(tolerance {t:.4e}) shape {list(got.shape)}")
        if tuple(got.shape) != tuple(want.shape) or not rel <= t:
            raise RuntimeError(f"{label} breaks its wire tolerance: {rel}")
    for label, got, want, t in (
            ("recorded block", out7, ref, tol),
            ("tuned block", out8, ref, tol),
            ("block under the CLI's profiles", out_cli, ref, tol),
            ("allgather_as_allreduce", ag_forced, h, 0.0),
            ("matmul_reducescatter fused_ring", mm_forced, mm_default,
             mm_tol),
            ("allgather_matmul fused_ring", agmm_forced, agmm_default,
             agmm_tol),
            ("matmul_accumulate fused_ring", acc_forced, acc_default,
             acc_tol)):
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
    ring_paths = dict(rdma.ring_allgather_matmul_rdma.launches_by_path)
    log(f"[main path] ring_allgather_matmul_rdma launches by path: "
        f"{json.dumps(ring_paths)}")
    if ring_paths["wgmma"] != main_path["ring_allgather_matmul_rdma"]:
        raise RuntimeError(f"main path: ring launches off the wgmma path: "
                           f"{ring_paths}")
    cmm.block_matmul_path = path_of
    bm_paths = dict(cmm.block_matmul.launches_by_path)
    off = {f"{d} k={k} vec_ok={v}": n_ for (pth, d, k, v), n_ in
           sorted(bm_calls.items()) if pth != "wgmma"}
    log(f"[main path] block_matmul launches by path: "
        f"{json.dumps(bm_paths)}; off the wgmma path, by dtype and depth: "
        f"{json.dumps(off)}")
    if sum(bm_calls.values()) != main_path["block_matmul"] or any(
            pth != "wgmma" and (d == "float32" or (k % 8 == 0 and v))
            for (pth, d, k, v) in bm_calls):
        raise RuntimeError(f"main path: block_matmul launches off the wgmma "
                           f"path that TMA could address: {off}")
    report["main_path_paths"] = {"ring_allgather_matmul_rdma": ring_paths,
                                 "block_matmul": bm_paths}
    # the tuning cells the fused rings lose: fused_ring against default
    # at attn-out and MLP-down (4096 rows) and the K/V accumulate (both
    # row counts), phase 6's medians
    for op, kk, rows in (("matmul_reducescatter", HEADS * HEAD_DIM // P,
                          TOKENS), ("matmul_reducescatter", D_FF // P, TOKENS),
                         ("matmul_accumulate", D_MODEL, TOKENS),
                         ("matmul_accumulate", D_MODEL, TOKENS // 8)):
        cell = {m.impl: m.latency * 1e3 for m in grep.measurements
                if m.op == op and m.cell.mm_k == kk and m.cell.mm_m == rows}
        log(f"[main path] {op} cell k={kk} rows={rows} (median ms): "
            f"fused_ring {cell.get('fused_ring', float('nan')):.4f} vs "
            f"default {cell.get('default', float('nan')):.4f}")

    # the two-axis cells of the data x model step (phase 13), measured on
    # the (data 2, model 4) mesh of 8 stacked lanes, each impl the median
    # of NREP samples: the 2-D cells of w_o and MLP-down, forward (p = data,
    # p2 = model) and transpose (p = model, p2 = data), default against
    # fused_ring2d; one hierarchical cell per op, MPIX_* against default
    backend = tuner.MeasuredBackend(MESH_D * MESH_Q, dev, max_nrep=20)
    t_loc, m_loc = MESH_T // MESH_Q, D_MODEL // MESH_D
    cells2 = []
    for site, k_ in MESH_SITES.items():
        cells2.append((f"{site} 2d", OpCell(
            "matmul_reducescatter_2d", MESH_D, k_ * m_loc * 2, "bfloat16",
            k_, MESH_T, D_MODEL, "2d", MESH_Q), ("default", "fused_ring2d")))
        cells2.append((f"{site} 2dT", OpCell(
            "matmul_reducescatter_2d", MESH_Q, t_loc * D_MODEL * 2,
            "bfloat16", MESH_T, D_MODEL, k_, "2dT", MESH_D),
            ("default", "fused_ring2d")))
    for op, nb in (("allreduce", 8 << 20), ("allgather", 1 << 20),
                   ("reducescatter", 1 << 20)):
        mpix = next(nm for nm, i in C.REGISTRY[op].items() if i.hier)
        cells2.append((f"{op} hier", OpCell(op, MESH_D, nb, "bfloat16",
                                            p2=MESH_Q), ("default", mpix)))
    report["mesh_cells"] = {}
    for label, cell, impls in cells2:
        lat = {nm: backend.latency(cell, nm) * 1e3 for nm in impls}
        nreps = {nm: backend.nrep_for(cell, nm) for nm in impls}
        report["mesh_cells"][label] = {"cell": dataclasses.asdict(cell),
                                       "median_ms": lat, "nrep": nreps}
        log(f"[8] mesh {MESH_D}x{MESH_Q} cell {label} ({cell.nbytes} B per "
            f"rank, median ms): " + ", ".join(
                f"{nm} {lat[nm]:.4f} (nrep {nreps[nm]})" for nm in impls)
            + f"; {impls[1]} / default = {lat[impls[1]] / lat['default']:.3f}")
    del backend

    # -- 9. where one call's device time goes (after the main path's counts)
    for nm in ("default", "allgather_as_ring", "wire_q8"):
        profile_call(torch, f"allgather {nm} x{list(x.shape)}",
                     lambda: api.allgather(x, axis, impl=nm))
    for nm in ("default", "fused_ring", "wire_q8"):
        profile_call(torch, f"matmul_accumulate {nm} x{list(xa.shape)} "
                     f"w{list(wkv.shape)}",
                     lambda: api.matmul_accumulate(xa, wkv, axis, impl=nm))
    for k, v in main_path.items():
        kernels[k]["launches"] = v
        kernels[k]["main_path"] = True
    kernels["ring_allgather_matmul_blocks"]["main_path"] = False

    # -- 10. the serve path: llama3.2-3b ----------------------------------
    every = dict(wrappers,
                 ring_allgather_matmul_blocks=rdma.ring_allgather_matmul_blocks,
                 flash_attention=fa.flash_attention,
                 rwkv6_scan=rw.rwkv6_scan, ssd_scan=ssd.ssd_scan)
    served = serve_phase(torch, dev, out_dir, every, "llama3.2-3b", "10",
                         ("fa_wgmma_kernel", "fa_split_kernel"))
    report["serve"] = served
    kernels["flash_attention"]["launches"] = served["launches"][
        "flash_attention"]
    kernels["flash_attention"]["main_path"] = True

    # -- 11. the serve paths of the SSM family ------------------------------
    report["ssm_serve"] = {}
    for arch, scan, needles in (
            ("rwkv6-3b", "rwkv6_scan", ("rwkv6_chunk_kernel",
                                        "rwkv6_decode_kernel")),
            ("zamba2-1.2b", "ssd_scan", ("ssd_chunk_kernel",
                                         "ssd_decode_kernel",
                                         "fa_wgmma_kernel",
                                         "fa_split_kernel"))):
        got = serve_phase(torch, dev, out_dir, every, arch, "11", needles)
        got["state_carry_rel_err"] = state_carry_check(torch, dev, every,
                                                       arch)
        report["ssm_serve"][arch] = got
        kernels[scan]["launches"] = got["launches"][scan]
        kernels[scan]["main_path"] = True

    # -- 12. the train path: llama3.2-3b, FSDP and TP ----------------------
    report["train"] = train_phase(torch, dev, every)
    for k, v in report["train"]["launches"].items():
        kernels[k]["train_launches"] = v

    # -- 13. the data x model train path: llama3.2-3b on a (2, 4) mesh ------
    report["mesh_train"] = train_mesh_phase(torch, dev, every)
    for k, v in report["mesh_train"]["launches"].items():
        kernels[k]["mesh_train_launches"] = v

    # -- 14. train through the kernels: flash, rwkv6_scan, ssd_scan ----------
    report["kernel_train"] = train_kernels_phase(torch, dev, every,
                                                 report["train"])
    for k, v in report["kernel_train"]["launches"].items():
        kernels[k]["kernel_train_launches"] = v

    # -- 15. the MoE serve: phi3.5-moe-42b-a6.6b, 16 of 32 layers ----------
    report["moe_serve"] = moe_serve_phase(torch, dev, out_dir, every, card)
    for k, v in report["moe_serve"]["launches"].items():
        kernels[k]["moe_serve_launches"] = v
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    (out_dir / "report.json").write_text(json.dumps(report, indent=1))
    log(f"[done] {report['seconds']:.1f} s")
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "main_path", "train_launches", "mesh_train_launches",
             "kernel_train_launches", "moe_serve_launches")
    print(json.dumps({"kernels": [{k: kernels[n][k] for k in order}
                                  for n in ("guideline_pack", "block_matmul",
                                            "ring_allgather_matmul_rdma",
                                            "ring_allgather_matmul_blocks",
                                            "quant_pack", "dequant_unpack",
                                            "flash_attention", "rwkv6_scan",
                                            "ssd_scan")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
