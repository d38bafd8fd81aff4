#!/usr/bin/env python3
"""Drive the PyTorch port's tuning loop, its serving paths (dense, SSM,
Mixture-of-Experts, multi-head latent attention, a data x model mesh,
sequence-sharded long-context decode, the prefix-LM VLM, the
encoder-decoder and a process-group axis) and its
training paths (one stacked axis, a data x model mesh, a pod x data x
model mesh, a process mesh, and training through the model kernels,
whisper-medium's and paligemma-3b's included), and the fleet loop
with its fault tolerance, on one CUDA card, end to end.

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
   its prefill on ``wgmma``, every decode step's length on ``split_kv``)
   and, on its MLA paths, deepseek-v3's at TP 8 (q ``[32, S, 1, 16,
   576]``, the latent keys ``[32, S, 1, 576]``, v their first 512
   columns as a view, scale ``1 / sqrt(192)``): the prefill on
   ``"mla_wgmma"`` and every decode kv_len 1025-1056 on ``"mla"``, v also
   as its own tensor (``"mla"``), three planted faults, times, bound, SDPA
   (E = 576, Ev = 512) and the kernels SDPA ran; and at head dim 256
   (phases 17-18): gemma3-1b's prefill per lane on ``wgmma`` (global and
   windowed), paligemma-3b's prefix split (the prefix rows non-causal,
   the text rows from q0 = 256), gemma3-1b's decode at kv_len 1056 on
   ``split_kv``, each timed beside its bound and SDPA, the prefix edge
   one key late, which the limit must reject, and a global and a local
   layer of the long_500k prefill (q ``[1, 524 256, 1, 4, 256]``) held to
   the plain version on two slices of 256 rows, timed by CUDA events over
   3 launches beside the bound (and SDPA's flash backend, global);
   and at whisper-medium's shapes (phase 19, dh 64, non-causal, 1500
   encoder keys: not a multiple of the 128-key block): the encoder's
   self-attention and the cross-attention at prefill on ``wgmma``, at
   decode on ``split_kv`` (at several q0: non-causal sees every key), each
   timed beside its bound and SDPA, with two planted faults (the decode
   launched causal, the prefill's ragged last block left out);
   each kernel's path counts (the ring's ``wgmma``/``wmma``/``f32``,
   flash's ``wgmma``/``split_kv``/``mma_sync``/``mla_wgmma``/``mla``/
   ``f32``); the ring's and
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
   ids and kept choices, outputs within ``MOE_CHECK_RTOL``);
16. serve deepseek-v3-671b at full width, cut to ``MLA_LAYERS`` = 2 of 61
   layers (MLA attention, 256 experts of d_ff 2048, top-8, 1 shared; TP
   p = 8 stacked: 16 q heads and 32 experts a rank; absorbed attention
   through flash's MLA paths, ``"mla_wgmma"`` at prefill and ``"mla"`` at
   decode; phase 10's requests): (a) the default
   serve, recording, routes probed; ``tune_trace`` (measured; cells whose
   replay passes ``MLA_REPLAY_CAP`` held out, logged), the profiles saved
   and reloaded; (b) the tuned re-serve, held as phase 15's (b); (c) the
   default serve again, bit-equal to (a); (d) the naive serve
   (``attn_impl="ref"``) of the same weights, held to (a) as (b) is, and
   again with every route pinned to (a)'s (``PinnedRoutes``): every
   request's logits within ``SERVE_RTOL``; peak memory of each step;
   ``torch.profiler`` over one prefill and one decode step;
17. gemma3-1b at full width and depth (26 layers, head dim 256): (a) on
   the (data 2, model 4) mesh, phase 10's requests split over data and
   the weights FSDP-sharded over it: the default serve recording,
   ``tune_trace`` (the quantized wire held out), the tuned re-serve, and
   the same requests over model only (TP 4), each within ``SERVE_RTOL``;
   (b) the ``long_500k`` cell: a prompt of ``LONG_PROMPT`` tokens
   prefilled on one model lane (flash on ``wgmma``), its 524 288-slot
   cache laid out as 8 sequence shards on (data 8, model 1), 32
   sequence-sharded decode steps (the combine's allreduces over data
   dispatched; every data lane's logits bit-equal), 32 unsharded steps
   from a clone of the cache as the yardstick, ``tune_trace`` (the 8-lane
   allreduce cells with their winner and ``default`` time) and the tuned
   sharded decode, each within ``SERVE_RTOL``; prefill seconds, decode ms
   a token each way, peak memory;
18. paligemma-3b at full width and depth (18 layers, TP 8 stacked): 4
   requests of 256 seeded stub patches + 1024 text tokens; the flash
   serve (two flash launches a layer at prefill: the prefix rows and the
   text rows), ``tune_trace`` and the tuned re-serve, and the ``ref``
   serve of the same weights, each within ``SERVE_RTOL``;
19. whisper-medium at full width and depth (24 encoder and 24 decoder
   layers, TP 8 stacked): 4 requests of 1500 seeded stub frames + 192
   prompt tokens, 1 + 32 tokens, a 448-slot self cache (the encoder runs
   inside the timed prefill; the cross K/V are cached at 1500 positions);
   the flash serve, ``tune_trace`` and the tuned re-serve, and the ``ref``
   serve of the same weights, each within ``SERVE_RTOL``;
20. the process-group axis (``GroupAxis`` over ``torch.distributed``):
   (a) NCCL at world 1 (NCCL puts one rank on a GPU): llama3.2-3b at full
   width and depth, TP 1, phase 10's requests, served on the
   ``GroupAxis`` and on ``StackedAxis(1)``, the same weights: flash
   launched 28 x 33 times, the axis' NCCL collectives counted (> 0), the
   logits bit-equal or within ``SERVE_RTOL``; prefill ms, decode ms a
   token and peak memory for both, timed again in the other order
   (group, stacked, stacked, group), and one decode step of each under
   ``torch.profiler`` (host ms, device busy ms, host ms in the process
   group's calls); (b) gloo at world 4 on the host's CPU (spawned
   processes under a hard timeout that kills them): the group selfcheck,
   flat and (2, 2), with no failure and the stacked run's totals, and a
   measured tune of ``allreduce`` at ``GROUP_TUNE_SIZES`` (4 sizes up to
   1 MiB), every rank the same picks, one profile written; its times are
   the host CPU's, labelled so;
21. the fleet loop and fault tolerance, llama3.2-3b at full width and
   depth, TP 8 stacked, 1 + 16 tokens a request, 2048 slots: (a) four
   servers of one set of weights, mixes (batch, prompt) A (4, 1024), B
   (8, 512), C (2, 1024), D (1, 1536), each recording into a
   ``ShardRecorder`` flushed as an epoch-1 shard; ``merge_shards`` keeps
   the total weight; ``tune_trace`` (measured) of the merged trace
   published as epoch 1; a live server on mix B through steps built ONCE
   with a ``Plan`` under the watched ``StoreRef`` serves epoch 0, epoch 1
   (after ``poll``; its vector changes iff the epoch picked a mock-up at
   a plan site), an ``explore(eps=1)`` vector and epoch 2 (tuned by a
   ``FeedbackBackend`` from the explored pairs' card replays, round the
   shard's ``#@lat`` lines), each within ``SERVE_RTOL`` of epoch 0, with
   a stale epoch-0 manifest refused; (b) a torn and a corrupted shard
   quarantined exactly, their samples dropped; a skewed epoch 3 refused;
   an epoch 4 that routes every plan site to the impl the measured tune
   found slowest for its cell, against an ``EpochTripwire`` (threshold
   1.2) fed each decode step's synchronized time: it must fire exactly
   when the medians say, and then the rolled-back pass runs epoch 2's
   vector with epoch 2's logits and epoch 4 is not adopted again; the
   ``FleetCoordinator`` on a fake clock (phase 5's Topo as its backend)
   sees a killed server go dead; (c) ``examples/torch_elastic_restart.py``
   on the card: two restarts, a bit-identical final state;
22. analysis at the graph layer (``repro_torch.analysis``): (a) the dry
   run ``python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape
   all --multi-pod both --topo <phase 5's fit>`` in a process of its own
   (the fake world must be its default group; the cells in parallel
   processes), full width and all 28 layers captured on fake tensors as
   one rank of a fake world of 256 (16 x 16) and 512 (2 x 16 x 16):
   every applicable cell ``ok`` with no unmapped site and a footer,
   ``long_500k`` skipped with its reason, each cell's roofline row and
   capture seconds logged; (b) phase 10's TP 8 stacked prefill (4 x 1024)
   and one decode step captured on fake tensors on the card's device
   with ``ref`` attention: ``program_costs``, the bound on the data
   sheet's rates, its share of phase 10's measured times (by the graph,
   by model flops, by the arguments read once), the graph's memory
   estimate beside phase 10's peak; (c) the rewrite mode on a gloo world
   of 4 on the host CPU (no card number): the JAX package's rewrite
   program with ``allgather_as_ring`` and ``alltoall_as_ppermute`` forced,
   bit-exact on every rank, every record matched; (d) the tuning-potential
   line of (a)'s prefill and decode graphs on phase 5's ``Topo``.  No
   kernel launches in it: the counts are zeroed before and read 0 after;
23. training across processes (``Trainer(processes=True)``): (a)
   llama3.2-3b at full width, ``TRAIN_LAYERS`` layers, flash, on a
   world-1 NCCL ``GroupMesh`` of (pod, data, model) = (1, 1, 1) and on
   the same mesh stacked on the card, the same weights and batches (2 x
   1024 tokens): a warm-up, two timed and one profiled step of each in
   turn, each step's loss and the parameters after them bit-equal or
   within ``TRAIN_RTOL``; the step times side by side, the NCCL calls a
   step, the process group's host time in the profiled step, flash's
   launches in the group steps (> 0); (b) ``python -m
   repro_torch.launch.train --smoke --world 1 --dist-backend nccl``: 3
   steps, a checkpoint, resumed to 5; (c) one gloo world of 8 on the
   host's CPU: the reference's four archs at (2, 4) and llama3.2-3b at
   (2, 2, 2), smoke size, float32, two steps held to the stacked step
   lane for lane (bit-equal at (2, 2, 2)) with equal dispatch records,
   its times the host CPU's;
24. two more families trained through flash's autograd Function, each
   at full width, bf16, AdamW, TP 8 stacked: (a) whisper-medium, 24 + 24
   layers, 2 x 1500 stub frames (187 decoder tokens); (b) paligemma-3b,
   18 layers, 2 x (256 stub patches + 1024 text tokens), the text-only
   loss: 1 warm-up, 3 timed and one profiled step (median step ms, peak
   memory, device busy share, flash's launches by path and head dim:
   ``wgmma`` at dh 64 and 256), then one step's loss and gradients
   within ``TRAIN_RTOL`` of the ``ref`` step's from the same weights and
   batch.

Each phase's seconds are logged as it ends (``[phase n]``).

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
``moe_serve_launches``.  They are zeroed again just before the MLA
serve path (phase 16) and read after its third serve: flash attention
must launch 2 x 33 times an absorbed serve, 2 on ``"mla_wgmma"`` (the
prefill) and 2 x 32 on ``"mla"``; each row carries its
``mla_serve_launches``, and the kernels line lists the MLA paths as
``flash_attention_mla`` (phase 3's prefill numbers, the ``mla_wgmma``
kernel's), with its launches in phases 12-16 read from flash's counts by
path (both MLA paths; ``paths`` splits them), and the decode's kernel as
``flash_attention_mla_decode`` (phase 3's numbers at kv_len 1056, its
launches phase 16's on ``"mla"``).
They are zeroed again just before phase 17's path and read around each
of its runs: 26 ``wgmma`` and 26 x 32 ``split_kv`` launches a mesh or
TP 4 serve, 26 ``wgmma`` at the long prefill, none in a
sequence-sharded decode (its partials are plain PyTorch, as the JAX
package's), 26 x 32 ``split_kv`` in the unsharded one; and just before
phase 18's: 2 x 18 ``wgmma`` and 18 x 32 ``split_kv`` a flash serve;
and just before phase 19's: 3 x 24 ``wgmma`` (the encoder's, the
self-attention's and the cross-attention's prefill launches) and 2 x 24
x 32 ``split_kv`` a flash serve, all at head dim 64; and just before
phase 20(a)'s group serve: flash 28 x 33 times; and just before phase
21(a): 28 x 17 times every serve of the fleet loop (28 ``wgmma``, 28 x
16 ``split_kv``), each step of the loop's launches logged; and just
before phase 23(a)'s group steps (flash must launch in them; the stacked
steps' launches are not counted) and phase 24's path (flash on
``wgmma`` in each family's timed steps).
Each row carries its ``long_context_launches``, ``vlm_serve_launches``,
``encdec_serve_launches``, ``group_serve_launches``, ``fleet_launches``,
``group_train_launches`` and ``family_train_launches``; the kernels
line lists flash at head dim 256 as ``flash_attention_d256`` (phase 3's
gemma3-1b prefill numbers, its launches by path in phases 17-19) and
whisper's calls as
``flash_attention_encdec`` (phase 3's encoder self-attention numbers,
its launches phase 19's at head dim 64).
The
ranks are stacked on ONE card: a ring hop is a device-memory copy, so
the times measure on-chip data movement and launch overhead, not a link
between GPUs, and both tiers of a two-axis mesh are the same memory.
Phases 20 and 23's worlds of one card time no link either, and their
gloo worlds run on the host's CPU.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  With no CUDA device, or without the
``src/repro_torch`` package beside this script, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# the H100's data-sheet rates (HBM3 bytes/s, peak FLOP/s by dtype) every
# bound divides by: ``repro_torch.analysis.roofline``'s, bound in main()
H100_BYTES_PER_S = H100_FLOPS = None
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
        if hasattr(f, "launches_by_dh"):
            f.launches_by_dh = {}


def path_delta(fn, before: dict) -> dict:
    """The launches of ``fn`` by path since the snapshot ``before``."""
    return {k: v - before.get(k, 0) for k, v in fn.launches_by_path.items()}


def dh_counts(fa) -> dict:
    """A snapshot of flash's launches by head dim, then path."""
    return {dh: dict(paths) for dh, paths in fa.launches_by_dh.items()}


def dh_delta(fa, before: dict, dh: int = 256) -> dict:
    """Flash's launches at head dim ``dh`` by path since ``before``
    (paths with none left out)."""
    now, was = fa.launches_by_dh.get(dh, {}), before.get(dh, {})
    got = {k: v - was.get(k, 0) for k, v in now.items()}
    return {k: v for k, v in got.items() if v}


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


def flash_work(n, sq, hk, g, dh, q0, kv_len, causal, window, itemsize,
               dv=None, v_in_k=False):
    """(operations, bytes) that one flash-attention call's data needs:
    2·(dh + dv) per visible (query, key) pair (QK^T and PV), and q, out
    and the keys and values some query sees, each moved once (values that
    are k's first dv columns, ``v_in_k``, are the keys' bytes)."""
    dv = dh if dv is None else dv
    pairs, lo_all, hi_all = 0, kv_len, 0
    for i in range(sq):
        qpos = q0 + i
        hi = min(kv_len, qpos + 1) if causal else kv_len
        lo = max(0, qpos - window + 1) if window else 0
        if hi > lo:
            pairs += hi - lo
            lo_all, hi_all = min(lo_all, lo), max(hi_all, hi)
    keys = max(0, hi_all - lo_all)
    flops = 2 * (dh + dv) * pairs * n * hk * g
    byts = (n * sq * hk * g * (dh + dv)
            + n * keys * hk * (dh + (0 if v_in_k else dv))) * itemsize
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
        if tuple(got.shape) != tuple(q.shape[:4]) + (v.shape[-1],) or not \
                share <= 1.0 or not bool(
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

    def timed(label, q, k, v, lib, *,
              lib_name="scaled_dot_product_attention", **kw):
        err, share = check(label, q, k, v, **kw)
        n, sq, hk, g, dh = q.shape
        flops, byts = flash_work(n, sq, hk, g, dh, kw.get("q0", 0),
                                 kw.get("kv_len") or k.shape[1],
                                 kw.get("causal", True), kw.get("window", 0),
                                 q.element_size(), v.shape[-1],
                                 v.data_ptr() == k.data_ptr())
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
            library_ms=None if lib is None else time_ms(torch, lib))
        rec["path"] = last_path[0]
        rec["events_ms"] = events_ms
        lib_s = "none" if lib is None else f"{rec['library_ms']:.4f} ms"
        log(f"[3] flash_attention {label} q{list(q.shape)} k{list(k.shape)} "
            f"{name_dt[q.dtype]} {kw} path {rec['path']}: max_abs_err "
            f"{err:.3e} ({share:.3f} of the limit) kernel device time "
            f"{rec['ms']:.4f} ms (events mean {events_ms:.4f} ms) plain "
            f"{rec['plain_ms']:.4f} ms "
            f"{lib_name} {lib_s} bound "
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
    mla = check_flash_mla(torch, fa, randn, timed, check, planted, on_path,
                          last_path)
    d256 = check_flash_d256(torch, fa, randn, timed, check, on_path)
    encdec = check_flash_encdec(torch, randn, timed, check, planted,
                                on_path, last_path)
    return {"prefill": prefill, "decode": decode, "zamba2_prefill_ms":
            zamba_ms, "moe_prefill_ms": moe_ms, "mla": mla, "d256": d256,
            "encdec": encdec}


def sdpa_backend(torch, fn) -> str:
    """The names of the device kernels one call of ``fn`` (a
    ``scaled_dot_product_attention`` call) ran, which name the backend it
    took."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted((e for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA")),
                  key=lambda e: -e.self_device_time_total)
    return "; ".join(e.key[:60] for e in rows[:3])


def sdpa_fastest(torch, label: str, calls: dict):
    """The fastest of ``calls`` (name -> ``(backend, fn)``, each fn one
    ``scaled_dot_product_attention`` call; backend an ``SDPBackend`` the
    call is held to, or None for the dispatcher's own pick).  Logs each
    call's events time and the kernels it ran, or why it was refused."""
    from torch.nn.attention import sdpa_kernel

    def held_to(backend, fn):
        if backend is None:
            return fn

        def run():
            with sdpa_kernel(backend):
                return fn()
        return run

    best = None
    for name, (backend, fn) in calls.items():
        run = held_to(backend, fn)
        try:
            run()
        except RuntimeError as e:
            log(f"[3] scaled_dot_product_attention at the {label} ({name}) "
                f"refused: {str(e).splitlines()[0][:200]}")
            continue
        ms = time_ms(torch, run)
        log(f"[3] scaled_dot_product_attention at the {label} ({name}): "
            f"{ms:.4f} ms, ran {sdpa_backend(torch, run)}")
        if best is None or ms < best[0]:
            best = (ms, name, run)
    if best is None:
        raise RuntimeError(f"no scaled_dot_product_attention call ran at "
                           f"the {label}")
    log(f"[3] library call of record at the {label}: {best[1]}")
    return best[2]


def check_flash_mla(torch, fa, randn, timed, check, planted, on_path,
                    last_path) -> dict:
    """Phase 3 for the MLA paths: deepseek-v3-671b's absorbed attention
    at TP 8 (phase 16's shapes: q ``[32, S, 1, 16, 576]``, the latent keys
    ``[32, S, 1, 576]``, v their first 512 columns as a view, scale ``1 /
    sqrt(192)``) against the plain version at the prefill shape (on
    ``"mla_wgmma"``) and at every decode kv_len (on ``"mla"``), with v its
    own tensor too (``"mla"``); times,
    bound and ``scaled_dot_product_attention`` (E = 576, Ev = 512) at the
    prefill and the first and last decode kv_len: the faster of the
    grouped call (one KV head, ``enable_gqa``) and the call on k and v
    expanded to the 16 q heads (stride-0 views) held to the
    memory-efficient backend."""
    from torch.nn.attention import SDPBackend
    from repro_torch.configs import get_config
    sdpa = torch.nn.functional.scaled_dot_product_attention
    efficient = SDPBackend.EFFICIENT_ATTENTION
    m = get_config(MLA_ARCH).mla
    dqk, dv = m.kv_lora_rank + m.rope_head_dim, m.kv_lora_rank
    scale = 1.0 / math.sqrt(m.nope_head_dim + m.rope_head_dim)
    n_fold, g = P * SERVE_BATCH, get_config(MLA_ARCH).n_heads // P
    q = randn(n_fold, SERVE_PROMPT, 1, g, dqk)
    k = randn(n_fold, SERVE_PROMPT, 1, dqk)
    v = k[..., :dv]
    qb = q.permute(0, 2, 3, 1, 4).reshape(n_fold, g, SERVE_PROMPT, dqk)
    kb = k.transpose(1, 2).contiguous()
    kx = kb.expand(-1, g, -1, -1)
    lib = sdpa_fastest(torch, "MLA prefill shape", {
        "one KV head, enable_gqa": (None, lambda: sdpa(
            qb, kb, kb[..., :dv], is_causal=True, enable_gqa=True,
            scale=scale)),
        "k, v expanded to the q heads, memory-efficient": (
            efficient, lambda: sdpa(qb, kx, kx[..., :dv], is_causal=True,
                                    scale=scale))})
    prefill = timed("mla prefill", q, k, v, lib, causal=True, scale=scale)
    on_path("mla prefill", "mla_wgmma")
    err, share = check("mla prefill, v its own tensor", q, k,
                       k[..., :dv].contiguous(), scale=scale)
    on_path("mla prefill, v its own tensor", "mla")
    log(f"[3] flash_attention mla prefill, v its own tensor: max_abs_err "
        f"{err:.3e} ({share:.3f} of the limit)")
    q1 = randn(n_fold, 1, 1, g, dqk)
    kc = randn(n_fold, SERVE_SLOTS, 1, dqk)
    vc = kc[..., :dv]
    worst = (0.0, 0.0)
    for kv_len in range(SERVE_PROMPT + 1, SERVE_PROMPT + SERVE_DECODE + 1):
        label = f"mla decode kv_len {kv_len}"
        worst = tuple(map(max, worst, check(
            label, q1, kc, vc, q0=kv_len - 1, kv_len=kv_len, scale=scale)))
        on_path(label, "mla")
    err, share = check("mla decode, v its own tensor", q1, kc,
                       vc.contiguous(), q0=SERVE_PROMPT,
                       kv_len=SERVE_PROMPT + 1, scale=scale)
    on_path("mla decode, v its own tensor", "mla")
    log(f"[3] flash_attention mla decode q{list(q1.shape)} k{list(kc.shape)} "
        f"bf16, kv_len {SERVE_PROMPT + 1}...{SERVE_PROMPT + SERVE_DECODE} "
        f"path {last_path[0]}: max_abs_err {worst[0]:.3e} ({worst[1]:.3f} "
        f"of the limit); v its own tensor: {err:.3e} ({share:.3f})")
    # the limit sees the dense scale (1 / sqrt(576)) and the last slot
    planted("mla: the dense paths' scale", q, k, v, dict(causal=True),
            causal=True, scale=scale)
    planted("mla: last filled slot left out", q1, kc, vc,
            dict(q0=SERVE_PROMPT, kv_len=SERVE_PROMPT, scale=scale),
            q0=SERVE_PROMPT, kv_len=SERVE_PROMPT + 1, scale=scale)
    last = SERVE_PROMPT + SERVE_DECODE
    planted("mla: one slot too many", q1, kc, vc,
            dict(q0=last, kv_len=last + 1, scale=scale),
            q0=last - 1, kv_len=last, scale=scale)
    decode = {}
    for kv_len in (SERVE_PROMPT + 1, SERVE_PROMPT + SERVE_DECODE):
        q1b = q1.reshape(n_fold, g, 1, dqk)
        kcb = kc[:, :kv_len].transpose(1, 2)
        kcx = kcb.expand(-1, g, -1, -1)
        lib = sdpa_fastest(torch, f"MLA decode shape, kv_len {kv_len}", {
            "one KV head, enable_gqa": (
                None, lambda kcb=kcb: sdpa(q1b, kcb, kcb[..., :dv],
                                           enable_gqa=True, scale=scale)),
            "k, v expanded to the q heads, memory-efficient": (
                efficient, lambda kcx=kcx: sdpa(q1b, kcx, kcx[..., :dv],
                                                scale=scale))})
        decode[kv_len] = timed(f"mla decode kv_len {kv_len}", q1, kc, vc,
                               lib, q0=kv_len - 1, kv_len=kv_len,
                               scale=scale)
        on_path(f"mla decode kv_len {kv_len}", "mla")
    return {"prefill": prefill, "decode": decode}


def check_flash_d256(torch, fa, randn, timed, check, on_path) -> dict:
    """Phase 3 at head dim 256 (phases 17-18's shapes, all on ``wgmma`` at
    prefill): gemma3-1b's prefill per lane on the (data 2,
    model 4) mesh (q ``[16, 1024, 1, 1, 256]``, global and its local
    layers' 512-key window); paligemma-3b's prefix split at TP 8, the
    prefix rows ``[32, 256, 1, 1, 256]`` non-causal over the prefix keys
    and the text rows ``[32, 1024, 1, 1, 256]`` causal from q0 = 256 over
    all 1280 keys; gemma3-1b's decode at kv_len 1056 in a 2048-slot cache
    (``split_kv``); each held to its plain version, timed beside its
    bound and ``scaled_dot_product_attention`` (whose flash backend takes
    dh 256); the prefix edge one key late, which the limit must reject;
    and a global and a local layer of the long_500k prefill
    (``long_prefill``)."""
    from torch.nn.attention.bias import causal_lower_right
    from repro_torch.configs import get_config
    from repro_torch.models import attention as A
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dh = get_config(LONG_ARCH).hd
    n_g = SERVE_BATCH * LONG_MESH[1]    # (data 2 x model 4) lanes x 2 each
    n_v = SERVE_BATCH * VLM_TP
    npf = get_config(VLM_ARCH).vlm.n_patches
    out = {}

    def bhsd(t):                      # [N, S, 1, 1, dh] / [N, S, 1, dh]
        return t.reshape(t.shape[0], t.shape[1], 1, dh).transpose(1, 2)

    q = randn(n_g, SERVE_PROMPT, 1, 1, dh)
    k, v = (randn(n_g, SERVE_PROMPT, 1, dh) for _ in range(2))
    qb, kb, vb = bhsd(q), bhsd(k), bhsd(v)
    out["gemma prefill"] = timed(
        "gemma3-1b prefill dh 256", q, k, v,
        lambda: sdpa(qb, kb, vb, is_causal=True), causal=True)
    on_path("gemma3-1b prefill dh 256", "wgmma")
    w = get_config(LONG_ARCH).window
    err, share = check("gemma3-1b local prefill", q, k, v, window=w)
    on_path("gemma3-1b local prefill", "wgmma")
    log(f"[3] flash_attention gemma3-1b local-layer prefill window {w}: "
        f"max_abs_err {err:.3e} ({share:.3f} of the limit)")
    # paligemma-3b at TP 8: its prefix rows and its text rows
    qp = randn(n_v, npf + SERVE_PROMPT, 1, 1, dh)
    kp, vp = (randn(n_v, npf + SERVE_PROMPT, 1, dh) for _ in range(2))
    qpb, kpb, vpb = bhsd(qp), bhsd(kp), bhsd(vp)
    pq, pk, pv = qp[:, :npf], kp[:, :npf], vp[:, :npf]
    out["prefix rows"] = timed(
        "paligemma prefix rows", pq, pk, pv,
        lambda: sdpa(qpb[:, :, :npf], kpb[:, :, :npf], vpb[:, :, :npf]),
        causal=False)
    on_path("paligemma prefix rows", "wgmma")
    tq = qp[:, npf:]
    # the text rows' mask is causal aligned to the last key (query i sees
    # keys <= i + npf): SDPA's lower-right causal bias
    text_bias = causal_lower_right(SERVE_PROMPT, npf + SERVE_PROMPT)
    out["text rows"] = timed(
        "paligemma text rows", tq, kp, vp,
        lambda: sdpa(qpb[:, :, npf:], kpb, vpb, attn_mask=text_bias),
        causal=True, q0=npf)
    on_path("paligemma text rows", "wgmma")
    # the split as the model runs it (two launches) against the plain
    # version of each half; then the prefix edge one key late
    before = fa.flash_attention.launches
    got = A._flash_prefix(qp, kp, vp, n_prefix=npf, softcap=0.0, q0=0)
    if fa.flash_attention.launches != before + 2:
        raise RuntimeError("the prefix split did not launch twice")
    pre = fa.flash_attention_plain(pq, pk, pv, causal=False)
    lim = fa.tolerance(pq, pk, pv, pre, causal=False)
    share = float(((got[:, :npf].float() - pre.float()).abs() / lim).max())
    bad = A._flash_prefix(qp, kp, vp, n_prefix=npf + 1, softcap=0.0, q0=0)
    bad_share = float(((bad[:, :npf].float() - pre.float()).abs()
                       / lim).max())
    log(f"[3] flash_attention prefix split (two launches) q{list(qp.shape)}"
        f": prefix rows {share:.3f} of the limit; planted fault, the prefix "
        f"edge one key late: {bad_share:.2f} of the limit")
    if not share <= 1.0 or not bad_share > 1.0:
        raise RuntimeError("flash_attention prefix split: the limit fails "
                           "the split or passes the planted prefix edge")
    # gemma3-1b's decode at kv_len 1056, 2048 slots, one q head a lane
    q1 = randn(n_g, 1, 1, 1, dh)
    kc, vc = (randn(n_g, SERVE_SLOTS, 1, dh) for _ in range(2))
    kv_len = SERVE_PROMPT + SERVE_DECODE
    q1b, kcb, vcb = (bhsd(q1), bhsd(kc[:, :kv_len]).contiguous(),
                     bhsd(vc[:, :kv_len]).contiguous())
    out["decode"] = timed(
        f"gemma3-1b decode dh 256 kv_len {kv_len}", q1, kc, vc,
        lambda: sdpa(q1b, kcb, vcb), q0=kv_len - 1, kv_len=kv_len)
    on_path("gemma3-1b decode dh 256", "split_kv")
    out.update(d256_decodes(torch, randn, timed, on_path, q1, kc, vc, kv_len))
    out["long prefill"] = long_prefill(torch, fa, randn)
    return out


def d256_decodes(torch, randn, timed, on_path, q1, kc, vc, kv_len) -> dict:
    """Phase 3's other dh-256 decodes (``split_kv``, fa_ring_kernel), each
    held to its plain version and timed beside its bound and SDPA:
    gemma3-1b's local layers (the 512-key window of the global decode's
    cache), paligemma-3b's at TP 8 after its 256 patches (``[32, 1, 1, 1,
    256]`` at kv_len 1312) and gemma2-9b's at TP 8 (``[32, 1, 1, 2, 256]``,
    softcap 50, window 4096, kv_len 1056), whose softcap no SDPA call
    computes: its library call is ``flex_attention`` (eager, the scores
    materialized) with the softcap and the window as its score_mod and
    the two query heads on one KV head (``enable_gqa``)."""
    from torch.nn.attention.flex_attention import flex_attention
    from repro_torch.configs import get_config
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dh = get_config(LONG_ARCH).hd
    out = {}

    def bhsd(t):                      # [N, S, HK, (G,) dh] -> [N, H, S, dh]
        return t.reshape(t.shape[0], t.shape[1], -1, dh).transpose(
            1, 2).contiguous()

    w = get_config(LONG_ARCH).window
    lo = max(0, kv_len - w)           # the window's first key
    q1b, kwb, vwb = bhsd(q1), bhsd(kc[:, lo:kv_len]), bhsd(vc[:, lo:kv_len])
    out["local decode"] = timed(
        f"gemma3-1b local-layer decode dh 256 window {w} kv_len {kv_len}",
        q1, kc, vc, lambda: sdpa(q1b, kwb, vwb), q0=kv_len - 1,
        kv_len=kv_len, window=w)
    on_path("gemma3-1b local-layer decode dh 256", "split_kv")
    n_v = SERVE_BATCH * VLM_TP
    kv_v = get_config(VLM_ARCH).vlm.n_patches + SERVE_PROMPT + SERVE_DECODE
    qv = randn(n_v, 1, 1, 1, dh)
    kcv, vcv = (randn(n_v, SERVE_SLOTS, 1, dh) for _ in range(2))
    qvb, kvb, vvb = bhsd(qv), bhsd(kcv[:, :kv_v]), bhsd(vcv[:, :kv_v])
    out["vlm decode"] = timed(
        f"paligemma-3b decode dh 256 kv_len {kv_v}", qv, kcv, vcv,
        lambda: sdpa(qvb, kvb, vvb), q0=kv_v - 1, kv_len=kv_v)
    on_path("paligemma-3b decode dh 256", "split_kv")
    g2 = get_config("gemma2-9b")
    hk2, gg = g2.n_kv_heads // VLM_TP, g2.n_heads // g2.n_kv_heads
    q2 = randn(n_v, 1, hk2, gg, g2.hd, scale=4.0)   # the softcap bites
    kc2 = randn(n_v, SERVE_SLOTS, hk2, g2.hd, scale=4.0)
    vc2 = randn(n_v, SERVE_SLOTS, hk2, g2.hd)
    cap2, w2, q02 = g2.attn_softcap, g2.window, kv_len - 1

    def capped(score, b, h, qi, ki):  # gemma2's softcap, then its window
        s = cap2 * torch.tanh(score / cap2)
        return torch.where(q02 + qi - ki < w2, s, -float("inf"))

    q2b, k2b, v2b = (bhsd(t) for t in (q2, kc2[:, :kv_len], vc2[:, :kv_len]))
    out["gemma2 decode"] = timed(
        f"gemma2-9b TP {VLM_TP} decode dh 256 softcap {g2.attn_softcap} "
        f"window {g2.window} kv_len {kv_len}", q2, kc2, vc2,
        lambda: flex_attention(q2b, k2b, v2b, score_mod=capped,
                               enable_gqa=True),
        lib_name="flex_attention (eager)", q0=q02, kv_len=kv_len, window=w2, softcap=cap2)
    on_path("gemma2-9b decode dh 256", "split_kv")
    return out


def long_prefill(torch, fa, randn) -> dict:
    """A global and a local layer of gemma3-1b's long_500k prefill on one
    model lane (q ``[1, LONG_PROMPT, 1, 4, 256]``, one launch each): the
    output's first 256 query rows and 256 rows that see 511 x 1024 keys
    held to the plain version over the keys they see (the local layer's
    from the window's start, 768 keys); each timed with CUDA events over
    3 launches beside its bound, the global layer beside
    ``scaled_dot_product_attention`` on its flash backend (k and v
    expanded to the 4 heads)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.configs import get_config
    cfg = get_config(LONG_ARCH)
    n_q, dh, w, L = cfg.n_heads, cfg.hd, cfg.window, LONG_PROMPT
    q = randn(1, L, 1, n_q, dh)
    k, v = (randn(1, L, 1, dh) for _ in range(2))
    out = {}
    for label, kw in (("global", dict(causal=True)),
                      ("local", dict(causal=True, window=w))):
        before = dict(fa.flash_attention.launches_by_path)
        got = fa.flash_attention(q, k, v, **kw)
        took = {p_: n for p_, n in path_delta(fa.flash_attention,
                                              before).items() if n}
        if took != {"wgmma": 1}:
            raise RuntimeError(f"long prefill {label} layer: paths {took}, "
                               "not one wgmma launch")
        worst = 0.0
        for r0 in (0, L // 1024 * 1024 - 256):   # keys whole plain chunks
            k0 = max(0, r0 - w) if label == "local" else 0
            want = fa.flash_attention_plain(
                q[:, r0:r0 + 256], k[:, k0:r0 + 256], v[:, k0:r0 + 256],
                q0=r0 - k0, **kw)
            lim = fa.tolerance(q[:, r0:r0 + 256], k[:, k0:r0 + 256],
                               v[:, k0:r0 + 256], want, q0=r0 - k0, **kw)
            share = float(((got[:, r0:r0 + 256].float() - want.float()).abs()
                           / lim).max())
            if not share <= 1.0 or not bool(torch.isfinite(
                    got[:, r0:r0 + 256].float()).all()):
                raise RuntimeError(f"long prefill {label} layer: rows "
                                   f"{r0}.. at {share:.3f} of the limit")
            worst = max(worst, share)
        del got
        flops, byts = flash_work(1, L, 1, n_q, dh, 0, L, True,
                                 kw.get("window", 0), q.element_size())
        ms = time_ms(torch, lambda: fa.flash_attention(q, k, v, **kw),
                     iters=3, warmup=1)
        bound = max(flops / H100_FLOPS["bfloat16"],
                    byts / H100_BYTES_PER_S) * 1e3
        out[label] = {"ms": ms, "bound_ms": bound, "share_of_limit": worst,
                      "tflops": flops / ms / 1e9}
        log(f"[3] flash_attention long_500k {label} layer q{list(q.shape)} "
            f"{kw}: rows 0..255 and {L // 1024 * 1024 - 256}.. within "
            f"{worst:.3f} of the limit; {ms:.3f} ms (events, mean of 3) "
            f"bound {bound:.3f} ms ({flops / 1e12:.1f} TFLOP) = "
            f"{flops / ms / 1e9:.1f} TFLOP/s")
    qb = q.reshape(1, L, n_q, dh).transpose(1, 2)
    kx, vx = (t.reshape(1, L, 1, dh).transpose(1, 2).expand(
        1, n_q, L, dh).contiguous() for t in (k, v))
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        lib = time_ms(torch, lambda: torch.nn.functional
                      .scaled_dot_product_attention(qb, kx, vx,
                                                    is_causal=True),
                      iters=3, warmup=1)
    out["global"]["library_ms"] = lib
    log(f"[3] long_500k global layer: scaled_dot_product_attention (flash "
        f"backend, k and v expanded to {n_q} heads) {lib:.3f} ms; the "
        f"kernel {out['global']['ms'] / lib:.2f}x of it")
    del q, k, v, qb, kx, vx
    torch.cuda.empty_cache()
    return out



def check_flash_encdec(torch, randn, timed, check, planted, on_path,
                       last_path) -> dict:
    """Phase 3 at whisper-medium's shapes (phase 19: TP 8, 4 requests, 2
    KV heads of 64 a rank, G = 1), all non-causal: the encoder's
    self-attention (q, k ``[32, 1500, 2, (1,) 64]``) and the
    cross-attention at prefill (q ``[32, 192, 2, 1, 64]``) on ``wgmma``,
    whose last 128-key block is ragged (1500 keys), and at decode (q
    ``[32, 1, 2, 1, 64]``) on ``split_kv``, which must see all 1500 keys
    whatever q0 is; each held to its plain version, timed beside its bound
    and ``scaled_dot_product_attention``; and two planted faults the limit
    must reject: the prefill's ragged last block left out, the decode
    launched causal at its position."""
    from repro_torch.configs import get_config
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cfg = get_config(ENCDEC_ARCH)
    n = SERVE_BATCH * ENCDEC_TP
    hk, g, dh = cfg.n_kv_heads // ENCDEC_TP, cfg.n_heads // cfg.n_kv_heads, \
        cfg.hd
    full = dict(causal=False)
    out = {}

    def bhsd(t):                      # [N, S, HK, (G,) dh] -> [N, H, S, dh]
        return t.reshape(t.shape[0], t.shape[1], -1, dh).transpose(
            1, 2).contiguous()

    q = randn(n, ENCDEC_FRAMES, hk, g, dh)
    k, v = (randn(n, ENCDEC_FRAMES, hk, dh) for _ in range(2))
    qb, kb, vb = bhsd(q), bhsd(k), bhsd(v)
    out["encoder"] = timed("whisper encoder self-attention", q, k, v,
                           lambda: sdpa(qb, kb, vb), **full)
    on_path("whisper encoder self-attention", "wgmma")
    ragged = ENCDEC_FRAMES // 128 * 128
    planted(f"encoder self-attention without the ragged last block (keys "
            f"{ragged}-{ENCDEC_FRAMES - 1})", q, k, v,
            dict(causal=False, kv_len=ragged), **full)
    qx = randn(n, ENCDEC_PROMPT, hk, g, dh)
    qxb = bhsd(qx)
    out["cross prefill"] = timed("whisper cross-attention prefill", qx, k, v,
                                 lambda: sdpa(qxb, kb, vb), **full)
    on_path("whisper cross-attention prefill", "wgmma")
    planted(f"cross prefill without the ragged last block (keys {ragged}-"
            f"{ENCDEC_FRAMES - 1})", qx, k, v,
            dict(causal=False, kv_len=ragged), **full)
    q1 = randn(n, 1, hk, g, dh)
    q1b = bhsd(q1)
    worst = (0.0, 0.0)
    for q0 in (0, ENCDEC_PROMPT, ENCDEC_PROMPT + SERVE_DECODE - 1,
               ENCDEC_FRAMES + 7):
        label = f"whisper cross-attention decode q0 {q0}"
        worst = tuple(map(max, worst, check(label, q1, k, v, q0=q0,
                                            **full)))
        on_path(label, "split_kv")
    log(f"[3] flash_attention whisper cross decode q{list(q1.shape)} "
        f"k{list(k.shape)} bf16 non-causal, q0 0...{ENCDEC_FRAMES + 7} "
        f"path {last_path[0]}: max_abs_err {worst[0]:.3e} ({worst[1]:.3f} "
        f"of the limit)")
    out["cross decode"] = timed("whisper cross-attention decode", q1, k, v,
                                lambda: sdpa(q1b, kb, vb), q0=ENCDEC_PROMPT,
                                **full)
    on_path("whisper cross-attention decode", "split_kv")
    planted(f"cross decode launched causal at q0 {ENCDEC_PROMPT}", q1, k, v,
            dict(causal=True, q0=ENCDEC_PROMPT), q0=ENCDEC_PROMPT, **full)
    return out


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


def step_profiles(torch, cfg, axis, params, prompts, tag: str,
                  needles: tuple, frames=None,
                  slots: int = SERVE_SLOTS) -> dict:
    """``profile_call`` over one prefill of ``prompts`` (an enc-dec
    model's with the encoder on ``frames``) and one decode step at the
    prompt's end; the decode step reads the caches that prefill returned
    (their filled length with them), so its attention spans the prompt."""
    from repro_torch.dist.axes import bind
    from repro_torch.launch import serve as sv
    from repro_torch.models import lm
    with bind(model=axis):
        caches = lm.init_caches(cfg, prompts.shape[0], slots, enc_len=None
                                if frames is None else frames.shape[1])
    pf, dc = sv.build_prefill(cfg, axis), sv.build_decode(cfg, axis)
    inputs = {"tokens": prompts}
    if frames is not None:
        inputs["frames"] = frames
    filled = []

    def prefill():
        filled[:] = [pf(params, inputs, caches)[1]]
    tok = prompts[:, :1]
    return {
        "prefill": profile_call(torch, f"{cfg.name} one prefill", prefill,
                                tag, needles),
        "decode": profile_call(torch, f"{cfg.name} one decode step",
                               lambda: dc(params, tok, filled[0],
                                          prompts.shape[1]), tag, needles)}


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
    from repro_torch.launch import serve as sv
    from repro_torch.models import lm
    from repro_torch.models.params import init_tree

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), attn_impl="flash")
    axis = StackedAxis(P, dev)
    t0 = time.perf_counter()

    def draw():
        gen = torch.Generator(device=dev).manual_seed(SEED)
        return init_tree(lm.model_specs(cfg, P), gen, axis)
    params = draw()
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
    shares = step_profiles(torch, cfg, axis, params, prompts, tag, needles)
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


def timed_steps(torch, tr, params, opt, batches, tag: str, sub: str = "a",
                warmup: int | None = None, steps: int | None = None):
    """``warmup`` (``TRAIN_WARMUP``) warm-up and ``steps``
    (``TRAIN_STEPS``) timed steps of ``tr``, then one step under
    ``torch.profiler`` (device busy share, the top kernels): ``(params,
    opt, losses, times, step_rec, profiled)``, with ``step_rec`` the
    dispatches of the last timed step; logged as ``[{tag}{sub}]``."""
    from torch.profiler import ProfilerActivity, profile
    warmup = TRAIN_WARMUP if warmup is None else warmup
    losses, times, step_rec = [], [], None
    n_a = warmup + (TRAIN_STEPS if steps is None else steps) + 1
    for i in range(n_a - 1):
        torch.cuda.synchronize()
        n0 = len(tr.record)
        t0 = time.perf_counter()
        params, opt, m = tr.step(params, opt, batches[i], i)
        losses.append(float(m["loss"]))          # waits for the step
        dt = time.perf_counter() - t0
        if i >= warmup:
            times.append(dt)
        step_rec = tr.record[n0:]
        log(f"[{tag}{sub}] step {i}: loss {losses[-1]:.6f} grad_norm "
            f"{float(m['grad_norm']):.4f} lr {float(m['lr']):.3e} "
            f"{dt * 1e3:.2f} ms{' (warm-up)' if i < warmup else ''}")
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
    from repro_torch.core import collectives as C, profiles, trace, tuner
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
    t0 = time.perf_counter()
    with C.wire_held_out("training needs exact gradients"):
        rep = tuner.tune_trace(trace.Trace(fits), backend)
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
    paths0 = (dict(bm.launches_by_path), dict(ring.launches_by_path),
              dict(wrappers["flash_attention"].launches_by_path),
              dh_counts(wrappers["flash_attention"]))
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
                    "ring_allgather_matmul_rdma": path_delta(ring, paths0[1]),
                    "flash_attention": path_delta(
                        wrappers["flash_attention"], paths0[2])}
    out["d256_paths"] = dh_delta(wrappers["flash_attention"], paths0[3])
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
    paths0 = (dict(bm.launches_by_path), dict(ring.launches_by_path),
              dict(wrappers["flash_attention"].launches_by_path),
              dh_counts(wrappers["flash_attention"]))

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
                    "ring_allgather_matmul_rdma": path_delta(ring, paths0[1]),
                    "flash_attention": path_delta(
                        wrappers["flash_attention"], paths0[2])}
    out["d256_paths"] = dh_delta(wrappers["flash_attention"], paths0[3])
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
    def apply(q, k, v, causal, window, softcap, q0, kv_len, scale):
        from repro_torch.kernels import flash_attention as fa
        return _pinned(fa.flash_attention_plain(
            q, k, v, causal=causal, window=window, softcap=softcap, q0=q0,
            kv_len=kv_len, scale=scale))


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
            def apply(q, k, v, causal, window, softcap, q0, kv_len, scale):
                kw = dict(causal=causal, window=window, softcap=softcap,
                          q0=q0, kv_len=kv_len, scale=scale)
                return held("flash_attention", flash.apply(
                    q, k, v, causal, window, softcap, q0, kv_len, scale),
                    (q, k, v),
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
        args = (True, 0, 0.0, 0, None, None)
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
    paths0 = {k: dict(wrappers[k].launches_by_path)
              for k in ("flash_attention", "rwkv6_scan", "ssd_scan")}
    dh0 = dh_counts(wrappers["flash_attention"])
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
    out["paths"] = {k: path_delta(wrappers[k], v) for k, v in paths0.items()}
    out["d256_paths"] = dh_delta(wrappers["flash_attention"], dh0)
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


class PinnedRoutes:
    """While active, every ``moe_block`` call routes its tokens to the
    experts that a recorded serve chose (``RouteProbe.host()``: rank 0's,
    which every lane of that serve shared), in that serve's order, so the
    two serves keep and drop the same choices; the gate values are the
    current router's probabilities at those experts, renormalised as
    ``models.moe._route`` does."""

    def __init__(self, torch, moe, calls: list):
        self.torch, self.moe, self.calls = torch, moe, calls
        self.real = moe._route
        self.n = 0

    def __enter__(self):
        torch, real = self.torch, self.real

        def route(p, cfg, xt):
            probs, _, ids = real(p, cfg, xt)
            want = self.calls[self.n]["ids"].to(ids.device).expand_as(ids)
            self.n += 1
            gates = torch.gather(probs, -1, want)
            gates = gates / torch.clamp(gates.sum(-1, keepdim=True),
                                        min=1e-9)
            return probs, gates, want
        self.moe._route = route
        return self

    def __exit__(self, *exc):
        self.moe._route = self.real


def route_changes(torch, a: list, b: list, n_layers: int, batch: int,
                  prompt: int, k: int, rtol: float,
                  parted: dict | None = None) -> dict:
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
    change see other inputs and are not held, nor are those after the
    step at which a request's greedy tokens parted (``parted``: request
    -> the step whose token differs; the next step decodes another
    token).  Returns ``{"changed":
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
        live = torch.tensor([int(r) not in first
                             and step <= (parted or {}).get(int(r), step)
                             for r in req])
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
    held_steps = [min(first[r][1] if r in first else n_steps,
                      (parted or {}).get(r, n_steps) + 1)
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
    # a request whose greedy tokens parted decodes another token after
    # that step: its later routes are not comparable
    n_steps = min(ref.tokens.shape[1], got.tokens.shape[1])
    diff = (ref.tokens[:, :n_steps] != got.tokens[:, :n_steps]).cpu()
    parted = {r: int(diff[r].nonzero()[0]) for r in range(diff.shape[0])
              if bool(diff[r].any())}
    if parted:
        log(f"[{tag}] {label}: greedy tokens parted (request: step) "
            f"{parted}; routes after that step are not held")
    rc = route_changes(torch, ref_routes, got_routes, cfg.n_layers,
                       SERVE_BATCH, SERVE_PROMPT, cfg.moe.top_k,
                       ROUTE_MOVE_BOUND, parted)
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

    def draw():
        gen = torch.Generator(device=dev).manual_seed(SEED)
        return init_tree(lm.model_specs(cfg, P), gen, axis)
    params = draw()
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
    c0, fa0, dh0 = counts(wrappers), dict(fa.launches_by_path), dh_counts(fa)

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
    fa_paths, d256 = path_delta(fa, fa0), dh_delta(fa, dh0)
    log(f"[moe serve path {cfg.name}] kernel launches: "
        f"{json.dumps(launches)}; flash_attention by path "
        f"{json.dumps(fa_paths)}; at head dim 256 {json.dumps(d256)}")

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
    shares = step_profiles(torch, cfg, axis, params, prompts, tag, (
        "fa_wgmma", "fa_ring_kernel", "nvjet", "gemm", "index",
        "scan"))
    del params, first, second, third, forced
    torch.cuda.empty_cache()
    block = moe_block_check(torch, dev, cfg, card, tag)
    log(f"[{tag}] MoE serve phase in {time.perf_counter() - t_phase:.1f} s "
        f"({card})")
    return {"launches": launches, "flash_paths": fa_paths,
            "d256_paths": d256, "per_serve": per_serve, "peak_bytes": peak,
            "serve_peak_bytes": serve_peak,
            "weights_bytes": w_bytes, "capacity": cap,
            "drops_prefill": drops, "both_dropped_prefill": both,
            "alltoall_ms": {str(k): v for k, v in a2a_cells.items()},
            "picks": picks, "routes": routes,
            "shares": shares, "serves": serves, "moe_block": block}


# ---------------------------------------------------------------------------
# the MLA serve (phase 16)
# ---------------------------------------------------------------------------

# deepseek-v3-671b (src/repro/configs/deepseek_v3.py, the public DeepSeek-V3
# config) at full width: d_model 7168, 128 heads, MLA (q_lora 1536, kv_lora
# 512, rope 64, nope 128, v 128), 256 routed experts of d_ff 2048, top-8, 1
# shared expert, vocab 129280, untied head; cut in depth only, to 2 of its
# 61 layers.  One layer is 23.01 GB of bf16 (the experts 22.55 GB, attention
# 0.37 GB, the shared expert 0.09 GB), the embedding and head 3.71 GB: 49.7
# GB in all; three layers would leave no room to serve.  TP P stacked: 16
# q heads and 32 experts a rank; absorbed attention ("flash"); the requests
# of phase 10.
MLA_ARCH, MLA_LAYERS = "deepseek-v3-671b", 2
# tune_trace replays a cell at the per-rank bytes it recorded, an alltoall
# at P times them (the JAX package's convention, ROADMAP queue 3): the
# prefill's dispatch alltoall, 587 MB a rank, takes a 37.6 GB operand
# (2.35e9 bf16 rows a rank) and its 37.6 GB output.  Phase 16 frees the
# 49.7 GB of weights and tries the whole trace; where it stops (the int32
# counts of alltoall_as_alltoallv, the JAX package's too, cannot describe
# 2.35e9 rows), the cells whose replayed operand passes this cap keep the
# default (logged) and the rest are tuned.  Every other cell of the serve
# is under 1 GB.
MLA_REPLAY_CAP = 8e9


def mla_serve_phase(torch, dev, out_dir: pathlib.Path, wrappers: dict,
                    card: str, tag: str = "16") -> dict:
    """Serve deepseek-v3-671b (``MLA_LAYERS`` layers, full width, TP ``P``)
    on the card through flash's MLA paths: (a) the default serve,
    recording, with rank 0's routes probed; ``tune_trace`` of its trace
    (measured) with the weights freed, then drawn again from the seed
    (cells over ``MLA_REPLAY_CAP`` held out only if the whole trace runs
    the card out of memory), the per-phase profiles saved and reloaded;
    (b) the tuned re-serve, probed: every
    changed route a near-tie, the logits no changed route reached within
    ``SERVE_RTOL``; (c) the default serve again: logits bit-equal to
    (a)'s; (d) the naive serve (``attn_impl="ref"``) of the same weights,
    probed, held to (a) as (b) is, then with every route pinned to (a)'s,
    every request's logits within ``SERVE_RTOL`` (the JAX package's
    absorbed-vs-naive check, ``tests/test_attn_variants.py:45-55``, at
    full width).  Flash
    must launch once per layer and forward in each absorbed serve, the
    prefill on ``"mla_wgmma"`` and every decode step on ``"mla"``.  (e)
    ``torch.profiler`` over one prefill and one decode step.  Times, rates and memory sizes name ``card``."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import profiles, trace, tuner
    from repro_torch.core._axis import StackedAxis
    from repro_torch.launch import serve as sv
    from repro_torch.models import lm, moe
    from repro_torch.models.params import init_tree, tree_leaves

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(MLA_ARCH), attn_impl="flash",
                              n_layers=MLA_LAYERS)
    m, ml = cfg.moe, cfg.mla
    axis = StackedAxis(P, dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()

    def draw():
        gen = torch.Generator(device=dev).manual_seed(SEED)
        return init_tree(lm.model_specs(cfg, P), gen, axis)
    params = draw()
    torch.cuda.synchronize()
    w_bytes = sum(t.numel() * t.element_size()
                  for t in tree_leaves(params))
    peaks = {"draw": torch.cuda.max_memory_allocated(dev)}
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} of 61 layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads, MLA q_lora {ml.q_lora_rank} "
        f"kv_lora {ml.kv_lora_rank} rope {ml.rope_head_dim} nope "
        f"{ml.nope_head_dim} v {ml.v_head_dim}, {m.n_experts} experts of "
        f"d_ff {m.d_ff_expert} top-{m.top_k} + {m.n_shared} shared, "
        f"capacity factor {m.capacity_factor}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}, attn_impl {cfg.attn_impl}; TP {P} stacked "
        f"({cfg.n_heads // P} q heads, {m.n_experts // P} experts a rank); "
        f"weights {w_bytes / 1e9:.3f} GB drawn in "
        f"{time.perf_counter() - t0:.1f} s, peak {peaks['draw'] / 1e9:.3f} "
        f"GB ({card})")
    rng = np.random.default_rng(SEED)
    prompts = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT)), device=dev)
    n_tokens = 1 + SERVE_DECODE
    per_serve = per_serve_launches(lm, cfg, n_tokens)
    sv.serve(cfg, axis, params, prompts, SERVE_SLOTS, 2)   # warm-up
    fa = wrappers["flash_attention"]

    zero_counts(wrappers)               # the MLA serve path starts here
    c0, dh0 = counts(wrappers), dh_counts(fa)

    def one(label, c=cfg, **kw):
        torch.cuda.reset_peak_memory_stats(dev)
        before, p_before = counts(wrappers), dict(fa.launches_by_path)
        res = sv.serve(c, axis, params, prompts, SERVE_SLOTS, n_tokens, **kw)
        peaks[label] = torch.cuda.max_memory_allocated(dev)
        after = counts(wrappers)
        got = {k: after[k] - before[k] for k in after}
        paths = path_delta(fa, p_before)
        log(f"[{tag} {label}] kernel launches: {json.dumps(got)}; "
            f"flash_attention by path {json.dumps(paths)}; peak "
            f"{peaks[label] / 1e9:.3f} GB")
        want = dict.fromkeys(got, 0)
        want_paths = dict.fromkeys(paths, 0)
        if c.attn_impl == "flash":
            want.update(per_serve)
            # the prefill on the wgmma kernel, every decode step on "mla"
            want_paths["mla_wgmma"] = c.n_layers
            want_paths["mla"] = per_serve["flash_attention"] - c.n_layers
        for kname in per_serve:
            if got[kname] != want[kname]:
                raise RuntimeError(f"{c.name} {label}: {kname} launched "
                                   f"{got[kname]} times, not {want[kname]}")
        if paths != want_paths:
            raise RuntimeError(f"{c.name} {label}: flash paths {paths}, "
                               f"not {want_paths}")
        return res

    with RouteProbe(moe) as probe_a:
        first = one("default serve")
    rec = trace.Trace.from_context(first.ctx)
    rec.save(out_dir / f"serve_trace_{cfg.name}.jsonl")
    for ln in rec.summary().splitlines():
        log(f"[{tag}] {ln}")
    # the weights make way for the replays and are drawn again after
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    log(f"[{tag}] weights freed for tune_trace: "
        f"{torch.cuda.memory_allocated(dev) / 1e9:.3f} GB allocated, "
        f"{torch.cuda.mem_get_info(dev)[0] / 1e9:.3f} GB free ({card})")
    biggest = max(rec.entries, key=lambda e: replay_bytes(e.cell))
    log(f"[{tag}] largest replay: {biggest.phase} {biggest.op} "
        f"{biggest.nbytes} B a rank, operand "
        f"{replay_bytes(biggest.cell) / 1e9:.1f} GB")
    t0 = time.perf_counter()
    held, rep = [], None
    try:
        rep = tuner.tune_trace(rec, tuner.MeasuredBackend(P, dev,
                                                          max_nrep=20))
    except RuntimeError as e:  # an int32 count overflow, out of memory
        why = f"{type(e).__name__}: {str(e).splitlines()[0]}"
    peaks["tune_trace, every cell"] = torch.cuda.max_memory_allocated(dev)
    if rep is None:
        # the failed replay's tensors go with its frames
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[{tag}] tune_trace of every cell stopped after "
            f"{time.perf_counter() - t0:.1f} s, peak "
            f"{peaks['tune_trace, every cell'] / 1e9:.3f} GB ({card}): "
            f"{why}")
        fits = []
        for e in rec.entries:
            (fits if replay_bytes(e.cell) <= MLA_REPLAY_CAP
             else held).append(e)
        for e in held:
            log(f"[{tag}] not tuned (operand "
                f"{replay_bytes(e.cell) / 1e9:.1f} GB over "
                f"{MLA_REPLAY_CAP / 1e9:.0f} GB): {e.phase} {e.op} "
                f"{e.nbytes} B x{e.count}")
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        rep = tuner.tune_trace(trace.Trace(fits),
                               tuner.MeasuredBackend(P, dev, max_nrep=20))
        peaks["tune_trace, capped"] = torch.cuda.max_memory_allocated(dev)
    log(f"[{tag}] tune_trace of {len(rec.entries) - len(held)} of "
        f"{len(rec.entries)} cells in {time.perf_counter() - t0:.1f} s, "
        f"peak {torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB "
        f"({card})")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = draw()
    torch.cuda.synchronize()
    peaks["redraw"] = torch.cuda.max_memory_allocated(dev)
    log(f"[{tag}] weights drawn again from seed {SEED} in "
        f"{time.perf_counter() - t0:.1f} s, peak {peaks['redraw'] / 1e9:.3f} "
        f"GB (the default serve's repeat, (c), shows them equal)")
    a2a_cells = {}
    for mm in rep.measurements:
        if mm.op == "alltoall":
            a2a_cells.setdefault(mm.nbytes, {})[mm.impl] = mm.latency * 1e3
    for nb, lat in sorted(a2a_cells.items()):
        log(f"[{tag}] alltoall cell {nb} B a rank (ms, replayed at {P} x "
            f"its bytes; {card}): " + ", ".join(
                f"{k} {v:.4f}" for k, v in lat.items()))
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
    picks = sorted({(r.cell.op, r.phase, r.impl) for r in second.ctx.record})
    log(f"[{tag}] tuned picks (op, phase, impl): {picks}")
    ra = probe_a.host()
    routes = {"tuned": hold_routes(torch, sv, cfg, tag, "tuned", first, ra,
                                   second, probe_b.host())}

    third = one("default serve again")
    same = all(torch.equal(a, b) for a, b in zip(first.logits,
                                                   third.logits))
    log(f"[{tag}] default serve repeated: logits bit-equal {same}, tokens "
        f"equal {torch.equal(first.tokens, third.tokens)}")
    if not same or not torch.equal(first.tokens, third.tokens):
        raise RuntimeError(f"{cfg.name}: the default serve does not repeat")
    c1 = counts(wrappers)
    launches = {k: c1[k] - c0[k] for k in c1}
    mla_paths = {"mla_wgmma": cfg.n_layers * 3,
                 "mla": (per_serve["flash_attention"] - cfg.n_layers) * 3}
    got_paths = {k: fa.launches_by_path[k] for k in mla_paths}
    if got_paths != mla_paths:
        raise RuntimeError(f"{cfg.name}: MLA launches on the path "
                           f"{got_paths}, not {mla_paths}")
    mla_launches = sum(mla_paths.values())
    d256 = dh_delta(fa, dh0)
    log(f"[mla serve path {cfg.name}] kernel launches: "
        f"{json.dumps(launches)}; flash_attention by MLA path "
        f"{json.dumps(got_paths)}; at head dim 256 {json.dumps(d256)}")

    # (d) absorbed against naive, the same weights (after the path's
    # counts): routed by its own router, whose near-ties flip (held as
    # (b)), then with every route pinned to (a)'s, where only the
    # attention's rounding tells the two apart: every request's logits
    # within SERVE_RTOL
    naive_cfg = dataclasses.replace(cfg, attn_impl="ref")
    with RouteProbe(moe) as probe_n:
        naive = one("naive serve", c=naive_cfg)
    routes["naive"] = hold_routes(torch, sv, cfg, tag, "naive", first, ra,
                                  naive, probe_n.host())
    if any(c["lanes_agree"] is not True for c in ra):
        raise RuntimeError(f"{cfg.name}: the default serve's lanes routed "
                           "apart; its routes cannot be pinned")
    with PinnedRoutes(torch, moe, ra) as pin:
        pinned = one("naive serve, routes pinned", c=naive_cfg)
    if pin.n != len(ra):
        raise RuntimeError(f"{cfg.name}: {pin.n} routed calls pinned, not "
                           f"{len(ra)}")
    pinned_rep = check_held(sv, torch, first, pinned,
                            [n_tokens] * SERVE_BATCH, SERVE_RTOL)
    for r, res in pinned_rep.items():
        log(f"[{tag}] naive serve with the default serve's routes pinned, "
            f"request {r}: logits within {res['max_rel_err']:.4e} "
            f"(max-norm relative, tolerance {SERVE_RTOL}) over "
            f"{res['steps']} steps, greedy tokens parted at "
            f"{res['diverged_at']}")
    routes["naive_pinned"] = {str(r): v for r, v in pinned_rep.items()}

    serves = {}
    for label, res in (("default", first), ("tuned", second),
                       ("default again", third), ("naive", naive),
                       ("naive pinned", pinned)):
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
    log(f"[{tag}] {cfg.name} weights {w_bytes / 1e9:.3f} GB; peak device "
        f"memory by step ({card}): " + ", ".join(
            f"{k} {v / 1e9:.3f} GB" for k, v in peaks.items()))

    # (e) where a step's device time goes
    shares = step_profiles(torch, cfg, axis, params, prompts, tag, (
        "fa_mla", "nvjet", "gemm", "index", "elementwise"))
    del params, first, second, third, naive, pinned
    torch.cuda.empty_cache()
    log(f"[{tag}] MLA serve phase in {time.perf_counter() - t_phase:.1f} s "
        f"({card})")
    return {"launches": launches, "mla_launches": mla_launches,
            "mla_paths": got_paths, "d256_paths": d256,
            "per_serve": per_serve, "peaks": peaks,
            "weights_bytes": w_bytes, "held_out": [
                (e.phase, e.op, e.nbytes) for e in held],
            "alltoall_ms": {str(k): v for k, v in a2a_cells.items()},
            "picks": picks, "routes": routes, "shares": shares,
            "serves": serves}


# ---------------------------------------------------------------------------
# the long-context serve (phase 17) and the VLM serve (phase 18)
# ---------------------------------------------------------------------------

# gemma3-1b (src/repro/configs/gemma3_1b.py: 26 layers, 5 local (window
# 512) to 1 global, d_model 1152, 4 q heads over 1 KV head of 256, d_ff
# 6912, vocab 262144) at full width and depth.  (a) on the (data 2, model
# 4) mesh: phase 10's 4 x 1024 requests split over data, the weights
# FSDP-sharded over data; held to the same requests over model only (TP 4).
# (b) the long_500k cell (src/repro/launch/shapes.py:52): one request, a
# 524 288-slot cache as 8 sequence shards on (data 8, model 1), a prompt of
# 524 288 - 32 tokens prefilled on one model lane.  The caches: 26 layers x
# 2 x 524 288 x 256 x 2 B = 13.96 GB, and its clone for the unsharded
# decode that the sharded one is held to
LONG_ARCH = "gemma3-1b"
LONG_MESH = (2, 4)
LONG_SLOTS, LONG_SHARDS = 524_288, 8
LONG_PROMPT = LONG_SLOTS - SERVE_DECODE
# paligemma-3b (src/repro/configs/paligemma_3b.py: 18 gemma layers, d_model
# 2048, 8 q heads over 1 KV head of 256, d_ff 16384, vocab 257216, 256
# stub SigLIP patches of 1152 before the text) at full width and depth, TP
# 8 stacked; 4 requests of 256 seeded patches + 1024 text tokens
VLM_ARCH, VLM_TP = "paligemma-3b", 8
# whisper-medium (src/repro/configs/whisper_medium.py: 24 encoder and 24
# decoder layers, d_model 1024, 16 q heads over 16 KV heads of 64, d_ff
# 4096, vocab 51865; the JAX package's simplified whisper: RMSNorm, the
# gated MLP, a stub front end) at full width and depth, TP 8 stacked (2 q
# heads and 2 KV heads a rank).  4 requests of 1500 seeded stub frames
# (max_source_positions of the public openai/whisper-medium config) and a
# 192-token prompt (the previous window's text), 1 + 32 greedy tokens, a
# 448-slot self cache (max_target_positions)
ENCDEC_ARCH, ENCDEC_TP = "whisper-medium", 8
ENCDEC_FRAMES, ENCDEC_PROMPT, ENCDEC_SLOTS = 1500, 192, 448


def _tune(torch, rec, dev, tag: str, label: str, out_dir, held=True):
    """``tune_trace`` of ``rec`` (measured, every cell at its own world;
    with ``held`` the quantized wire held out: a weight gathered over
    data on it changes the model), the per-phase profiles saved under
    ``out_dir`` and reloaded: ``(report, phase stores)``."""
    import contextlib
    from repro_torch.core import collectives as C, profiles, tuner
    t0 = time.perf_counter()
    with (C.wire_held_out("FSDP weights on the quantized wire") if held
          else contextlib.nullcontext()):
        rep = tuner.tune_trace(rec, tuner.MeasuredBackend(None, dev,
                                                          max_nrep=20))
    log(f"[{tag}] {label} tune_trace in {time.perf_counter() - t0:.1f} s")
    for ln in rep.summary().splitlines():
        log(f"[{tag}] {ln}")
    prof_dir = out_dir / f"profiles_{tag}_{label.replace(' ', '_')}"
    shutil.rmtree(prof_dir, ignore_errors=True)
    rep.save(prof_dir)
    _, phases = profiles.resolve_stores(prof_dir)
    return rep, phases


def _serve_line(tag, label, res, n_req, prompt_tokens, card):
    if res.prefill_s:
        pf = (f"prefill {res.prefill_s * 1e3:.2f} ms "
              f"({n_req * prompt_tokens / res.prefill_s:.0f} tokens/s), ")
    else:
        pf = ""
    log(f"[{tag}] {label}: {pf}decode {res.decode_s_per_token * 1e3:.3f} "
        f"ms/token ({n_req / res.decode_s_per_token:.1f} tokens/s over "
        f"{n_req} requests) ({card})")


def long_context_phase(torch, dev, out_dir: pathlib.Path, wrappers: dict,
                       card: str, tag: str = "17") -> dict:
    """gemma3-1b at full width and depth.  (a) Serve phase 10's requests
    on the (data 2, model 4) mesh (batch over data, weights FSDP over
    data): the default serve recording, ``tune_trace`` (the quantized wire
    held out), the tuned re-serve within ``SERVE_RTOL`` of it, and the
    default serve held to the same requests over model only (TP 4).
    (b) ``long_500k``: prefill a ``LONG_PROMPT``-token prompt on one
    model lane (flash on ``wgmma``), lay its 524 288-slot cache out as
    8 sequence shards on (data 8, model 1), decode 32 steps over the
    shards (the combine's two allreduces over data dispatched), every
    data lane's logits bit-equal under the defaults; 32 unsharded decode
    steps from a clone of the cache (flash ``split_kv``) as the
    yardstick, within ``SERVE_RTOL``; ``tune_trace`` of the sharded
    decode's trace, the 8-lane allreduce cells with their winner and
    ``default`` time, the tuned decode within ``SERVE_RTOL``.  Flash
    launches are read by path around each run.  Times and memory name
    ``card``."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import api, trace
    from repro_torch.core._axis import StackedAxis, StackedMesh
    from repro_torch.dist.axes import bind
    from repro_torch.launch import serve as sv
    from repro_torch.launch.shapes import SHAPES
    from repro_torch.models import lm
    from repro_torch.models.params import init_tree

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(LONG_ARCH), attn_impl="flash")
    fa = wrappers["flash_attention"]
    n_tokens = 1 + SERVE_DECODE
    n_attn = per_serve_launches(lm, cfg, 1)["flash_attention"]
    out: dict = {"paths": {}, "d256_paths": {}}

    def draw(tp, axis):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        return init_tree(lm.model_specs(cfg, tp), gen, axis)

    def flash_run(label, fn, want):
        """Run ``fn``; flash's launches by path in it must be ``want``,
        all of them at head dim 256."""
        torch.cuda.reset_peak_memory_stats(dev)
        before, dh0 = dict(fa.launches_by_path), dh_counts(fa)
        res = fn()
        torch.cuda.synchronize()
        got = {k: v for k, v in path_delta(fa, before).items() if v}
        d256 = dh_delta(fa, dh0)
        peak = torch.cuda.max_memory_allocated(dev)
        log(f"[{tag} {label}] flash_attention launches by path "
            f"{json.dumps(got)}, at head dim 256 {json.dumps(d256)}; peak "
            f"{peak / 1e9:.3f} GB ({card})")
        if got != want or d256 != want:
            raise RuntimeError(f"{cfg.name} {label}: flash paths {got} (at "
                               f"head dim 256 {d256}), not {want}")
        for k, v in got.items():
            out["paths"][k] = out["paths"].get(k, 0) + v
            out["d256_paths"][k] = out["d256_paths"].get(k, 0) + d256[k]
        return res, peak

    # -- (a) the (data 2, model 4) mesh -------------------------------------
    d, t = LONG_MESH
    mesh = StackedMesh((d, t), ("data", "model"), dev)
    params = draw(t, mesh)
    rng = np.random.default_rng(SEED)
    prompts = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT)), device=dev)
    log(f"[{tag}a] {cfg.name}: {cfg.n_layers} layers (5 local of window "
        f"{cfg.window} : 1 global), d_model {cfg.d_model}, {cfg.n_heads} "
        f"heads / {cfg.n_kv_heads} KV head x {cfg.hd}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}; mesh data {d} x model {t}, "
        f"{SERVE_BATCH} x {SERVE_PROMPT} prompt tokens, {SERVE_SLOTS} slots")
    sv.serve(cfg, mesh, params, prompts, SERVE_SLOTS, 2)      # warm-up
    zero_counts(wrappers)          # the long-context serve path starts here
    c0 = counts(wrappers)
    per_serve = {"wgmma": n_attn, "split_kv": n_attn * SERVE_DECODE}
    first, peak_a = flash_run("a default serve", lambda: sv.serve(
        cfg, mesh, params, prompts, SERVE_SLOTS, n_tokens), per_serve)
    rec = trace.Trace.from_context(first.ctx)
    rec.save(out_dir / f"serve_trace_{cfg.name}_mesh.jsonl")
    for ln in rec.summary().splitlines():
        log(f"[{tag}a] {ln}")
    _, phases = _tune(torch, rec, dev, f"{tag}a", "mesh", out_dir)
    second, _ = flash_run("a tuned serve", lambda: sv.serve(
        cfg, mesh, params, prompts, SERVE_SLOTS, n_tokens,
        phase_profiles=phases), per_serve)
    for ln in api.format_footer(second.ctx).splitlines():
        log(f"[{tag}a] {ln}")
    del params
    tp_axis = StackedAxis(t, dev)
    params_tp = draw(t, tp_axis)
    tp4, _ = flash_run("a TP 4 serve", lambda: sv.serve(
        cfg, tp_axis, params_tp, prompts, SERVE_SLOTS, n_tokens), per_serve)
    del params_tp
    checks = {"mesh vs TP 4": sv.check_serves(tp4, first, SERVE_RTOL),
              "tuned vs default": sv.check_serves(first, second, SERVE_RTOL)}
    for label, c in checks.items():
        log(f"[{tag}a] {label}: {c['steps']} steps, max-norm relative error "
            f"{c['max_rel_err']:.4e} (tolerance {SERVE_RTOL}), tokens "
            f"diverged at {c['diverged_at']}")
    for label, res in (("mesh default", first), ("mesh tuned", second),
                       ("TP 4", tp4)):
        _serve_line(f"{tag}a", label, res, SERVE_BATCH, SERVE_PROMPT, card)
    out["mesh"] = {"checks": checks, "peak_bytes": peak_a, "serves": {
        label: {"prefill_ms": r.prefill_s * 1e3,
                "decode_ms_per_token": r.decode_s_per_token * 1e3}
        for label, r in (("default", first), ("tuned", second),
                         ("tp4", tp4))}}
    del first, second, tp4
    torch.cuda.empty_cache()

    # -- (b) long_500k: 8 sequence shards on (data 8, model 1) --------------
    cell = SHAPES["long_500k"]
    one = StackedAxis(1, dev)
    mesh8 = StackedMesh((LONG_SHARDS, 1), ("data", "model"), dev)
    params1, params8 = draw(1, one), draw(1, mesh8)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (1, LONG_PROMPT)), device=dev)
    with bind(model=one):
        caches = lm.init_caches(cfg, 1, LONG_SLOTS)
    torch.cuda.synchronize()
    cache_bytes = 2 * sum(
        c["self"]["k"].numel() * 2 for g in caches["stack"].values()
        for c in (g if isinstance(g, list) else [g]) for c in c.values())
    log(f"[{tag}b] long_500k: cache {LONG_SLOTS} slots x {cfg.n_layers} "
        f"layers, {cache_bytes / 1e9:.3f} GB; prompt {LONG_PROMPT} tokens; "
        f"{LONG_SHARDS} shards of {LONG_SLOTS // LONG_SHARDS} slots, the "
        f"last filled slot {LONG_PROMPT - 1} in shard "
        f"{(LONG_PROMPT - 1) // (LONG_SLOTS // LONG_SHARDS)} ({card})")
    prefill = sv.build_prefill(cfg, one)
    t0 = time.perf_counter()
    (logits, caches), peak_pf = flash_run(
        "b prefill", lambda: prefill(params1, {"tokens": prompt}, caches),
        {"wgmma": n_attn})
    prefill_s = time.perf_counter() - t0
    lg0 = sv.full_vocab(logits)
    if not bool(torch.isfinite(lg0).all()):
        raise RuntimeError("long_500k prefill: logits not finite")
    log(f"[{tag}b] prefill of {LONG_PROMPT} tokens on one lane: "
        f"{prefill_s:.2f} s ({LONG_PROMPT / prefill_s:.0f} tokens/s), peak "
        f"{peak_pf / 1e9:.3f} GB ({card})")
    clone = sv.clone_caches(caches)
    shards = sv.seq_shards(caches, LONG_SHARDS)
    sharded, peak_b = flash_run("b sharded decode", lambda: sv.decode_from(
        cfg, mesh8, params8, shards, lg0, LONG_PROMPT, n_tokens, cell=cell),
        {})
    spread = max(sharded.lane_spread)
    log(f"[{tag}b] data lanes' logits: largest difference from data rank "
        f"0's over {len(sharded.lane_spread)} steps {spread} (must be 0)")
    if spread != 0.0:
        raise RuntimeError("long_500k: the data lanes' logits differ")
    flat, _ = flash_run("b unsharded decode", lambda: sv.decode_from(
        cfg, one, params1, clone, lg0, LONG_PROMPT, n_tokens),
        {"split_kv": n_attn * SERVE_DECODE})
    del clone
    rec = trace.Trace.from_context(sharded.ctx)
    rec.save(out_dir / f"serve_trace_{cfg.name}_long_500k.jsonl")
    for ln in rec.summary().splitlines():
        log(f"[{tag}b] {ln}")
    # the combine's two sums over data, once each a layer and token: the
    # numerator [1, 1, H, dh] in bf16 and the denominator [1, H, 1] in f32
    want_ar = dict.fromkeys((cfg.n_heads * cfg.hd * 2, cfg.n_heads * 4),
                            cfg.n_layers * SERVE_DECODE)
    got_ar = {c.nbytes: n for c, n in rec.cells().items()
              if c.op == "allreduce" and c.p == LONG_SHARDS}
    log(f"[{tag}b] recorded allreduce cells over data {LONG_SHARDS} "
        f"(bytes: calls) {json.dumps(got_ar)}, want {json.dumps(want_ar)}")
    if got_ar != want_ar:
        raise RuntimeError(f"long_500k: recorded allreduce cells over data "
                           f"{got_ar}, not {want_ar}")
    rep, phases = _tune(torch, rec, dev, f"{tag}b", "long 500k", out_dir)
    cells = {}
    for m_ in rep.measurements:
        if m_.op == "allreduce" and m_.cell.p == LONG_SHARDS:
            cells.setdefault(m_.nbytes, {})[m_.impl] = m_.latency * 1e3
    if set(cells) != set(want_ar) or any("default" not in lat
                                         for lat in cells.values()):
        raise RuntimeError(f"long_500k: tune_trace measured allreduce cells "
                           f"{ {nb: sorted(lat) for nb, lat in cells.items()} }"
                           f", not {sorted(want_ar)} each with default")
    for nb, lat in sorted(cells.items()):
        win = min(lat, key=lat.get)
        log(f"[{tag}b] allreduce over data {LONG_SHARDS} at {nb} B: winner "
            f"{win} {lat[win]:.4f} ms, default {lat['default']:.4f} ms "
            f"({len(lat)} impls measured; {card})")
    tuned, _ = flash_run("b tuned sharded decode", lambda: sv.decode_from(
        cfg, mesh8, params8, shards, lg0, LONG_PROMPT, n_tokens, cell=cell,
        phase_profiles=phases), {})
    footer = api.format_footer(tuned.ctx).splitlines()
    for ln in footer:
        log(f"[{tag}b] {ln}")
    tuned_ar: dict = {}
    for op, p_, nb, impl, *_ in tuned.ctx.record:
        if op == "allreduce" and p_ == LONG_SHARDS:
            tuned_ar.setdefault(nb, {}).setdefault(impl, 0)
            tuned_ar[nb][impl] += 1
    if {nb: sum(n.values()) for nb, n in tuned_ar.items()} != want_ar or any(
            f"#@pgmpi alg MPI_Allreduce {nb} {impl}" not in footer
            for nb, n in tuned_ar.items() for impl in n):
        raise RuntimeError(f"long_500k: the tuned decode's allreduce calls "
                           f"over data {tuned_ar} and footer lines do not "
                           f"show the cells {sorted(want_ar)}")
    checks = {"sharded vs unsharded": sv.check_serves(flat, sharded,
                                                      SERVE_RTOL),
              "tuned vs default": sv.check_serves(sharded, tuned,
                                                  SERVE_RTOL)}
    for label, c in checks.items():
        log(f"[{tag}b] {label}: {c['steps']} steps, max-norm relative error "
            f"{c['max_rel_err']:.4e} (tolerance {SERVE_RTOL}), tokens "
            f"diverged at {c['diverged_at']}")
    for label, res in (("sharded default", sharded), ("sharded tuned", tuned),
                       ("unsharded", flat)):
        _serve_line(f"{tag}b", label, res, 1, LONG_PROMPT, card)
    launches = {k: v - c0[k] for k, v in counts(wrappers).items()}
    log(f"[long-context path {cfg.name}] kernel launches: "
        f"{json.dumps(launches)}")
    out["long_500k"] = {
        "prefill_s": prefill_s, "peak_prefill_bytes": peak_pf,
        "peak_decode_bytes": peak_b, "cache_bytes": cache_bytes,
        "checks": checks, "allreduce_cells_ms": cells,
        "decode_ms_per_token": {
            "sharded": sharded.decode_s_per_token * 1e3,
            "tuned": tuned.decode_s_per_token * 1e3,
            "unsharded": flat.decode_s_per_token * 1e3}}
    out["launches"] = launches
    del params1, params8, caches, shards, logits
    torch.cuda.empty_cache()
    log(f"[{tag}] long-context phase in {time.perf_counter() - t_phase:.1f} "
        f"s")
    return out


def flash_ref_serves(torch, dev, out_dir: pathlib.Path, wrappers: dict,
                     card: str, tag: str, cfg, axis, params, prompts,
                     slots: int, want: dict, label: str, **inputs) -> dict:
    """Three serves of ``prompts`` (with the model's extra ``inputs``:
    patches or frames) on ``axis``, 1 + ``SERVE_DECODE`` tokens,
    ``slots`` slots: (a) the flash serve recording, flash's launches by
    path ``want``, all at ``cfg.hd``; ``tune_trace`` (the quantized wire
    kept in) and the tuned re-serve within ``SERVE_RTOL``; (b) the
    ``ref`` serve of the same weights, the flash serve held to it within
    ``SERVE_RTOL``.  The kernels' counts are zeroed after a warm-up serve
    and read after the three; flash's launches at head dim 256 are counted
    around each of the three, ``ref`` included (``d256_paths``)."""
    from repro_torch.core import api, trace
    from repro_torch.launch import serve as sv
    from repro_torch.models.params import tree_leaves

    fa = wrappers["flash_attention"]
    w_bytes = sum(t_.numel() * t_.element_size()
                  for t_ in tree_leaves(params))
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads / {cfg.n_kv_heads} KV heads x {cfg.hd}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.param_count()} "
        f"parameters; TP {axis.size} stacked; weights {w_bytes / 1e9:.3f} GB "
        f"stacked; {prompts.shape[0]} requests of {label}, {slots} slots "
        f"({card})")
    n_tokens = 1 + SERVE_DECODE
    n_prompt = prompts.shape[1] + (inputs["patches"].shape[1]
                                   if "patches" in inputs else 0)
    sv.serve(cfg, axis, params, prompts, slots, 2, **inputs)    # warm-up
    zero_counts(wrappers)               # the serve path starts here
    c0 = counts(wrappers)
    paths: dict = {}
    dh_paths: dict = {}
    d256_paths: dict = {}

    def one(label, c, **kw):
        torch.cuda.reset_peak_memory_stats(dev)
        before, dh0 = dict(fa.launches_by_path), dh_counts(fa)
        res = sv.serve(c, axis, params, prompts, slots, n_tokens, **inputs,
                       **kw)
        torch.cuda.synchronize()
        got = {k: v for k, v in path_delta(fa, before).items() if v}
        at_dh = dh_delta(fa, dh0, dh=cfg.hd)
        at256 = dh_delta(fa, dh0, dh=256)
        peak = torch.cuda.max_memory_allocated(dev)
        log(f"[{tag} {label}] flash_attention launches by path "
            f"{json.dumps(got)}, at head dim {cfg.hd} {json.dumps(at_dh)}; "
            f"peak {peak / 1e9:.3f} GB ({card})")
        if c.attn_impl == "flash" and (got != want or at_dh != want):
            raise RuntimeError(f"{cfg.name} {label}: flash paths {got} (at "
                               f"head dim {cfg.hd} {at_dh}), not {want}")
        for k, v in got.items():
            paths[k] = paths.get(k, 0) + v
        for k, v in at_dh.items():
            dh_paths[k] = dh_paths.get(k, 0) + v
        for k, v in at256.items():
            d256_paths[k] = d256_paths.get(k, 0) + v
        _serve_line(tag, label, res, prompts.shape[0], n_prompt, card)
        return res, peak

    first, peak = one("flash serve", cfg)
    rec = trace.Trace.from_context(first.ctx)
    rec.save(out_dir / f"serve_trace_{cfg.name}.jsonl")
    for ln in rec.summary().splitlines():
        log(f"[{tag}] {ln}")
    _, phases = _tune(torch, rec, dev, tag, cfg.name, out_dir, held=False)
    second, _ = one("tuned flash serve", cfg, phase_profiles=phases)
    for ln in api.format_footer(second.ctx).splitlines():
        log(f"[{tag}] {ln}")
    ref, peak_ref = one("ref serve", dataclasses.replace(cfg,
                                                          attn_impl="ref"))
    checks = {"flash vs ref": sv.check_serves(ref, first, SERVE_RTOL),
              "tuned vs default": sv.check_serves(first, second, SERVE_RTOL)}
    for label, c in checks.items():
        log(f"[{tag}] {label}: {c['steps']} steps, max-norm relative error "
            f"{c['max_rel_err']:.4e} (tolerance {SERVE_RTOL}), tokens "
            f"diverged at {c['diverged_at']}")
    launches = {k: v - c0[k] for k, v in counts(wrappers).items()}
    log(f"[{tag} serve path {cfg.name}] kernel launches: "
        f"{json.dumps(launches)}")
    return {"launches": launches, "paths": paths, "dh_paths": dh_paths,
            "d256_paths": d256_paths,
            "checks": checks, "peak_bytes": peak, "ref_peak_bytes": peak_ref,
            "weights_bytes": w_bytes, "serves": {
                label: {"prefill_ms": r.prefill_s * 1e3,
                        "decode_ms_per_token": r.decode_s_per_token * 1e3}
                for label, r in (("flash", first), ("tuned", second),
                                 ("ref", ref))}}


def vlm_serve_phase(torch, dev, out_dir: pathlib.Path, wrappers: dict,
                    card: str, tag: str = "18") -> dict:
    """paligemma-3b at full width and depth, TP ``VLM_TP`` stacked: 4
    requests of 256 seeded stub patches + 1024 text tokens, 1 + 32 tokens,
    2048 slots, through ``flash_ref_serves`` (two flash launches a layer
    at prefill, the prefix rows and the text rows, both ``wgmma``;
    ``split_kv`` at decode)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core._axis import StackedAxis
    from repro_torch.models import lm
    from repro_torch.models.params import init_tree

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(VLM_ARCH), attn_impl="flash")
    axis = StackedAxis(VLM_TP, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_tree(lm.model_specs(cfg, VLM_TP), gen, axis)
    rng = np.random.default_rng(SEED)
    prompts = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT)), device=dev)
    npf = cfg.vlm.n_patches
    patches = torch.as_tensor(rng.standard_normal(
        (SERVE_BATCH, npf, cfg.vlm.patch_dim), dtype=np.float32),
        device=dev)
    out = flash_ref_serves(
        torch, dev, out_dir, wrappers, card, tag, cfg, axis, params,
        prompts, SERVE_SLOTS, {"wgmma": 2 * cfg.n_layers,
                               "split_kv": cfg.n_layers * SERVE_DECODE},
        f"{npf} patches of {cfg.vlm.patch_dim} + {SERVE_PROMPT} tokens",
        patches=patches)
    del params
    torch.cuda.empty_cache()
    log(f"[{tag}] VLM serve phase in {time.perf_counter() - t_phase:.1f} s")
    return out


def encdec_serve_phase(torch, dev, out_dir: pathlib.Path, wrappers: dict,
                       card: str, tag: str = "19") -> dict:
    """whisper-medium at full width and depth, TP ``ENCDEC_TP`` stacked:
    4 requests of ``ENCDEC_FRAMES`` seeded stub frames and an
    ``ENCDEC_PROMPT``-token prompt, 1 + 32 tokens, ``ENCDEC_SLOTS`` self
    slots, through ``flash_ref_serves`` (the encoder inside the timed
    prefill; a serve's flash launches all at head dim 64: 3 a layer on
    ``wgmma`` at prefill, the encoder's, the self- and the
    cross-attention's, and 2 a layer a step on ``split_kv``); then
    ``torch.profiler`` over one prefill and one decode step."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core._axis import StackedAxis
    from repro_torch.models import lm
    from repro_torch.models.params import init_tree

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(ENCDEC_ARCH), attn_impl="flash")
    axis = StackedAxis(ENCDEC_TP, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_tree(lm.model_specs(cfg, ENCDEC_TP), gen, axis)
    rng = np.random.default_rng(SEED)
    prompts = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (SERVE_BATCH, ENCDEC_PROMPT)), device=dev)
    frames = torch.as_tensor(rng.standard_normal(
        (SERVE_BATCH, ENCDEC_FRAMES, cfg.d_model), dtype=np.float32),
        device=dev)
    n_dec, n_enc = cfg.n_layers, cfg.encdec.n_enc_layers
    out = flash_ref_serves(
        torch, dev, out_dir, wrappers, card, tag, cfg, axis, params,
        prompts, ENCDEC_SLOTS, {"wgmma": n_enc + 2 * n_dec,
                                "split_kv": 2 * n_dec * SERVE_DECODE},
        f"{ENCDEC_FRAMES} frames ({n_enc} encoder layers) + "
        f"{ENCDEC_PROMPT} tokens", frames=frames)
    # where a step's device time goes (after the path's counts)
    out["shares"] = step_profiles(torch, cfg, axis, params, prompts, tag, (
        "fa_wgmma", "fa_ring_kernel", "nvjet", "gemm",
        "elementwise", "reduce"), frames=frames, slots=ENCDEC_SLOTS)
    del params
    torch.cuda.empty_cache()
    log(f"[{tag}] enc-dec serve phase in {time.perf_counter() - t_phase:.1f}"
        f" s")
    return out


# ---------------------------------------------------------------------------
# the process-group axis (phase 20)
# ---------------------------------------------------------------------------

# (a) llama3.2-3b at full width and depth, TP 1, phase 10's requests, on a
# world-1 GroupAxis (NCCL puts one rank on a GPU: one card holds a world of
# one) against the same serve on StackedAxis(1); (b) gloo at world
# GROUP_WORLD on the host's CPU, in processes spawned under a hard timeout
GROUP_ARCH, GROUP_BACKEND, GROUP_WORLD = "llama3.2-3b", "nccl", 4
GROUP_TIMEOUT_S = 420.0
# (b)'s measured tune: phase 10's sizes (TUNE_SIZES) up to 1 MiB; the
# tuning CLI's 13 sizes took 31-263 s of the host's CPU, most of it in the
# 16 MiB cell
GROUP_TUNE_SIZES = tuple(s for s in TUNE_SIZES if s <= 1 << 20)


def cpu_model() -> str:
    """The host CPU's model, from ``/proc/cpuinfo`` (x86: its model name;
    Arm: the architecture with the implementer and part codes), with the
    number of CPUs this process may use."""
    import platform
    fields = {}
    try:
        for ln in pathlib.Path("/proc/cpuinfo").read_text().splitlines():
            k, _, v = ln.partition(":")
            fields.setdefault(k.strip(), v.strip())
    except OSError:
        pass
    name = fields.get("model name") or (
        f"{platform.machine()}, CPU implementer "
        f"{fields.get('CPU implementer', '?')} part "
        f"{fields.get('CPU part', '?')}")
    return f"{name}, {len(os.sched_getaffinity(0))} CPUs"


def group_tune_rank(out_dir: str) -> dict:
    """One rank of (b)'s measured tune: ``allreduce`` at
    ``GROUP_TUNE_SIZES`` on a ``GroupAxis`` over the world
    (``MeasuredBackend(axis=)``, every rank the slowest rank's samples);
    ``profiles.publish`` has rank 0 write the profile once the ranks'
    digests agree."""
    from repro_torch.core import profiles, tuner
    from repro_torch.core._axis import GroupAxis
    axis = GroupAxis("cpu")
    rep = tuner.tune(["allreduce"], GROUP_TUNE_SIZES, axis_size=axis.size,
                     backend=tuner.MeasuredBackend(axis=axis))
    base, _ = profiles.publish(rep.profiles, out_dir, axis)
    return {"digest": profiles.stores_digest(base, {}),
            "summary": rep.summary()}


def decode_host_profile(torch, cfg, axis, params, prompts, tag: str,
                        label: str) -> dict:
    """One decode step of ``cfg`` on ``axis`` at the prompts' end: its
    host ms (timed alone), then under ``torch.profiler`` its device busy
    ms, the host ms inside the process group's calls (ops named
    ``c10d::``, each call's inclusive time) and the top host ops by self
    time, so a process axis' extra host time per token is attributed."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.dist.axes import bind
    from repro_torch.launch import serve as sv
    from repro_torch.models import lm
    with bind(model=axis):
        caches = lm.init_caches(cfg, prompts.shape[0], SERVE_SLOTS)
    pf, dc = sv.build_prefill(cfg, axis), sv.build_decode(cfg, axis)
    filled = pf(params, {"tokens": prompts}, caches)[1]
    tok = prompts[:, :1]

    def step():
        dc(params, tok, filled, prompts.shape[1])
        torch.cuda.synchronize()
    step()
    t0 = time.perf_counter()
    step()
    host = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
    rows = prof.key_averages()
    on_dev = [e for e in rows
              if str(getattr(e, "device_type", "")).endswith("CUDA")]
    on_host = [e for e in rows if e not in on_dev]
    busy = sum(e.self_device_time_total for e in on_dev) / 1e3
    pg = {e.key: (e.count, e.cpu_time_total / 1e3) for e in on_host
          if e.key.startswith("c10d::")}
    pg_ms = sum(ms for _, ms in pg.values())
    log(f"[{tag}] {label} decode step: host {host:.4f} ms, device busy "
        f"{busy:.4f} ms; process-group calls {sum(n for n, _ in pg.values())}"
        f" taking {pg_ms:.4f} ms of host time under the profiler "
        f"{json.dumps({k: [n, round(ms, 4)] for k, (n, ms) in pg.items()})}")
    for e in sorted(on_host, key=lambda e: -e.self_cpu_time_total)[:8]:
        log(f"[{tag}]   host self {e.self_cpu_time_total / 1e3:9.4f} ms "
            f"x{e.count:5d} {e.key[:80]}")
    return {"host_ms": host, "busy_ms": busy, "pg_ms": pg_ms,
            "pg": {k: list(v) for k, v in pg.items()}}


def group_serve(torch, dev, wrappers: dict, card: str, tag: str) -> dict:
    """(a) of phase 20: ``GROUP_ARCH`` at full width and depth, TP 1, phase
    10's requests (flash), served on a world-1 ``GroupAxis`` over
    ``GROUP_BACKEND`` and on ``StackedAxis(1)``, the same weights.  The
    kernels' counts are zeroed just before the group serve and read just
    after it: flash must launch, 1 + ``SERVE_DECODE`` times a layer, and
    the axis' collectives must have gone through the backend.  Its logits
    are held to the stacked serve's: bit-equal, or within
    ``SERVE_RTOL``.  Both serves then run again in the other order
    (group, stacked, stacked, group), and ``decode_host_profile`` times
    one decode step of each axis."""
    import tempfile

    import numpy as np
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core._axis import GroupAxis, StackedAxis
    from repro_torch.launch import serve as sv
    from repro_torch.launch.mesh import init_world
    from repro_torch.models import lm
    from repro_torch.models.params import init_tree

    fa = wrappers["flash_attention"]
    cfg = dataclasses.replace(get_config(GROUP_ARCH), attn_impl="flash")
    stacked = StackedAxis(1, dev)
    params = init_tree(lm.model_specs(cfg, 1),
                       torch.Generator(device=dev).manual_seed(SEED), stacked)
    rng = np.random.default_rng(SEED)
    prompts = torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT)), device=dev)
    n_tokens = 1 + SERVE_DECODE
    with tempfile.TemporaryDirectory() as tmp:
        init_world(GROUP_BACKEND, rank=0, world=1,
                   init_method=(pathlib.Path(tmp) / "store").as_uri())
        try:
            group = GroupAxis(dev)
            log(f"[{tag}a] {cfg.name}: {cfg.n_layers} layers, d_model "
                f"{cfg.d_model}, TP 1 on {group!r} and on StackedAxis(1); "
                f"{SERVE_BATCH} requests of {SERVE_PROMPT} tokens, "
                f"{n_tokens} tokens, {SERVE_SLOTS} slots ({card})")
            for axis in (group, stacked):                     # warm-up
                sv.serve(cfg, axis, params, prompts, SERVE_SLOTS, 2)
            serves = {}
            zero_counts(wrappers)         # the group serve path starts here
            c0, p0, d0 = counts(wrappers), dict(fa.launches_by_path), \
                dh_counts(fa)
            calls0 = dict(group.calls)
            torch.cuda.reset_peak_memory_stats(dev)
            res = sv.serve(cfg, group, params, prompts, SERVE_SLOTS, n_tokens)
            torch.cuda.synchronize()
            c1 = counts(wrappers)
            launches = {k: c1[k] - c0[k] for k in c1}
            require_launched(f"{tag}a group serve",
                             {"flash_attention": c0["flash_attention"]},
                             {"flash_attention": c1["flash_attention"]})
            paths = {k: v for k, v in path_delta(fa, p0).items() if v}
            calls = {k: v - calls0.get(k, 0) for k, v in group.calls.items()}
            serves["group"] = (res, torch.cuda.max_memory_allocated(dev))
            log(f"[{tag}a] flash launches by path {json.dumps(paths)}; "
                f"{GROUP_BACKEND} collectives of the axis {json.dumps(calls)}")
            if launches["flash_attention"] != cfg.n_layers * n_tokens:
                raise RuntimeError(f"flash launched "
                                   f"{launches['flash_attention']} times, not "
                                   f"{cfg.n_layers * n_tokens}")
            if sum(v for k, v in calls.items() if k != "barrier") <= 0:
                raise RuntimeError(f"no {GROUP_BACKEND} collective ran")
            d256, d64 = dh_delta(fa, d0, 256), dh_delta(fa, d0, 64)
            torch.cuda.reset_peak_memory_stats(dev)
            serves["stacked"] = (sv.serve(cfg, stacked, params, prompts,
                                          SERVE_SLOTS, n_tokens),
                                 torch.cuda.max_memory_allocated(dev))
            # the timed serves ran group then stacked; run them again in
            # the other order, so an order effect shows apart from the axis
            again = {label: sv.serve(cfg, axis, params, prompts,
                                     SERVE_SLOTS, n_tokens)
                     for label, axis in (("stacked", stacked),
                                         ("group", group))}
            steps = {label: decode_host_profile(torch, cfg, axis, params,
                                                prompts, f"{tag}a", label)
                     for label, axis in (("group", group),
                                         ("stacked", stacked))}
        finally:
            dist.destroy_process_group()
    (got, _), (want, _) = serves["group"], serves["stacked"]
    equal = all(torch.equal(a, b) for a, b in zip(want.logits, got.logits))
    check = sv.check_serves(want, got, SERVE_RTOL)
    log(f"[{tag}a] group vs stacked logits: "
        + ("bit-equal" if equal else
           f"not bit-equal, max-norm relative {check['max_rel_err']:.4e} "
           f"(tolerance {SERVE_RTOL}: a one-rank all-reduce or gather "
           "should be a copy; the kernels are the same)"))
    out = {"launches": launches, "paths": paths, "d256_paths": d256,
           "d64_paths": d64, "calls": calls, "bit_equal": equal,
           "check": check, "serves": {}, "decode_steps": steps}
    log(f"[{tag}a] launches of the group serve: {json.dumps(launches)}")
    for label, (r, peak) in serves.items():
        log(f"[{tag}a] {label} serve: prefill {r.prefill_s * 1e3:.2f} ms, "
            f"decode {r.decode_s_per_token * 1e3:.3f} ms/token, peak "
            f"{peak / 1e9:.3f} GB ({card})")
        out["serves"][label] = {"prefill_ms": r.prefill_s * 1e3,
                                "decode_ms_per_token":
                                    r.decode_s_per_token * 1e3,
                                "peak_bytes": peak}
    order = [("group", serves["group"][0]), ("stacked", serves["stacked"][0]),
             ("stacked", again["stacked"]), ("group", again["group"])]
    log(f"[{tag}a] serves in the order group, stacked, stacked, group: "
        f"prefill {[round(r.prefill_s * 1e3, 2) for _, r in order]} ms, "
        "decode "
        f"{[round(r.decode_s_per_token * 1e3, 3) for _, r in order]} ms a "
        f"token ({card})")
    out["abba"] = [{"axis": label, "prefill_ms": r.prefill_s * 1e3,
                    "decode_ms_per_token": r.decode_s_per_token * 1e3}
                   for label, r in order]
    del params
    torch.cuda.empty_cache()
    return out


def group_cpu(out_dir: pathlib.Path, tag: str) -> dict:
    """(b) of phase 20: gloo at ``GROUP_WORLD`` ranks on the host's CPU,
    each world in processes under a hard timeout: the group selfcheck
    (flat and (2, W/2)) with no failure and the stacked run's totals, then
    a measured tune of ``allreduce`` at ``GROUP_TUNE_SIZES``
    (``group_tune_rank``), every rank the same picks and one profile
    written.  Its times are the host
    CPU's, not the card's."""
    from repro_torch.core import collectives as C, selfcheck
    from repro_torch.launch.mesh import spawn

    host = f"gloo, host CPU ({cpu_model()})"
    t0 = time.perf_counter()
    reps = spawn(selfcheck.run_group, GROUP_WORLD, backend="gloo",
                 args=("cpu",), timeout_s=GROUP_TIMEOUT_S)[0]
    sc_s = time.perf_counter() - t0
    held = C.demotions()
    try:
        want = [selfcheck.run(GROUP_WORLD, "cpu"),
                selfcheck.run_mesh((2, GROUP_WORLD // 2), "cpu")]
    finally:
        C.clear_demotions()
        for (op, nm), why in held.items():
            C.demote(op, nm, why)
    for got, ref in zip(reps, want):
        log(f"[{tag}b] selfcheck --world {GROUP_WORLD} {got['devices']}: "
            f"{got['total']} checks (stacked {ref['total']}), failures "
            f"{got['failures']}, demoted {got['demoted']}, not applicable "
            f"{sorted(got['not_applicable'])} ({host}, {sc_s:.1f} s)")
        if got["failures"] or got["total"] != ref["total"]:
            raise RuntimeError(f"group selfcheck {got['devices']}: "
                               f"{got['failures']}, {got['total']} checks "
                               f"against {ref['total']}")
    prof = out_dir / "group_profiles"
    t0 = time.perf_counter()
    tuned = spawn(group_tune_rank, GROUP_WORLD, backend="gloo",
                  args=(str(prof),), timeout_s=GROUP_TIMEOUT_S)
    tune_s = time.perf_counter() - t0
    log(f"[{tag}b] measured tune of allreduce at world {GROUP_WORLD}, its "
        f"times on {host}:")
    text = tuned[0]["summary"]
    for ln in text.strip().splitlines():
        log(f"[{tag}b] {ln}")
    files = sorted(f.name for f in prof.glob("*.pgtune"))
    digests = {t["digest"] for t in tuned}
    log(f"[{tag}b] tuned in {tune_s:.1f} s; digests of the ranks' picks "
        f"{sorted(d[:16] for d in digests)}; profiles written: {files} "
        f"({host})")
    if len(digests) != 1 or files != [f"allreduce_p{GROUP_WORLD}.pgtune"]:
        raise RuntimeError(f"group tune: digests {digests}, profiles "
                           f"{files}")
    return {"selfcheck": reps, "selfcheck_s": sc_s, "tune_s": tune_s,
            "profiles": files, "host": host,
            "tune_lines": text.strip().splitlines()}


def group_phase(torch, dev, out_dir: pathlib.Path, wrappers: dict,
                card: str, tag: str = "20") -> dict:
    """The process-group axis: (a) ``group_serve``, (b) ``group_cpu``."""
    t_phase = time.perf_counter()
    out = group_serve(torch, dev, wrappers, card, tag)
    out["cpu"] = group_cpu(out_dir, tag)
    log(f"[{tag}] process-group phase in "
        f"{time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# the fleet loop and fault tolerance (phase 21)
# ---------------------------------------------------------------------------

# llama3.2-3b at full width and depth, TP P stacked, as in phase 10: four
# servers share one set of weights, each with its own (batch, prompt) mix,
# so each records other cells; 1 + FLEET_DECODE greedy tokens a request
FLEET_ARCH = "llama3.2-3b"
FLEET_MIXES = {"A": (4, 1024), "B": (8, 512), "C": (2, 1024),
               "D": (1, 1536)}
FLEET_LIVE = "B"            # the mix the live server serves
FLEET_DECODE, FLEET_SLOTS = 16, SERVE_SLOTS
FLEET_PLAN = 64             # the plan's capacity
FLEET_EXPLORE_OBS = 4       # latency samples of each explored pair
FLEET_TRIP = 1.2            # EpochTripwire threshold


def fleet_phase(torch, dev, out_dir: pathlib.Path, wrappers: dict,
                card: str, topo, tag: str = "21") -> dict:
    """The fleet loop on the card: (a) four servers record shards, the
    merged trace is tuned with the measured backend into epoch 1, and a
    live server built once with ``tuned(store_ref=..., plan=...)`` serves
    epoch 0, epoch 1, an ``explore(eps=1)`` vector and epoch 2 (tuned from
    the explored pairs' card timings, round the ``#@lat`` lines); (b) the
    faults: a torn and a corrupted shard quarantined, a skewed epoch 3
    refused, a bad epoch 4 against the ``EpochTripwire``, the coordinator
    on a fake clock with a killed server; (c) the restart example.  The
    kernels' counts are zeroed just before (a) and read around every step
    of the loop; every serve must launch flash once per layer and token,
    the prefill on ``wgmma`` and the decode on ``split_kv``."""
    import statistics
    import warnings

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core import api, profiles, trace, tuner
    from repro_torch.core._axis import StackedAxis
    from repro_torch.ft import ChaosMonkey, FleetCoordinator
    from repro_torch.launch import serve as sv
    from repro_torch.models import lm
    from repro_torch.models.params import init_tree

    t_phase = time.perf_counter()
    fa = wrappers["flash_attention"]
    cfg = dataclasses.replace(get_config(FLEET_ARCH), attn_impl="flash")
    axis = StackedAxis(P, dev)
    params = init_tree(lm.model_specs(cfg, P),
                       torch.Generator(device=dev).manual_seed(SEED), axis)
    rng = np.random.default_rng(SEED)
    prompts = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                                  device=dev)
               for k, (b, s) in FLEET_MIXES.items()}
    n_tokens = 1 + FLEET_DECODE
    per_serve = per_serve_launches(lm, cfg, n_tokens)["flash_attention"]
    n_blk = per_serve // n_tokens
    want_paths = dict.fromkeys(fa.launches_by_path, 0)
    want_paths.update(wgmma=n_blk, split_kv=n_blk * (n_tokens - 1))
    root = out_dir / "fleet"
    shutil.rmtree(root, ignore_errors=True)
    shards, live = root / "shards", root / "live"
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"TP {P} stacked; servers "
        f"{ {k: f'{b} x {s}' for k, (b, s) in FLEET_MIXES.items()} }, "
        f"{n_tokens} tokens, {FLEET_SLOTS} slots ({card})")
    sv.serve(cfg, axis, params, prompts[FLEET_LIVE], FLEET_SLOTS, 2)
    steps_log: dict = {}
    zero_counts(wrappers)              # the fleet path starts here

    def step(label: str, fn, serves: bool = False):
        """Run one step of the loop; log (and keep) its kernel launches;
        a serve must launch flash as ``per_serve_launches`` says."""
        c0, p0 = counts(wrappers), dict(fa.launches_by_path)
        out = fn()
        c1 = counts(wrappers)
        got = {k: c1[k] - c0[k] for k in c1}
        paths = path_delta(fa, p0)
        steps_log[label] = got
        log(f"[{tag} {label}] kernel launches: {json.dumps(got)}; flash "
            f"by path {json.dumps(paths)}")
        if serves and (got["flash_attention"] != per_serve
                       or paths != want_paths):
            raise RuntimeError(f"{label}: flash launched "
                               f"{got['flash_attention']} times on "
                               f"{paths}, not {per_serve} on {want_paths}")
        return out

    def serve(mix: str, **kw):
        return sv.serve(cfg, axis, params, prompts[mix], FLEET_SLOTS,
                        n_tokens, **kw)

    # -- (a) 1. the fleet records: one shard a server, epoch 1 ------------
    weights = {}
    for i, mix in enumerate(FLEET_MIXES):
        rec = trace.ShardRecorder(f"srv{mix}", seed=i)
        step(f"record srv{mix}", lambda: serve(mix, record=rec), True)
        weights[mix] = rec.total()
        path = rec.flush(shards, epoch=1)
        log(f"[{tag}] {path.name}: {trace.shard_meta(path)}")
    merged = trace.Trace.merge_shards(shards)
    log(f"[{tag}] {merged.summary()}")
    if merged.quarantined or merged.total() != sum(weights.values()):
        raise RuntimeError(f"merge kept {merged.total()} of "
                           f"{sum(weights.values())} dispatches")
    # -- 2. tune the merged trace on the card: epoch 1 --------------------
    mb = tuner.MeasuredBackend(P, dev)
    t0 = time.perf_counter()
    rep1 = step("tune epoch 1",
                lambda: tuner.tune_trace(merged.trace, mb))
    log(f"[{tag}] tune_trace (measured) in {time.perf_counter() - t0:.1f} s")
    lat1: dict = {}
    for m in rep1.measurements:
        lat1[(m.cell, m.impl)] = m.latency
        log(f"[{tag}] measured {m.op} {m.nbytes}B {m.impl}: "
            f"{m.latency * 1e3:.4f} ms")
    for ln in rep1.summary().splitlines():
        log(f"[{tag}] epoch 1: {ln}")

    # -- 3. the live server: steps built once, four passes ----------------
    ref = profiles.resolve_stores(live, watch=True)
    if ref.epoch != -1:
        raise RuntimeError(f"an empty live directory read as epoch "
                           f"{ref.epoch}")
    plan = api.Plan(FLEET_PLAN)
    built = {"n": 0}
    real = (sv.build_prefill, sv.build_decode)

    def counted(fn):
        def build(*a, **k):
            built["n"] += 1
            return fn(*a, **k)
        return build
    sv.build_prefill, sv.build_decode = map(counted, real)
    try:
        steps = (sv.build_prefill(cfg, axis, plan=plan),
                 sv.build_decode(cfg, axis, plan=plan))
    finally:
        sv.build_prefill, sv.build_decode = real
    live_rec = trace.ShardRecorder("live", seed=len(FLEET_MIXES))
    passes: dict = {}

    def live_pass(label: str, vec):
        sv.build_prefill, sv.build_decode = map(counted, real)
        try:
            res = step(label, lambda: serve(
                FLEET_LIVE, store_ref=ref, plan=plan, plan_vec=vec,
                steps=steps, record=live_rec, time_steps=True), True)
        finally:
            sv.build_prefill, sv.build_decode = real
        passes[label] = res
        log(f"[{tag} {label}] epoch {ref.epoch}, vector "
            f"{vec[:len(plan)].tolist()}: prefill {res.prefill_s * 1e3:.2f} "
            f"ms, decode {res.decode_s_per_token * 1e3:.3f} ms/token, "
            f"median step {statistics.median(res.step_s) * 1e3:.3f} ms")
        return res

    vec0 = plan.vector(ref)
    res0 = live_pass("epoch 0", vec0)
    sites = plan.sites()
    for cell, ph, impls in sites:
        log(f"[{tag}] plan site {ph} {cell.op} {cell.nbytes}B: {impls}")
    if not sites:
        raise RuntimeError("no dispatch site registered on the plan")
    rep1.save(live, epoch=1, source_digest=trace.shard_digest(shards))
    if not ref.poll() or ref.epoch != 1:
        raise RuntimeError(f"poll did not adopt epoch 1 (epoch {ref.epoch})")
    vec1 = plan.vector(ref)
    picks = {(c.op, c.nbytes, ph): ref.lookup(c, ph) for c, ph, _ in sites}
    chose = any(n not in (None, "default") for n in picks.values())
    changed = bool((vec1 != vec0).any())
    log(f"[{tag}] epoch 1 picks at the plan sites: {picks}; vector changed: "
        f"{changed}")
    if changed != chose:
        raise RuntimeError(f"epoch 1: the vector changed ({changed}) where "
                           f"the stores chose a mock-up ({chose}) or not")
    res1 = live_pass("epoch 1", vec1)
    profiles.write_manifest(live, 0)           # a delayed epoch-0 writer
    with warnings.catch_warnings(record=True) as wlog:
        warnings.simplefilter("always")
        stale = ref.poll()
    if stale or ref.epoch != 1 or not any("stale" in str(w.message)
                                          for w in wlog):
        raise RuntimeError("a stale epoch-0 manifest was not refused with "
                           "a warning")
    log(f"[{tag}] stale epoch-0 manifest refused: {wlog[-1].message}")
    vec_x, explored = plan.explore(ref, eps=1.0,
                                   rng=np.random.default_rng(SEED))
    if not explored or not (vec_x != vec1).any():
        raise RuntimeError("explore(eps=1) flipped no site")
    res_x = live_pass("explore", vec_x)
    # the explored pairs timed on the card (replays of each cell), round
    # the shard's #@lat lines into epoch 2's tune
    for (cell, ph), impl in explored.items():
        for _ in range(FLEET_EXPLORE_OBS):
            live_rec.observe(cell, impl, mb.latency(cell, impl))
    live_rec.flush(shards, epoch=2)
    observed = trace.load_shard_latencies(shards)
    log(f"[{tag}] fed back: " + "; ".join(
        f"{c.op} {c.nbytes}B {im}: "
        f"{[round(t * 1e3, 4) for t in v]} ms"
        for (c, im), v in observed.items()))
    if set(observed) != {(c, im) for (c, _), im in explored.items()}:
        raise RuntimeError("the explored pairs did not round-trip through "
                           "the shards")
    fb = tuner.FeedbackBackend(mb, observed)
    rep2 = step("tune epoch 2", lambda: tuner.tune_trace(
        trace.Trace.merge_shards(shards).trace, fb))
    for ln in rep2.summary().splitlines():
        log(f"[{tag}] epoch 2: {ln}")
    rep2.save(live, epoch=2, source_digest=trace.shard_digest(shards))
    if not ref.poll() or ref.epoch != 2:
        raise RuntimeError(f"poll did not adopt epoch 2 (epoch {ref.epoch})")
    vec2 = plan.vector(ref)
    res2 = live_pass("epoch 2", vec2)
    if built["n"] != 2:
        raise RuntimeError(f"the steps were built {built['n']} times, not "
                           "once each")
    checks = {}
    for label in ("epoch 1", "explore", "epoch 2"):
        checks[label] = sv.check_serves(res0, passes[label], SERVE_RTOL)
        log(f"[{tag}] {label} vs epoch 0: {json.dumps(checks[label])}")

    # -- (b) faults: chaos on a copy of the shards -------------------------
    chaos = root / "chaos"
    shutil.copytree(shards, chaos)
    monkey = ChaosMonkey(seed=SEED)
    torn = monkey.tear_shard(chaos / "shard-srvA-e000001.jsonl")
    bad = monkey.corrupt_line(chaos / "shard-live-e000002.jsonl")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        report = trace.Trace.merge_shards(chaos)
        skip = [n.path for n in report.quarantined]
        kept = trace.load_shard_latencies(chaos, skip=skip)
        every_lat = trace.load_shard_latencies(chaos)
    log(f"[{tag}] chaos: {[str(e) for e in monkey.events]}")
    log(f"[{tag}] {report.summary()}")
    if {n.path.name for n in report.quarantined} != {torn.name, bad.name} \
            or kept or not every_lat:
        raise RuntimeError("chaos: the torn and the corrupted shard were "
                           "not quarantined exactly, or their samples kept")
    # the bad generation: every plan site to the admissible impl the
    # measured tune found slowest for its cell
    slow = {}
    for cell, ph, impls in sites:
        timed = {im: lat1[(cell, im)] for im in impls if (cell, im) in lat1}
        slow[(cell, ph)] = max(timed, key=timed.get)
    log(f"[{tag}] bad epoch: " + "; ".join(
        f"{ph} {c.nbytes}B -> {im} ({lat1[(c, im)] * 1e3:.4f} ms)"
        for (c, ph), im in slow.items()))
    bad_phases: dict = {}
    for (cell, ph), im in sorted(slow.items()):
        bad_phases.setdefault(ph, []).append(
            profiles.Range(cell.nbytes, cell.nbytes, im))
    bad_rep = tuner.TraceTuneReport(
        phase_profiles={ph: profiles.ProfileStore([profiles.Profile(
            "allreduce", P, rs)]) for ph, rs in bad_phases.items()},
        measurements=[], est_default_s={}, est_tuned_s={})
    bad_rep.save(live, epoch=3, source_digest="bad")
    monkey.skew_profiles(live)
    with warnings.catch_warnings(record=True) as wlog:
        warnings.simplefilter("always")
        skewed = ref.poll()
    if skewed or ref.epoch != 2 or not any("skew" in str(w.message)
                                           for w in wlog):
        raise RuntimeError("a skewed epoch 3 was not refused")
    log(f"[{tag}] skewed epoch 3 refused: {wlog[-1].message}")
    # the tripwire over epoch 2's decode steps, then epoch 4's
    tw = api.EpochTripwire(ref, threshold=FLEET_TRIP)
    costs = {2: list(res2.step_s)}
    for c in costs[2]:
        if tw.observe(c):
            raise RuntimeError("the tripwire fired on epoch 2 itself")
    bad_rep.save(live, epoch=4, source_digest="bad")
    if not ref.poll() or ref.epoch != 4:
        raise RuntimeError(f"poll did not adopt epoch 4 (epoch {ref.epoch})")
    vec4 = plan.vector(ref)
    res4 = live_pass("epoch 4", vec4)
    costs[4] = list(res4.step_s)
    base = statistics.median(costs[2][-tw.window:])
    expect, fired_at = None, None
    for i in range(len(costs[4])):
        win = costs[4][max(0, i + 1 - tw.window):i + 1]
        if len(win) >= tw.min_samples and \
                statistics.median(win) > FLEET_TRIP * base:
            expect = i
            break
    with warnings.catch_warnings(record=True) as wlog:
        warnings.simplefilter("always")
        for i, c in enumerate(costs[4]):
            if tw.observe(c):
                fired_at = i
                break
    log(f"[{tag}] tripwire: epoch 2 median {base * 1e3:.3f} ms a step, "
        f"epoch 4 steps {[round(c * 1e3, 3) for c in costs[4]]} ms; "
        f"expected to fire at {expect}, fired at {fired_at} "
        f"({'fired' if fired_at is not None else 'did not fire'})")
    if fired_at != expect:
        raise RuntimeError(f"tripwire fired at {fired_at}, the medians say "
                           f"{expect}")
    trip = {"baseline_ms": base * 1e3, "fired_at": fired_at,
            "epoch4_median_ms": statistics.median(costs[4]) * 1e3}
    if fired_at is not None:
        if ref.epoch != 2 or tw.fired != [(4, 2)]:
            raise RuntimeError(f"rollback left epoch {ref.epoch}")
        vec_r = plan.vector(ref)
        if not np.array_equal(vec_r, vec2):
            raise RuntimeError("the rolled-back vector is not epoch 2's")
        res_r = live_pass("rolled back", vec_r)
        trip["rolled_back"] = sv.check_serves(res2, res_r, SERVE_RTOL)
        log(f"[{tag}] rolled back vs epoch 2: "
            f"{json.dumps(trip['rolled_back'])}")
        with warnings.catch_warnings(record=True) as wlog:
            warnings.simplefilter("always")
            again = ref.poll()
        if again or ref.epoch != 2:
            raise RuntimeError("the poisoned epoch 4 was adopted again")
        log(f"[{tag}] epoch 4 not adopted again (poisoned"
            f"{': ' + str(wlog[-1].message) if wlog else ', manifest unchanged'})")
    if built["n"] != 2:
        raise RuntimeError(f"the steps were built {built['n']} times")
    # the coordinator on a fake clock; a killed server goes dead
    now = [0.0]
    co = FleetCoordinator(shards, ref, backend=tuner.CostModelBackend(topo),
                          heartbeat_timeout=30.0, clock=lambda: now[0])
    st0 = co.scan()
    log(f"[{tag}] coordinator: {st0.summary()}")
    monkey.kill_server("srvD", at_epoch=3)
    now[0] += 20.0
    for server in [f"srv{m}" for m in FLEET_MIXES] + ["live"]:
        if monkey.alive(server, 3):
            trace.ShardRecorder(server).flush(shards, epoch=3)
    now[0] += 20.0
    st1 = co.scan()
    log(f"[{tag}] coordinator after srvD was killed: {st1.summary()}")
    if st1.dead != ["srvD"] or "srvD" in st1.alive:
        raise RuntimeError(f"coordinator: dead {st1.dead}, not ['srvD']")

    # -- (c) the restart example on the card -------------------------------
    restart = _example("torch_elastic_restart")
    out = io.StringIO()
    argv = ["--ckpt-dir", str(root / "ckpt")]
    if dev.type != "cuda":
        argv += ["--device", str(dev)]
    t0 = time.perf_counter()

    def run_restart():
        with contextlib.redirect_stdout(out):
            return restart.main(argv)
    rc = step("restart", run_restart)
    lines = out.getvalue().strip().splitlines()
    for ln in lines[-3:]:
        log(f"[{tag}c] {ln}")
    if rc != 0 or "restarts: 2" not in out.getvalue():
        raise RuntimeError(f"the restart example failed (rc {rc})")
    log(f"[{tag}c] restart example in {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(root / "ckpt", ignore_errors=True)

    launches = {k: sum(s[k] for s in steps_log.values())
                for k in wrappers}
    log(f"[serve path fleet] kernel launches: {json.dumps(launches)}")
    paths = {"paths": dict(fa.launches_by_path),     # zeroed before (a)
             "d256_paths": dh_delta(fa, {}, 256),
             "d64_paths": dh_delta(fa, {}, 64)}
    seconds = time.perf_counter() - t_phase
    log(f"[{tag}] fleet phase in {seconds:.1f} s")
    return {"launches": launches, "steps": steps_log,
            "plan_sites": len(sites), "explored": len(explored),
            "vector_changed_at_1": changed, "epoch1_picks": {
                f"{k[2]} {k[0]} {k[1]}": v for k, v in picks.items()},
            "decode_ms_per_token": {
                k: r.decode_s_per_token * 1e3 for k, r in passes.items()},
            "prefill_ms": {k: r.prefill_s * 1e3 for k, r in passes.items()},
            "checks": checks, "tripwire": trip, "chaos": {
                "quarantined": [n.path.name for n in report.quarantined]},
            "coordinator": [st0.summary(), st1.summary()],
            "seconds": seconds, **paths}


# ---------------------------------------------------------------------------
# analysis at the graph layer (phase 22)
# ---------------------------------------------------------------------------

DRYRUN_ARCH = "llama3.2-3b"
#: the dry run's cells in processes of their own, at once (the card's host
#: has 8 cores; the two train cells take the longest)
DRYRUN_JOBS = 6
DRYRUN_TIMEOUT_S = 600.0
#: more dry-run flags (a CPU rehearsal passes ``--smoke``)
DRYRUN_FLAGS: tuple = ()
#: train_4k's micro-batches in the dry run (the cell's own is 8): its
#: trace unrolls them, so it is cut in depth as a model's layers are
DRYRUN_MICRO = 2
#: the rewrite's movement mock-ups (a reduction mock-up reorders the sum
#: and is legitimately not bit-exact)
REWRITE_FORCE = {"allgather": "allgather_as_ring",
                 "alltoall": "alltoall_as_ppermute"}
REWRITE_CHANGED = [["allgather", "allgather_as_ring"],
                   ["alltoall", "alltoall_as_ppermute"]]


def rewrite_rank() -> dict:
    """One rank of (c): the JAX package's ``REWRITE_SCRIPT`` program
    (``tests/test_hlo_interpose.py``: all-gather, matmul, reduce-scatter,
    all-reduce, all-to-all) on a ``GroupAxis`` of gloo processes,
    rewritten with the movement mock-ups forced (``interpose.rewrite``)."""
    import torch
    from repro_torch.analysis.interpose import rewrite
    from repro_torch.core import api
    from repro_torch.core._axis import GroupAxis

    axis = GroupAxis("cpu")

    def body(x, w):
        g = api.allgather(x, axis)
        s = api.reducescatter(g @ w, axis)
        return api.alltoall(api.allreduce(s * 2.0, axis), axis)
    x = torch.arange(16 * 16, dtype=torch.float32).reshape(16, 16) / 7.0
    w = torch.ones((16, 16), dtype=torch.float32) * 0.5
    t0 = time.perf_counter()
    res = rewrite(body, x[4 * axis.rank:4 * axis.rank + 4][None], w,
                  force=dict(REWRITE_FORCE))
    return {"bitexact": res.bitexact, "diffs": res.diffs,
            "changed": sorted([r.cell.op, r.impl] for r in res.changed),
            "matched": sorted({r.cell.op for r, _ in res.matched}),
            "unmatched": [r.cell.op for r in res.unmatched_records],
            "extra": [s.name for s in res.extra_sites],
            "seconds": time.perf_counter() - t0}


def step_roofline(torch, dev, served: dict, card: str, tag: str) -> dict:
    """(b): phase 10's llama3.2-3b TP-P stacked prefill (``SERVE_BATCH`` x
    ``SERVE_PROMPT``) and one decode step captured on fake tensors on the
    card's device, ``ref`` attention (the kernels cannot be traced), and
    their bounds on the H100's data-sheet rates against phase 10's
    measured times and peak memory."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.analysis.graph import capture, program_costs
    from repro_torch.analysis.roofline import (H100_SXM, model_flops,
                                               roofline_terms)
    from repro_torch.configs import get_config
    from repro_torch.core._axis import StackedAxis
    from repro_torch.dist.axes import bind
    from repro_torch.launch import dryrun, serve as sv
    from repro_torch.launch.shapes import ShapeCell
    from repro_torch.models import lm
    from repro_torch.models.params import torch_dtype, tree_map_specs

    cfg = get_config(DRYRUN_ARCH)
    if cfg.attn_impl != "ref":
        raise RuntimeError(f"{cfg.name}: attn_impl {cfg.attn_impl}")
    axis = StackedAxis(P, dev)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    with mode:
        params = tree_map_specs(lambda s: torch.empty(
            (P,) + s.local_shape({"model": P}), dtype=torch_dtype(s.dtype),
            device=dev), lm.model_specs(cfg, P))
        tokens = torch.empty((SERVE_BATCH, SERVE_PROMPT), dtype=torch.int64,
                             device=dev)
        tok = torch.empty((SERVE_BATCH, 1), dtype=torch.int64, device=dev)
        with bind(model=axis):
            caches = lm.init_caches(cfg, SERVE_BATCH, SERVE_SLOTS)
    measured = served["serves"]["default"]
    steps = {
        "prefill": (sv.build_prefill(cfg, axis),
                    (params, {"tokens": tokens}, caches),
                    ShapeCell("phase10_prefill", SERVE_PROMPT, SERVE_BATCH,
                              "prefill"), measured["prefill_ms"]),
        "decode": (sv.build_decode(cfg, axis),
                   (params, tok, dryrun.with_len(caches, SERVE_PROMPT),
                    SERVE_PROMPT),
                   ShapeCell("phase10_decode", SERVE_SLOTS, SERVE_BATCH,
                             "decode"), measured["decode_ms_per_token"])}
    peak = int(served["peak_bytes"])
    out = {}
    for name, (fn, args, cell, ms) in steps.items():
        t0 = time.perf_counter()
        gm = capture(fn, *args)
        pc = program_costs(gm)
        cap_s = time.perf_counter() - t0
        rl = roofline_terms(DRYRUN_ARCH, name, f"TP {P} stacked", cost={},
                            coll={}, cfg=cfg, cell=cell, n_devices=1,
                            chip=H100_SXM, flops_override=pc["dot_flops"],
                            bytes_override=pc["bytes"], dtype=cfg.dtype,
                            stacked=True)
        mf = model_flops(cfg, cell, 1)
        t_model = mf / H100_SXM.flops(cfg.dtype) * 1e3
        t_args = pc["argument_bytes"] / H100_SXM.hbm_bytes_per_s * 1e3
        bound = rl.step_time_bound * 1e3
        row = {"program_costs": {k: pc[k] for k in (
            "dot_flops", "bytes", "nodes", "argument_bytes", "output_bytes",
            "peak_live_bytes")}, "roofline": rl.row(),
            "bound_ms": bound, "model_flops": mf,
            "model_flops_ms": t_model, "argument_bytes_ms": t_args,
            "measured_ms": ms, "share_graph": bound / ms,
            "share_model_flops": t_model / ms,
            "share_argument_bytes": t_args / ms, "capture_s": cap_s}
        out[name] = row
        log(f"[{tag}b] {DRYRUN_ARCH} {name} (TP {P} stacked, "
            f"{SERVE_BATCH} x {SERVE_PROMPT if name == 'prefill' else 1} "
            f"tokens, ref attention, fake tensors on {dev}): "
            f"{pc['nodes']} nodes captured in {cap_s:.1f} s; dot flops "
            f"{pc['dot_flops']:.4e}, eager bytes {pc['bytes']:.4e}, "
            f"argument bytes {pc['argument_bytes']:.4e}, peak live "
            f"{pc['peak_live_bytes']:.4e}")
        log(f"[{tag}b] {name} bound on the data sheet ({H100_SXM.source}): "
            f"graph {bound:.4f} ms ({rl.bottleneck}: compute "
            f"{rl.t_compute * 1e3:.4f} ms, memory {rl.t_memory * 1e3:.4f} "
            f"ms), model flops {mf:.4e} -> {t_model:.4f} ms, arguments "
            f"read once {t_args:.4f} ms; phase 10 measured {ms:.3f} ms "
            f"({card}): share of the graph bound {bound / ms:.4f}, by "
            f"model flops {t_model / ms:.4f}, by argument bytes "
            f"{t_args / ms:.4f}")
    est = out["prefill"]["program_costs"]
    log(f"[{tag}b] the prefill graph's memory estimate: arguments "
        f"{est['argument_bytes'] / 1e9:.3f} GB + peak live "
        f"{est['peak_live_bytes'] / 1e9:.3f} GB = "
        f"{(est['argument_bytes'] + est['peak_live_bytes']) / 1e9:.3f} GB "
        f"(eager, ref attention, no frees but last uses) beside phase 10's "
        f"torch.cuda.max_memory_allocated {peak / 1e9:.3f} GB (flash "
        "attention, tune_trace's replays included)")
    out["phase10_peak_bytes"] = peak
    return out


def analysis_phase(torch, dev, out_dir: pathlib.Path, wrappers: dict,
                   card: str, topo, served: dict, tag: str = "22") -> dict:
    """Analysis at the graph layer: (a) the dry run of ``DRYRUN_ARCH`` at
    full width and depth on the 16 x 16 and 2 x 16 x 16 fake worlds, every
    shape (train_4k in ``DRYRUN_MICRO`` micro-batches), priced on phase
    5's fitted ``Topo``; (b) ``step_roofline``;
    (c) the rewrite mode on a gloo world of 4 on the host CPU; (d) the
    tuning-potential lines of (a)'s prefill and decode graphs.  Nothing
    here launches a kernel (fake tensors, gloo on the CPU): the counts of
    ``wrappers`` are zeroed before and must read 0 after."""
    from repro_torch.launch.mesh import spawn

    t_phase = time.perf_counter()
    zero_counts(wrappers)
    out: dict = {}
    # the fake process-group backend the dry run's worlds are made of
    # (``launch.mesh.init_fake_world``); a torch without it fails (a)
    import torch.testing._internal.distributed.fake_pg as fake_pg
    out["fake_pg"] = f"{fake_pg.__name__} (torch {torch.__version__})"
    log(f"[{tag}a] fake process group: torch's \"fake\" backend from "
        f"{out['fake_pg']}")
    # (a) the dry run, in a process of its own: the fake world must be
    # that process's default group
    topo_path = out_dir / "topo.json"
    topo_path.write_text(json.dumps(dataclasses.asdict(topo)))
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           DRYRUN_ARCH, "--shape", "all", "--multi-pod", "both", "--topo",
           str(topo_path), "--jobs", str(DRYRUN_JOBS), "--n-micro",
           str(DRYRUN_MICRO), "--out", str(out_dir / "dryrun"),
           *DRYRUN_FLAGS]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                       timeout=DRYRUN_TIMEOUT_S)
    dry_s = time.perf_counter() - t0
    cells = [json.loads(ln) for ln in r.stdout.splitlines()
             if ln.startswith("{")]
    log(f"[{tag}a] {' '.join(cmd[1:])}: exit {r.returncode}, "
        f"{len(cells)} cells in {dry_s:.1f} s (fake worlds, host CPU)")
    for c in cells:
        if c["status"] == "skip":
            log(f"[{tag}a] {c['arch']} {c['shape']} {c['mesh']}: skip "
                f"({c['reason']})")
            continue
        log(f"[{tag}a] {c['arch']} {c['shape']} {c['mesh']}: "
            f"{c['status']}, {c.get('sites')} sites, unmapped "
            f"{c.get('unmapped')}, trace_s {c.get('trace_s')}, roofline "
            f"{json.dumps(c.get('roofline'))}")
    bad = [c for c in cells if c["status"] == "error" or (
        c["status"] == "ok" and (c["unmapped"] or not c["pgmpi_footer"]))]
    skips = {c["shape"] for c in cells if c["status"] == "skip"}
    if r.returncode or bad or len(cells) != 8 or skips != {"long_500k"}:
        raise RuntimeError(f"dry run: exit {r.returncode}, bad cells "
                           f"{[(c['shape'], c['mesh'], c.get('error')) for c in bad]}, "
                           f"skips {skips}; stderr {r.stderr[-2000:]}")
    out["dryrun"] = {"seconds": dry_s, "cells": [
        {k: c.get(k) for k in ("shape", "mesh", "status", "reason", "sites",
                               "trace_s", "roofline", "memory",
                               "collectives", "tuning_potential",
                               "modeled_collective_latency_us")}
        for c in cells]}

    # (b) the roofline of the card's own steps
    out["steps"] = step_roofline(torch, dev, served, card, tag)

    # (c) the rewrite mode across processes
    host = f"gloo, host CPU ({cpu_model()}), no card number"
    t0 = time.perf_counter()
    ranks = spawn(rewrite_rank, 4, backend="gloo", timeout_s=GROUP_TIMEOUT_S)
    rw_s = time.perf_counter() - t0
    for i, g in enumerate(ranks):
        if not g["bitexact"] or g["changed"] != REWRITE_CHANGED or \
                g["unmatched"] or g["extra"] or g["matched"] != [
                    "allgather", "allreduce", "alltoall", "reducescatter"]:
            raise RuntimeError(f"rewrite rank {i}: {g}")
    log(f"[{tag}c] rewrite on a world of 4 ({host}): bit-exact on every "
        f"rank, changed {ranks[0]['changed']}, matched "
        f"{ranks[0]['matched']}, unmatched [], extra []; "
        f"{rw_s:.1f} s with the world's start")
    out["rewrite"] = {"ranks": ranks, "seconds": rw_s, "host": host}

    # (d) the tuning-potential report of (a)'s prefill and decode graphs
    for c in cells:
        if c["shape"] in ("prefill_32k", "decode_32k"):
            tp = c["tuning_potential"]
            log(f"[{tag}d] {c['arch']} {c['shape']} {c['mesh']} on "
                f"{tp['topo']}: {tp['line']}")
    after = counts(wrappers)
    if any(after.values()):
        raise RuntimeError(f"phase {tag} launched kernels: {after}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[{tag}] analysis phase in {out['seconds']:.1f} s; no kernel "
        "launched (fake tensors, gloo on the CPU)")
    return out


# ---------------------------------------------------------------------------
# training across processes (phase 23)
# ---------------------------------------------------------------------------

# (a) llama3.2-3b at full width, phase 12's TRAIN_LAYERS layers, flash, on a
# world-1 NCCL GroupMesh of (pod, data, model) = (1, 1, 1) against
# Trainer(mesh=(1, 1, 1)) stacked on the same card: the same weights and
# batches of GROUP_TRAIN_BATCH x TRAIN_SEQ tokens; a warm-up step, two timed
# steps (group then stacked, in turn) and one profiled step of each
GROUP_TRAIN_MESH, GROUP_TRAIN_BATCH, GROUP_TRAIN_STEPS = (1, 1, 1), 2, 4
# (b) the train CLI at world 1 on NCCL: the smoke config, CLI_STEPS steps,
# then resumed to CLI_STEPS + 2
GROUP_CLI_STEPS, GROUP_CLI_TIMEOUT_S = 3, 300.0
# (c) gloo worlds of GROUP_TRAIN_WORLD on the host's CPU at smoke size, the
# reference's four archs at (2, 4) and llama3.2-3b at (2, 2, 2), float32,
# two steps (indices 50, 51) held to the stacked step lane for lane: bit
# for bit where every axis has two ranks (gloo's sum of two is the stacked
# one); at (2, 4) the model axis sums four ranks in gloo's order, so the
# loss within GROUP_LOSS_RTOL, the grad norm within GROUP_NORM_RTOL, the
# AdamW moments within GROUP_MOMENT_RTOL of each leaf's max (leaves whose
# gradient is a sum that cancels: rwkv6-3b's norm is 1e4 at its init) and
# each parameter within GROUP_ADAM_STEP learning rates a step (AdamW
# moves an element whose gradient is rounding noise by up to the learning
# rate, either way); tests/test_torch_train_group.py holds the same
GROUP_TRAIN_WORLD = 8
GROUP_TRAIN_CASES = (("llama3.2-3b", (2, 4)), ("phi3.5-moe-42b-a6.6b", (2, 4)),
                     ("rwkv6-3b", (2, 4)), ("zamba2-1.2b", (2, 4)),
                     ("llama3.2-3b", (2, 2, 2)))
GROUP_LOSS_RTOL, GROUP_NORM_RTOL, GROUP_MOMENT_RTOL = 1e-5, 1e-3, 1e-2
GROUP_ADAM_STEP = 2.01


def group_train_rank(jobs: list) -> list:
    """One rank of (c): for each job ``(cfg, mesh, tree, batches,
    start)`` a ``Trainer`` over the world from the global ``tree``, one
    step a batch from index ``start``; this rank's lanes of the params
    and AdamW moments (float32 numpy), each step's metrics and dispatch
    records (cell, impl, phase), and the gloo calls of its axes."""
    from repro_torch.core._axis import is_mesh
    from repro_torch.models.params import tree_leaves
    from repro_torch.train import Trainer
    out = []
    for cfg, mesh, tree, batches, start in jobs:
        tr = Trainer(cfg, mesh=mesh, device="cpu", processes=True,
                     record=[])
        params, opt = tr.from_global(tree)
        metrics, records = [], []
        for i, b in enumerate(batches):
            n = len(tr.record)
            params, opt, m = tr.step(params, opt, tr.put_batch(b), start + i)
            metrics.append({k: float(v) for k, v in m.items()})
            records.append(sorted((dataclasses.astuple(r.cell), r.impl,
                                   r.phase) for r in tr.record[n:]))
        axes = ([tr.axis[n] for n in tr.axis.names] if is_mesh(tr.axis)
                else [tr.axis])
        out.append({
            "metrics": metrics, "records": records,
            "params": [t.float().numpy().copy() for t in tree_leaves(params)],
            "opt": [t.float().numpy().copy() for k in ("m", "v")
                    for t in tree_leaves(opt[k])],
            "calls": sum(sum(v for k, v in ax.calls.items()
                             if k != "barrier") for ax in axes)})
    return out


def group_train_card(torch, dev, wrappers: dict, card: str,
                     tag: str) -> dict:
    """(a) of phase 23: ``GROUP_ARCH`` at full width, ``TRAIN_LAYERS``
    layers, flash, trained on a world-1 NCCL ``GroupMesh`` of
    ``GROUP_TRAIN_MESH`` and on the same mesh stacked on the card, from
    the same weights (each trainer's ``init(SEED)``) and batches: a
    warm-up step, two timed and one profiled step of each, in turn.  The
    kernels' counts are zeroed just before the group steps start: flash
    must launch in them.  Each step's loss and the parameters after the
    steps are held to the stacked trainer's: bit-equal, or within
    ``TRAIN_RTOL``.  A world of one card times no link."""
    import tempfile

    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import make_batch
    from repro_torch.launch.mesh import init_world
    from repro_torch.models.params import tree_paths
    from repro_torch.train import Trainer

    fa = wrappers["flash_attention"]
    cfg = dataclasses.replace(get_config(GROUP_ARCH), n_layers=TRAIN_LAYERS,
                              attn_impl="flash")
    out: dict = {"steps": {"group": [], "stacked": []}}
    with tempfile.TemporaryDirectory() as tmp:
        init_world(GROUP_BACKEND, rank=0, world=1,
                   init_method=(pathlib.Path(tmp) / "store").as_uri())
        try:
            group = Trainer(cfg, mesh=GROUP_TRAIN_MESH, device=dev,
                            processes=True, record=[])
            stacked = Trainer(cfg, mesh=GROUP_TRAIN_MESH, device=dev,
                              record=[])
            state = {"group": group.init(SEED), "stacked": stacked.init(SEED)}
            trainers = {"group": group, "stacked": stacked}
            axes = [group.axis[n] for n in group.axis.names]
            log(f"[{tag}a] {cfg.name}: {cfg.n_layers} of "
                f"{get_config(GROUP_ARCH).n_layers} layers at full width, "
                f"flash, {cfg.dtype}, {cfg.optimizer}; {group.axis!r} and "
                f"the same mesh stacked; {GROUP_TRAIN_BATCH} x {TRAIN_SEQ} "
                f"tokens a step ({card}; a world of one card times no "
                "link)")
            batches = [make_batch(cfg, GROUP_TRAIN_BATCH, TRAIN_SEQ, i)
                       for i in range(GROUP_TRAIN_STEPS)]
            zero_counts(wrappers)     # the group train path starts here
            c_group = dict.fromkeys(wrappers, 0)
            paths: dict = {}
            by_dh: dict = {64: {}, 256: {}}
            for i, b in enumerate(batches):
                profiled = i == GROUP_TRAIN_STEPS - 1
                for label in ("group", "stacked"):
                    tr = trainers[label]
                    batch = tr.put_batch(b)
                    calls0 = sum(sum(ax.calls.values()) for ax in axes)
                    c_before, p_before, d_before = counts(wrappers), dict(
                        fa.launches_by_path), dh_counts(fa)
                    torch.cuda.synchronize()
                    ctx = (profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA])
                           if profiled else contextlib.nullcontext())
                    torch.cuda.reset_peak_memory_stats(dev)
                    with ctx as prof:
                        t0 = time.perf_counter()
                        params, opt, m = tr.step(*state[label], batch, i)
                        loss = float(m["loss"])        # waits for the step
                        dt = (time.perf_counter() - t0) * 1e3
                    state[label] = (params, opt)
                    if label == "group":      # the group steps' launches
                        for k, v in counts(wrappers).items():
                            c_group[k] += v - c_before[k]
                        for k, v in path_delta(fa, p_before).items():
                            paths[k] = paths.get(k, 0) + v
                        for dh, got in by_dh.items():
                            for k, v in dh_delta(fa, d_before, dh).items():
                                got[k] = got.get(k, 0) + v
                    step = {"loss": loss, "grad_norm": float(m["grad_norm"]),
                            "ms": dt, "peak_bytes":
                                torch.cuda.max_memory_allocated(dev),
                            "nccl_calls": sum(sum(ax.calls.values())
                                              for ax in axes) - calls0}
                    if profiled:
                        rows = prof.key_averages()
                        on_dev = [e for e in rows if str(getattr(
                            e, "device_type", "")).endswith("CUDA")]
                        step["busy_ms"] = sum(e.self_device_time_total
                                              for e in on_dev) / 1e3
                        pg = [e for e in rows if e not in on_dev
                              and e.key.startswith("c10d::")]
                        step["pg_calls"] = sum(e.count for e in pg)
                        step["pg_host_ms"] = sum(e.cpu_time_total
                                                 for e in pg) / 1e3
                    out["steps"][label].append(step)
                    log(f"[{tag}a] step {i} {label}: loss {loss:.6f} "
                        f"grad_norm {step['grad_norm']:.4f} {dt:.2f} ms"
                        f"{' (warm-up)' if i == 0 else ''}"
                        f"{' (profiled)' if profiled else ''}, "
                        f"{step['nccl_calls']} NCCL calls, peak "
                        f"{step['peak_bytes'] / 1e9:.3f} GB"
                        + (f"; device busy {step['busy_ms']:.2f} ms, "
                           f"{step['pg_calls']} process-group calls taking "
                           f"{step['pg_host_ms']:.3f} ms of host time"
                           if profiled else ""))
            paths = {k: v for k, v in paths.items() if v}
            want = dict(tree_paths(state["stacked"][0]))
            got = dict(tree_paths(state["group"][0]))
        finally:
            dist.destroy_process_group()
    log(f"[{tag}a] kernel launches in the group steps: "
        f"{json.dumps(c_group)}; flash by path {json.dumps(paths)}")
    if c_group["flash_attention"] <= 0:
        raise RuntimeError(f"[{tag}a] flash never launched in the group "
                           "steps")
    if min(s["nccl_calls"] for s in out["steps"]["group"]) <= 0:
        raise RuntimeError(f"[{tag}a] a group step made no NCCL call")
    equal = all(torch.equal(got[k], want[k]) for k in want) and all(
        a["loss"] == b["loss"] for a, b in zip(out["steps"]["group"],
                                               out["steps"]["stacked"]))
    err, leaf = grads_rel_err(torch, got, want)
    lerr = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in
               zip(out["steps"]["group"], out["steps"]["stacked"]))
    log(f"[{tag}a] group vs stacked after {GROUP_TRAIN_STEPS} steps: "
        + ("bit-equal" if equal else
           f"not bit-equal: params max-norm relative {err:.3e} ({leaf}), "
           f"losses {lerr:.3e} (tolerance {TRAIN_RTOL})"))
    if not equal and not (err <= TRAIN_RTOL and lerr <= TRAIN_RTOL):
        raise RuntimeError(f"[{tag}a] the group steps differ from the "
                           f"stacked ones: params {err} at {leaf}, loss "
                           f"{lerr}")
    timed = {k: [s["ms"] for s in v[1:-1]] for k, v in out["steps"].items()}
    log(f"[{tag}a] timed steps, group {timed['group']} ms beside stacked "
        f"{timed['stacked']} ms ({card}; a world of one card times no link)")
    del state, trainers, group, stacked, got, want
    torch.cuda.empty_cache()
    out.update(bit_equal=equal, param_rel_err=err, loss_rel_err=lerr,
               launches=c_group, paths=paths, d256_paths=by_dh[256],
               d64_paths=by_dh[64], timed_ms=timed)
    return out


def group_train_cli(out_dir: pathlib.Path, tag: str) -> dict:
    """(b) of phase 23: ``python -m repro_torch.launch.train --smoke
    --world 1 --dist-backend nccl`` (``GROUP_BACKEND``) on the card,
    ``GROUP_CLI_STEPS`` steps, then resumed for two more from its
    checkpoint."""
    ck = out_dir / "group_train_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    runs = []
    for steps in (GROUP_CLI_STEPS, GROUP_CLI_STEPS + 2):
        argv = [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
                "--world", "1", "--dist-backend", GROUP_BACKEND, "--mesh",
                "1x1x1", "--steps", str(steps), "--log-every", "1", "--seq",
                "64", "--ckpt-dir", str(ck)]
        if GROUP_BACKEND == "gloo":              # gloo runs on the CPU
            argv += ["--device", "cpu"]
        t0 = time.perf_counter()
        res = subprocess.run(argv, capture_output=True, text=True, env=env,
                             timeout=GROUP_CLI_TIMEOUT_S, cwd=ROOT)
        sec = time.perf_counter() - t0
        for ln in res.stdout.strip().splitlines():
            log(f"[{tag}b] {ln}")
        if res.returncode != 0:
            raise RuntimeError(f"[{tag}b] the train CLI failed "
                               f"({res.returncode}): {res.stderr[-3000:]}")
        runs.append({"steps": steps, "seconds": sec, "stdout": res.stdout})
        log(f"[{tag}b] --world 1 --dist-backend {GROUP_BACKEND} --steps "
            f"{steps}: {sec:.1f} s")
    first, second = (r["stdout"] for r in runs)
    done = f"steps over 1 processes ({GROUP_BACKEND}"
    if f"done: {GROUP_CLI_STEPS} {done}" not in first \
            or f"resumed from step {GROUP_CLI_STEPS}" not in second \
            or f"done: 2 {done}" not in second:
        raise RuntimeError(f"[{tag}b] the CLI did not train, checkpoint and "
                           "resume")
    shutil.rmtree(ck, ignore_errors=True)
    return {"runs": [{k: r[k] for k in ("steps", "seconds")} for r in runs]}


def group_train_cpu(tag: str) -> dict:
    """(c) of phase 23: one gloo world of ``GROUP_TRAIN_WORLD`` processes
    on the host's CPU runs every case of ``GROUP_TRAIN_CASES`` at smoke
    size in float32 (``group_train_rank``), each held to the stacked
    ``Trainer`` on the CPU lane for lane; the times are the host CPU's."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn
    from repro_torch.models.params import tree_leaves
    from repro_torch.train import Trainer

    host = f"gloo, host CPU ({cpu_model()})"
    jobs, want = [], []
    t0 = time.perf_counter()
    for arch, mesh in GROUP_TRAIN_CASES:
        cfg = dataclasses.replace(get_config(arch).smoke(), dtype="float32")
        rng = np.random.default_rng(SEED)
        batches = []
        for _ in range(2):
            toks = rng.integers(0, cfg.vocab_size, (8, 16)).astype(np.int32)
            batches.append({"tokens": toks, "labels": toks.copy()})
        st = Trainer(cfg, mesh=mesh, device="cpu", record=[])
        params, opt = st.init(SEED)
        # a copy: the stacked steps below update the state in place
        tree = _clone_tree(st.to_global(params, opt))
        jobs.append((cfg, mesh, tree, batches, 50))
        metrics, records = [], []
        for i, b in enumerate(batches):
            n = len(st.record)
            params, opt, m = st.step(params, opt, st.put_batch(b), 50 + i)
            metrics.append({k: float(v) for k, v in m.items()})
            records.append(sorted((dataclasses.astuple(r.cell), r.impl,
                                   r.phase) for r in st.record[n:]))
        want.append({"metrics": metrics, "records": records,
                     "params": [t.float().numpy() for t in
                                tree_leaves(params)],
                     "opt": [t.float().numpy() for k in ("m", "v")
                             for t in tree_leaves(opt[k])]})
    stacked_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = spawn(group_train_rank, GROUP_TRAIN_WORLD, backend="gloo",
                args=(jobs,), timeout_s=GROUP_TIMEOUT_S)
    world_s = time.perf_counter() - t0
    out = {"host": host, "world_s": world_s, "stacked_s": stacked_s,
           "cases": []}
    for c, (arch, mesh) in enumerate(GROUP_TRAIN_CASES):
        w = want[c]
        exact = all(n <= 2 for n in mesh)
        lr = sum(m["lr"] for m in w["metrics"])
        worst = {"loss": 0.0, "grad_norm": 0.0, "moments": 0.0,
                 "params_per_lr": 0.0}
        for r in range(GROUP_TRAIN_WORLD):
            g = got[r][c]
            if g["records"] != w["records"]:
                raise RuntimeError(f"[{tag}c] {arch} {mesh} rank {r}: the "
                                   "records differ from the stacked step's")
            if g["calls"] <= 0:
                raise RuntimeError(f"[{tag}c] {arch} {mesh}: no gloo call")
            for gm, wm in zip(g["metrics"], w["metrics"]):
                for k in ("loss", "grad_norm"):
                    worst[k] = max(worst[k], abs(gm[k] - wm[k]) / abs(wm[k]))
            for a, b in zip(g["opt"], w["opt"]):
                b = b[r:r + 1]
                worst["moments"] = max(worst["moments"], float(
                    np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)))
            for a, b in zip(g["params"], w["params"]):
                worst["params_per_lr"] = max(worst["params_per_lr"], float(
                    np.abs(a - b[r:r + 1]).max() / lr))
        ok = (all(v == 0 for v in worst.values()) if exact else
              worst["loss"] <= GROUP_LOSS_RTOL
              and worst["grad_norm"] <= GROUP_NORM_RTOL
              and worst["moments"] <= GROUP_MOMENT_RTOL
              and worst["params_per_lr"] <= GROUP_ADAM_STEP)
        log(f"[{tag}c] {arch} at {'x'.join(map(str, mesh))}, world "
            f"{GROUP_TRAIN_WORLD}, 2 steps vs stacked, worst over ranks: "
            + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
            + (" (bit-equal)" if exact and ok else "")
            + f"; records equal ({host})")
        if not ok:
            raise RuntimeError(f"[{tag}c] {arch} {mesh}: the process steps "
                               f"differ from the stacked ones {worst}")
        out["cases"].append({"arch": arch, "mesh": list(mesh), **worst})
    log(f"[{tag}c] the world of {GROUP_TRAIN_WORLD} ran the "
        f"{len(GROUP_TRAIN_CASES)} cases in {world_s:.1f} s, the stacked "
        f"steps {stacked_s:.1f} s ({host})")
    return out


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone_tree(v) for v in tree]
    return tree.clone()


def group_train_phase(torch, dev, out_dir: pathlib.Path, wrappers: dict,
                      card: str, tag: str = "23") -> dict:
    """Training across processes: (a) ``group_train_card``, (b)
    ``group_train_cli``, (c) ``group_train_cpu``."""
    t_phase = time.perf_counter()
    out = group_train_card(torch, dev, wrappers, card, tag)
    out["cli"] = group_train_cli(out_dir, tag)
    out["cpu"] = group_train_cpu(tag)
    log(f"[{tag}] training across processes in "
        f"{time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# two more families trained through the kernels (phase 24)
# ---------------------------------------------------------------------------

# (a) whisper-medium, 24 + 24 layers at full width, TP ENCDEC_TP stacked,
# FAMILY_BATCH requests of ENCDEC_FRAMES stub frames (and the decoder's
# ENCDEC_FRAMES / dec_ratio tokens); (b) paligemma-3b, 18 layers at full
# width, TP VLM_TP stacked, FAMILY_BATCH requests of 256 stub patches +
# SERVE_PROMPT text tokens, the text-only loss.  Both bf16, AdamW; one
# warm-up, FAMILY_STEPS timed and one profiled step each
FAMILY_BATCH, FAMILY_WARMUP, FAMILY_STEPS = 2, 1, 3


def family_train(torch, dev, wrappers: dict, card: str, tag: str,
                 label: str, arch: str, tp: int, seq: int, n_layers=None):
    """Train ``arch`` at full width (``n_layers`` cuts the depth) on ``tp``
    stacked model ranks through flash's autograd Function, on batches of
    ``make_batch``'s shapes drawn from ``SEED``: timed steps
    (``timed_steps``: peak memory, busy share), flash's launches by path
    and head dim in them; then one step's loss and gradients against the
    ``ref`` step's from the same weights and batch, within
    ``TRAIN_RTOL``."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data import batch_specs
    from repro_torch.models.params import tree_nbytes, tree_paths
    from repro_torch.optim import state_specs
    from repro_torch.train import Trainer

    fa = wrappers["flash_attention"]
    full = get_config(arch)
    cfg = dataclasses.replace(full, attn_impl="flash",
                              n_layers=n_layers or full.n_layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    tr = Trainer(cfg, mesh=(1, tp), device=dev, record=[])
    params, opt = tr.init(SEED)
    n_a = FAMILY_WARMUP + FAMILY_STEPS + 1
    # make_batch's shapes, drawn from SEED (make_batch seeds from
    # hash(cfg.name), which each process salts): every run checks the
    # same step
    rng = np.random.default_rng(SEED)
    batches = []
    for _ in range(n_a + 1):
        b = {k: rng.standard_normal(shape, dtype=np.float32)
             if dt == "bfloat16" else
             rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
             for k, (shape, dt) in batch_specs(cfg, FAMILY_BATCH,
                                               seq).items()}
        b["labels"] = b["tokens"].copy()
        batches.append(tr.put_batch(b))
    shapes = {k: list(v.shape) for k, v in batches[0].items()}
    log(f"[{tag}{label}] {arch}: {cfg.n_layers} of {full.n_layers} layers"
        + (f" + {cfg.encdec.n_enc_layers} encoder layers"
           if cfg.encdec else "")
        + f" at full width (d_model {cfg.d_model}, head dim {cfg.head_dim}),"
        f" {cfg.dtype}, {cfg.optimizer}, TP {tp} stacked, flash; params "
        f"{tree_nbytes(tr.specs) / 1e9:.3f} GB + optimizer state "
        f"{tree_nbytes(state_specs(cfg.optimizer, tr.specs)) / 1e9:.3f} GB;"
        f" a step's batch {json.dumps(shapes)} ({card})")
    p0, d0 = dict(fa.launches_by_path), dh_counts(fa)
    c0 = counts(wrappers)["flash_attention"]
    params, opt, losses, times, _, prof = timed_steps(
        torch, tr, params, opt, batches, tag, label, FAMILY_WARMUP,
        FAMILY_STEPS)
    torch.cuda.synchronize()
    took = {k: v for k, v in path_delta(fa, p0).items() if v}
    by_dh = {dh: dh_delta(fa, d0, dh) for dh in (64, 128, 256)}
    by_dh = {dh: v for dh, v in by_dh.items() if v}
    n_flash = counts(wrappers)["flash_attention"] - c0
    med = sorted(times)[len(times) // 2]
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[{tag}{label}] {arch}: median step {med * 1e3:.2f} ms over "
        f"{FAMILY_STEPS} steps, peak device memory {peak / 1e9:.3f} GB, "
        f"device busy {100 * prof['busy_share']:.1f} % of the profiled "
        f"step; flash launches in the {n_a} steps {n_flash}, by path "
        f"{json.dumps(took)}, by head dim {json.dumps(by_dh)} ({card})")
    if n_flash <= 0 or took.get("wgmma", 0) <= 0:
        raise RuntimeError(f"[{tag}{label}] flash did not train on its "
                           f"wgmma path: {took}")
    del opt
    batch = batches[n_a]
    del batches
    torch.cuda.empty_cache()
    loss0, g0 = tr.grads(params, batch)
    g0 = dict(tree_paths(g0))
    ref_tr = Trainer(dataclasses.replace(cfg, attn_impl="ref"), mesh=(1, tp),
                     device=dev)
    torch.cuda.empty_cache()
    loss1, g1 = ref_tr.grads(params, batch)
    errs = {k: grads_rel_err(torch, {k: g0[k]}, {k: w})[0]
            for k, w in tree_paths(g1)}
    lerr = abs(float(loss0) - float(loss1)) / abs(float(loss1))
    leaf = max(errs, key=errs.get)
    worst = sorted(errs, key=errs.get, reverse=True)[:5]
    log(f"[{tag}{label}] the five leaves farthest apart (max-norm "
        f"relative): {', '.join(f'{k} {errs[k]:.3e}' for k in worst)}")
    log(f"[{tag}{label}] step through flash vs ref attention: loss "
        f"{float(loss0):.6f} vs {float(loss1):.6f} (rel {lerr:.3e}), "
        f"gradients max-norm relative {errs[leaf]:.3e} at {leaf} "
        f"(tolerance {TRAIN_RTOL})")
    if not (errs[leaf] <= TRAIN_RTOL and lerr <= TRAIN_RTOL):
        raise RuntimeError(f"[{tag}{label}] the flash step differs from "
                           f"the ref step: grads {errs[leaf]} at {leaf}, "
                           f"loss {lerr}")
    del tr, ref_tr, params, g0, g1, batch
    torch.cuda.empty_cache()
    return {"n_layers": cfg.n_layers, "batch": shapes,
            "step_ms": [t * 1e3 for t in times],
            "median_step_ms": med * 1e3, "peak_bytes": peak,
            "profiled_step": prof, "losses": losses, "flash_launches": n_flash,
            "paths": took, "by_dh": by_dh, "grad_rel_err": errs[leaf],
            "leaf": leaf, "loss_rel_err": lerr}


def family_train_phase(torch, dev, wrappers: dict, card: str,
                       tag: str = "24") -> dict:
    """(a) whisper-medium and (b) paligemma-3b trained through flash
    (``family_train``).  The kernels' counts are zeroed just before the
    path and read after it."""
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    fa = wrappers["flash_attention"]
    zero_counts(wrappers)                  # the path starts here
    c0, p0, d0 = counts(wrappers), dict(fa.launches_by_path), dh_counts(fa)
    pali = get_config(VLM_ARCH)
    out = {ENCDEC_ARCH: family_train(torch, dev, wrappers, card, tag, "a",
                                     ENCDEC_ARCH, ENCDEC_TP, ENCDEC_FRAMES),
           VLM_ARCH: family_train(torch, dev, wrappers, card, tag, "b",
                                  VLM_ARCH, VLM_TP,
                                  pali.vlm.n_patches + SERVE_PROMPT)}
    c1 = counts(wrappers)
    out["launches"] = {k: c1[k] - c0[k] for k in c1}
    out["paths"] = path_delta(fa, p0)
    out["d256_paths"] = dh_delta(fa, d0, 256)
    out["d64_paths"] = dh_delta(fa, d0, 64)
    log(f"[family train path] kernel launches: {json.dumps(out['launches'])};"
        f" flash by path {json.dumps(out['paths'])}, dh 64 "
        f"{json.dumps(out['d64_paths'])}, dh 256 "
        f"{json.dumps(out['d256_paths'])}")
    log(f"[{tag}] family train phase in {time.perf_counter() - t_phase:.1f} s")
    return out


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


#: spill bytes ptxas may report for a flash wgmma kernel (a name's
#: fragment: bytes); every other such kernel spills none
FLASH_SPILL_OK = {"fa_wgmma64_kernel": 8}


def spill_bytes(line: str):
    """The spill stores of a ptxas ``... bytes spill stores ...`` line, or
    None for another line."""
    m = re.search(r"(\d+) bytes spill stores", line)
    return None if m is None else int(m.group(1))


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
    global H100_BYTES_PER_S, H100_FLOPS
    from repro_torch.analysis.roofline import H100_BYTES_PER_S, H100_FLOPS
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
    report: dict = {"phase_seconds": {}}
    clock = {"phase": None, "t": t_start}

    def phase(n: str) -> None:
        """Close the running phase (its seconds logged and kept) and open
        phase ``n`` (None: the end)."""
        now = time.perf_counter()
        if clock["phase"] is not None:
            sec = now - clock["t"]
            report["phase_seconds"][clock["phase"]] = sec
            log(f"[phase {clock['phase']}] {sec:.1f} s")
        clock.update(phase=n, t=now)

    phase("1")
    # -- 1. the card ---------------------------------------------------------
    card = nvidia_smi("name,power.limit")
    log(card)                       # exactly as nvidia-smi prints it
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    report["card"] = card

    phase("2")
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
        fn = ""
        for ln in _build.build_log(lib).splitlines():
            if "Function properties for" in ln:
                fn = ln.split('for ', 1)[1]
                log(f"[2] ptxas {lib}: {fn[:100]}")
            elif "registers" in ln or "spill" in ln or "smem" in ln or \
                    "C75" in ln:
                log(f"[2] ptxas {lib}:   {ln.strip()}")
                # flash's wgmma kernels hold their accumulators in
                # registers: a spill, or a register defined under a
                # product in flight, serializes their products (ptxas
                # C75xx, a line that names its kernel);
                # fa_wgmma64_kernel's 8 bytes are stored before its loop
                # and loaded after it
                if lib == "flash_attention" and \
                        "wgmma.mma_async instructions are serialized" in ln:
                    raise RuntimeError(f"ptxas serialized wgmma: {ln}")
                spilled = spill_bytes(ln)
                allowed = max((b for k, b in FLASH_SPILL_OK.items()
                               if k in fn), default=0)
                if spilled is not None and lib == "flash_attention" and \
                        "wgmma" in fn and spilled > allowed:
                    raise RuntimeError(f"ptxas spilled in {fn}: {ln}")
    for dt in (torch.bfloat16, torch.float32):
        log(f"[2] agmm_ring blocks per rank at p={P}, n={TOKENS // P}, "
            f"m={2 * D_FF // P}, {dt}: "
            f"{rdma.blocks_per_rank(dt, P, TOKENS // P, 2 * D_FF // P)}")

    phase("3")
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
    kernels["flash_attention_mla"] = dict(
        flash["mla"]["prefill"], name="flash_attention_mla", main_path=True)
    kernels["flash_attention_mla_decode"] = dict(
        flash["mla"]["decode"][SERVE_PROMPT + SERVE_DECODE],
        name="flash_attention_mla_decode", main_path=True)
    kernels["flash_attention_d256"] = dict(
        flash["d256"]["gemma prefill"], name="flash_attention_d256",
        main_path=True)
    kernels["flash_attention_encdec"] = dict(
        flash["encdec"]["encoder"], name="flash_attention_encdec",
        main_path=True)
    report["flash_encdec"] = flash["encdec"]
    report["flash_d256"] = flash["d256"]
    report["flash_decode"] = flash["decode"]
    report["flash_mla_decode"] = flash["mla"]["decode"]
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

    phase("4")
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

    phase("5")
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

    phase("6")
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

    phase("7")
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

    phase("8")
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

    phase("9")
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

    phase("10")
    # -- 10. the serve path: llama3.2-3b ----------------------------------
    every = dict(wrappers,
                 ring_allgather_matmul_blocks=rdma.ring_allgather_matmul_blocks,
                 flash_attention=fa.flash_attention,
                 rwkv6_scan=rw.rwkv6_scan, ssd_scan=ssd.ssd_scan)
    served = serve_phase(torch, dev, out_dir, every, "llama3.2-3b", "10",
                         ("fa_wgmma", "fa_ring_kernel"))
    report["serve"] = served
    kernels["flash_attention"]["launches"] = served["launches"][
        "flash_attention"]
    kernels["flash_attention"]["main_path"] = True

    phase("11")
    # -- 11. the serve paths of the SSM family ------------------------------
    report["ssm_serve"] = {}
    for arch, scan, needles in (
            ("rwkv6-3b", "rwkv6_scan", ("rwkv6_chunk_kernel",
                                        "rwkv6_decode_kernel")),
            ("zamba2-1.2b", "ssd_scan", ("ssd_chunk_kernel",
                                         "ssd_decode_kernel",
                                         "fa_wgmma",
                                         "fa_ring_kernel"))):
        got = serve_phase(torch, dev, out_dir, every, arch, "11", needles)
        got["state_carry_rel_err"] = state_carry_check(torch, dev, every,
                                                       arch)
        report["ssm_serve"][arch] = got
        kernels[scan]["launches"] = got["launches"][scan]
        kernels[scan]["main_path"] = True

    phase("12")
    # -- 12. the train path: llama3.2-3b, FSDP and TP ----------------------
    report["train"] = train_phase(torch, dev, every)
    for k, v in report["train"]["launches"].items():
        kernels[k]["train_launches"] = v

    phase("13")
    # -- 13. the data x model train path: llama3.2-3b on a (2, 4) mesh ------
    report["mesh_train"] = train_mesh_phase(torch, dev, every)
    for k, v in report["mesh_train"]["launches"].items():
        kernels[k]["mesh_train_launches"] = v

    phase("14")
    # -- 14. train through the kernels: flash, rwkv6_scan, ssd_scan ----------
    report["kernel_train"] = train_kernels_phase(torch, dev, every,
                                                 report["train"])
    for k, v in report["kernel_train"]["launches"].items():
        kernels[k]["kernel_train_launches"] = v

    phase("15")
    # -- 15. the MoE serve: phi3.5-moe-42b-a6.6b, 16 of 32 layers ----------
    report["moe_serve"] = moe_serve_phase(torch, dev, out_dir, every, card)
    for k, v in report["moe_serve"]["launches"].items():
        kernels[k]["moe_serve_launches"] = v
    # the MLA paths' launches in each path's run (phases 12-15 read
    # flash's counts by path around their runs)
    mla_row = kernels["flash_attention_mla"]

    def mla_count(paths: dict) -> int:
        return paths.get("mla", 0) + paths.get("mla_wgmma", 0)
    for key, field in (("train", "train_launches"),
                       ("mesh_train", "mesh_train_launches"),
                       ("kernel_train", "kernel_train_launches")):
        mla_row[field] = mla_count(report[key]["paths"]["flash_attention"])
    mla_row["moe_serve_launches"] = mla_count(
        report["moe_serve"]["flash_paths"])

    phase("16")
    # -- 16. the MLA serve: deepseek-v3-671b, 2 of 61 layers ---------------
    report["mla_serve"] = mla_serve_phase(torch, dev, out_dir, every, card)
    for k, v in report["mla_serve"]["launches"].items():
        kernels[k]["mla_serve_launches"] = v
    kernels["flash_attention_mla"]["launches"] = report["mla_serve"][
        "mla_launches"]
    kernels["flash_attention_mla"]["mla_serve_launches"] = report[
        "mla_serve"]["mla_launches"]
    kernels["flash_attention_mla"]["paths"] = report["mla_serve"][
        "mla_paths"]
    dec_row = kernels["flash_attention_mla_decode"]
    dec_row["launches"] = dec_row["mla_serve_launches"] = report[
        "mla_serve"]["mla_paths"]["mla"]
    dec_row["paths"] = {"mla": dec_row["launches"]}

    phase("17")
    # -- 17. gemma3-1b: the data x model serve and long_500k ----------------
    report["long_context"] = long_context_phase(torch, dev, out_dir, every,
                                                card)
    for k, v in report["long_context"]["launches"].items():
        kernels[k]["long_context_launches"] = v

    phase("18")
    # -- 18. paligemma-3b: the prefix-LM VLM serve --------------------------
    report["vlm_serve"] = vlm_serve_phase(torch, dev, out_dir, every, card)
    for k, v in report["vlm_serve"]["launches"].items():
        kernels[k]["vlm_serve_launches"] = v
    # the MLA paths' launches in phases 17-18 (flash's counts by path);
    # flash at head dim 256: phase 3's gemma3-1b prefill numbers, and its
    # launches at that head dim by path in each path's run (phases 12-18
    # read flash's counts by head dim around their runs)
    mla_row["long_context_launches"] = mla_count(
        report["long_context"]["paths"])
    mla_row["vlm_serve_launches"] = mla_count(report["vlm_serve"]["paths"])
    d256 = kernels["flash_attention_d256"]
    for key, field in (("train", "train_launches"),
                       ("mesh_train", "mesh_train_launches"),
                       ("kernel_train", "kernel_train_launches"),
                       ("moe_serve", "moe_serve_launches"),
                       ("mla_serve", "mla_serve_launches"),
                       ("long_context", "long_context_launches"),
                       ("vlm_serve", "vlm_serve_launches")):
        d256[field] = report[key]["d256_paths"]
    d256["launches"] = sum(report["long_context"]["d256_paths"].values()) + \
        sum(report["vlm_serve"]["d256_paths"].values())
    d256["paths"] = {k: report["long_context"]["d256_paths"].get(k, 0)
                     + report["vlm_serve"]["d256_paths"].get(k, 0)
                     for k in {**report["long_context"]["d256_paths"],
                               **report["vlm_serve"]["d256_paths"]}}

    phase("19")
    # -- 19. whisper-medium: the encoder-decoder serve ----------------------
    report["encdec_serve"] = encdec_serve_phase(torch, dev, out_dir, every,
                                                card)
    for k, v in report["encdec_serve"]["launches"].items():
        kernels[k]["encdec_serve_launches"] = v
    # flash's rows by path and head dim in phase 19: the MLA paths, dh 256
    # and the enc-dec row (phase 3's encoder self-attention numbers; its
    # launches: phase 19's at head dim 64)
    mla_row["encdec_serve_launches"] = mla_count(
        report["encdec_serve"]["paths"])
    d256["encdec_serve_launches"] = report["encdec_serve"]["d256_paths"]
    enc_row = kernels["flash_attention_encdec"]
    enc_row["encdec_serve_launches"] = report["encdec_serve"]["dh_paths"]
    enc_row["launches"] = sum(report["encdec_serve"]["dh_paths"].values())

    phase("20")
    # -- 20. the process-group axis: NCCL at world 1, gloo at world 4 -------
    report["group"] = group_phase(torch, dev, out_dir, every, card)
    for k, v in report["group"]["launches"].items():
        kernels[k]["group_serve_launches"] = v
    mla_row["group_serve_launches"] = mla_count(report["group"]["paths"])
    d256["group_serve_launches"] = report["group"]["d256_paths"]
    enc_row["group_serve_launches"] = report["group"]["d64_paths"]

    phase("21")
    # -- 21. the fleet loop and fault tolerance: llama3.2-3b ---------------
    report["fleet"] = fleet_phase(torch, dev, out_dir, every, card, topo)
    for k, v in report["fleet"]["launches"].items():
        kernels[k]["fleet_launches"] = v
    mla_row["fleet_launches"] = mla_count(report["fleet"]["paths"])
    d256["fleet_launches"] = report["fleet"]["d256_paths"]
    enc_row["fleet_launches"] = report["fleet"]["d64_paths"]

    phase("22")
    # -- 22. analysis at the graph layer: dry run, roofline, rewrite -------
    report["analysis"] = analysis_phase(torch, dev, out_dir, every, card,
                                        topo, report["serve"])

    phase("23")
    # -- 23. training across processes: NCCL world 1, the CLI, gloo ------
    report["group_train"] = group_train_phase(torch, dev, out_dir, every,
                                              card)

    phase("24")
    # -- 24. whisper-medium and paligemma-3b trained through flash --------
    report["family_train"] = family_train_phase(torch, dev, every, card)
    # each row's launches in phases 23 and 24, flash's rows by path and
    # head dim
    for key in ("group_train", "family_train"):
        field = f"{key}_launches"
        for k, v in report[key]["launches"].items():
            kernels[k][field] = v
        mla_row[field] = mla_count(report[key]["paths"])
        d256[field] = report[key]["d256_paths"]
        enc_row[field] = report[key]["d64_paths"]
    phase(None)
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    (out_dir / "report.json").write_text(json.dumps(report, indent=1))
    log(f"[done] {report['seconds']:.1f} s")
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "main_path", "paths", "train_launches", "mesh_train_launches",
             "kernel_train_launches", "moe_serve_launches",
             "mla_serve_launches", "long_context_launches",
             "vlm_serve_launches", "encdec_serve_launches",
             "group_serve_launches", "fleet_launches",
             "group_train_launches", "family_train_launches")
    print(json.dumps({"kernels": [{k: kernels[n].get(k) for k in order}
                                  for n in ("guideline_pack", "block_matmul",
                                            "ring_allgather_matmul_rdma",
                                            "ring_allgather_matmul_blocks",
                                            "quant_pack", "dequant_unpack",
                                            "flash_attention",
                                            "flash_attention_mla",
                                            "flash_attention_mla_decode",
                                            "flash_attention_d256",
                                            "flash_attention_encdec",
                                            "rwkv6_scan", "ssd_scan")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
