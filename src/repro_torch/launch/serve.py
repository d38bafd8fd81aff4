"""Serving: the prefill / decode steps and the profile-driven serve loop.

Profile-driven serving, as in the JAX package's ``launch/serve.py``:
dispatches are tagged ``api.phase("prefill")`` / ``api.phase("decode")``,
which (a) records a phase-split workload trace and (b) lets per-phase
stores from ``tuner.tune_trace`` pick different mock-ups for prefill and
decode.  A step runs under whatever ``api.tuned`` context is ambient at
call time; ``serve`` opens one with explicit ``phase_profiles=`` or, when
given none, the stores of ``$PGTUNE_PROFILE_DIR`` (``resolve_stores``).

``serve`` is the counterpart of ``examples/serve_decode.py``: prefill a
batch of prompts, greedy-decode with tensor parallelism over a stacked
``model`` axis, tokens kept on the device.  On a (data, model)
``StackedMesh`` the batch is cut over ``data`` (the JAX package's
``_dp``) and the weights are FSDP-sharded over it, gathered by the ops
as in training.  The ``long_500k`` cell (``launch.shapes``) decodes over
a sequence-sharded cache instead: the prompt is prefilled unsharded on
the model axis, its cache laid out as ``d`` sequence shards
(``seq_shards``), and ``decode_from`` decodes with the token replicated
over ``data``, the logits read from data rank 0.  The CLI closes the
paper's offline -> online loop on the recorded traffic::

    python -m repro_torch.launch.serve --device cpu --arch llama3.2-3b
    python -m repro_torch.launch.serve --device cpu --arch gemma3-1b \
        --mesh 2x2
    python -m repro_torch.launch.serve --device cpu --arch gemma3-1b \
        --mesh 4x1 --shape long_500k

(also ``--arch rwkv6-3b``, ``zamba2-1.2b``, ``paligemma-3b`` (stub image
patches before the prompt), ``whisper-medium`` (stub frame embeddings,
``dec_ratio`` times the prompt's length, for the encoder; drawn from
``--seed``); the smoke-size config: default serve,
recording; ``tune_trace`` with the measured backend; serve again under
the per-phase profiles; the tokens and logits must agree; at ``--shape
long_500k`` the sharded decode is also held to an unsharded one from the
same prefill, and the prompt is cut to the smoke size).  Without
``--device cpu`` it runs on the card.
Across processes, ``axis`` is a ``GroupAxis`` (TP, one rank a process)
or a (data, model) ``GroupMesh`` (``launch.mesh``): each process holds
one lane, the full-vocab logits are gathered with the axis' own
``all_gather`` (every rank holds them and picks the same tokens); in the
sequence-sharded decode each process holds its own shard, and the data
rank that owns a slot writes it.  The CLI runs it over gloo on the CPU with ``--world N --dist-backend gloo``
(TP N, or ``--mesh dxt`` with d*t = N); the measured tune replays the
cells whose world is N, and rank 0 writes the profiles every rank
tuned (``profiles.publish``).
Fleet mode: ``build_prefill``/``build_decode``/``serve`` take
``store_ref=`` (a ``profiles.StoreRef``, e.g. from
``resolve_stores(watch=True)``) and ``plan=`` (an ``api.Plan``).  With a
plan the step takes one TRAILING argument, the plan vector (a host array:
``plan.vector(store_ref)``), and runs the model under
``api.plan_input(vec)``, so every multi-impl dispatch site runs the impl
the vector names.  A new profile epoch is adopted by feeding the next
call a new vector: the step built once serves every epoch.  The JAX
builders' other tuning arguments (``profiles=``, ``force=``,
``phase_profiles=``, ``profile_dir=``) are not ported: a step runs under
the ambient context, which ``serve`` opens.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import pathlib
import shutil
import time

import numpy as np
import torch

from repro_torch.core import api
from repro_torch.core._axis import (GroupAxis, StackedAxis, is_mesh,
                                    spans_processes)
from repro_torch.core.profiles import publish, resolve_stores
from repro_torch.dist.axes import bind
from repro_torch.launch.mesh import (make_group_mesh, make_host_mesh,
                                    spawn)
from repro_torch.launch.shapes import SHAPES, ShapeCell
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig


@contextlib.contextmanager
def _serving_ctx(tag, record, store_ref=None, plan=None):
    """Phase-tag the step under the ambient context; with ``record=``,
    ``store_ref=`` or ``plan=``, open a context that inherits every
    tuning input of the ambient one (a fresh context would silently
    shadow a caller-managed api.tuned) and overrides those given."""
    amb = api._ctx()
    given = (("record", record), ("store_ref", store_ref), ("plan", plan))
    if all(v is None or (amb is not None and getattr(amb, k) is v)
           for k, v in given):
        with api.phase(tag):
            yield
        return
    inputs = {} if amb is None else dict(
        profiles=amb.profiles, phase_profiles=amb.phase_profiles,
        force=amb.force or None,
        scratch_budget_bytes=amb.scratch_budget_bytes,
        chunk_bytes=amb.chunk_bytes, record=amb.record,
        store_ref=amb.store_ref, plan=amb.plan, mesh_topo=amb.mesh_topo)
    for k, v in given:
        if v is not None:
            inputs[k] = v
    with api.tuned(**inputs), api.phase(tag):
        yield


def _axes_of(axis) -> dict:
    """The names to bind for ``axis``: one axis (``StackedAxis`` or
    ``GroupAxis``) is the model axis; a mesh binds each of its names
    (data and model)."""
    if is_mesh(axis):
        return {n: axis[n] for n in axis.names}
    return {"model": axis}


def _data_size(axis) -> int:
    return axis["data"].size if is_mesh(axis) else 1


def _model_axis(axis):
    return axis["model"] if is_mesh(axis) else axis


def lane_batch(x: torch.Tensor, axis) -> torch.Tensor:
    """A global ``[B, ...]`` batch as the lanes see it: unchanged on a
    model axis (every rank sees it); on a mesh each lane's data rank's
    slice, ``[L, B/d, ...]`` (lane ``i*t + j`` holds slice i; on a
    ``GroupMesh`` this process's, ``[1, B/d, ...]``)."""
    if not is_mesh(axis):
        return x
    d, t = axis["data"].size, axis["model"].size
    if x.shape[0] % d:
        raise ValueError(f"batch {x.shape[0]} does not split over data {d}")
    xs = x.reshape(d, x.shape[0] // d, *x.shape[1:])
    if spans_processes(axis):
        i = axis["data"].rank
        return xs[i:i + 1]
    return xs.unsqueeze(1).expand(d, t, *xs.shape[1:]).reshape(
        d * t, *xs.shape[1:])


def build_prefill(cfg: ModelConfig, axis, *, record=None, store_ref=None,
                  plan=None):
    """``step(params, batch, caches) -> (last-token logits [L, B, 1, V_t],
    caches)`` on ``axis`` (the model axis, or a (data, model) mesh with
    the batch cut over data), tagged ``prefill``.  A seq-sharded cache is
    filled by prefilling unsharded and cutting it (``seq_shards``).  With
    ``plan=`` the step takes a trailing plan vector (module docstring)."""
    if plan is None:
        def step(params, batch, caches):
            with bind(**_axes_of(axis)), _serving_ctx(
                    "prefill", record, store_ref):
                return lm.prefill(params, cfg, batch, caches)
        return step

    def plan_step(params, batch, caches, plan_vec):
        with bind(**_axes_of(axis)), _serving_ctx(
                "prefill", record, store_ref, plan), \
                api.plan_input(plan_vec):
            return lm.prefill(params, cfg, batch, caches)
    return plan_step


def build_decode(cfg: ModelConfig, axis, cell: ShapeCell | None = None, *,
                 record=None, store_ref=None, plan=None):
    """``step(params, token, caches, t) -> (logits [L, B, 1, V_t],
    caches)`` on ``axis``, tagged ``decode``; ``t`` is a host int.  With
    a seq-sharded ``cell`` the caches' sequence is cut over ``data``
    (``seq_shards``) and the token ``[L, B, 1]`` is the same on every
    data rank.  With ``plan=`` the step takes a trailing plan vector
    (module docstring)."""
    seq = bool(cell is not None and cell.seq_sharded)

    if plan is None:
        def step(params, token, caches, t: int):
            with bind(**_axes_of(axis)), _serving_ctx(
                    "decode", record, store_ref):
                return lm.decode_step(params, cfg, token, caches, t,
                                      seq_sharded=seq)
        return step

    def plan_step(params, token, caches, t: int, plan_vec):
        with bind(**_axes_of(axis)), _serving_ctx(
                "decode", record, store_ref, plan), \
                api.plan_input(plan_vec):
            return lm.decode_step(params, cfg, token, caches, t,
                                  seq_sharded=seq)
    return plan_step


def clone_caches(tree):
    """A copy of a cache tree (each tensor cloned, the filled lengths
    kept): decode writes its caches in place."""
    if isinstance(tree, dict):
        return {k: clone_caches(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone_caches(v) for v in tree]
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def seq_shards(caches, d: int):
    """A prefilled unsharded cache tree on ``t`` model lanes laid out as
    ``d`` sequence shards for a (data d, model t) mesh: each attention
    cache ``[t, B, S, ...]`` becomes ``[d*t, B, S/d, ...]``, lane ``i*t +
    j`` holding model rank j's slots ``[i*S/d, (i+1)*S/d)`` (a view when
    t = B = 1: the shards then write into the prefilled buffers); each
    SSM state (no sequence dim) is copied to every data rank.  The
    filled lengths are kept."""
    def lay(key, x):
        if key in ("k", "v"):
            t, b, s = x.shape[:3]
            if s % d:
                raise ValueError(f"{s} slots do not split into {d} shards")
            y = x.reshape(t, b, d, s // d, *x.shape[3:]).movedim(2, 0)
            return y.reshape(d * t, b, s // d, *x.shape[3:])
        return x.unsqueeze(0).expand(d, *x.shape).reshape(
            d * x.shape[0], *x.shape[1:]).clone()

    def node(key, c):
        if isinstance(c, list):
            return [node(key, v) for v in c]
        if isinstance(c, dict):
            if "c_kv" in c:
                raise NotImplementedError("an MLA cache has no sequence-"
                                          "sharded layout")
            return {k: node(k, v) for k, v in c.items()}
        return c if key == "len" else lay(key, c)
    return node(None, caches)


# ---------------------------------------------------------------------------
# the serve loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ServeResult:
    """``tokens [B, n_tokens]`` (on the device); ``logits``: the full-vocab
    float32 logits ``[B, V_pad]`` each token was picked from (the
    prefill's last position, then each decode step); host seconds of the
    prefill and of the whole decode loop, each ended by a device
    synchronize; the dispatch context (records, footer).  A
    sequence-sharded decode's ``lane_spread``: per decode step, the
    largest difference of any data rank's logits from data rank 0's
    (read after the loop).  ``step_s``: with ``time_steps``, the host
    seconds of each decode step, each ended by a device synchronize."""
    tokens: torch.Tensor
    logits: list[torch.Tensor]
    prefill_s: float
    decode_s: float
    ctx: api.TuneContext
    lane_spread: list[float] | None = None
    step_s: list[float] | None = None

    @property
    def decode_s_per_token(self) -> float:
        return self.decode_s / max(1, len(self.logits) - 1)


def full_vocab(logits: torch.Tensor, d: int = 1) -> torch.Tensor:
    """Vocab-sharded last-position logits ``[L, b, S, V_t]`` -> ``[d*b,
    t*V_t]``: on a (data d, model t) mesh, data rank i's rows after rank
    i - 1's, each row's model shards concatenated in rank order."""
    last = logits[:, :, -1]
    lanes, b, v_t = last.shape
    t = lanes // d
    return last.reshape(d, t, b, v_t).permute(0, 2, 1, 3).reshape(
        d * b, t * v_t)


def _vocab_of(logits: torch.Tensor, axis) -> torch.Tensor:
    """``full_vocab`` on ``axis``: on a process axis the model shards (then
    the data ranks' rows) are gathered with the axes' own
    ``all_gather``, so every rank holds the ``[d*b, t*V_t]`` logits."""
    if not spans_processes(axis):
        return full_vocab(logits, _data_size(axis))
    model = _model_axis(axis)
    last = logits[:, :, -1]                               # [1, b, V_t]
    g = model.all_gather(last, tiled=False)[0]            # [t, b, V_t]
    rows = g.permute(1, 0, 2).reshape(1, last.shape[1], -1)
    if is_mesh(axis):
        rows = axis["data"].all_gather(rows)              # [1, d*b, .]
    return rows[0]


def _greedy(lg: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return (torch.argmax(lg, dim=-1) % cfg.vocab_size)[:, None]


def _sync(axis) -> None:
    """Wait for the device; on a process axis also for every rank (a
    barrier over the axis), so a host time is the slowest rank's."""
    if spans_processes(axis):
        axis.barrier()
    elif axis.device.type == "cuda":
        torch.cuda.synchronize(axis.device)


def _stores(phase_profiles):
    """(base, per-phase) stores: explicit ``phase_profiles``, else those
    of ``$PGTUNE_PROFILE_DIR`` (none when it is unset)."""
    if phase_profiles is not None:
        return None, phase_profiles
    return resolve_stores()


def _decode_loop(cfg, axis, decode, params, caches, tok, t0: int,
                 n_steps: int, seq: bool, extra=(), step_s=None):
    """``n_steps`` greedy decode steps from ``tok [B, 1]`` at position
    ``t0``: (tokens, full-vocab logits, per-step data-lane spreads as
    device scalars, or None).  ``extra``: trailing step arguments (a plan
    vector); a ``step_s`` list gets each step's synchronized seconds."""
    d = _data_size(axis)
    out_tok, out_lg, spread = [], [], []
    for step in range(n_steps):
        if seq:
            lanes = tok.unsqueeze(0).expand(axis.lanes, *tok.shape)
        else:
            lanes = lane_batch(tok, axis)
        if step_s is not None:
            t_a = time.perf_counter()
        logits, caches = decode(params, lanes, caches, t0 + step, *extra)
        if seq and spans_processes(axis):
            # every data rank holds the same logits: gather the data
            # ranks' to read their spread from data rank 0's
            lg = _vocab_of(logits, _model_axis(axis))
            every = axis["data"].all_gather(lg[None], tiled=False)[0]
            spread.append((every - every[:1]).abs().amax())
        elif seq:
            # every data rank holds the same logits: read data rank 0's
            t = _model_axis(axis).size
            per = logits.reshape(d, t, *logits.shape[1:])
            spread.append((per - per[:1]).abs().amax())
            lg = full_vocab(per[0])
        else:
            lg = _vocab_of(logits, axis)
        tok = _greedy(lg, cfg)
        if step_s is not None:
            _sync(axis)
            step_s.append(time.perf_counter() - t_a)
        out_tok.append(tok)
        out_lg.append(lg)
    return out_tok, out_lg, (spread if seq else None)


def serve(cfg: ModelConfig, axis, params, prompts, s_max: int,
          n_tokens: int, *, patches=None, frames=None, phase_profiles=None,
          record=None, store_ref=None, plan=None, plan_vec=None,
          steps=None, time_steps: bool = False) -> ServeResult:
    """Prefill ``prompts [B, S]`` (a VLM's after its ``patches [B, N,
    patch_dim]``; an enc-dec model's with the encoder run on its ``frames
    [B, S_enc, D]`` inside the timed prefill, its cross K/V cached at
    ``S_enc`` positions) and greedy-decode ``n_tokens`` tokens in all (the
    prefill's and ``n_tokens - 1`` decode steps) over the full
    vocabulary, under ``api.tuned(phase_profiles=..., record=...)``; with
    no ``phase_profiles`` the stores of ``$PGTUNE_PROFILE_DIR`` serve, if
    it is set.  ``axis``: the model axis, or a (data, model) mesh that
    cuts the batch over data.  The decode position is a host int (it
    counts a VLM's patches); nothing in the loop waits on the device
    unless ``time_steps`` asks for each step's time (``step_s``).

    Fleet mode: ``store_ref=`` serves the live generation (no
    ``$PGTUNE_PROFILE_DIR`` stores are loaded beside it) and ``plan=``
    dispatches through the plan with ``plan_vec`` (default
    ``plan.vector(store_ref)``).  ``steps=(prefill, decode)`` serves
    through steps the caller built (with the same ``plan``), so that one
    pair of steps serves every epoch."""
    batch, s0 = prompts.shape
    if patches is not None:
        s0 += patches.shape[1]
    if (frames is not None) != (cfg.encdec is not None):
        raise ValueError(f"{cfg.name}: an enc-dec model is served with "
                         "frames, and only it")
    if s0 + n_tokens - 1 > s_max:
        raise ValueError(f"{s0} prompt + {n_tokens - 1} decode tokens exceed "
                         f"the cache's {s_max} slots")
    if steps is None:
        steps = (build_prefill(cfg, axis, plan=plan),
                 build_decode(cfg, axis, plan=plan))
    prefill, decode = steps
    extra = ()
    if plan is not None:
        extra = (plan.vector(store_ref) if plan_vec is None else plan_vec,)
    with bind(**_axes_of(axis)):
        caches = lm.init_caches(cfg, batch, s_max, enc_len=None if frames
                                is None else frames.shape[1])
    inputs = {"tokens": lane_batch(prompts, axis)}
    if patches is not None:
        inputs["patches"] = lane_batch(patches, axis)
    if frames is not None:
        inputs["frames"] = lane_batch(frames, axis)
    base, phase_profiles = ((None, phase_profiles) if store_ref is not None
                            else _stores(phase_profiles))
    step_s = [] if time_steps else None
    with api.tuned(profiles=base, phase_profiles=phase_profiles,
                   record=record, store_ref=store_ref, plan=plan) as ctx:
        _sync(axis)
        t0 = time.perf_counter()
        logits, caches = prefill(params, inputs, caches, *extra)
        lg = _vocab_of(logits, axis)
        tok = _greedy(lg, cfg)
        _sync(axis)
        t1 = time.perf_counter()
        toks, lgs, _ = _decode_loop(cfg, axis, decode, params, caches, tok,
                                    s0, n_tokens - 1, False, extra, step_s)
        _sync(axis)
        t2 = time.perf_counter()
    return ServeResult(torch.cat([tok] + toks, dim=1), [lg] + lgs, t1 - t0,
                       t2 - t1, ctx, step_s=step_s)


def decode_from(cfg: ModelConfig, axis, params, caches, lg0: torch.Tensor,
                t0: int, n_tokens: int, *, cell: ShapeCell | None = None,
                phase_profiles=None, record=None) -> ServeResult:
    """Greedy-decode from prefilled ``caches`` of length ``t0`` whose last
    logits were ``lg0 [B, V_pad]`` (its token is the first of
    ``n_tokens``), under the same context rules as ``serve``.  With a
    seq-sharded ``cell`` the caches are ``seq_shards`` of a prefill on
    ``axis``'s data mesh; the token is the same on every data rank, the
    logits are data rank 0's, and ``lane_spread`` is recorded.  The
    decode writes ``caches`` in place: decoding again from the same
    ``t0`` rewrites the same slots before it reads them."""
    seq = bool(cell is not None and cell.seq_sharded)
    decode = build_decode(cfg, axis, cell)
    tok = _greedy(lg0.float(), cfg)
    base, phase_profiles = _stores(phase_profiles)
    with api.tuned(profiles=base, phase_profiles=phase_profiles,
                   record=record) as ctx:
        _sync(axis)
        t1 = time.perf_counter()
        toks, lgs, spread = _decode_loop(cfg, axis, decode, params, caches,
                                         tok, t0, n_tokens - 1, seq)
        _sync(axis)
        t2 = time.perf_counter()
    return ServeResult(torch.cat([tok] + toks, dim=1), [lg0] + lgs, 0.0,
                       t2 - t1, ctx,
                       None if spread is None else
                       [float(x) for x in spread])


def check_serves(ref: ServeResult, got: ServeResult, rtol: float) -> dict:
    """Hold ``got``'s logits to ``ref``'s, token by token, as the max-norm
    relative error ``max|got - ref| / max|ref|`` <= ``rtol``.  The tokens
    must agree wherever ``ref``'s top-2 margin exceeds twice the absolute
    error (a smaller margin may flip the argmax); after the first step
    whose tokens differ the two runs decode different inputs, so the
    comparison stops there.  Returns ``{"steps", "max_rel_err",
    "diverged_at"}``; raises ``RuntimeError`` on a breach."""
    worst, diverged = 0.0, None
    steps = 0
    for i, (a, b) in enumerate(zip(ref.logits, got.logits)):
        a, b = a.float(), b.float()
        if tuple(a.shape) != tuple(b.shape) or not bool(
                torch.isfinite(b).all()):
            raise RuntimeError(f"step {i}: logits {tuple(b.shape)} not "
                               f"finite or not {tuple(a.shape)}")
        err = (a - b).abs().amax(dim=-1)                     # per row
        rel = float(err.max()) / max(float(a.abs().max()), 1e-30)
        worst = max(worst, rel)
        steps += 1
        if rel > rtol:
            raise RuntimeError(f"step {i}: logits differ by {rel:.3e} "
                               f"(max-norm relative) > {rtol:.3e}")
        ta, tb = ref.tokens[:, i], got.tokens[:, i]
        if not bool(torch.equal(ta, tb)):
            top2 = torch.topk(a, 2, dim=-1).values
            margin = top2[:, 0] - top2[:, 1]
            rows = (ta != tb).nonzero().flatten()
            if bool((margin[rows] > 2 * err[rows]).any()):
                raise RuntimeError(f"step {i}: tokens differ where the top-2 "
                                   "margin exceeds the logits' error")
            diverged = i
            break
    return {"steps": steps, "max_rel_err": worst, "diverged_at": diverged}


def _mesh(spec: str | None, tp: int, device, processes: bool = False):
    """``--mesh dxt`` -> a (data, model) ``StackedMesh``; None -> the model
    axis of ``tp`` ranks.  ``processes``: the same over the processes of
    the world (``GroupMesh``, or a ``GroupAxis`` of every rank)."""
    if spec is None:
        return GroupAxis(device) if processes else StackedAxis(tp, device)
    d, t = (int(v) for v in spec.lower().split("x"))
    make = make_group_mesh if processes else make_host_mesh
    return make((d, t), ("data", "model"), device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tp", type=int, default=2,
                    help="model-parallel degree (ranks stacked on the "
                         "device), without --mesh")
    ap.add_argument("--mesh", default=None,
                    help="dxt: a (data, model) mesh stacked on the device; "
                         "the batch (or at --shape long_500k the cache's "
                         "sequence) is cut over data")
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES),
                    help="a decode shape cell; long_500k decodes one "
                         "request over a sequence-sharded cache (at the "
                         "smoke size: a prompt of --prompt-len)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, prompts, patches and frames")
    ap.add_argument("--device", default=None,
                    help="torch device; the default is the CUDA card")
    ap.add_argument("--out", default="build/serve",
                    help="directory for the trace and the profiles")
    ap.add_argument("--world", type=int, default=None,
                    help="serve across N processes, one rank each: TP N "
                         "(--tp is ignored), or --mesh dxt with d*t = N")
    ap.add_argument("--dist-backend", default="nccl",
                    choices=("nccl", "gloo"),
                    help="the process group's backend with --world (NCCL: "
                         "one rank per GPU; gloo: pass --device cpu)")
    args = ap.parse_args(argv)
    if args.world:
        return spawn(_cli, args.world, backend=args.dist_backend,
                     args=(args,), timeout_s=CLI_TIMEOUT_S)[0]
    return _cli(args)


#: a ``--world`` serve that has not finished by then has hung
CLI_TIMEOUT_S = 900.0


def _cli(args) -> int:
    """The CLI's serve, tune and re-serve, on stacked ranks or (with
    ``--world``) on this rank of the world; rank 0 prints."""
    from repro_torch.configs import get_config
    from repro_torch.core import collectives as C, tuner
    from repro_torch.core.trace import Trace
    from repro_torch.models.params import init_tree, local

    procs = bool(args.world)
    cfg = dataclasses.replace(get_config(args.arch).smoke(),
                              attn_impl="flash")
    cell = SHAPES[args.shape] if args.shape else None
    seq = bool(cell is not None and cell.seq_sharded)
    axis = _mesh(args.mesh, args.tp, args.device, procs)
    say = print if not procs or axis.mesh_rank == 0 else (lambda *a: None)
    if seq and not is_mesh(axis):
        raise SystemExit("--shape long_500k needs --mesh dxt")
    batch = 1 if seq else args.batch
    d = _data_size(axis)
    t = _model_axis(axis).size
    s_max = args.prompt_len + args.tokens + 8
    if cfg.vlm is not None:
        s_max += cfg.vlm.n_patches
    s_max = -(-s_max // d) * d
    gen = torch.Generator(device=axis.device).manual_seed(args.seed)
    params = init_tree(lm.model_specs(cfg, t), gen, axis)
    rng = np.random.default_rng(args.seed)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (batch, args.prompt_len)),
        device=axis.device)
    patches = None
    if cfg.vlm is not None:
        patches = torch.as_tensor(rng.standard_normal(
            (batch, cfg.vlm.n_patches, cfg.vlm.patch_dim),
            dtype=np.float32), device=axis.device)
    frames = None
    if cfg.encdec is not None:
        frames = torch.as_tensor(rng.standard_normal(
            (batch, args.prompt_len * cfg.encdec.dec_ratio, cfg.d_model),
            dtype=np.float32), device=axis.device)
    out = pathlib.Path(args.out)

    if seq:
        # prefill unsharded on the model axis (the same weights: each leaf
        # is one global draw, cut per layout), lay the cache out as d
        # sequence shards, decode over the mesh; hold it to an unsharded
        # decode of a clone of the same cache
        maxis = StackedAxis(t, axis.device)
        if frames is not None:
            raise SystemExit(f"{cfg.name}: an enc-dec model has no "
                             "sequence-sharded decode here")
        gen = torch.Generator(device=axis.device).manual_seed(args.seed)
        mparams = init_tree(lm.model_specs(cfg, t), gen, maxis)
        with bind(model=maxis):
            caches = lm.init_caches(cfg, 1, s_max)
        logits, caches = build_prefill(cfg, maxis)(
            mparams, {"tokens": prompts}, caches)
        lg0 = full_vocab(logits)
        clone = clone_caches(caches)
        shards = local(seq_shards(caches, d), axis)
        s0 = args.prompt_len

        def run(phases=None):
            return decode_from(cfg, axis, params, shards, lg0, s0,
                               args.tokens, cell=cell,
                               phase_profiles=phases)
        first = run()
        yard = decode_from(cfg, maxis, mparams, clone, lg0, s0, args.tokens)
        rep = check_serves(yard, first, rtol=2e-2)
        say(f"seq-sharded decode over {d} shards vs unsharded: logits "
              f"agree to {rep['max_rel_err']:.2e}; data lanes' logits "
              f"spread {max(first.lane_spread):.3e}")
    else:
        def run(phases=None):
            return serve(cfg, axis, params, prompts, s_max, args.tokens,
                         patches=patches, frames=frames,
                         phase_profiles=phases)
        first = run()

    # 1. the default serve's phase-tagged workload trace
    trace = Trace.from_context(first.ctx)
    if not procs or axis.mesh_rank == 0:
        trace.save(out / "trace.jsonl")
    say(trace.summary())

    # 2. tune the recorded op mix, per phase, on this device (across
    # processes: the cells whose world is the world's, on every rank)
    held = (C.wire_held_out("FSDP weights on the quantized wire")
            if is_mesh(axis) else contextlib.nullcontext())
    world = (axis if isinstance(axis, GroupAxis) else GroupAxis(axis.device)
             ) if procs else None
    with held:
        rep = tuner.tune_trace(trace, tuner.MeasuredBackend(
            None, axis.device, axis=world))
    if procs:
        _, phases = publish(rep, out / "profiles", world)
    else:
        shutil.rmtree(out / "profiles", ignore_errors=True)
        rep.save(out / "profiles")
        _, phases = resolve_stores(out / "profiles")
    say(rep.summary())

    # 3. serve again under the tuned per-phase stores
    second = run(phases)
    say("tuned-run dispatch footer:")
    say(api.format_footer(second.ctx))
    report = check_serves(first, second, rtol=2e-2)
    where = (f"mesh data {d} x model {t}" if is_mesh(axis) else f"tp={t}")
    if procs:
        where += (f" over {args.world} processes "
                  f"({args.dist_backend})")
    say(f"arch={cfg.name} (smoke) batch={batch} {where} "
          f"shape={args.shape} prompt={args.prompt_len} "
          f"generated={second.tokens.shape[1]} tokens on {axis.device}; "
          f"default prefill {first.prefill_s:.3f}s decode "
          f"{first.decode_s:.3f}s, tuned prefill {second.prefill_s:.3f}s "
          f"decode {second.decode_s:.3f}s; logits agree to "
          f"{report['max_rel_err']:.2e}")
    say("default tokens:", first.tokens[0, :12].tolist())
    say("tuned tokens:  ", second.tokens[0, :12].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
