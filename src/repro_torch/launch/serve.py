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
``model`` axis, tokens kept on the device; the CLI closes the paper's
offline -> online loop on the recorded traffic::

    python -m repro_torch.launch.serve --device cpu --arch llama3.2-3b

(also ``--arch rwkv6-3b`` and ``--arch zamba2-1.2b``; the smoke-size
config: default serve, recording; ``tune_trace`` with the
measured backend; serve again under the per-phase profiles; the tokens
and logits must agree).  Without ``--device cpu`` it runs on the card.
The fleet mode of the JAX package (``store_ref=``, ``plan=``) and its
builders' own tuning arguments (``profiles=``, ``force=``,
``phase_profiles=``, ``profile_dir=``) are not ported: no caller here
needs them.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import pathlib
import time

import numpy as np
import torch

from repro_torch.core import api
from repro_torch.core._axis import StackedAxis
from repro_torch.core.profiles import resolve_stores
from repro_torch.dist.axes import bind
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig


@contextlib.contextmanager
def _serving_ctx(tag, record):
    """Phase-tag the step under the ambient context; with ``record=``,
    inherit the ambient context's tuning inputs and swap its sink (a
    fresh context would silently shadow a caller-managed api.tuned)."""
    if record is None:
        with api.phase(tag):
            yield
        return
    amb = api._ctx()
    inherited = {} if amb is None else dict(
        profiles=amb.profiles, phase_profiles=amb.phase_profiles,
        force=amb.force or None,
        scratch_budget_bytes=amb.scratch_budget_bytes,
        chunk_bytes=amb.chunk_bytes)
    with api.tuned(record=record, **inherited), api.phase(tag):
        yield


def build_prefill(cfg: ModelConfig, axis: StackedAxis, *, record=None):
    """``step(params, batch, caches) -> (last-token logits [p, B, 1, V_t],
    caches)`` on ``axis``, tagged ``prefill``.  (The JAX package's
    builders also take a shape cell for their mesh specs; the stacked
    axis needs none, and sequence-sharded decode is not ported.)"""
    def step(params, batch, caches):
        with bind(model=axis), _serving_ctx("prefill", record):
            return lm.prefill(params, cfg, batch, caches)
    return step


def build_decode(cfg: ModelConfig, axis: StackedAxis, *, record=None):
    """``step(params, token, caches, t) -> (logits [p, B, 1, V_t],
    caches)`` on ``axis``, tagged ``decode``; ``t`` is a host int."""
    def step(params, token, caches, t: int):
        with bind(model=axis), _serving_ctx("decode", record):
            return lm.decode_step(params, cfg, token, caches, t)
    return step


# ---------------------------------------------------------------------------
# the serve loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ServeResult:
    """``tokens [B, n_tokens]`` (on the device); ``logits``: the full-vocab
    float32 logits ``[B, V_pad]`` each token was picked from (the
    prefill's last position, then each decode step); host seconds of the
    prefill and of the whole decode loop, each ended by a device
    synchronize; the dispatch context (records, footer)."""
    tokens: torch.Tensor
    logits: list[torch.Tensor]
    prefill_s: float
    decode_s: float
    ctx: api.TuneContext

    @property
    def decode_s_per_token(self) -> float:
        return self.decode_s / max(1, len(self.logits) - 1)


def full_vocab(logits: torch.Tensor) -> torch.Tensor:
    """Vocab-sharded last-position logits ``[p, B, S, V_t]`` -> ``[B,
    p*V_t]``, the shards concatenated in rank order."""
    last = logits[:, :, -1]
    return last.permute(1, 0, 2).reshape(last.shape[1], -1)


def _greedy(lg: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return (torch.argmax(lg, dim=-1) % cfg.vocab_size)[:, None]


def _sync(axis: StackedAxis) -> None:
    if axis.device.type == "cuda":
        torch.cuda.synchronize(axis.device)


def serve(cfg: ModelConfig, axis: StackedAxis, params, prompts, s_max: int,
          n_tokens: int, *, phase_profiles=None, record=None) -> ServeResult:
    """Prefill ``prompts [B, S]`` and greedy-decode ``n_tokens`` tokens in
    all (the prefill's and ``n_tokens - 1`` decode steps) over the full
    vocabulary, under ``api.tuned(phase_profiles=..., record=...)``; with
    no ``phase_profiles`` the stores of ``$PGTUNE_PROFILE_DIR`` serve, if
    it is set.  The decode position is a host int; nothing in the loop
    waits on the device."""
    batch, s0 = prompts.shape
    if s0 + n_tokens - 1 > s_max:
        raise ValueError(f"{s0} prompt + {n_tokens - 1} decode tokens exceed "
                         f"the cache's {s_max} slots")
    prefill = build_prefill(cfg, axis)
    decode = build_decode(cfg, axis)
    with bind(model=axis):
        caches = lm.init_caches(cfg, batch, s_max)
    base = None
    if phase_profiles is None:
        base, phase_profiles = resolve_stores()
    with api.tuned(profiles=base, phase_profiles=phase_profiles,
                   record=record) as ctx:
        _sync(axis)
        t0 = time.perf_counter()
        logits, caches = prefill(params, {"tokens": prompts}, caches)
        lg = full_vocab(logits)
        tok = _greedy(lg, cfg)
        out_tok, out_lg = [tok], [lg]
        _sync(axis)
        t1 = time.perf_counter()
        for step in range(n_tokens - 1):
            logits, caches = decode(params, tok, caches, s0 + step)
            lg = full_vocab(logits)
            tok = _greedy(lg, cfg)
            out_tok.append(tok)
            out_lg.append(lg)
        _sync(axis)
        t2 = time.perf_counter()
    return ServeResult(torch.cat(out_tok, dim=1), out_lg, t1 - t0, t2 - t1,
                       ctx)


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


def main(argv=None) -> int:
    from repro_torch.configs import get_config
    from repro_torch.core import tuner
    from repro_torch.core.trace import Trace
    from repro_torch.models.params import init_tree

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tp", type=int, default=2,
                    help="model-parallel degree (ranks stacked on the "
                         "device)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device; the default is the CUDA card")
    ap.add_argument("--out", default="build/serve",
                    help="directory for the trace and the profiles")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(get_config(args.arch).smoke(),
                              attn_impl="flash")
    axis = StackedAxis(args.tp, args.device)
    s_max = args.prompt_len + args.tokens + 8
    gen = torch.Generator(device=axis.device).manual_seed(0)
    params = init_tree(lm.model_specs(cfg, args.tp), gen, axis)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)),
        device=axis.device)

    # 1. default serve, recording the phase-tagged workload trace
    first = serve(cfg, axis, params, prompts, s_max, args.tokens)
    trace = Trace.from_context(first.ctx)
    out = pathlib.Path(args.out)
    trace.save(out / "trace.jsonl")
    print(trace.summary())

    # 2. tune the recorded op mix, per phase, on this device
    rep = tuner.tune_trace(trace, tuner.MeasuredBackend(args.tp,
                                                        axis.device))
    rep.save(out / "profiles")
    print(rep.summary())
    _, phases = resolve_stores(out / "profiles")

    # 3. re-serve with the tuned per-phase stores
    second = serve(cfg, axis, params, prompts, s_max, args.tokens,
                   phase_profiles=phases)
    report = check_serves(first, second, rtol=2e-2)
    print(f"arch={cfg.name} (smoke) batch={args.batch} tp={args.tp} "
          f"prompt={args.prompt_len} generated={second.tokens.shape[1]} "
          f"tokens on {axis.device}; default prefill "
          f"{first.prefill_s:.3f}s decode {first.decode_s:.3f}s, tuned "
          f"prefill {second.prefill_s:.3f}s decode {second.decode_s:.3f}s; "
          f"logits agree to {report['max_rel_err']:.2e}")
    print("default tokens:", first.tokens[0, :12]
          .tolist())
    print("tuned tokens:  ", second.tokens[0, :12].tolist())
    print("tuned-run dispatch footer:")
    print(api.format_footer(second.ctx))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
