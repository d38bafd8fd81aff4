"""Model assembly: spec trees, forward pass, prefill and decode.

The port's counterpart of the JAX package's ``models/lm.py`` for the
decoder-only LMs: dense (llama / gemma style: ``attn`` and ``attn_local``
blocks with a gated MLP), MoE (phi3.5: the MLP is ``models.moe``'s
expert-parallel block, whose load-balance loss the forward returns), SSM
(rwkv6: ``rwkv`` blocks) and hybrid (zamba2: ``mamba`` blocks with one
``shared_attn`` block, its weights shared, after every ``hybrid_period``
of them).  The other families raise ``NotImplementedError`` naming the
kind: ``mla``, ``encdec`` and ``vlm`` come with later slices.

Every function runs inside ``dist.axes.bind(model=axis)`` (or, for
training, ``bind(data=axis)``): tensors carry the rank dim first
(``[p, B, S, ...]``); tokens are ``[B, S]`` ids that every rank sees, or
under the data axis each rank's own ``[p, B/p, S]`` slice.  Layers run
in a Python loop; a scanned group of the JAX package (``stack_plan``) is
a list of per-layer parameter subtrees here (``models.params``).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.dist import ops
from repro_torch.dist.axes import AXES, get_axis
from repro_torch.models import ssm
from repro_torch.models.attention import attention, attn_specs
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import moe_block, moe_specs
from repro_torch.models.layers import (embed_lookup, embed_specs, head_specs,
                                       lm_logits, mlp, mlp_specs, rms_norm,
                                       sharded_xent)
from repro_torch.models.params import ParamSpec, torch_dtype, tree_map_specs


# ---------------------------------------------------------------------------
# stack plan: group the layer pattern into repeating units
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Group:
    name: str
    unit: tuple[str, ...]     # block kinds executed per repetition
    n_rep: int                # repetitions


def _unsupported(cfg: ModelConfig) -> list[str]:
    kinds = [k for k in cfg.pattern()
             if k not in ("attn", "attn_local", "rwkv", "mamba")]
    for name in ("mla", "encdec", "vlm"):
        if getattr(cfg, name) is not None:
            kinds.append(name)
    return sorted(set(kinds))


def stack_plan(cfg: ModelConfig) -> list[Group]:
    """The JAX package's grouping: a ``shared_attn`` marker after every
    ``hybrid_period`` layers (zamba2); then one unit per layer when
    ``scan_layers`` is off, else the largest prefix of whole units
    (``layer_pattern``, times ``hybrid_period`` plus the marker for a
    hybrid) as one group and the remainder as another."""
    bad = _unsupported(cfg)
    if bad:
        raise NotImplementedError(f"{cfg.name}: block kinds {bad} are not "
                                  "ported yet (later slices)")
    pat = list(cfg.pattern())
    if cfg.hybrid_period:
        out = []
        for i, k in enumerate(pat):
            out.append(k)
            if (i + 1) % cfg.hybrid_period == 0:
                out.append("shared_attn")
        pat = out
    if not cfg.scan_layers:
        return [Group(f"u{i}", (k,), 1) for i, k in enumerate(pat)]
    unit = list(cfg.layer_pattern)
    if cfg.hybrid_period:
        unit = unit * cfg.hybrid_period + ["shared_attn"]
    u = len(unit)
    n_rep = 0
    while (n_rep + 1) * u <= len(pat) and \
            pat[n_rep * u:(n_rep + 1) * u] == unit:
        n_rep += 1
    groups = []
    if n_rep:
        groups.append(Group("g0", tuple(unit), n_rep))
    rem = pat[n_rep * u:]
    if rem:
        groups.append(Group("g1", tuple(rem), 1))
    return groups


def _block_specs(kind: str, cfg: ModelConfig, tp: int) -> dict:
    if kind == "rwkv":
        return ssm.rwkv_specs(cfg, tp)
    if kind == "mamba":
        return ssm.mamba_specs(cfg, tp)
    if kind not in ("attn", "attn_local"):
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")
    return {
        "ln1": ParamSpec((cfg.d_model,), (None,), init="zeros",
                         dtype="float32"),
        "attn": attn_specs(cfg, tp),
        "ln2": ParamSpec((cfg.d_model,), (None,), init="zeros",
                         dtype="float32"),
        "ffn": (moe_specs(cfg) if cfg.moe is not None
                else mlp_specs(cfg.d_model, cfg.d_ff, cfg.dtype)),
    }


def _per_group(g: Group, fn) -> Any:
    """One subtree per repetition of a group with n_rep > 1 (a list), the
    subtree itself otherwise."""
    if g.n_rep > 1:
        return [fn() for _ in range(g.n_rep)]
    return fn()


def model_specs(cfg: ModelConfig, tp: int) -> dict:
    """The full parameter tree (``ParamSpec`` leaves; a scanned group is a
    list of per-layer subtrees).  A hybrid's shared attention block lives
    outside the stack, under ``"shared_attn"``: ``proj_in [2D, D]`` and one
    attention block."""
    specs: dict[str, Any] = {"embed": embed_specs(
        cfg.vocab_padded, cfg.d_model, cfg.dtype)}
    if not cfg.tie_embeddings:
        specs["head"] = head_specs(cfg.d_model, cfg.vocab_padded, cfg.dtype)
    specs["final_norm"] = ParamSpec((cfg.d_model,), (None,), init="zeros",
                                    dtype="float32")
    stack: dict[str, Any] = {}
    for g in stack_plan(cfg):
        stack[g.name] = _per_group(g, lambda g=g: {
            f"b{i}_{kind}": _block_specs(kind, cfg, tp)
            for i, kind in enumerate(g.unit) if kind != "shared_attn"})
    specs["stack"] = stack
    if cfg.hybrid_period:
        specs["shared_attn"] = {
            "proj_in": ParamSpec((2 * cfg.d_model, cfg.d_model),
                                 ("data", None), dtype=cfg.dtype),
            **_block_specs("attn", _shared_cfg(cfg), tp)}
    return specs


def _shared_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, moe=None, mla=None)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def cache_specs(cfg: ModelConfig, batch: int, s_max: int, tp: int) -> dict:
    """``ParamSpec`` tree of the KV and SSM caches (global shapes +
    shardings): a KV cache per attention block and per ``shared_attn``
    occurrence, the token-shift / conv tails and the float32 state S per
    SSM block."""
    hd = cfg.hd
    kv_dim = "model" if cfg.n_kv_heads % tp == 0 else None
    n_kv = cfg.n_kv_heads

    def attn_cache():
        return {"self": {
            "k": ParamSpec((batch, s_max, n_kv, hd),
                           ("data", None, kv_dim, None), dtype=cfg.dtype),
            "v": ParamSpec((batch, s_max, n_kv, hd),
                           ("data", None, kv_dim, None), dtype=cfg.dtype),
        }}

    dt, d = cfg.dtype, cfg.d_model

    def ssm_cache(kind):
        if kind == "rwkv":
            h = ssm.rwkv_heads_padded(cfg, tp)
            sd = cfg.ssm.head_dim
            return {
                "last_tm": ParamSpec((batch, 1, d), ("data", None, None),
                                     dtype=dt),
                "last_cm": ParamSpec((batch, 1, d), ("data", None, None),
                                     dtype=dt),
                "s": ParamSpec((batch, h, sd, sd),
                               ("data", "model", None, None),
                               dtype="float32"),
            }
        di = cfg.ssm.expand * d
        nh = di // cfg.ssm.head_dim
        k = cfg.ssm.conv_kernel
        return {
            "conv_x": ParamSpec((batch, k - 1, di), ("data", None, "model"),
                                dtype=dt),
            "conv_bc": ParamSpec((batch, k - 1, 2 * cfg.ssm.state_dim),
                                 ("data", None, None), dtype=dt),
            "s": ParamSpec((batch, nh, cfg.ssm.state_dim, cfg.ssm.head_dim),
                           ("data", "model", None, None), dtype="float32"),
        }

    def block_cache(kind):
        return ssm_cache(kind) if kind in ("rwkv", "mamba") else attn_cache()

    return {"stack": {g.name: _per_group(g, lambda g=g: {
        f"b{i}_{kind}": block_cache(kind) for i, kind in enumerate(g.unit)})
        for g in stack_plan(cfg)}}


def init_caches(cfg: ModelConfig, batch_size: int, s_max: int):
    """Zero caches for the bound model axis: ``[p, B, S_max, KVloc, hd]``
    per attention block, each with ``"len": 0``, and ``[p, *local]`` SSM
    states."""
    axis = get_axis(AXES.model)
    specs = cache_specs(cfg, batch_size, s_max, axis.size)

    def mk(s: ParamSpec):
        return torch.zeros((axis.size,) + s.local_shape({"model": axis.size}),
                           dtype=torch_dtype(s.dtype), device=axis.device)

    tree = tree_map_specs(mk, specs)

    def add_len(node):
        if isinstance(node, torch.Tensor):
            return node
        if isinstance(node, list):
            return [add_len(n) for n in node]
        if "k" in node:
            return {**node, "len": 0}
        return {k: add_len(v) for k, v in node.items()}

    return add_len(tree)


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------


def _run_attn_block(p, cfg: ModelConfig, x, *, kind, pos, mode, cache):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    mask_kind = "local" if kind == "attn_local" else "causal"
    a = attention(p["attn"], cfg, h, pos=pos, kind=mask_kind,
                  cache=None if cache is None else cache["self"], mode=mode)
    x = x + a.y
    new_cache = {"self": a.cache} if a.cache is not None else None
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.moe is not None:
        y, aux = moe_block(p["ffn"], cfg, h2)
    else:
        y, aux = mlp(p["ffn"], h2), 0.0
    return x + y, new_cache, aux


def _run_block(kind, p, cfg: ModelConfig, x, *, pos, mode, cache, shared_p,
               resid0):
    """One block of any ported kind; returns ``(x, new_cache, aux)``
    (aux: the MoE load-balance loss ``[L]``, else 0.0)."""
    if kind in ("attn", "attn_local"):
        return _run_attn_block(p, cfg, x, kind=kind, pos=pos, mode=mode,
                               cache=cache)
    if kind == "shared_attn":
        # zamba2: the shared block on concat(x, resid0), projected in
        h = ops.matmul_accumulate(torch.cat([x, resid0], dim=-1),
                                  shared_p["proj_in"])
        y, c, aux = _run_attn_block(shared_p, _shared_cfg(cfg), h,
                                    kind="attn", pos=pos, mode=mode,
                                    cache=cache)
        return x + y, c, aux
    if kind == "rwkv":
        return (*ssm.rwkv_block(p, cfg, x, state=cache), 0.0)
    if kind == "mamba":
        return (*ssm.mamba_block(p, cfg, x, state=cache), 0.0)
    raise ValueError(kind)


def _run_stack(params, cfg: ModelConfig, x, *, pos, mode, caches):
    """Every layer in order; returns ``(x, new_caches, aux)``, aux summed
    over the layers.  ``resid0``, the embedding output, feeds every
    ``shared_attn`` block."""
    aux_total = 0.0
    new_caches: dict[str, Any] = {"stack": {}}
    resid0 = x
    shared_p = params.get("shared_attn")
    for g in stack_plan(cfg):
        gp = params["stack"][g.name]
        gc = None if caches is None else caches["stack"][g.name]
        reps = gp if g.n_rep > 1 else [gp]
        creps = (gc if g.n_rep > 1 else [gc]) if gc is not None else \
            [None] * len(reps)
        out = []
        for lp, lc in zip(reps, creps):
            ncs = {}
            for i, kind in enumerate(g.unit):
                key = f"b{i}_{kind}"
                x, nc, aux = _run_block(
                    kind, lp.get(key), cfg, x, pos=pos, mode=mode,
                    cache=None if lc is None else lc[key],
                    shared_p=shared_p, resid0=resid0)
                aux_total = aux_total + aux
                if nc is not None:
                    ncs[key] = nc
            out.append(ncs)
        new_caches["stack"][g.name] = out if g.n_rep > 1 else out[0]
    return x, (new_caches if caches is not None else None), aux_total


def _embed_inputs(params, cfg: ModelConfig, batch, *, pos0: int = 0):
    """Returns ``(x, pos)``: the embedded tokens ``[p, B, S, D]`` and the
    positions ``[1, S]``."""
    scale = (cfg.d_model ** 0.5) if cfg.scale_embed else None
    x = embed_lookup(params["embed"], batch["tokens"], scale=scale)
    pos = pos0 + torch.arange(x.shape[2], device=x.device)[None, :]
    return x, pos


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def forward(params, cfg: ModelConfig, batch, *, mode: str = "train",
            caches=None, pos0: int = 0):
    """Full forward.  Returns ``(logits [p, B, S, V_t], new_caches, aux)``:
    aux is the MoE load-balance loss summed over the layers, ``[p]``, and
    0.0 for a model with no MoE block."""
    x, pos = _embed_inputs(params, cfg, batch, pos0=pos0)
    x, new_caches, aux = _run_stack(params, cfg, x, pos=pos, mode=mode,
                               caches=caches)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(params["embed"], x,
                       params.get("head") if not cfg.tie_embeddings else None,
                       final_softcap=cfg.final_softcap)
    return logits, new_caches, aux


def loss_fn(params, cfg: ModelConfig, batch):
    """Next-token cross-entropy plus 0.01 of the MoE load-balance loss:
    ``(loss [p], {"nll", "aux"})``, each rank's mean over its tokens."""
    logits, _, aux = forward(params, cfg, batch, mode="train")
    mask = batch.get("mask")
    loss = sharded_xent(logits[:, :, :-1], batch["labels"][..., 1:],
                        None if mask is None else mask[..., 1:])
    return loss + 0.01 * aux, {"nll": loss, "aux": aux}


def prefill(params, cfg: ModelConfig, batch, caches):
    """Fill caches from a prompt; returns ``(last-token logits [p, B, 1,
    V_t], caches)``."""
    logits, new_caches, _ = forward(params, cfg, batch, mode="prefill",
                                    caches=caches)
    return logits[:, :, -1:], new_caches


def decode_step(params, cfg: ModelConfig, token, caches, t: int):
    """One-token step.  token: ``[B, 1]`` ids (on the device); t: the
    current length, a host int, so the step never waits on the device."""
    logits, new_caches, _ = forward(params, cfg, {"tokens": token},
                                    mode="decode", caches=caches, pos0=t)
    return logits, new_caches

