"""Model assembly: spec trees, forward pass, prefill and decode.

The port's counterpart of the JAX package's ``models/lm.py`` for the
decoder-only LMs: dense (llama / gemma style: ``attn`` and ``attn_local``
blocks with a gated MLP), MoE (phi3.5: the MLP is ``models.moe``'s
expert-parallel block, whose load-balance loss the forward returns; and
deepseek-v3, whose attention is MLA), SSM (rwkv6: ``rwkv`` blocks) and
hybrid (zamba2: ``mamba`` blocks with one ``shared_attn`` block, its
weights shared, after every ``hybrid_period`` of them) and the VLM
(paligemma: a gemma stack behind a prefix of stub image-patch
embeddings, projected by ``img_proj``, under the prefix-LM mask) and
the encoder-decoder (whisper: a bidirectional encoder over stub frame
embeddings, ``params["encoder"]``, and a decoder whose blocks add
cross-attention to the encoder's output, its K/V cached per block as
``cross_k``/``cross_v``; no rope anywhere, sincos positions added to the
frames and to the token embeddings).

Every function runs inside ``dist.axes.bind(model=axis)`` (or, for
training, ``bind(data=axis)``, or both names as views of one
``StackedMesh``): tensors carry the lane dim first (``[L, B, S,
...]``); tokens are ``[B, S]`` ids that every rank sees, or under the
data axis each lane's own ``[L, B/d, S]`` slice (VLM patches likewise,
``[B, N, patch_dim]`` or ``[L, B/d, N, patch_dim]``).  Layers run in a
Python loop; a scanned group of the JAX package (``stack_plan``) is a
list of per-layer parameter subtrees here (``models.params``).

``seq_sharded=True`` (decode only; the ``long_500k`` cell) keeps every
attention cache's sequence sharded over ``data`` (``attention.
_decode_seq_sharded``) and the SSM states replicated over it.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.dist import ops
from repro_torch.dist.axes import AXES, axis_size_or_1, get_axis, has_axis
from repro_torch.models import ssm
from repro_torch.models.attention import (attention, attn_specs,
                                          cross_attn_specs)
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import moe_block, moe_specs
from repro_torch.models.layers import (embed_lookup, embed_specs, head_specs,
                                       lm_logits, mlp, mlp_specs, rms_norm,
                                       sharded_xent, sincos_positions)
from repro_torch.models.params import ParamSpec, torch_dtype


# ---------------------------------------------------------------------------
# stack plan: group the layer pattern into repeating units
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Group:
    name: str
    unit: tuple[str, ...]     # block kinds executed per repetition
    n_rep: int                # repetitions


def stack_plan(cfg: ModelConfig) -> list[Group]:
    """The JAX package's grouping: a ``shared_attn`` marker after every
    ``hybrid_period`` layers (zamba2); then one unit per layer when
    ``scan_layers`` is off, else the largest prefix of whole units
    (``layer_pattern``, times ``hybrid_period`` plus the marker for a
    hybrid) as one group and the remainder as another."""
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
        raise ValueError(f"unknown block kind {kind!r}")
    s = {
        "ln1": ParamSpec((cfg.d_model,), (None,), init="zeros",
                         dtype="float32"),
        "attn": attn_specs(cfg, tp),
        "ln2": ParamSpec((cfg.d_model,), (None,), init="zeros",
                         dtype="float32"),
        "ffn": (moe_specs(cfg) if cfg.moe is not None
                else mlp_specs(cfg.d_model, cfg.d_ff, cfg.dtype)),
    }
    if cfg.encdec is not None:
        s["ln_x"] = ParamSpec((cfg.d_model,), (None,), init="zeros",
                              dtype="float32")
        s["xattn"] = cross_attn_specs(cfg, tp)
    return s


def _enc_block_specs(cfg: ModelConfig, tp: int) -> dict:
    return {
        "ln1": ParamSpec((cfg.d_model,), (None,), init="zeros",
                         dtype="float32"),
        "attn": attn_specs(dataclasses.replace(cfg, mla=None), tp),
        "ln2": ParamSpec((cfg.d_model,), (None,), init="zeros",
                         dtype="float32"),
        "ffn": mlp_specs(cfg.d_model, cfg.d_ff, cfg.dtype),
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
    attention block.  An enc-dec model's encoder is ``"encoder"``, a list
    of ``n_enc_layers`` per-layer subtrees (the JAX package's stacked
    leaves), and ``"enc_final_norm"``."""
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
    if cfg.encdec is not None:
        specs["encoder"] = [_enc_block_specs(cfg, tp)
                            for _ in range(cfg.encdec.n_enc_layers)]
        specs["enc_final_norm"] = ParamSpec((cfg.d_model,), (None,),
                                            init="zeros", dtype="float32")
    if cfg.vlm is not None:
        specs["img_proj"] = ParamSpec((cfg.vlm.patch_dim, cfg.d_model),
                                      ("data", None), dtype=cfg.dtype)
    return specs


def _shared_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, moe=None, mla=None)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def cache_specs(cfg: ModelConfig, batch: int, s_max: int, tp: int, *,
                seq_sharded: bool = False, enc_len: int | None = None) -> dict:
    """``ParamSpec`` tree of the KV and SSM caches (global shapes +
    shardings): a KV cache per attention block and per ``shared_attn``
    occurrence (MLA: the latent ``c_kv`` and the rope key ``k_rope``,
    replicated over the model axis), the token-shift / conv tails and the
    float32 state S per SSM block.  The batch dim is cut over ``data``;
    with ``seq_sharded`` the attention caches' sequence dim is instead,
    and the SSM states (no sequence dim) are replicated over it.  The
    JAX package's ``"len"`` leaf is a host int that ``init_caches``
    adds.  An enc-dec model's attention blocks also cache the encoder's
    K/V, ``cross_k``/``cross_v [batch, enc_len, n_kv, hd]``; ``enc_len``
    defaults to ``s_max``, the JAX package's convention (its prefill then
    replaces the buffers by ones of the encoder's real length;
    ``init_caches`` takes the real one)."""
    hd = cfg.hd
    kv_dim = "model" if cfg.n_kv_heads % tp == 0 else None
    n_kv = cfg.n_kv_heads
    # seq-sharded: the sequence over data, the batch (and the SSM states,
    # which have no sequence dim) replicated over it
    bdim, sdim = (None, "data") if seq_sharded else ("data", None)

    def attn_cache():
        if cfg.mla is not None:
            m = cfg.mla
            return {"self": {
                "c_kv": ParamSpec((batch, s_max, m.kv_lora_rank),
                                  (bdim, sdim, None), dtype=cfg.dtype),
                "k_rope": ParamSpec((batch, s_max, m.rope_head_dim),
                                    (bdim, sdim, None), dtype=cfg.dtype),
            }}
        return {"self": {
            "k": ParamSpec((batch, s_max, n_kv, hd),
                           (bdim, sdim, kv_dim, None), dtype=cfg.dtype),
            "v": ParamSpec((batch, s_max, n_kv, hd),
                           (bdim, sdim, kv_dim, None), dtype=cfg.dtype),
        }}

    dt, d = cfg.dtype, cfg.d_model

    def ssm_cache(kind):
        if kind == "rwkv":
            h = ssm.rwkv_heads_padded(cfg, tp)
            sd = cfg.ssm.head_dim
            return {
                "last_tm": ParamSpec((batch, 1, d), (bdim, None, None),
                                     dtype=dt),
                "last_cm": ParamSpec((batch, 1, d), (bdim, None, None),
                                     dtype=dt),
                "s": ParamSpec((batch, h, sd, sd),
                               (bdim, "model", None, None),
                               dtype="float32"),
            }
        di = cfg.ssm.expand * d
        nh = di // cfg.ssm.head_dim
        k = cfg.ssm.conv_kernel
        return {
            "conv_x": ParamSpec((batch, k - 1, di), (bdim, None, "model"),
                                dtype=dt),
            "conv_bc": ParamSpec((batch, k - 1, 2 * cfg.ssm.state_dim),
                                 (bdim, None, None), dtype=dt),
            "s": ParamSpec((batch, nh, cfg.ssm.state_dim, cfg.ssm.head_dim),
                           (bdim, "model", None, None), dtype="float32"),
        }

    def block_cache(kind):
        if kind in ("rwkv", "mamba"):
            return ssm_cache(kind)
        c = attn_cache()
        if cfg.encdec is not None and kind != "shared_attn":
            n = s_max if enc_len is None else enc_len
            for key in ("cross_k", "cross_v"):
                c[key] = ParamSpec((batch, n, n_kv, hd),
                                   (bdim, None, kv_dim, None),
                                   dtype=cfg.dtype)
        return c

    return {"stack": {g.name: _per_group(g, lambda g=g: {
        f"b{i}_{kind}": block_cache(kind) for i, kind in enumerate(g.unit)})
        for g in stack_plan(cfg)}}


def init_caches(cfg: ModelConfig, batch_size: int, s_max: int, *,
                seq_sharded: bool = False, enc_len: int | None = None):
    """Zero caches for the bound axes (``model``, and ``data`` where it is
    bound: the global batch, or with ``seq_sharded`` the global
    sequence, cut over it): ``[L, B_loc, S_loc, KVloc, hd]`` per
    attention block, each with ``"len": 0``, and ``[L, *local]`` SSM
    states.  An MLA cache's ``c_kv`` and ``k_rope`` are the column blocks
    of one ``[L, B, S_max, kvr + dr]`` buffer, so the absorbed path reads
    its keys, ``concat(c_kv, k_rope)``, as a view
    (``attention.latent_keys``).  An enc-dec model's cross K/V buffers
    hold ``enc_len`` encoder positions (default ``s_max``): prefill writes
    the encoder's K/V into them in place, and raises where the encoder's
    length is another."""
    axis = get_axis(AXES.model)
    sizes = {"model": axis.size}
    if has_axis(AXES.data):
        sizes["data"] = get_axis(AXES.data).size
    specs = cache_specs(cfg, batch_size, s_max, axis.size,
                        seq_sharded=seq_sharded, enc_len=enc_len)

    def mk(s: ParamSpec):
        return torch.zeros((axis.lanes,) + s.local_shape(sizes),
                           dtype=torch_dtype(s.dtype), device=axis.device)

    def node(sp):
        if isinstance(sp, ParamSpec):
            return mk(sp)
        if isinstance(sp, list):
            return [node(n) for n in sp]
        if "c_kv" in sp:
            c, r = sp["c_kv"], sp["k_rope"]
            buf = mk(dataclasses.replace(
                c, shape=c.shape[:-1] + (c.shape[-1] + r.shape[-1],)))
            kvr = c.shape[-1]
            return {"c_kv": buf[..., :kvr], "k_rope": buf[..., kvr:],
                    "len": 0}
        out = {k: node(v) for k, v in sp.items()}
        return {**out, "len": 0} if "k" in sp else out

    return node(specs)


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------


def _run_attn_block(p, cfg: ModelConfig, x, *, kind, pos, mode, cache,
                    n_prefix: int = 0, enc_out=None,
                    seq_sharded: bool = False):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    mask_kind = ("local" if kind == "attn_local" else
                 ("prefix" if n_prefix else "causal"))
    a = attention(p["attn"], cfg, h, pos=pos, kind=mask_kind,
                  n_prefix=n_prefix,
                  cache=None if cache is None else cache["self"], mode=mode,
                  use_rope=cfg.encdec is None, seq_sharded=seq_sharded)
    x = x + a.y
    new_cache = {"self": a.cache} if a.cache is not None else None
    if cfg.encdec is not None:
        x, new_cache = _run_cross(p, cfg, x, pos=pos, cache=cache,
                                  new_cache=new_cache, enc_out=enc_out)
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.moe is not None:
        y, aux = moe_block(p["ffn"], cfg, h2)
    else:
        y, aux = mlp(p["ffn"], h2), 0.0
    return x + y, new_cache, aux


def _run_cross(p, cfg: ModelConfig, x, *, pos, cache, new_cache, enc_out):
    """The decoder's cross-attention sub-block: ``x + xattn(ln_x(x))``
    over the encoder's K/V, projected from ``enc_out`` (train, prefill;
    prefill writes them into the cache's ``cross_k``/``cross_v`` in
    place) or read from the cache (decode: ``enc_out`` None, the encoder
    never re-projected).  Returns ``(x, new_cache)``."""
    hx = rms_norm(x, p["ln_x"], cfg.norm_eps)
    if enc_out is None:
        ck, cv = cache["cross_k"], cache["cross_v"]
    else:
        ck, cv = _cross_kv(p["xattn"], cfg, enc_out)
        if cache is not None:                   # prefill
            _write_cross(cache, ck, cv)
    ca = attention(p["xattn"], cfg, hx, pos=pos, cross_kv=(ck, cv),
                   mode="train", use_rope=False)
    if new_cache is not None:               # prefill, decode
        new_cache = {**new_cache, "cross_k": cache["cross_k"],
                     "cross_v": cache["cross_v"]}
    return x + ca.y, new_cache


def _write_cross(cache, ck, cv) -> None:
    """The encoder's K/V into the cache's cross buffers, in place; raises
    where the buffers hold another number of encoder positions."""
    for key, t in (("cross_k", ck), ("cross_v", cv)):
        buf = cache[key]
        if buf.shape != t.shape:
            raise ValueError(f"the cache's {key} holds {buf.shape[2]} "
                             f"encoder positions, the encoder gave "
                             f"{t.shape[2]} (init_caches(..., "
                             f"enc_len={t.shape[2]}))")
        buf.copy_(t)


def _cross_kv(p, cfg: ModelConfig, enc_out):
    """The encoder's K/V for one decoder block, ``[p, B, S_enc, KVloc,
    hd]`` each: ``col_matmul(fsdp_dim=0)`` where the KV heads are sharded
    over the model axis, else every rank projects all of them
    (``matmul_accumulate`` over ``tp_psum_grad``)."""
    tp = axis_size_or_1(AXES.model)
    kv_sharded = cfg.n_kv_heads % tp == 0
    if kv_sharded:
        k = ops.col_matmul(enc_out, p["w_k"], fsdp_dim=0)
        v = ops.col_matmul(enc_out, p["w_v"], fsdp_dim=0)
    else:
        k = ops.matmul_accumulate(enc_out, ops.tp_psum_grad(p["w_k"]))
        v = ops.matmul_accumulate(enc_out, ops.tp_psum_grad(p["w_v"]))
    n_loc = cfg.n_kv_heads // tp if kv_sharded else cfg.n_kv_heads
    shape = (*enc_out.shape[:-1], n_loc, cfg.hd)
    return k.reshape(shape), v.reshape(shape)


def _run_block(kind, p, cfg: ModelConfig, x, *, pos, mode, cache, shared_p,
               resid0, n_prefix: int = 0, enc_out=None,
               seq_sharded: bool = False):
    """One block of any ported kind; returns ``(x, new_cache, aux)``
    (aux: the MoE load-balance loss ``[L]``, else 0.0)."""
    if kind in ("attn", "attn_local"):
        return _run_attn_block(p, cfg, x, kind=kind, pos=pos, mode=mode,
                               cache=cache, n_prefix=n_prefix,
                               enc_out=enc_out, seq_sharded=seq_sharded)
    if kind == "shared_attn":
        # zamba2: the shared block on concat(x, resid0), projected in
        h = ops.matmul_accumulate(torch.cat([x, resid0], dim=-1),
                                  shared_p["proj_in"])
        y, c, aux = _run_attn_block(shared_p, _shared_cfg(cfg), h,
                                    kind="attn", pos=pos, mode=mode,
                                    cache=cache, n_prefix=n_prefix,
                                    seq_sharded=seq_sharded)
        return x + y, c, aux
    if kind == "rwkv":
        return (*ssm.rwkv_block(p, cfg, x, state=cache), 0.0)
    if kind == "mamba":
        return (*ssm.mamba_block(p, cfg, x, state=cache), 0.0)
    raise ValueError(kind)


def _run_stack(params, cfg: ModelConfig, x, *, pos, mode, caches,
               n_prefix: int = 0, enc_out=None, seq_sharded: bool = False):
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
                    shared_p=shared_p, resid0=resid0, n_prefix=n_prefix,
                    enc_out=enc_out, seq_sharded=seq_sharded)
                aux_total = aux_total + aux
                if nc is not None:
                    ncs[key] = nc
            out.append(ncs)
        new_caches["stack"][g.name] = out if g.n_rep > 1 else out[0]
    return x, (new_caches if caches is not None else None), aux_total


def _lane_patches(patches: torch.Tensor, lanes: int) -> torch.Tensor:
    """VLM patches (or enc-dec frames) as a stacked operand: ``[B, N, P]``
    that every lane sees become ``[L, B, N, P]``; under the data axis they
    are each lane's own ``[L, B/d, N, P]`` already (as token ids,
    ``rank_ids``)."""
    if has_axis(AXES.data):
        return patches
    return patches.unsqueeze(0).expand(lanes, *patches.shape)


def _embed_inputs(params, cfg: ModelConfig, batch, *, pos0: int = 0):
    """Returns ``(x, pos, n_prefix)``: the embedded inputs ``[p, B, S,
    D]``, the positions ``[1, S]`` and the length of the prefix-LM prefix
    (VLM: the image patches, projected by ``img_proj`` through
    ``matmul_accumulate`` and placed before the text; else 0).  An
    enc-dec model adds the sincos embeddings of the positions (from
    ``pos0`` in decode)."""
    scale = (cfg.d_model ** 0.5) if cfg.scale_embed else None
    x = embed_lookup(params["embed"], batch["tokens"], scale=scale)
    n_prefix = 0
    if cfg.vlm is not None and "patches" in batch:
        w = params["img_proj"]
        patches = _lane_patches(batch["patches"], w.shape[0]).to(w.dtype)
        img = ops.matmul_accumulate(patches, w).to(x.dtype)
        x = torch.cat([img, x], dim=2)
        n_prefix = img.shape[2]
    pos = pos0 + torch.arange(x.shape[2], device=x.device)[None, :]
    if cfg.encdec is not None:
        x = x + sincos_positions(pos, cfg.d_model).to(x.dtype)
    return x, pos, n_prefix


def _encode(params, cfg: ModelConfig, frames):
    """The enc-dec encoder over stub frame embeddings ``[B, S_enc, D]``
    (every lane's, or under the data axis each lane's ``[L, B/d, S_enc,
    D]``): sincos positions added, then per layer bidirectional attention
    (mask ``"full"``, no rope, mode ``"train"``: no cache) and the gated
    MLP, each behind its RMS norm; the final norm.  Returns ``[L, B,
    S_enc, D]``."""
    lanes = params["enc_final_norm"].shape[0]
    x = _lane_patches(frames, lanes).to(torch_dtype(cfg.dtype))
    pos = torch.arange(x.shape[2], device=x.device)[None, :]
    x = x + sincos_positions(pos, cfg.d_model).to(x.dtype)
    for lp in params["encoder"]:
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a = attention(lp["attn"], cfg, h, pos=pos, kind="full",
                      mode="train", use_rope=False)
        x = x + a.y
        x = x + mlp(lp["ffn"], rms_norm(x, lp["ln2"], cfg.norm_eps))
    return rms_norm(x, params["enc_final_norm"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def forward(params, cfg: ModelConfig, batch, *, mode: str = "train",
            caches=None, pos0: int = 0, seq_sharded: bool = False,
            last_only: bool = False):
    """Full forward.  Returns ``(logits [p, B, S, V_t], new_caches, aux)``:
    aux is the MoE load-balance loss summed over the layers, ``[p]``, and
    0.0 for a model with no MoE block.  ``last_only``: the logits of the
    last position only, ``[p, B, 1, V_t]`` (they are per position, so the
    values are the same).  An enc-dec model's batch may carry ``frames``
    (train, prefill): the encoder runs on them and every decoder block
    attends to its output; without them (decode) the blocks read the
    cached cross K/V."""
    enc_out = None
    if cfg.encdec is not None and "frames" in batch:
        enc_out = _encode(params, cfg, batch["frames"])
    x, pos, n_prefix = _embed_inputs(params, cfg, batch, pos0=pos0)
    x, new_caches, aux = _run_stack(params, cfg, x, pos=pos, mode=mode,
                                    caches=caches, n_prefix=n_prefix,
                                    enc_out=enc_out, seq_sharded=seq_sharded)
    if last_only:
        x = x[:, :, -1:]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_logits(params["embed"], x,
                       params.get("head") if not cfg.tie_embeddings else None,
                       final_softcap=cfg.final_softcap)
    return logits, new_caches, aux


def loss_fn(params, cfg: ModelConfig, batch):
    """Next-token cross-entropy plus 0.01 of the MoE load-balance loss:
    ``(loss [p], {"nll", "aux"})``, each rank's mean over its tokens (a
    VLM's text positions only: the logits after its patches)."""
    logits, _, aux = forward(params, cfg, batch, mode="train")
    if cfg.vlm is not None:
        logits = logits[:, :, cfg.vlm.n_patches:]
    mask = batch.get("mask")
    loss = sharded_xent(logits[:, :, :-1], batch["labels"][..., 1:],
                        None if mask is None else mask[..., 1:])
    return loss + 0.01 * aux, {"nll": loss, "aux": aux}


def prefill(params, cfg: ModelConfig, batch, caches, *,
            seq_sharded: bool = False):
    """Fill caches from a prompt; returns ``(last-token logits [p, B, 1,
    V_t], caches)``.  Only the last position's logits are computed (at
    524 288 positions the whole ``[S, V_t]`` would not fit the card).

    A sequence-sharded prefill raises: the JAX package's writes the
    whole prompt at slot 0 of every shard (its ``attention`` prefill
    branch ignores the sharding) and nothing calls it, since ``long_500k``
    is a decode cell.  Prefill unsharded and lay the cache out as
    sequence shards (``launch.serve.seq_shards``)."""
    if seq_sharded:
        raise NotImplementedError(
            "prefill over a sequence-sharded cache is not supported: "
            "prefill unsharded, then lay the cache out as sequence shards "
            "(launch.serve.seq_shards)")
    logits, new_caches, _ = forward(params, cfg, batch, mode="prefill",
                                    caches=caches, last_only=True)
    return logits, new_caches


def decode_step(params, cfg: ModelConfig, token, caches, t: int, *,
                seq_sharded: bool = False):
    """One-token step.  token: ``[B, 1]`` ids (on the device; under the
    data axis each lane's ``[L, B/d, 1]``); t: the current length, a host
    int, so the step never waits on the device.  ``seq_sharded``: the
    attention caches' sequence is sharded over ``data``."""
    logits, new_caches, _ = forward(params, cfg, {"tokens": token},
                                    mode="decode", caches=caches, pos0=t,
                                    seq_sharded=seq_sharded)
    return logits, new_caches

