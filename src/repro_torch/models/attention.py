"""Attention: dense GQA with sliding windows and softcap, and its caches.

Head sharding contract (TP degree ``t``), as in the JAX package:

* q heads padded up to a multiple of ``t``; each rank owns ``Hq_pad/t``.
* kv heads: if ``kv % t == 0`` the kv projections are model-sharded like
  q; otherwise (kv < t) they are REPLICATED, every rank computes all kv
  heads, and the rank's q-head block picks its kv head by its index.

Cache (batch-sharded): ``{"k", "v": [p, B, S_max, KVloc, hd], "len": int}``
with the filled length a host ``int``, so a decode step never syncs with
the device to learn its position.  Prefill and decode write the cache IN
PLACE (the JAX package returns updated copies, which its jit aliases onto
the donated buffers).

``attn_impl="flash"`` goes through ``kernels.flash_attention`` (the Hopper
kernel on CUDA tensors; there is no fallback), and where a gradient is
needed through its autograd Function ``FlashAttention`` (the same
kernel forward, a backward through the plain version, as the JAX package
differentiates ``_flash_jnp``); ``"ref"`` goes through the dense
``_sdpa``.  MLA, cross-attention and sequence-sharded decode come
with later slices.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.dist import ops
from repro_torch.dist.axes import AXES, axis_index, axis_size_or_1
from repro_torch.kernels.flash_attention import FlashAttention, flash_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import needs_grad, rms_norm, rope
from repro_torch.models.params import ParamSpec

NEG = -1e30


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


def attn_specs(cfg: ModelConfig, tp: int) -> dict:
    if cfg.mla is not None:
        raise NotImplementedError("attention block kind 'mla' is not ported "
                                  "yet (a later slice)")
    d, hd, dt = cfg.d_model, cfg.hd, cfg.dtype
    hq = cfg.heads_padded(tp)
    kv_sharded = cfg.n_kv_heads % tp == 0
    kv_dim = ("model" if kv_sharded else None)
    n_kv = cfg.n_kv_heads
    specs = {
        "w_q": ParamSpec((d, hq * hd), ("data", "model"), dtype=dt),
        "w_k": ParamSpec((d, n_kv * hd), ("data", kv_dim), dtype=dt),
        "w_v": ParamSpec((d, n_kv * hd), ("data", kv_dim), dtype=dt),
        "w_o": ParamSpec((hq * hd, d), ("model", "data"), dtype=dt),
    }
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((hd,), (None,), init="zeros",
                                    dtype="float32")
        specs["k_norm"] = ParamSpec((hd,), (None,), init="zeros",
                                    dtype="float32")
    return specs


# ---------------------------------------------------------------------------
# masks and the dense path
# ---------------------------------------------------------------------------


def make_mask(q_pos, kv_pos, *, kind: str, window: int = 0,
              n_prefix: int = 0, kv_len_valid=None):
    """Boolean ``[.., Sq, Skv]`` attend-mask.

    kind: "causal" | "local" (causal & window) | "prefix" (bidirectional
    for kv_pos < n_prefix, else causal) | "full" (encoder).
    ``kv_len_valid``: positions >= it are invalid (unfilled cache).
    """
    q = q_pos[..., :, None]
    k = kv_pos[..., None, :]
    if kind == "full":
        m = torch.ones(torch.broadcast_shapes(q.shape, k.shape),
                       dtype=torch.bool, device=q.device)
    elif kind == "causal":
        m = k <= q
    elif kind == "local":
        m = (k <= q) & (k > q - window)
    elif kind == "prefix":
        m = (k <= q) | (k < n_prefix)
    else:
        raise ValueError(kind)
    if kv_len_valid is not None:
        m = m & (k < kv_len_valid)
    return m


def _sdpa(q, k, v, mask, *, softcap=None, scale=None):
    """q ``[N, Sq, H, dh]``, k/v ``[N, Skv, H, dh]``, mask broadcast to
    ``[N?, Sq, Skv]`` -> ``[N, Sq, H, dh]``: float32 scores, p rounded to
    v's dtype before the PV product."""
    dh = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s * (scale if scale is not None else 1.0 / math.sqrt(dh))
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    m = mask[:, None, :, :] if mask.dim() == 3 else mask
    s = torch.where(m, s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                        v.float()).to(v.dtype)


def _repeat_kv(k, n_rep: int):
    """``[..., S, H, hd] -> [..., S, H*n_rep, hd]``, each head repeated."""
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=-2)


def _rank_heads(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-rank head selection: ``t [p, B, S, H, hd]``, ``idx [p, h]`` ->
    ``[p, B, S, h, hd]`` (rank r takes heads ``idx[r]``)."""
    p, b, s, _, hd = t.shape
    index = idx.view(p, 1, 1, -1, 1).expand(p, b, s, idx.shape[1], hd)
    return torch.gather(t, 3, index)


def _grouped_kv(k_loc, v_loc, cfg: ModelConfig, tp: int, hq_loc: int,
                kv_sharded: bool):
    """(k_sel, v_sel, group_size) for the grouped flash path.

    kv_sharded: kv already local -> group = hq_loc / kv_loc.
    replicated kv (kv < tp): a rank's contiguous q block maps to exactly
    ONE kv head, selected per rank by its index."""
    if kv_sharded:
        kv_loc = k_loc.shape[3]
        if hq_loc % kv_loc:
            raise ValueError(f"{hq_loc} local q heads over {kv_loc} kv heads")
        return k_loc, v_loc, hq_loc // kv_loc
    hq = cfg.heads_padded(tp)
    g_all = max(hq // cfg.n_kv_heads, 1)
    if hq_loc > g_all:
        raise ValueError("local q block spans several kv heads; the grouped "
                         "flash path needs hq_loc <= hq/n_kv for "
                         "replicated kv")
    t_idx = axis_index(AXES.model)
    kv_head = ((t_idx * hq_loc) // g_all).view(-1, 1)
    return (_rank_heads(k_loc, kv_head), _rank_heads(v_loc, kv_head),
            hq_loc)


def _local_kv_select(k_all, cfg: ModelConfig, tp: int):
    """From the replicated all-kv-heads tensor ``[p, B, S, n_kv, hd]``,
    each rank's kv per local q head ``[p, B, S, hq_loc, hd]``."""
    hq = cfg.heads_padded(tp)
    hq_loc = hq // tp
    n_kv = cfg.n_kv_heads
    rep = hq // n_kv if hq % n_kv == 0 else -1
    full = _repeat_kv(k_all, max(rep, 1))                # [p,B,S,hq?,hd]
    if full.shape[3] < hq:                               # ragged: tile
        reps = -(-hq // full.shape[3])
        full = full.repeat(1, 1, 1, reps, 1)[:, :, :, :hq]
    t_idx = axis_index(AXES.model)
    idx = t_idx[:, None] * hq_loc + torch.arange(hq_loc,
                                                 device=t_idx.device)
    return _rank_heads(full, idx)


def _flash_args(kind: str, window: int) -> tuple[bool, int]:
    """(causal, window) of the kernel for a mask kind."""
    if kind == "causal":
        return True, 0
    if kind == "local":
        return True, window
    if kind == "full":
        return False, 0
    raise NotImplementedError(f"mask kind {kind!r} has no flash path yet "
                              "(the vlm slice)")


# ---------------------------------------------------------------------------
# the attention block
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AttnOut:
    y: torch.Tensor
    cache: dict | None = None


def attention(p: dict, cfg: ModelConfig, x, *, pos, kind: str = "causal",
              cache: dict | None = None, mode: str = "train") -> AttnOut:
    """One attention sub-block (no residual/norm — the stack handles those).

    x: ``[p, B, S, D]`` replicated over TP.  pos: ``[1, S]`` absolute
    positions, ``pos0 + arange(S)`` (the same for every rank and row),
    with ``pos0`` 0 in train and prefill mode and the cache's length in
    decode: the flash path takes its query offset from the mode, as a host
    int, and never reads ``pos``.  mode: train | prefill | decode.  cache
    (prefill out / decode in-out): ``{"k","v": [p, B, S_max, KVloc, hd],
    "len": int}``.
    """
    if cfg.mla is not None:
        raise NotImplementedError("attention block kind 'mla' is not ported "
                                  "yet (a later slice)")
    tp = axis_size_or_1(AXES.model)
    hq = cfg.heads_padded(tp)
    hq_loc = hq // tp
    hd = cfg.hd
    kv_sharded = cfg.n_kv_heads % tp == 0
    lead = x.shape[:-1]                                  # (p, B, S)

    q = ops.col_matmul(x, p["w_q"], fsdp_dim=0).reshape(*lead, hq_loc, hd)
    if kv_sharded:
        k = ops.col_matmul(x, p["w_k"], fsdp_dim=0)
        v = ops.col_matmul(x, p["w_v"], fsdp_dim=0)
    else:
        k = ops.matmul_accumulate(x, ops.tp_psum_grad(p["w_k"]))
        v = ops.matmul_accumulate(x, ops.tp_psum_grad(p["w_v"]))
    n_kv_loc = (cfg.n_kv_heads // tp) if kv_sharded else cfg.n_kv_heads
    k = k.reshape(*lead, n_kv_loc, hd)
    v = v.reshape(*lead, n_kv_loc, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)

    s_new = x.shape[2]
    pos0 = 0
    new_cache = None
    if mode == "train":
        k_loc, v_loc, kv_start, kv_valid = k, v, 0, None
    elif mode == "prefill":
        _cache_write(cache["k"], k, 0)
        _cache_write(cache["v"], v, 0)
        new_cache = {"k": cache["k"], "v": cache["v"], "len": s_new}
        k_loc, v_loc, kv_start, kv_valid = k, v, 0, None
    elif mode == "decode":
        t = cache["len"]
        _cache_write(cache["k"], k, t)
        _cache_write(cache["v"], v, t)
        new_cache = {"k": cache["k"], "v": cache["v"], "len": t + s_new}
        k_loc, v_loc, kv_start, kv_valid = (cache["k"], cache["v"], 0,
                                            t + s_new)
        pos0 = t
    else:
        raise ValueError(mode)

    if (cfg.attn_impl == "flash" and mode == "decode" and kind == "local"
            and cfg.window < k_loc.shape[2]):
        # decode only attends inside the window: take the window's slots
        # of the cache (a view) instead of streaming all S_max of them
        start = min(max(kv_valid - cfg.window, 0),
                    k_loc.shape[2] - cfg.window)
        k_loc = k_loc[:, :, start:start + cfg.window]
        v_loc = v_loc[:, :, start:start + cfg.window]
        kv_start = start

    if cfg.attn_impl == "flash":
        if kv_valid is not None:
            # only the filled slots (a view): the replicated-kv branch
            # copies the heads it selects
            k_loc = k_loc[:, :, :kv_valid - kv_start]
            v_loc = v_loc[:, :, :kv_valid - kv_start]
        k_sel, v_sel, g = _grouped_kv(k_loc, v_loc, cfg, tp, hq_loc,
                                      kv_sharded)
        nb = lead[0] * lead[1]
        qg = q.reshape(nb, s_new, k_sel.shape[3], g, hd)
        causal, window = _flash_args(kind, cfg.window)
        # positions relative to the first key passed: the masks depend on
        # differences only
        kf, vf = k_sel.flatten(0, 1), v_sel.flatten(0, 1)
        softcap = cfg.attn_softcap or 0.0
        if needs_grad(qg, kf, vf):
            o = FlashAttention.apply(qg, kf, vf, causal, window, softcap,
                                     pos0 - kv_start, None)
        else:
            o = flash_attention(qg, kf, vf, causal=causal, window=window,
                                softcap=softcap, q0=pos0 - kv_start)
        o = o.reshape(*lead, hq_loc * hd)
    else:
        if kv_sharded:
            k_use = _repeat_kv(k_loc, hq_loc // k_loc.shape[3])
            v_use = _repeat_kv(v_loc, hq_loc // v_loc.shape[3])
        else:
            k_use = _local_kv_select(k_loc, cfg, tp)
            v_use = _local_kv_select(v_loc, cfg, tp)
        kv_pos = torch.arange(k_use.shape[2], device=x.device)[None]
        mask = make_mask(pos, kv_pos, kind=kind, window=cfg.window,
                         kv_len_valid=kv_valid)
        o = _sdpa(q.flatten(0, 1), k_use.flatten(0, 1), v_use.flatten(0, 1),
                  mask, softcap=cfg.attn_softcap)
        o = o.reshape(*lead, hq_loc * hd)
    y = ops.row_matmul(o, p["w_o"], fsdp_dim=1)
    return AttnOut(y=y, cache=new_cache)


def _cache_write(buf, kv, t: int):
    """Write a ``[p, B, s, ...]`` update at slot ``t`` of ``buf``, in
    place."""
    buf[:, :, t:t + kv.shape[2]] = kv.to(buf.dtype)
