"""Attention: dense GQA with sliding windows and softcap, DeepSeek's
multi-head latent attention (MLA), and their caches.

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

Sequence-sharded cache (``seq_sharded=True`` in decode, the long-context
``long_500k`` cell): ``{"k", "v": [L, B, S_max/d, KVloc, hd], "len":
int}`` with data rank i holding the absolute slots ``[i*S_loc,
(i+1)*S_loc)``.  A decode step writes the new token's k/v into its owner
shard only, every shard computes flash-decoding partials over its slots
(``_sdpa_partial``: unnormalized output, row sum, row max), and the
partials combine over ``data``: the max through ``StackedAxis.pmax``
(undispatched, as the JAX package's ``lax.pmax``), the two sums through
``api.allreduce`` (dispatched and tunable).

``attn_impl="flash"`` goes through ``kernels.flash_attention`` (the Hopper
kernel on CUDA tensors; there is no fallback), and where a gradient is
needed through its autograd Function ``FlashAttention`` (the same
kernel forward, a backward through the plain version, as the JAX package
differentiates ``_flash_jnp``); ``"ref"`` goes through the dense
``_sdpa``.  The prefix-LM mask (``kind="prefix"``, the VLM) runs the
kernel twice: the prefix rows non-causal over the prefix keys, the text
rows causal over every key from their own offset (``_flash_prefix``).

MLA (``_attention_mla``, the JAX package's ``models/attention.py:463``):
the query through a low-rank ``w_dq`` / ``w_uq`` pair, keys and values
from one latent ``c_kv`` (``kv_lora_rank`` wide, shared by every head)
plus one rope key (``rope_head_dim``) shared by every head.  Its cache is
that latent and rope key, ``{"c_kv": [p, B, S_max, kvr], "k_rope": [p,
B, S_max, dr], "len": int}``, replicated over the model axis; the port
allocates the two as column views of one ``[p, B, S_max, kvr + dr]``
buffer (``models.lm.init_caches``), so the absorbed path reads the
latent keys in place.  ``attn_impl="flash"`` is the ABSORBED form:
``w_uk`` folded into the query (``q_eff``, kvr wide) and ``w_uv`` into the
output, so attention runs over the latent itself, one KV head with the
rank's heads as its group, q and k ``kvr + dr`` = 576 wide and v the
latent's 512 columns (a view of k), through ``kernels.flash_attention``'s
``"mla"`` path with scale ``1 / sqrt(nope + rope)``.  ``"ref"`` is the
NAIVE form: the latent up-projected per use by ``w_ukv`` and the dense
``_sdpa``.

Cross-attention (the enc-dec family, whisper): ``attention(...,
cross_kv=(k, v))`` projects q only and attends to the encoder's k and v
(``models.lm._cross_kv``) with the ``"full"`` mask, no rope and no cache
write; on flash that is one non-causal launch.  Where the KV heads are
replicated (``n_kv % tp != 0``) each rank takes its one KV head, as for
self-attention: the JAX package's flash path treats a cross K/V as
sharded there (``src/repro/models/attention.py:370-371``) and picks the
wrong heads; the port follows its ``ref`` path.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import api
from repro_torch.core._axis import spans_processes
from repro_torch.dist import ops
from repro_torch.dist.axes import (AXES, axis_index, axis_size_or_1,
                                   get_axis, has_axis)
from repro_torch.kernels.flash_attention import FlashAttention, flash_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import needs_grad, rms_norm, rope
from repro_torch.models.params import ParamSpec

NEG = -1e30


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


def attn_specs(cfg: ModelConfig, tp: int) -> dict:
    d, hd, dt = cfg.d_model, cfg.hd, cfg.dtype
    hq = cfg.heads_padded(tp)
    if cfg.mla is not None:
        m = cfg.mla
        qk_hd = m.nope_head_dim + m.rope_head_dim
        return {
            "w_dq": ParamSpec((d, m.q_lora_rank), ("data", None), dtype=dt),
            "q_norm": ParamSpec((m.q_lora_rank,), (None,), init="zeros",
                                dtype="float32"),
            "w_uq": ParamSpec((m.q_lora_rank, hq * qk_hd), ("data", "model"),
                              dtype=dt),
            "w_dkv": ParamSpec((d, m.kv_lora_rank + m.rope_head_dim),
                               ("data", None), dtype=dt),
            "kv_norm": ParamSpec((m.kv_lora_rank,), (None,), init="zeros",
                                 dtype="float32"),
            "w_ukv": ParamSpec(
                (m.kv_lora_rank, hq * (m.nope_head_dim + m.v_head_dim)),
                ("data", "model"), dtype=dt),
            "w_o": ParamSpec((hq * m.v_head_dim, d), ("model", "data"),
                             dtype=dt),
        }
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


def cross_attn_specs(cfg: ModelConfig, tp: int) -> dict:
    """Decoder cross-attention (whisper): q from the decoder, k and v from
    the encoder's output (``models.lm._cross_kv``)."""
    return attn_specs(dataclasses.replace(cfg, mla=None), tp)


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


def _sdpa_partial(q, k, v, mask, *, softcap=None):
    """Flash-decoding partial over the local keys, grouped: q ``[...,
    Sq, HK, G, dh]``, k/v ``[..., Skv, HK, dh]`` (each KV head serves its
    G query heads; no KV head is repeated), mask broadcast to ``[...,
    Sq, Skv]``.  Returns ``(o, l, m)``: the unnormalized output ``[...,
    Sq, HK, G, dv]`` in v's dtype (the weights rounded to it before the
    product), the row sums and row maxima ``[..., HK, G, Sq]`` in
    float32.  Masked scores are the finite ``NEG``, so a shard whose
    slots are all masked has ``m = NEG`` and drops out of the combine
    (``exp(NEG - max) = 0``)."""
    dh = q.shape[-1]
    s = torch.einsum("...qhgd,...khd->...hgqk", q.float(),
                     k.float()) / math.sqrt(dh)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(mask[..., None, None, :, :], s,
                    torch.full((), NEG, dtype=s.dtype, device=s.device))
    m = s.amax(-1)
    w = torch.exp(s - m[..., None])
    l = w.sum(-1)
    o = torch.einsum("...hgqk,...khd->...qhgd", w.to(v.dtype), v)
    return o, l, m


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
    """(causal, window) of the kernel for a mask kind; the prefix-LM mask
    is two launches (``_flash_prefix``)."""
    if kind == "causal":
        return True, 0
    if kind == "local":
        return True, window
    if kind == "full":
        return False, 0
    raise ValueError(f"mask kind {kind!r} is not one launch of the flash "
                     "kernel")


def _flash(q, k, v, *, causal, window, softcap, q0, scale=None):
    """One launch: the autograd Function where a gradient is needed, the
    bare kernel otherwise (serving)."""
    if needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window, softcap, q0,
                                    None, scale)
    return flash_attention(q, k, v, causal=causal, window=window,
                           softcap=softcap, q0=q0, scale=scale)


def _flash_prefix(q, k, v, *, n_prefix: int, softcap, q0: int):
    """The prefix-LM mask ``(k <= q) | (k < n_prefix)`` as two launches of
    the kernel, keys from position 0: a query row before ``n_prefix``
    sees exactly the keys before ``n_prefix`` (non-causal over them), a
    row at or past it exactly the keys up to itself (causal from its
    offset).  The outputs are concatenated along S."""
    sq = q.shape[1]
    cut = min(max(n_prefix - q0, 0), sq)
    outs = []
    if cut:
        outs.append(_flash(q[:, :cut], k[:, :n_prefix], v[:, :n_prefix],
                           causal=False, window=0, softcap=softcap, q0=0))
    if cut < sq:
        outs.append(_flash(q[:, cut:], k, v, causal=True, window=0,
                           softcap=softcap, q0=q0 + cut))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# the attention block
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AttnOut:
    y: torch.Tensor
    cache: dict | None = None


def attention(p: dict, cfg: ModelConfig, x, *, pos, kind: str = "causal",
              n_prefix: int = 0, cache: dict | None = None,
              mode: str = "train", cross_kv=None, use_rope: bool = True,
              seq_sharded: bool = False) -> AttnOut:
    """One attention sub-block (no residual/norm — the stack handles those).

    x: ``[p, B, S, D]`` replicated over TP.  pos: ``[1, S]`` absolute
    positions, ``pos0 + arange(S)`` (the same for every rank and row),
    with ``pos0`` 0 in train and prefill mode and the cache's length in
    decode: the flash path takes its query offset from the mode, as a host
    int, and never reads ``pos``.  kind: causal | local | prefix (with
    ``n_prefix``) | full.  mode: train | prefill | decode.  cache
    (prefill out / decode in-out): ``{"k","v": [p, B, S_max, KVloc, hd],
    "len": int}``; with ``seq_sharded`` (decode only) the cache's
    sequence is sharded over ``data`` (``_decode_seq_sharded``).
    ``use_rope``: rotate q and k (off for the enc-dec family, whose
    positions are sincos embeddings).  ``cross_kv``: the encoder's ``(k,
    v)`` ``[p, B, S_enc, KVloc, hd]`` (``models.lm._cross_kv``) for
    cross-attention: q is projected (no rope), every encoder position is
    seen (mask ``"full"``), and nothing is cached, whatever the mode.
    """
    if seq_sharded and mode != "decode":
        raise NotImplementedError(f"a sequence-sharded cache is read in "
                                  f"decode mode only, not {mode}")
    if cfg.mla is not None and cross_kv is None:
        if seq_sharded:
            raise NotImplementedError("sequence-sharded decode of an MLA "
                                      "cache is not supported")
        return _attention_mla(p, cfg, x, pos=pos, kind=kind, cache=cache,
                              mode=mode)
    tp = axis_size_or_1(AXES.model)
    hq = cfg.heads_padded(tp)
    hq_loc = hq // tp
    hd = cfg.hd
    kv_sharded = cfg.n_kv_heads % tp == 0
    lead = x.shape[:-1]                                  # (p, B, S)

    q = ops.col_matmul(x, p["w_q"], fsdp_dim=0).reshape(*lead, hq_loc, hd)
    if cross_kv is not None:
        k_loc, v_loc = cross_kv
        o = _attend(cfg, q, k_loc, v_loc, pos, kind="full", n_prefix=0,
                    pos0=0, kv_start=0, kv_valid=None)
        return AttnOut(y=ops.row_matmul(o, p["w_o"], fsdp_dim=1))
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
    if use_rope:
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
        if seq_sharded:
            o, new_cache = _decode_seq_sharded(cfg, q, k, v, cache,
                                               kind=kind)
            return AttnOut(y=ops.row_matmul(o, p["w_o"], fsdp_dim=1),
                           cache=new_cache)
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

    o = _attend(cfg, q, k_loc, v_loc, pos, kind=kind, n_prefix=n_prefix,
                pos0=pos0, kv_start=kv_start, kv_valid=kv_valid)
    y = ops.row_matmul(o, p["w_o"], fsdp_dim=1)
    return AttnOut(y=y, cache=new_cache)


def _attend(cfg: ModelConfig, q, k_loc, v_loc, pos, *, kind: str,
            n_prefix: int, pos0: int, kv_start: int, kv_valid):
    """The rank's heads attended: q ``[p, B, Sq, hq_loc, hd]`` (query i at
    position ``pos0 + i``) over k/v ``[p, B, Skv, KVloc, hd]`` (key j at
    position ``kv_start + j``; with ``kv_valid``, the keys before it
    only) -> ``[p, B, Sq, hq_loc*hd]``.  Flash groups each KV head's q
    heads (a replicated KV tensor, ``n_kv % tp != 0``, gives each rank
    its one KV head, also for an encoder's cross K/V); ``ref`` repeats
    the KV heads to the q heads and masks densely."""
    tp = axis_size_or_1(AXES.model)
    hq_loc, hd = q.shape[3], q.shape[4]
    lead = q.shape[:3]
    kv_sharded = cfg.n_kv_heads % tp == 0
    if cfg.attn_impl == "flash":
        if kv_valid is not None:
            # only the filled slots (a view): the replicated-kv branch
            # copies the heads it selects
            k_loc = k_loc[:, :, :kv_valid - kv_start]
            v_loc = v_loc[:, :, :kv_valid - kv_start]
        k_sel, v_sel, g = _grouped_kv(k_loc, v_loc, cfg, tp, hq_loc,
                                      kv_sharded)
        nb = lead[0] * lead[1]
        qg = q.reshape(nb, lead[2], k_sel.shape[3], g, hd)
        # positions relative to the first key passed: the masks depend on
        # differences only
        kf, vf = k_sel.flatten(0, 1), v_sel.flatten(0, 1)
        softcap = cfg.attn_softcap or 0.0
        if kind == "prefix":
            o = _flash_prefix(qg, kf, vf, n_prefix=n_prefix,
                              softcap=softcap, q0=pos0 - kv_start)
        else:
            causal, window = _flash_args(kind, cfg.window)
            o = _flash(qg, kf, vf, causal=causal, window=window,
                       softcap=softcap, q0=pos0 - kv_start)
        return o.reshape(*lead, hq_loc * hd)
    if kv_sharded:
        k_use = _repeat_kv(k_loc, hq_loc // k_loc.shape[3])
        v_use = _repeat_kv(v_loc, hq_loc // v_loc.shape[3])
    else:
        k_use = _local_kv_select(k_loc, cfg, tp)
        v_use = _local_kv_select(v_loc, cfg, tp)
    kv_pos = torch.arange(k_use.shape[2], device=q.device)[None]
    mask = make_mask(pos, kv_pos, kind=kind, window=cfg.window,
                     n_prefix=n_prefix, kv_len_valid=kv_valid)
    o = _sdpa(q.flatten(0, 1), k_use.flatten(0, 1), v_use.flatten(0, 1),
              mask, softcap=cfg.attn_softcap)
    return o.reshape(*lead, hq_loc * hd)


def _cache_write(buf, kv, t: int):
    """Write a ``[p, B, s, ...]`` update at slot ``t`` of ``buf``, in
    place."""
    buf[:, :, t:t + kv.shape[2]] = kv.to(buf.dtype)


def _lanes_at(axis, rank: int):
    """The lanes whose coordinate on ``axis`` is ``rank``: a slice when
    they are contiguous (the mesh's outer axis), else an index tensor."""
    lanes = [i for i in range(axis.lanes)
             if (i // axis.stride) % axis.p == rank]
    if lanes[-1] - lanes[0] == len(lanes) - 1:
        return slice(lanes[0], lanes[-1] + 1)
    return torch.tensor(lanes, device=axis.device)


def _decode_seq_sharded(cfg: ModelConfig, q, k_new, v_new, cache, *,
                        kind: str):
    """Flash-decoding over a sequence-sharded cache (the data axis).

    q ``[L, B, 1, hq_loc, hd]``, k_new/v_new ``[L, B, 1, KVloc, hd]``;
    cache k/v ``[L, B, S_loc, KVloc, hd]``, data rank i holding the
    absolute slots ``[i*S_loc, (i+1)*S_loc)``, ``"len"`` the global
    length t before this token (a host int).  The new token goes to slot
    ``t % S_loc`` of the lanes of data rank ``t // S_loc`` only (on a
    process axis, by the process whose data rank that is); every
    lane takes its partial over its own slots (grouped heads, no repeated
    cache) and the partials combine over ``data``: the maxima through
    ``StackedAxis.pmax``, the weighted outputs and row sums through
    ``api.allreduce``.  Returns ``(o [L, B, 1, hq_loc*hd], new_cache)``."""
    if q.shape[2] != 1:
        raise ValueError(f"sequence-sharded decode takes one token a step, "
                         f"got {q.shape[2]}")
    data = get_axis(AXES.data) if has_axis(AXES.data) else None
    d = data.size if data is not None else 1
    s_loc = cache["k"].shape[2]
    t = cache["len"]
    owner, slot = divmod(t, s_loc)
    if owner >= d:
        raise ValueError(f"the cache's {d} x {s_loc} slots are full at {t}")
    if data is None:
        sel = slice(None)
    elif spans_processes(data):
        # one lane a process: write where this data rank owns the slot
        sel = slice(0, 1) if data.rank == owner else None
    else:
        sel = _lanes_at(data, owner)
    if sel is not None:
        for buf, new in ((cache["k"], k_new), (cache["v"], v_new)):
            buf[sel, :, slot] = new[sel, :, 0].to(buf.dtype)
    new_cache = {"k": cache["k"], "v": cache["v"], "len": t + 1}

    tp = axis_size_or_1(AXES.model)
    hq_loc = cfg.heads_padded(tp) // tp
    kv_sharded = cfg.n_kv_heads % tp == 0
    k_sel, v_sel, g = _grouped_kv(cache["k"], cache["v"], cfg, tp, hq_loc,
                                  kv_sharded)
    lanes, b = q.shape[:2]
    qg = q.reshape(lanes, b, 1, k_sel.shape[3], g, cfg.hd)
    d_idx = (axis_index(AXES.data) if data is not None else
             torch.zeros(lanes, dtype=torch.int64, device=q.device))
    kv_pos = d_idx[:, None] * s_loc + torch.arange(s_loc, device=q.device)
    qpos = torch.full((1, 1), t, dtype=torch.int64, device=q.device)
    mask = make_mask(qpos, kv_pos, kind=kind, window=cfg.window,
                     kv_len_valid=t + 1)                      # [L, 1, S_loc]
    o, l, m = _sdpa_partial(qg, k_sel, v_sel, mask[:, None],
                            softcap=cfg.attn_softcap)
    # o [L, B, 1, HK, G, dh]; l, m [L, B, HK, G, 1]
    if data is not None:
        a = torch.exp(m - data.pmax(m))
        a_o = a.permute(0, 1, 4, 2, 3)[..., None].to(o.dtype)
        num = api.allreduce((o * a_o).reshape(lanes, b, 1, hq_loc, cfg.hd),
                            data)
        den = api.allreduce((l * a).reshape(lanes, b, hq_loc, 1), data)
    else:
        num = o.reshape(lanes, b, 1, hq_loc, cfg.hd)
        den = l.reshape(lanes, b, hq_loc, 1)
    o = num / torch.clamp(den, min=1e-30).transpose(2, 3)[..., None].to(
        num.dtype)
    return o.reshape(lanes, b, 1, hq_loc * cfg.hd), new_cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek multi-head latent attention)
# ---------------------------------------------------------------------------


def latent_keys(c_kv: torch.Tensor, k_rope: torch.Tensor) -> torch.Tensor:
    """The one ``[..., kvr + dr]`` buffer, ``concat(c_kv, k_rope)``, whose
    adjacent column blocks an MLA cache's ``c_kv`` and ``k_rope`` are
    (``models.lm.init_caches`` makes them so), as a view.  Raises for
    two tensors that are not."""
    kvr = c_kv.shape[-1]
    if not (k_rope.dtype == c_kv.dtype
            and k_rope.shape[:-1] == c_kv.shape[:-1]
            and k_rope.stride() == c_kv.stride() and c_kv.stride(-1) == 1
            and k_rope.data_ptr() == c_kv.data_ptr()
            + kvr * c_kv.element_size()):
        raise ValueError("an MLA cache's c_kv and k_rope must be adjacent "
                         "column blocks of one buffer "
                         "(models.lm.init_caches)")
    return c_kv.as_strided((*c_kv.shape[:-1], kvr + k_rope.shape[-1]),
                           c_kv.stride())


def _attention_mla(p: dict, cfg: ModelConfig, x, *, pos, kind: str,
                   cache: dict | None, mode: str) -> AttnOut:
    """MLA with the JAX package's collectives: ``matmul_accumulate`` for
    ``w_dq`` and (over ``tp_psum_grad``) ``w_dkv``, ``col_matmul(fsdp_dim=
    0)`` for ``w_uq`` (and the naive path's ``w_ukv``), ``fsdp_gather`` of
    ``w_ukv`` on the absorbed path, ``row_matmul(fsdp_dim=1)`` for
    ``w_o``.  x ``[p, B, S, D]``, pos ``[1, S]``; cache ``{"c_kv",
    "k_rope", "len"}`` written in place (prefill, decode)."""
    m = cfg.mla
    tp = axis_size_or_1(AXES.model)
    hq_loc = cfg.heads_padded(tp) // tp
    qk_hd = m.nope_head_dim + m.rope_head_dim
    kvr, dn, dvh = m.kv_lora_rank, m.nope_head_dim, m.v_head_dim
    scale = 1.0 / math.sqrt(qk_hd)
    lead = x.shape[:-1]                                  # (p, B, S)

    c_q = rms_norm(ops.matmul_accumulate(x, p["w_dq"]), p["q_norm"],
                   cfg.norm_eps)
    q = ops.col_matmul(c_q, p["w_uq"], fsdp_dim=0).reshape(*lead, hq_loc,
                                                           qk_hd)
    q_nope, q_rope = q[..., :dn], rope(q[..., dn:], pos, cfg.rope_theta)
    ckv_kr = ops.matmul_accumulate(x, ops.tp_psum_grad(p["w_dkv"]))
    c_kv = rms_norm(ckv_kr[..., :kvr], p["kv_norm"], cfg.norm_eps)
    k_rope = rope(ckv_kr[..., None, kvr:], pos, cfg.rope_theta)
    # the new rows' latent and rope key, [p, B, S, kvr + dr]: the keys of
    # the absorbed path, and what the cache's one buffer stores
    lat = torch.cat([c_kv, k_rope[..., 0, :].to(c_kv.dtype)], dim=-1)

    s_new = x.shape[2]
    pos0, kv_valid, new_cache = 0, None, None
    kv_pos = pos
    if mode in ("prefill", "decode"):
        t = cache["len"] if mode == "decode" else 0
        buf = latent_keys(cache["c_kv"], cache["k_rope"])
        _cache_write(buf, lat, t)
        new_cache = {"c_kv": cache["c_kv"], "k_rope": cache["k_rope"],
                     "len": t + s_new}
        if mode == "decode":
            lat = buf                        # every slot, read in place
            c_kv, k_rope = buf[..., :kvr], buf[..., None, kvr:]
            kv_pos = torch.arange(buf.shape[2], device=x.device)[None]
            pos0, kv_valid = t, t + s_new
    elif mode != "train":
        raise ValueError(mode)

    if cfg.attn_impl == "flash":
        # ABSORBED: w_uk folded into the query and w_uv into the output, so
        # the latent itself is the one KV head of every local q head
        w_ukv = ops.fsdp_gather(p["w_ukv"], 0).reshape(
            lead[0], kvr, hq_loc, dn + dvh)
        w_uk, w_uv = w_ukv[..., :dn], w_ukv[..., dn:]
        q_eff = torch.einsum("pbshd,pkhd->pbshk", q_nope, w_uk)
        qf = torch.cat([q_eff, q_rope.to(q_eff.dtype)], dim=-1)
        nb = lead[0] * lead[1]
        qg = qf.reshape(nb, s_new, 1, hq_loc, kvr + m.rope_head_dim)
        # the filled slots only (decode: of the cache's buffer)
        kf = lat[:, :, :pos0 + s_new].flatten(0, 1)[:, :, None, :]
        vf = kf[..., :kvr]                 # the latent: a view of the keys
        causal, window = _flash_args(kind, cfg.window)
        o_lat = _flash(qg, kf, vf, causal=causal, window=window,
                       softcap=cfg.attn_softcap or 0.0, q0=pos0, scale=scale)
        o_lat = o_lat.reshape(*lead, hq_loc, kvr)
        o = torch.einsum("pbshk,pkhd->pbshd", o_lat, w_uv)
        o = o.reshape(*lead, hq_loc * dvh)
    else:
        # NAIVE: the latent up-projected for the local heads per use
        kv = ops.col_matmul(c_kv.to(x.dtype), p["w_ukv"], fsdp_dim=0)
        kv = kv.reshape(*c_kv.shape[:-1], hq_loc, dn + dvh)
        k_nope, v = kv[..., :dn], kv[..., dn:]
        k = torch.cat([k_nope, k_rope.to(k_nope.dtype).expand(
            *k_nope.shape[:-1], m.rope_head_dim)], dim=-1)
        qf = torch.cat([q_nope, q_rope], dim=-1)
        mask = make_mask(pos, kv_pos, kind=kind, window=cfg.window,
                         kv_len_valid=kv_valid)
        o = _sdpa(qf.flatten(0, 1), k.flatten(0, 1), v.flatten(0, 1), mask,
                  softcap=cfg.attn_softcap, scale=scale)
        o = o.reshape(*lead, hq_loc * dvh)
    y = ops.row_matmul(o, p["w_o"], fsdp_dim=1)
    return AttnOut(y=y, cache=new_cache)
