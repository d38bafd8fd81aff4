"""Flash attention: the Hopper kernel, its plain version and the oracle.

``flash_attention`` is the Hopper counterpart of the TPU kernel
``repro/kernels/flash_attention.py:flash_attention``, written for the
model's flash path (``models/attention.py``) and its layout:

* ``q [N, Sq, HK, G, dh]``, ``k [N, Skv, HK, dh]``, ``v [N, Skv, HK,
  dv]`` with ``dv <= dh`` (``dv < dh`` for MLA's absorbed path, where v
  may be a view of k's first dv columns), out ``[N, Sq, HK, G, dv]`` in
  q's dtype (the model folds its p stacked ranks into N = p·B, so one
  launch covers every rank of a layer, and groups the G query heads of a
  KV head, so no KV head is repeated);
* query i has position ``q0 + i``; key j is seen when ``j < kv_len``,
  (``causal``) ``j <= q0 + i`` and (``window > 0``) ``j > q0 + i -
  window``; scores are ``q·k · scale`` (``scale=None``: ``1 /
  sqrt(dh)``), then ``softcap · tanh(s / softcap)`` when ``softcap >
  0``.

The TPU kernel's function is the case ``q0 = 0``, ``kv_len = Skv``;
``flash_attention_bhsd`` is that case in its layout ``[B, H, S, dh]``.
The CUDA source, with the bound it works against, is
``csrc/flash_attention.cu``; it takes bfloat16 and float32.  The source
decides (``flash_attention_plan``) which of its kernels a call takes, from
the dtype, the head dim, the number of folded query rows (``Sq·G``) and the
alignment, before the launch; every call is one launch.
``flash_attention.launches_by_path`` counts them by path, and
``flash_attention.launches_by_dh`` by head dim, then path:

* ``"wgmma"``: bf16 prefill (at least 64 folded rows, dh 64, 128 or 256,
  16-byte strides): CTAs of 128 folded rows, K/V blocks of 128 keys by
  TMA from a producer warpgroup (at dh 256, where O alone is 128
  registers a thread: 64-key blocks, thread 0 issuing the loads), both
  products on ``wgmma``; bound by operations.  At dh 64, where a block's
  exponentials cost as much as its products, the softmax runs under the
  products: each warpgroup's softmax of one block beside its PV product
  of the block before, and the two warpgroups taking turns to issue
  (``fa_wgmma64_kernel``);
* ``"split_kv"``: bf16 decode (at most 16 folded rows): the KV range split
  across CTAs, float32 partials in scratch that this wrapper allocates, the
  last CTA of each (n, KV head) merging them (``_tickets`` keeps the
  per-head counters, re-armed by the kernel).  The keys stream through a
  ring of 32-key blocks (two CTAs an SM at dh 256; head dims up to 32
  zero-padded to 32), the splits sized to fill the card's resident CTAs
  once (``fa_ring_kernel``);
* ``"mma_sync"``: other bf16 calls, 32-key blocks on ``mma.sync``;
* ``"mla_wgmma"``: the bf16 MLA prefill (dh 576, dv 512, v a view of k's
  first 512 columns, at least 64 folded rows, 16-byte strides): CTAs of 64
  folded rows holding Q, 64-key K blocks by TMA with V read from the same
  stage, S split by keys across two warpgroups, P through shared memory,
  each warpgroup's O += P V over half the output's columns, all on
  ``wgmma``; bound by operations;
* ``"mla"``: other bf16 calls with ``dv != dh`` or ``dh > 256`` (MLA: dh
  up to 576, dv up to 512; the decode, a v that is its own tensor): 8
  warps a CTA splitting the output's columns, S and P through shared
  memory, the value rows read from the key stage when v is a view of k;
  at most 16 folded rows (decode) the visible blocks split across CTAs
  with float32 partials in scratch, as ``split_kv`` does; the decode is
  bound by the bytes of the latent cache;
* ``"f32"``: float32, full float32 FMA (dh up to 576).

``flash_attention_plain`` is a PyTorch copy of the JAX package's
``models/attention.py:_flash_jnp`` with the same arguments: an online
softmax over KV chunks of ``CHUNK`` keys, float32 scores and accumulator
(float64 for float64 inputs), p rounded to v's dtype before the PV
product.  Where ``_flash_jnp`` halves its chunk until it divides the keys
(down to chunks of 4 keys at whisper-medium's 1500 frames), the plain
version stops halving at ``MIN_CHUNK`` keys and takes a shorter last
chunk: the same function in another summation order, and a fifteenth of
the launches at 1500 keys (a whisper-medium training step differentiates
48 such calls).  CPU tensors take it; on the card it checks the kernel, within
``tolerance``, and is what training differentiates: ``FlashAttention`` is
the ``torch.autograd.Function`` whose forward is ``flash_attention`` (the
kernel on CUDA tensors) and whose backward recomputes the attention
through ``flash_attention_plain`` under autograd, the counterpart of
``jax.vjp`` of ``_flash_jnp``.  It saves only q, k and v.
``flash_attention_ref`` is the oracle of
``repro/kernels/ref.py:flash_attention_ref`` (Pallas layout).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._recompute import grads_through

NEG = -1e30
CHUNK = 1024                       # _flash_jnp's KV chunk
MIN_CHUNK = 64                     # the plain version halves it no further
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_DH = 256                  # the dense bf16 paths
MLA_DH, MLA_DV = 576, 512     # the "mla" path's widest q/k and v
PATHS = ("f32", "mma_sync", "wgmma", "split_kv", "mla",
         "mla_wgmma")                              # flash_attention_plan
_TICKETS: dict = {}          # device -> int32 counters, zero between calls


def _lib() -> ctypes.CDLL:
    lib = _build.cuda_library("flash_attention", ["flash_attention.cu"])
    fn = lib.flash_attention
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                       + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 14
                       + [ctypes.c_int] * 2 + [ctypes.c_float] * 2
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3)
        plan = lib.flash_attention_plan
        plan.restype = ctypes.c_int
        plan.argtypes = [ctypes.c_int] * 13 + [
            ctypes.POINTER(ctypes.c_longlong)]
    return lib


def build() -> None:
    """Compile (once) and load the CUDA library."""
    _lib()


def _tickets(device: torch.device, count: int) -> torch.Tensor:
    """The split decode's per-(n, KV head) counters on ``device``: zeroed
    once, left at zero by every launch.  Two split launches on different
    streams at once would share them; the port issues its launches on one
    stream."""
    t = _TICKETS.get(device)
    if t is None or t.numel() < count:
        t = torch.zeros(max(count, 1024), dtype=torch.int32, device=device)
        _TICKETS[device] = t
    return t


def _check(q, k, v):
    if q.dim() != 5 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention takes q [N, Sq, HK, G, dh], "
                         f"k [N, Skv, HK, dh] and v [N, Skv, HK, dv], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    n, _, hk, _, dh = q.shape
    if (tuple(k.shape[:3]) != tuple(v.shape[:3]) or k.shape[0] != n
            or k.shape[2] != hk or k.shape[3] != dh
            or not 1 <= v.shape[3] <= dh):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype} differ")


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0, q0: int = 0,
                          kv_len: int | None = None,
                          scale: float | None = None) -> torch.Tensor:
    """The plain PyTorch version (``_flash_jnp``'s schedule): online
    softmax over KV chunks of ``CHUNK`` keys, halved until it divides Skv
    but not below ``MIN_CHUNK`` (the last chunk is then shorter)."""
    _check(q, k, v)
    n, sq, hk, g, dh = q.shape
    dv = v.shape[-1]
    skv = k.shape[1]
    kv_len = skv if kv_len is None else kv_len
    c = min(CHUNK, skv)
    while c > MIN_CHUNK and skv % c:
        c //= 2
    scale = 1.0 / math.sqrt(dh) if scale is None else scale
    qpos = q0 + torch.arange(sq, device=q.device)
    ct = torch.promote_types(q.dtype, torch.float32)
    qf = q.to(ct)
    m = torch.full((n, hk, g, sq), NEG, dtype=ct, device=q.device)
    l = torch.zeros((n, hk, g, sq), dtype=ct, device=q.device)
    acc = torch.zeros((n, hk, g, sq, dv), dtype=ct, device=q.device)
    for c0 in range(0, skv, c):
        kb, vb = k[:, c0:c0 + c], v[:, c0:c0 + c]
        kpos = torch.arange(c0, c0 + kb.shape[1], device=q.device)
        s = torch.einsum("nqhgd,nchd->nhgqc", qf, kb.to(ct)) * scale
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        mask = (kpos < kv_len)[None, :].expand(sq, -1)
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        s = torch.where(mask, s, torch.full_like(s, NEG))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "nhgqc,nchd->nhgqd", p.to(v.dtype).to(ct), vb.to(ct))
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q0: int = 0,
                    kv_len: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Attention on the model's layout (see the module docstring).  CPU
    tensors take the plain version; CUDA tensors launch the kernel (the
    head dim must be contiguous; other dims may be strided views, and v
    may be a view of k's first dv columns)."""
    _check(q, k, v)
    skv = k.shape[1]
    kv_len = skv if kv_len is None else int(kv_len)
    if not 0 <= kv_len <= skv:
        raise ValueError(f"flash_attention: kv_len {kv_len} outside "
                         f"[0, {skv}]")
    if q.device.type == "cpu" and k.device.type == "cpu" \
            and v.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, q0=q0, kv_len=kv_len,
                                     scale=scale)
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError(f"flash_attention: q on {q.device}, k on "
                         f"{k.device}, v on {v.device}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attention takes float32/bfloat16, got "
                         f"{q.dtype}")
    n, sq, hk, g, dh = q.shape
    dv = v.shape[-1]
    if q.dtype == torch.float32 or (dv == dh and dh <= MAX_DH):
        if dh > MLA_DH:
            raise ValueError(f"flash_attention: head dim {dh} > {MLA_DH}")
    elif dh > MLA_DH or dv > MLA_DV or dv == dh:
        raise ValueError(f"flash_attention: head dim {dh} (v {dv}) past "
                         f"the dense paths' {MAX_DH} and the mla path's "
                         f"{MLA_DH} (v {MLA_DV}, narrower than k)")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention needs a contiguous head dim")
    if hk > 65535 or n > 65535:
        raise ValueError(f"flash_attention: grid ({hk}, {n}) too large")
    out = torch.empty(q.shape[:4] + (dv,), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (q.stride()[:4] + k.stride()[:3] + v.stride()[:3]
               + out.stride()[:4])
    vec_ok = int(dh % 8 == 0 and dv % 8 == 0
                 and all(s % 8 == 0 for s in strides[:10])
                 and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))
    v_in_k = int(v.data_ptr() == k.data_ptr()
                 and v.stride()[:3] == k.stride()[:3])
    lib = _lib()
    need = ctypes.c_longlong(0)
    path = PATHS[lib.flash_attention_plan(
        _DTYPE_CODE[q.dtype], n, sq, hk, g, dh, dv, int(q0), kv_len,
        int(bool(causal)), int(window), vec_ok, v_in_k, ctypes.byref(need))]
    scratch = tickets = None
    if need.value:
        scratch = torch.empty(need.value, dtype=torch.float32,
                              device=q.device)
        tickets = _tickets(q.device, n * hk)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_attention(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), n, sq, skv, hk, g, dh, dv, *strides,
        int(bool(causal)), int(window), float(softcap or 0.0),
        1.0 / math.sqrt(dh) if scale is None else float(scale), int(q0),
        kv_len, vec_ok, v_in_k,
        None if scratch is None else scratch.data_ptr(),
        None if tickets is None else tickets.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    flash_attention.launches_by_path[path] += 1
    flash_attention.launches_by_dh.setdefault(
        dh, dict.fromkeys(PATHS, 0))[path] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_path = dict.fromkeys(PATHS, 0)
flash_attention.launches_by_dh = {}


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` under autograd:
    ``FlashAttention.apply(q, k, v, causal, window, softcap, q0, kv_len,
    scale)`` (scale None: ``1 / sqrt(dh)``).  The forward is
    ``flash_attention`` (the kernel on CUDA tensors, the plain version on
    CPU ones) and saves q, k and v only; the backward recomputes the attention through ``flash_attention_plain``
    under autograd and returns its gradients for q, k and v (v may be a
    view of k: autograd sums the two into k's base)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q0, kv_len, scale):
        ctx.kw = dict(causal=causal, window=window, softcap=softcap, q0=q0,
                      kv_len=kv_len, scale=scale)
        ctx.save_for_backward(q, k, v)
        return flash_attention(q, k, v, **ctx.kw)

    @staticmethod
    def backward(ctx, g):
        grads = grads_through(flash_attention_plain, ctx.saved_tensors,
                              ctx.needs_input_grad[:3], g, **ctx.kw)
        return (*grads, *(None,) * 6)


def tolerance(q, k, v, want: torch.Tensor, **kw) -> torch.Tensor:
    """The elementwise limit on ``|flash_attention - want|``, ``want``
    being ``flash_attention_plain(q, k, v, **kw)``.

    float32: the JAX package's kernel test's 3e-5 (summation order).
    With ``dv < dh`` (MLA) the same rules hold over the dv output columns.
    bfloat16: the two differ only where they round.  Each p is rounded to
    bfloat16 after running maxima that differ (the kernel's key blocks and
    splits, the plain version's chunks), so a p may land one bfloat16 step (at
    most 2^-7 of it) apart; over all keys that moves an output by at most
    2^-7 · A, A being the attention-weighted mean of |v| (the plain
    version on |v| in float32).  Each side then rounds its output once,
    half a step (2^-8 of |out|) each, taken as 2^-6 · |want| with margin.
    A limit of 3e-2 absolute, the reference test's at S <= 256, is the
    size of a typical output at the serve shapes (|out| ~ 0.04 over ~1000
    keys) and would pass a kernel that drops a key."""
    if q.dtype == torch.float32:
        return torch.full(want.shape, 3e-5, device=want.device)
    a = flash_attention_plain(q.float(), k.float(), v.float().abs(), **kw)
    return 2.0 ** -7 * a + 2.0 ** -6 * want.float().abs()


def to_model_layout(q, k, v):
    """Pallas layout ``q [B, Hq, S, dh]``, ``k, v [B, Hkv, S, dh]`` ->
    model-layout views (no copies)."""
    b, hq, sq, dh = q.shape
    hkv = k.shape[1]
    if hq % hkv:
        raise ValueError(f"flash_attention: {hq} q heads over {hkv} kv heads")
    qm = q.unflatten(1, (hkv, hq // hkv)).permute(0, 3, 1, 2, 4)
    return qm, k.transpose(1, 2), v.transpose(1, 2)


def flash_attention_bhsd(q, k, v, *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0) -> torch.Tensor:
    """The TPU kernel's function and layout: ``q [B, Hq, Sq, dh]``, ``k, v
    [B, Hkv, Skv, dh]`` -> ``[B, Hq, Sq, dh]`` in q's dtype (q0 = 0,
    kv_len = Skv); it goes through ``flash_attention``."""
    qm, km, vm = to_model_layout(q, k, v)
    o = flash_attention(qm, km, vm, causal=causal, window=window,
                        softcap=softcap)
    return o.permute(0, 2, 3, 1, 4).flatten(1, 2)


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0,
                        scale: float | None = None) -> torch.Tensor:
    """The oracle (``repro/kernels/ref.py:flash_attention_ref``): dense
    float32 softmax attention, Pallas layout, GQA by repeating KV heads;
    with MLA's arguments too (``scale``, None for ``1 / sqrt(dh)``, and v
    narrower than k)."""
    b, hq, sq, dh = q.shape
    g = hq // k.shape[1]
    kk = torch.repeat_interleave(k, g, dim=1).float()
    vv = torch.repeat_interleave(v, g, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * (
        1.0 / math.sqrt(dh) if scale is None else scale)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(k.shape[2], device=q.device)[None, :]
    mask = torch.ones((sq, k.shape[2]), dtype=torch.bool, device=q.device)
    if causal:
        mask = kpos <= qpos
    if window:
        mask = mask & (kpos > qpos - window)
    s = torch.where(mask, s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)
