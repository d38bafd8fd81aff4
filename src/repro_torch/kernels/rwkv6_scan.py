"""RWKV6 WKV scan: the Hopper kernel, its plain version and the oracle.

``rwkv6_scan`` is the Hopper counterpart of the TPU kernel
``repro/kernels/rwkv6_scan.py:rwkv6_scan``, written for the model's rwkv
block (``models/ssm.py``) and its layout:

* ``r, k, v, w [N, S, H, hd]`` (the model folds its p stacked ranks into
  N = p·B, so one launch covers every rank of a layer), ``u [Nu, H, hd]``
  (row n takes ``u[n // (N // Nu)]``: the model passes its per-rank bonus,
  Nu = p), ``s0 [N, H, hd, hd]`` or None (zeros);
* returns ``y [N, S, H, hd]`` and ``s_fin [N, H, hd, hd]``, both float32,
  with ``y_t = r_t · (S + diag(u) k_tᵀ v_t)`` and ``S ← diag(w_t) S +
  k_tᵀ v_t`` (the state indexed [key channel, value channel]).

Two extensions over the TPU kernel, both needed by serving: the initial
state ``s0`` (prefill starts from the cache's state, decode carries it)
and any S (the TPU kernel asserts ``S % chunk == 0``; the model runs
prompts of any length and decode at S = 1, so the ragged last chunk is
masked).  The TPU kernel's function is ``s0 = None``;
``rwkv6_scan_bhsd`` is that case in its layout ``[BH, S, hd]``.  r, k, v
may be bfloat16 (the kernel converts them exactly); w, u and the state
are float32.  ``out_state=`` names a tensor that receives ``s_fin``; it
may be ``s0`` itself (the kernel reads a state before it writes it: each
column of a state belongs to one CTA), which is how the model updates its
cache in place.  The CUDA source, with the bound it works against, is
``csrc/rwkv6_scan.cu``; it decides which of its kernels a call takes
(``rwkv6_scan_path``): ``decode`` at S = 1, else ``chunked``, counted in
``rwkv6_scan.launches_by_path``.

``rwkv6_scan_plain`` is the TPU kernel's chunked algorithm in PyTorch
(log-decay cumsum per chunk, pairwise differences clamped at <= 0, the
bonus on the diagonal, the state update), over chunks of ``CHUNK`` rows;
``rwkv6_scan_plain_log`` is the same on ``log w``.  CPU tensors take it;
on the card it checks the kernel, within ``tolerance``, and is what
training differentiates: ``RWKV6Scan`` is the ``torch.autograd.Function``
whose forward is ``rwkv6_scan`` and whose backward recomputes the scan
through ``rwkv6_scan_plain_log`` under autograd, the counterpart of
``jax.vjp`` of the JAX package's ``models/ssm.py:_wkv_scan``.  ``rwkv6_ref`` is the oracle of
``repro/kernels/ref.py:rwkv6_ref`` (sequential, TPU layout).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._recompute import grads_through

CHUNK = 32                     # the kernel's chunk, as the TPU kernel's
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HD = 128                   # the state and a chunk fit in shared memory


def _lib() -> ctypes.CDLL:
    lib = _build.cuda_library("rwkv6_scan", ["rwkv6_scan.cu"])
    fn = lib.rwkv6_scan
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                       + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 14
                       + [ctypes.c_int, ctypes.c_void_p])
        lib.rwkv6_scan_path.restype = ctypes.c_int
        lib.rwkv6_scan_path.argtypes = [ctypes.c_int]
    return lib


def build() -> None:
    """Compile (once) and load the CUDA library."""
    _lib()


PATHS = ("chunked", "decode")          # rwkv6_scan_path


def rwkv6_scan_path(s: int) -> str:
    """The kernel a call of ``s`` rows takes (the C source's
    ``rwkv6_scan_path``)."""
    return PATHS[_lib().rwkv6_scan_path(s)]


def _quads_ok(r, k, v, w) -> bool:
    """Whether the kernel may load r, k, v and w four channels at a time:
    hd % 4 == 0, every stride a multiple of 4, base pointers aligned to
    four elements."""
    return r.shape[-1] % 4 == 0 and all(
        all(st % 4 == 0 for st in t.stride()[:3])
        and t.data_ptr() % (4 * t.element_size()) == 0
        for t in (r, k, v, w))


def _check(r, k, v, w, u, s0, out_state):
    if r.dim() != 4 or u.dim() != 3:
        raise ValueError(f"rwkv6_scan takes r, k, v, w [N, S, H, hd] and u "
                         f"[Nu, H, hd], got {tuple(r.shape)}, "
                         f"{tuple(u.shape)}")
    n, _, h, hd = r.shape
    for name, t in (("k", k), ("v", v), ("w", w)):
        if tuple(t.shape) != tuple(r.shape):
            raise ValueError(f"rwkv6_scan: {name} {tuple(t.shape)} != r "
                             f"{tuple(r.shape)}")
    if u.shape[1:] != (h, hd) or u.shape[0] == 0 or n % u.shape[0]:
        raise ValueError(f"rwkv6_scan: u {tuple(u.shape)} does not fit r "
                         f"{tuple(r.shape)}")
    for name, t in (("s0", s0), ("out_state", out_state)):
        if t is not None and tuple(t.shape) != (n, h, hd, hd):
            raise ValueError(f"rwkv6_scan: {name} {tuple(t.shape)} is not "
                             f"{(n, h, hd, hd)}")
    if not (r.dtype == k.dtype == v.dtype):
        raise ValueError(f"rwkv6_scan: r, k, v dtypes {r.dtype}, {k.dtype}, "
                         f"{v.dtype} differ")


def rwkv6_scan_plain(r, k, v, w, u, s0=None, *, chunk: int = CHUNK):
    """The plain PyTorch version: the TPU kernel's chunked algorithm over
    chunks of ``chunk`` rows (the last one ragged), float32 inside
    (float64 for float64 inputs)."""
    _check(r, k, v, w, u, s0, None)
    wf = w.to(torch.promote_types(w.dtype, torch.float32))
    return rwkv6_scan_plain_log(r, k, v, torch.log(torch.clamp(wf, min=1e-38)),
                                u, s0, chunk=chunk)


def rwkv6_scan_plain_log(r, k, v, logw, u, s0=None, *, chunk: int = CHUNK):
    """``rwkv6_scan_plain`` on the log of the decay, ``logw = log w <=
    0``: what training differentiates.  Its backward never divides by w
    (the chunked algorithm works on log-decay cumsums), so it stays
    finite where w underflows to 0, as the JAX package's ``_wkv_scan``,
    which multiplies by w, does."""
    _check(r, k, v, logw, u, s0, None)
    n, s, h, hd = r.shape
    dev = r.device
    ct = torch.promote_types(r.dtype, torch.float32)
    uu = u.to(ct).repeat_interleave(n // u.shape[0], 0)[:, :, None]
    st = (torch.zeros(n, h, hd, hd, dtype=ct, device=dev)
          if s0 is None else s0.to(ct))
    y = torch.empty(n, s, h, hd, dtype=ct, device=dev)
    for c0 in range(0, s, chunk):
        rc, kc, vc, lwc = (t[:, c0:c0 + chunk].to(ct).transpose(1, 2)
                           for t in (r, k, v, logw))        # [N, H, Lc, hd]
        lc = rc.shape[2]
        cum = torch.cumsum(lwc, dim=2)
        cum_prev = torch.cat([torch.zeros_like(cum[:, :, :1]),
                              cum[:, :, :-1]], dim=2)       # exclusive
        strict = torch.ones(lc, lc, dtype=torch.bool, device=dev).tril(-1)
        diff = cum_prev[:, :, :, None, :] - cum[:, :, None, :, :]
        e = torch.exp(torch.clamp(diff, max=0.0)) * strict[..., None]
        a = (rc[:, :, :, None, :] * kc[:, :, None, :, :] * e).sum(-1)
        a = a + torch.diag_embed((rc * uu * kc).sum(-1))    # the bonus
        yc = (rc * torch.exp(cum_prev)) @ st + a @ vc
        y[:, c0:c0 + lc] = yc.transpose(1, 2)
        last = cum[:, :, -1]                                 # [N, H, hd]
        kdec = kc * torch.exp(last[:, :, None] - cum)
        st = torch.exp(last)[..., None] * st + kdec.transpose(-1, -2) @ vc
    return y, st


def rwkv6_scan(r, k, v, w, u, s0=None, *, out_state=None):
    """The scan on the model's layout (see the module docstring).  CPU
    tensors take the plain version; CUDA tensors launch the kernel (the
    last dim of r, k, v, w and u must be contiguous, other dims may be
    strided views; s0 and out_state contiguous)."""
    _check(r, k, v, w, u, s0, out_state)
    ts = [t for t in (r, k, v, w, u, s0, out_state) if t is not None]
    if all(t.device.type == "cpu" for t in ts):
        y, s_fin = rwkv6_scan_plain(r, k, v, w, u, s0)
        if out_state is not None:
            out_state.copy_(s_fin)
            s_fin = out_state
        return y, s_fin
    dev = r.device
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError("rwkv6_scan: tensors on "
                         f"{sorted({str(t.device) for t in ts})}")
    if r.dtype not in _DTYPE_CODE:
        raise ValueError(f"rwkv6_scan takes r, k, v in float32/bfloat16, got "
                         f"{r.dtype}")
    for name, t in (("w", w), ("u", u), ("s0", s0),
                    ("out_state", out_state)):
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"rwkv6_scan: {name} must be float32, got "
                             f"{t.dtype}")
    n, s, h, hd = r.shape
    if hd > MAX_HD:
        raise ValueError(f"rwkv6_scan: head dim {hd} > {MAX_HD}")
    if any(t.stride(-1) != 1 for t in (r, k, v, w, u)):
        raise ValueError("rwkv6_scan needs a contiguous head dim")
    if any(t is not None and not t.is_contiguous() for t in (s0, out_state)):
        raise ValueError("rwkv6_scan needs a contiguous s0 and out_state")
    y = torch.empty(n, s, h, hd, dtype=torch.float32, device=dev)
    s_out = (out_state if out_state is not None else
             torch.empty(n, h, hd, hd, dtype=torch.float32, device=dev))
    if n * h == 0:
        return y, s_out
    stream = torch.cuda.current_stream(dev).cuda_stream
    path = rwkv6_scan_path(s)
    rc = _lib().rwkv6_scan(
        _DTYPE_CODE[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
        w.data_ptr(), u.data_ptr(), None if s0 is None else s0.data_ptr(),
        y.data_ptr(), s_out.data_ptr(), n, s, h, hd, u.shape[0],
        *r.stride()[:3], *k.stride()[:3], *v.stride()[:3], *w.stride()[:3],
        *u.stride()[:2], int(_quads_ok(r, k, v, w)), stream)
    if rc != 0:
        raise RuntimeError(f"rwkv6_scan launch failed: CUDA error {rc}")
    rwkv6_scan.launches += 1
    rwkv6_scan.launches_by_path[path] += 1
    return y, s_out


rwkv6_scan.launches = 0
rwkv6_scan.launches_by_path = dict.fromkeys(PATHS, 0)


class RWKV6Scan(torch.autograd.Function):
    """``rwkv6_scan`` from a zero state under autograd, on the log of the
    decay: ``RWKV6Scan.apply(r, k, v, logw, u) -> y``, gradients for r,
    k, v, logw and u.  The forward is the kernel on CUDA tensors
    (``rwkv6_scan`` with ``w = exp(logw)``) and ``rwkv6_scan_plain_log``
    on CPU ones, and saves its five inputs; the backward recomputes ``y``
    through ``rwkv6_scan_plain_log`` under autograd.  Taking log w, not
    w, keeps 1/w out of the backward (the model's decay ``exp(-exp(.))``
    underflows in float32)."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u):
        ctx.save_for_backward(r, k, v, logw, u)
        if all(t.device.type == "cpu" for t in (r, k, v, logw, u)):
            return rwkv6_scan_plain_log(r, k, v, logw, u)[0]
        return rwkv6_scan(r, k, v, torch.exp(logw), u)[0]

    @staticmethod
    def backward(ctx, g):
        return tuple(grads_through(
            lambda *ins: rwkv6_scan_plain_log(*ins)[0], ctx.saved_tensors,
            ctx.needs_input_grad, g))


def tolerance(r, k, v, w, u, s0=None):
    """The elementwise limits ``(y_lim, s_lim)`` on ``|rwkv6_scan -
    rwkv6_scan_plain|`` for these inputs.

    Both sides compute the same float32 terms in another order: each
    output is a sum of products ``r·k·v`` (and ``r·s0``) times decay
    factors ``exp(·) <= 1``.  Let M be that sum over the terms' absolute
    values (the plain version on ``|r|, |k|, |v|, |u|, |s0|``).  The
    summation order moves an output by at most ~(hd + L)·2^-24·M; the
    decay exponents are differences of cumsums that the two sides add in
    another order (the card's ``torch.cumsum`` is a parallel scan), off
    by a few float32 steps of the largest |cumsum| in a chunk, ``L·max|log
    w|``, which moves a factor by as much relatively.  The limit is 16
    times both: ``(2^-20·(hd + L) + 2^-20·L·max|log w|)·M``.  A planted
    fault (the carried state dropped, the bonus left out, a row not
    written) moves an output by a term of M itself, ~1/sqrt(terms) of it,
    far above."""
    y_abs, s_abs = rwkv6_scan_plain(
        r.abs(), k.abs(), v.abs(), w, u.abs(),
        None if s0 is None else s0.abs())
    hd = r.shape[-1]
    lw = float(torch.log(torch.clamp(w.float(), min=1e-38)).abs().max())
    f = 2.0 ** -20 * (hd + CHUNK) + 2.0 ** -20 * CHUNK * lw
    tiny = torch.finfo(torch.float32).tiny
    return f * y_abs + tiny, f * s_abs + tiny


def to_model_layout(r, k, v, w, u):
    """TPU layout ``r, k, v, w [BH, S, hd]``, ``u [BH, hd]`` -> model
    layout views ``[BH, S, 1, hd]`` and ``u [BH, 1, hd]`` (no copies)."""
    return (r.unsqueeze(2), k.unsqueeze(2), v.unsqueeze(2), w.unsqueeze(2),
            u.unsqueeze(1))


def rwkv6_scan_bhsd(r, k, v, w, u):
    """The TPU kernel's function and layout: ``[BH, S, hd]`` in, ``(y [BH,
    S, hd], s_fin [BH, hd, hd])`` float32 out (s0 = zeros); it goes
    through ``rwkv6_scan``."""
    y, s_fin = rwkv6_scan(*to_model_layout(r, k, v, w, u))
    return y[:, :, 0], s_fin[:, 0]


def rwkv6_ref(r, k, v, w, u, s0=None):
    """The oracle (``repro/kernels/ref.py:rwkv6_ref``): the recurrence step
    by step in float32, TPU layout ``[BH, S, hd]``, ``u [BH, hd]``, ``s0
    [BH, hd, hd]``."""
    bh, s, hd = r.shape
    st = (torch.zeros(bh, hd, hd, dtype=torch.float32, device=r.device)
          if s0 is None else s0.float())
    ys = []
    uf = u.float()
    for t in range(s):
        rt, kt, vt, wt = (a[:, t].float() for a in (r, k, v, w))
        kv = kt[:, :, None] * vt[:, None, :]
        ys.append(torch.einsum("bk,bkv->bv", rt, st)
                  + torch.einsum("bk,bkv->bv", rt * uf, kv))
        st = wt[..., None] * st + kv
    return torch.stack(ys, 1), st
