"""SSM blocks: RWKV6 ("Finch", data-dependent decay) and Mamba2 (SSD).

The port's counterpart of the JAX package's ``models/ssm.py``, with the
same TP contract: SSM heads are sharded over the model axis (RWKV6 heads
padded up to a multiple of tp); B/C and the conv over them (mamba) and
the decay-LoRA down-projection (rwkv) are replicated with
``tp_psum_grad`` markers; the channel-mix receptance is gathered with
``tp_allgather``; the group norms run per head, so they do not depend on
tp.

Operands are stacked over the ``model`` axis: activations ``[p, B, S,
D]``, parameters ``[p, *local_shape]``.  The recurrences go to the
kernels: ``kernels.rwkv6_scan`` in place of the JAX package's
``lax.scan`` (``_wkv_scan``), ``kernels.ssd_mamba2.ssd_scan`` in place of
its jnp ``_ssd_chunked``, each called once per block with the p ranks'
rows folded into its N = p·B rows; on CPU tensors they run their plain
versions, on CUDA tensors the Hopper kernels.  Where a gradient is needed
(training), each goes through its autograd Function (``RWKV6Scan``,
``SSDScan``): the same kernel forward, a backward through the plain
version.  ``RWKV6Scan`` takes the log of the decay, ``-exp(dec_raw)``, so
the backward never divides by a decay that underflowed to 0.

Decode carries O(1) state per block: the last token (rwkv) or the conv
tail (mamba), and S.  The state S is updated IN PLACE in the cache (the
kernels write their final state over their initial one); the short
token-shift and conv tails come back as new tensors, as in the JAX
package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist import ops
from repro_torch.dist.axes import AXES, axis_size_or_1
from repro_torch.kernels.rwkv6_scan import RWKV6Scan, rwkv6_scan
from repro_torch.kernels.ssd_mamba2 import SSDScan, ssd_scan
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _per_rank, needs_grad, rms_norm
from repro_torch.models.params import ParamSpec


# ===========================================================================
# RWKV6
# ===========================================================================


def _stateless(block: str, state) -> None:
    """Training runs from a zero state: the cache's state is updated in
    place, which autograd cannot differentiate."""
    if state:
        raise ValueError(f"{block}: a gradient through a cached state (the "
                         "in-place decode update) is not supported; train "
                         "without a cache")


def rwkv_heads_padded(cfg: ModelConfig, tp: int) -> int:
    h = cfg.d_model // cfg.ssm.head_dim
    return -(-h // tp) * tp


def rwkv_specs(cfg: ModelConfig, tp: int) -> dict:
    d, dt = cfg.d_model, cfg.dtype
    hd = cfg.ssm.head_dim
    da = rwkv_heads_padded(cfg, tp) * hd          # attention width (padded)
    r = cfg.ssm.decay_lora_rank
    return {
        "ln1": ParamSpec((d,), (None,), init="zeros", dtype="float32"),
        "ln2": ParamSpec((d,), (None,), init="zeros", dtype="float32"),
        # time-mix
        "mu_r": ParamSpec((d,), (None,), init="zeros", dtype=dt),
        "mu_k": ParamSpec((d,), (None,), init="zeros", dtype=dt),
        "mu_v": ParamSpec((d,), (None,), init="zeros", dtype=dt),
        "mu_w": ParamSpec((d,), (None,), init="zeros", dtype=dt),
        "mu_g": ParamSpec((d,), (None,), init="zeros", dtype=dt),
        "w_r": ParamSpec((d, da), ("data", "model"), dtype=dt),
        "w_k": ParamSpec((d, da), ("data", "model"), dtype=dt),
        "w_v": ParamSpec((d, da), ("data", "model"), dtype=dt),
        "w_g": ParamSpec((d, da), ("data", "model"), dtype=dt),
        "w0": ParamSpec((da,), ("model",), init="zeros", dtype="float32"),
        "wA": ParamSpec((d, r), ("data", None), dtype=dt),
        "wB": ParamSpec((r, da), (None, "model"), dtype=dt),
        "u": ParamSpec((da,), ("model",), init="zeros", dtype="float32"),
        "ln_x": ParamSpec((da,), ("model",), init="zeros", dtype="float32"),
        "w_o": ParamSpec((da, d), ("model", "data"), dtype=dt),
        # channel-mix
        "mu_ck": ParamSpec((d,), (None,), init="zeros", dtype=dt),
        "mu_cr": ParamSpec((d,), (None,), init="zeros", dtype=dt),
        "w_ck": ParamSpec((d, cfg.d_ff), ("data", "model"), dtype=dt),
        "w_cv": ParamSpec((cfg.d_ff, d), ("model", "data"), dtype=dt),
        "w_cr": ParamSpec((d, d), ("data", "model"), dtype=dt),
    }


def _token_shift(x, last):
    """x: ``[p, B, S, D]``; last: ``[p, B, 1, D]``, the token before the
    first (zeros at the start of a sequence)."""
    return torch.cat([last, x[:, :, :-1]], dim=2)


def _lerp(x, prev, mu):
    return x + (prev - x) * _per_rank(mu, x.dim())


def rwkv_block(p: dict, cfg: ModelConfig, x, *, state=None):
    """Time-mix + channel-mix.  state (prefill and decode): ``{"last_tm",
    "last_cm": [p, B, 1, D], "s": [p, B, h, hd, hd] float32}``, whose "s"
    is updated in place.  Returns ``(out, new_state)``."""
    tp = axis_size_or_1(AXES.model)
    hd = cfg.ssm.head_dim
    h_loc = rwkv_heads_padded(cfg, tp) // tp
    np_, b, s, d = x.shape
    n = np_ * b

    # ---- time mix ----------------------------------------------------------
    xn = rms_norm(x, p["ln1"], cfg.norm_eps)
    last_tm = (state["last_tm"] if state else
               torch.zeros(np_, b, 1, d, dtype=x.dtype, device=x.device))
    prev = _token_shift(xn, last_tm)
    xr = _lerp(xn, prev, p["mu_r"])
    xk = _lerp(xn, prev, p["mu_k"])
    xv = _lerp(xn, prev, p["mu_v"])
    xw = _lerp(xn, prev, p["mu_w"])
    xg = _lerp(xn, prev, p["mu_g"])

    r = ops.col_matmul(xr, p["w_r"], fsdp_dim=0)
    k = ops.col_matmul(xk, p["w_k"], fsdp_dim=0)
    v = ops.col_matmul(xv, p["w_v"], fsdp_dim=0)
    g = ops.col_matmul(xg, p["w_g"], fsdp_dim=0)
    # data-dependent decay (the Finch headline feature)
    low = torch.tanh(ops.matmul_accumulate(xw, ops.tp_psum_grad(p["wA"])))
    dec_raw = _per_rank(p["w0"].float(), x.dim()) + ops.col_matmul(
        low, p["wB"]).float()
    logw = -torch.exp(dec_raw)        # log of the decay w in (0, 1)

    rkv = [t.reshape(n, s, h_loc, hd) for t in (r, k, v, logw)]
    u = p["u"].float().reshape(np_, h_loc, hd)
    if needs_grad(*rkv, u):
        _stateless("rwkv_block", state)
        y = RWKV6Scan.apply(*rkv, u)
    else:
        s_state = state["s"].view(n, h_loc, hd, hd) if state else None
        y, _ = rwkv6_scan(*rkv[:3], torch.exp(rkv[3]), u, s_state,
                          out_state=s_state)
    # per-head group norm (RWKV GroupNorm(n_heads)) -- invariant under TP
    yh = rms_norm(y.to(x.dtype).reshape(np_, b, s, h_loc, hd),
                  p["ln_x"].reshape(np_, h_loc, hd), cfg.norm_eps)
    y = yh.reshape(np_, b, s, h_loc * hd) * F.silu(g)
    att = ops.row_matmul(y, p["w_o"], fsdp_dim=1)

    x_in_last = xn[:, :, -1:]     # time-mix shifts against the NORMED input
    x = x + att

    # ---- channel mix --------------------------------------------------------
    xn2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    last_cm = (state["last_cm"] if state else
               torch.zeros(np_, b, 1, d, dtype=x.dtype, device=x.device))
    prevc = _token_shift(xn2, last_cm)
    xck = _lerp(xn2, prevc, p["mu_ck"])
    xcr = _lerp(xn2, prevc, p["mu_cr"])
    kk = ops.col_matmul(xck, p["w_ck"], fsdp_dim=0)
    kk = torch.square(F.relu(kk))
    cv = ops.row_matmul(kk, p["w_cv"], fsdp_dim=1)
    r_loc = ops.col_matmul(xcr, p["w_cr"], fsdp_dim=0)
    r_full = ops.tp_allgather(r_loc, -1)
    out = x + torch.sigmoid(r_full) * cv

    new_state = None
    if state:
        # time-mix shifts against the block input; channel-mix against the
        # post-attention residual stream (its own input), per RWKV layout
        new_state = {"last_tm": x_in_last, "last_cm": xn2[:, :, -1:],
                     "s": state["s"]}
    return out, new_state


# ===========================================================================
# Mamba2 (SSD, chunked)
# ===========================================================================


def mamba_specs(cfg: ModelConfig, tp: int) -> dict:
    d, dt = cfg.d_model, cfg.dtype
    c = cfg.ssm
    di = c.expand * d                     # d_inner
    nh = di // c.head_dim                 # heads
    if nh % tp:
        raise ValueError(f"mamba heads {nh} not divisible by tp {tp}")
    n = c.state_dim
    return {
        "ln": ParamSpec((d,), (None,), init="zeros", dtype="float32"),
        "w_in_z": ParamSpec((d, di), ("data", "model"), dtype=dt),
        "w_in_x": ParamSpec((d, di), ("data", "model"), dtype=dt),
        "w_bc": ParamSpec((d, 2 * n), ("data", None), dtype=dt),
        "w_dt": ParamSpec((d, nh), ("data", "model"), dtype=dt),
        "dt_bias": ParamSpec((nh,), ("model",), init="zeros",
                             dtype="float32"),
        "a_log": ParamSpec((nh,), ("model",), init="zeros", dtype="float32"),
        "d_skip": ParamSpec((nh,), ("model",), init="ones", dtype="float32"),
        "conv_x": ParamSpec((c.conv_kernel, di), (None, "model"),
                            scale=0.5, dtype=dt),
        "conv_bc": ParamSpec((c.conv_kernel, 2 * n), (None, None),
                             scale=0.5, dtype=dt),
        "gate_norm": ParamSpec((di,), ("model",), init="zeros",
                               dtype="float32"),
        "w_out": ParamSpec((di, d), ("model", "data"), dtype=dt),
    }


def _causal_conv(x, w, tail=None):
    """Depthwise causal conv via K shifted adds.  x: ``[p, B, S, C]``, w:
    ``[p, K, C]``; ``tail``: ``[p, B, K-1, C]``, the previous context
    (decode).  Returns ``(y, new_tail)``."""
    k = w.shape[1]
    if tail is None:
        tail = torch.zeros(*x.shape[:2], k - 1, x.shape[3], dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([tail, x], dim=2)
    s = x.shape[2]
    y = sum(xp[:, :, i:i + s] * w[:, k - 1 - i][:, None, None]
            for i in range(k))
    new_tail = xp[:, :, -(k - 1):] if k > 1 else tail
    return y, new_tail


def mamba_block(p: dict, cfg: ModelConfig, x, *, state=None):
    """Mamba2 mixer.  state (prefill and decode): ``{"conv_x": [p, B, K-1,
    di_loc], "conv_bc": [p, B, K-1, 2N], "s": [p, B, h, N, P] float32}``,
    whose "s" is updated in place.  Returns ``(out, new_state)``."""
    c = cfg.ssm
    tp = axis_size_or_1(AXES.model)
    di_loc = c.expand * cfg.d_model // tp
    h_loc = di_loc // c.head_dim
    n_st = c.state_dim
    np_, b, s, _ = x.shape
    n = np_ * b

    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    z = ops.col_matmul(xn, p["w_in_z"], fsdp_dim=0)
    xin = ops.col_matmul(xn, p["w_in_x"], fsdp_dim=0)
    bc = ops.matmul_accumulate(xn, ops.tp_psum_grad(p["w_bc"]))
    dt_raw = ops.col_matmul(xn, p["w_dt"], fsdp_dim=0)

    xin, tail_x = _causal_conv(xin, p["conv_x"],
                               state["conv_x"] if state else None)
    bc, tail_bc = _causal_conv(bc, ops.tp_psum_grad(p["conv_bc"]),
                               state["conv_bc"] if state else None)
    xin = F.silu(xin)
    bc = F.silu(bc)

    dt = F.softplus(dt_raw.float() + _per_rank(p["dt_bias"], x.dim()))
    a = torch.exp(p["a_log"].float())                 # per-head decay rate
    xh = xin.reshape(n, s, h_loc, c.head_dim)
    # B and C go in as views of the conv output, shared by a row's heads
    ins = (xh, dt.reshape(n, s, h_loc), a, bc[..., :n_st].reshape(n, s, n_st),
           bc[..., n_st:].reshape(n, s, n_st))
    if needs_grad(*ins):
        _stateless("mamba_block", state)
        y = SSDScan.apply(*ins)
    else:
        s_state = (state["s"].view(n, h_loc, n_st, c.head_dim) if state
                   else None)
        y, _ = ssd_scan(*ins, s_state, out_state=s_state)
    d_skip = p["d_skip"].float().repeat_interleave(b, 0)     # [n, h_loc]
    y = y + xh.float() * d_skip[:, None, :, None]
    yh = rms_norm(y.to(x.dtype).reshape(np_, b, s, h_loc, c.head_dim),
                  p["gate_norm"].reshape(np_, h_loc, c.head_dim),
                  cfg.norm_eps)                       # per head (TP-inv.)
    y = yh.reshape(np_, b, s, di_loc) * F.silu(z)
    out = x + ops.row_matmul(y, p["w_out"], fsdp_dim=1)

    new_state = None
    if state:
        new_state = {"conv_x": tail_x, "conv_bc": tail_bc, "s": state["s"]}
    return out, new_state
