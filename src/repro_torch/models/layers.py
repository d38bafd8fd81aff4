"""Shared layers: norms, RoPE, gated MLP, the vocab-sharded embedding and
output head.  Operands are stacked over the ``model`` axis: activations
``[p, B, S, ...]``, parameters ``[p, *local_shape]`` (``models.params``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake

from repro_torch.dist import ops
from repro_torch.dist.axes import AXES, axis_index, get_axis, has_axis
from repro_torch.models.params import ParamSpec


def _per_rank(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """A stacked ``[p, *D]`` parameter shaped to broadcast against a
    stacked ``ndim``-dim activation ``[p, ..., *D]``."""
    return t.reshape(t.shape[0], *([1] * (ndim - t.dim())), *t.shape[1:])


def needs_grad(*ts: torch.Tensor) -> bool:
    """Whether autograd records an op on ``ts``: the kernels' autograd
    Functions are taken then, the bare kernels otherwise (serving)."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """RMS norm over the last dim with a ``1 + scale`` gain, in float32
    inside; ``scale`` is stacked, ``[p, D]`` or ``[p, h, D]`` (per head)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + _per_rank(scale.float(), x.dim()))).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0):
    """Rotary embedding, half-split; x: ``[..., S, H, hd]``, positions
    ``[..., S]`` (broadcast against x's leading dims)."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., :, None].float() * freq          # [..., S, half]
    cos = torch.cos(ang)[..., :, None, :]                  # [..., S, 1, half]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def sincos_positions(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Whisper-style absolute sinusoidal embeddings ``[..., S, d_model]``
    in float32 (sin, then cos); positions ``[..., S]``.  The caller casts
    them to the activations' dtype before the add."""
    half = d_model // 2
    freq = 10_000.0 ** (-torch.arange(half, dtype=torch.float32,
                                      device=positions.device)
                        / max(half - 1, 1))
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# gated MLP (column -> row parallel)
# ---------------------------------------------------------------------------


def mlp_specs(d_model: int, d_ff: int, dtype: str):
    return {
        "w_in": ParamSpec((d_model, d_ff), ("data", "model"), dtype=dtype),
        "w_gate": ParamSpec((d_model, d_ff), ("data", "model"), dtype=dtype),
        "w_out": ParamSpec((d_ff, d_model), ("model", "data"), dtype=dtype),
    }


def mlp(params, x, *, act=F.silu):
    h = ops.col_matmul(x, params["w_in"], fsdp_dim=0)
    g = ops.col_matmul(x, params["w_gate"], fsdp_dim=0)
    return ops.row_matmul(act(g) * h, params["w_out"], fsdp_dim=1)


# ---------------------------------------------------------------------------
# embedding (vocab sharded over TP, feature over FSDP) and the output head
# ---------------------------------------------------------------------------


def embed_specs(vocab_padded: int, d_model: int, dtype: str):
    return {"table": ParamSpec((vocab_padded, d_model), ("model", "data"),
                               scale=d_model ** -0.5, dtype=dtype)}


def head_specs(d_model: int, vocab_padded: int, dtype: str):
    return {"w": ParamSpec((d_model, vocab_padded), ("data", "model"),
                           dtype=dtype)}


def rank_ids(ids: torch.Tensor) -> torch.Tensor:
    """Token ids as a stacked tensor: ``[B, S]`` ids that every rank sees
    become ``[1, B, S]`` (broadcast over the ranks); where the data axis
    is bound each rank holds its own slice of the batch and the ids are
    already ``[p, B/p, S]``."""
    return ids if has_axis(AXES.data) else ids.unsqueeze(0)


def _vocab_offsets(p: int, v_t: int, device) -> torch.Tensor:
    """Each rank's first vocab id, ``axis_index(model) * V_t``: ``[p]``."""
    if has_axis(AXES.model):
        return axis_index(AXES.model) * v_t
    return torch.zeros(p, dtype=torch.int64, device=device)


class _TakeRows(torch.autograd.Function):
    """``table.index_select(0, rows)`` whose backward sums the gradients of
    repeated rows in float32 (or wider) before casting them to the table's
    dtype.  ``index_select``'s own backward adds them in the table's dtype
    with atomics, so a bf16 table's gradient for a frequent token (hundreds
    of rows under Zipf ids) changes by several percent from run to run."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, rows: torch.Tensor):
        ctx.save_for_backward(rows)
        ctx.n_rows = table.shape[0]
        return table.index_select(0, rows)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (rows,) = ctx.saved_tensors
        wide = torch.promote_types(g.dtype, torch.float32)
        if is_fake(rows):
            # a capture on fake tensors (analysis.graph) cannot size
            # unique's output: the same sums, into a table-sized buffer
            acc = torch.zeros(ctx.n_rows, g.shape[-1], dtype=wide,
                              device=g.device).index_add_(0, rows,
                                                          g.to(wide))
            return acc.to(g.dtype), None
        uniq, inv = torch.unique(rows, return_inverse=True)
        acc = torch.zeros(uniq.numel(), g.shape[-1], dtype=wide,
                          device=g.device).index_add_(0, inv, g.to(wide))
        dt = g.new_zeros(ctx.n_rows, g.shape[-1])
        dt[uniq] = acc.to(g.dtype)
        return dt, None


def embed_lookup(params, tokens: torch.Tensor, *, scale: float | None = None):
    """tokens: ``[B, S]`` global ids, the same on every rank (or each
    rank's own ``[p, B/p, S]`` under the data axis, ``rank_ids``); the
    table ``[p, V_t, D]`` is vocab-sharded over the model axis.  Each rank
    looks up the ids in its own vocab block (offset ``axis_index * V_t``),
    zeroes the rest, and the partial embeddings are summed over the
    axis."""
    table = ops.fsdp_gather(params["table"], 1)        # [p, V_t, D]
    p, v_t, d = table.shape
    ids = rank_ids(tokens)
    lead = [1] * (ids.dim() - 1)
    local = ids - _vocab_offsets(p, v_t, table.device).view(p, *lead)
    ok = (local >= 0) & (local < v_t)
    rows = local.clamp(0, v_t - 1) + (torch.arange(
        p, device=table.device) * v_t).view(p, *lead)
    emb = _TakeRows.apply(table.reshape(p * v_t, d), rows.reshape(-1))
    emb = emb.view(*local.shape, d).masked_fill(~ok[..., None], 0)
    emb = ops.tp_allreduce(emb)
    if scale is not None:
        emb = emb * torch.tensor(scale, dtype=emb.dtype, device=emb.device)
    return emb


def lm_logits(params, x, head_params=None, *, final_softcap=None):
    """x: ``[p, B, S, D]`` -> logits ``[p, B, S, V_t]`` (vocab-sharded,
    float32)."""
    if head_params is not None:
        logits = ops.col_matmul(x, head_params["w"], fsdp_dim=0)
    else:
        # the table [V_t, D] transposed is K-sharded on dim 0 over "data"
        logits = ops.col_matmul(x, params["table"].transpose(1, 2),
                                fsdp_dim=0)
    logits = logits.float()
    if final_softcap:
        logits = torch.tanh(logits / final_softcap) * final_softcap
    return logits


def sharded_xent(logits, labels, mask=None):
    """Cross-entropy with the vocab dim sharded over TP.

    logits: ``[p, B, S, V_t]`` float32; labels: ``[B, S]`` global ids (or
    per rank, ``rank_ids``); mask: like labels.  Returns each rank's mean
    NLL over the unmasked tokens of its batch, ``[p]`` (the caller
    averages over the data axis).  The max over the vocab shards is taken
    over the model axis with no gradient (``StackedAxis.pmax``), as the
    JAX package's ``lax.pmax`` of a stopped value (undispatched there
    too); logsumexp does not depend on it."""
    p, v_t = logits.shape[0], logits.shape[-1]
    with torch.no_grad():
        m = logits.amax(-1)
        if has_axis(AXES.model):
            m = get_axis(AXES.model).pmax(m)
    se = torch.sum(torch.exp(logits - m[..., None]), dim=-1)
    se = ops.tp_allreduce(se)
    logz = torch.log(se) + m
    ids = rank_ids(labels)
    local = ids - _vocab_offsets(p, v_t, logits.device).view(
        p, *[1] * (ids.dim() - 1))
    ok = (local >= 0) & (local < v_t)
    tgt = torch.gather(logits, -1, local.clamp(0, v_t - 1)[..., None].to(
        torch.int64))[..., 0]
    tgt = torch.where(ok, tgt, torch.zeros((), dtype=tgt.dtype,
                                           device=tgt.device))
    tgt = ops.tp_allreduce(tgt)
    nll = logz - tgt
    dims = tuple(range(1, nll.dim()))
    if mask is not None:
        nll = nll * rank_ids(mask)
        denom = torch.clamp(torch.sum(rank_ids(mask).expand_as(nll).float(),
                                      dim=dims), min=1.0)
    else:
        denom = float(nll[0].numel())
    return torch.sum(nll, dim=dims) / denom
