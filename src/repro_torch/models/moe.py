"""Mixture-of-Experts with expert parallelism over the model axis.

The port's counterpart of the JAX package's ``models/moe.py``.  GShard-
style capacity dispatch; the position of each (token, slot) choice in its
expert is a cumsum over the flattened choices, so no ``[T, E, C]``
one-hot is ever built.  Choices over capacity are dropped in that
flattened order.  With ``cfg.moe.global_capacity`` and a bound ``data``
axis the keep decision uses the choice's position in the GLOBAL
per-expert order (one extra tunable ``api.allreduce`` of router stats
over ``data``), so data-sharded drops equal a single-device run's.

The expert shuffle is two all-to-alls over the model axis through
``ops.ep_alltoall``: the dispatch and the combine.  Shared experts
(DeepSeek) run as a dense TP MLP on every token.

Operands are stacked over the lanes of the bound axes (``dist.axes``):
``x`` is ``[L, B, S, D]``, every routing tensor carries the lane dim
first, and the cumsum runs per lane.  The model axis' size comes from the
binding.  Under pure TP every model rank holds all T tokens and routes
all of them, so rank j receives tp identical copies of the choices for
its experts and runs ``[E/tp, tp*cap, D]`` rows through them: the JAX
package's semantics and shapes, kept as they are.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import api
from repro_torch.dist import ops
from repro_torch.dist.axes import (AXES, axis_index, axis_size_or_1, get_axis,
                                   has_axis)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import mlp, mlp_specs
from repro_torch.models.params import ParamSpec


def moe_specs(cfg: ModelConfig) -> dict:
    m = cfg.moe
    d, dt = cfg.d_model, cfg.dtype
    specs = {
        "router": ParamSpec((d, m.n_experts), ("data", None),
                            dtype="float32"),
        # experts sharded over TP on the expert dim, FSDP on d_model
        "w_in": ParamSpec((m.n_experts, d, m.d_ff_expert),
                          ("model", "data", None), dtype=dt),
        "w_gate": ParamSpec((m.n_experts, d, m.d_ff_expert),
                            ("model", "data", None), dtype=dt),
        "w_out": ParamSpec((m.n_experts, m.d_ff_expert, d),
                           ("model", None, "data"), dtype=dt),
    }
    if m.n_shared:
        specs["shared"] = mlp_specs(d, m.n_shared * m.d_ff_expert, dt)
    return specs


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    m = cfg.moe
    c = int(n_tokens * m.top_k * m.capacity_factor / m.n_experts)
    return max(4, -(-c // 4) * 4)


def _route(p: dict, cfg: ModelConfig, xt: torch.Tensor):
    """The float32 router: ``xt [L, T, D]`` -> ``(probs [L, T, E],
    gate_vals [L, T, k] renormalised, expert_ids [L, T, k])``."""
    logits = ops.matmul_accumulate(xt.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, cfg.moe.top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(-1, keepdim=True), min=1e-9)
    return probs, gate_vals, expert_ids


def _keep(cfg: ModelConfig, flat_e: torch.Tensor, t: int):
    """Position in expert and keep decision of each flattened (token,
    slot) choice ``flat_e [L, T*k]``.  Returns ``(pos_in_e, keep,
    cap_buf, counts)``: ``pos_in_e`` the choice's local position,
    ``keep`` whether it fits ``cap``, ``cap_buf`` the rows a local
    dispatch buffer holds per expert, ``counts`` the local ``[L, E]``
    choice counts."""
    m = cfg.moe
    cap = _capacity(t, cfg)
    onehot = F.one_hot(flat_e, m.n_experts).to(torch.int32)    # [L, T*k, E]
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
    pos_in_e = torch.gather(pos, 2, flat_e[..., None])[..., 0]
    counts = onehot.sum(1, dtype=torch.int32)                    # [L, E]
    if m.global_capacity and has_axis(AXES.data):
        # the batch is split contiguously over the data axis, so the global
        # position is the local one plus the preceding shards' per-expert
        # counts: one tunable allreduce of one-hot-placed [dp, E] int32
        # stats (the JAX package's exchange)
        dax = get_axis(AXES.data)
        dp = dax.size
        cap = _capacity(t * dp, cfg)
        di = axis_index(AXES.data)                               # [L]
        lanes = flat_e.shape[0]
        placed = torch.zeros(lanes, dp, m.n_experts, dtype=torch.int32,
                             device=flat_e.device)
        placed[torch.arange(lanes, device=flat_e.device), di] = counts
        all_counts = api.allreduce(placed, dax)                  # [L, dp, E]
        before = (torch.arange(dp, device=flat_e.device)[None, :]
                  < di[:, None])                                 # [L, dp]
        offset = torch.where(before[..., None], all_counts, 0).sum(
            1, dtype=torch.int32)                                # [L, E]
        pos_keep = pos_in_e + torch.gather(offset, 1, flat_e)
        # the local buffer only ever holds this shard's kept choices
        cap_buf = min(cap, max(4, -(-(t * m.top_k) // 4) * 4))
    else:
        pos_keep = pos_in_e
        cap_buf = cap
    return pos_in_e, pos_keep < cap, cap_buf, counts


def moe_block(p: dict, cfg: ModelConfig, x: torch.Tensor):
    """``x [L, B, S, D]`` -> ``(y [L, B, S, D], aux [L])``; experts
    sharded over the model axis."""
    m = cfg.moe
    tp = axis_size_or_1(AXES.model)
    e_loc = m.n_experts // tp
    lanes, b, s, d = x.shape
    t = b * s
    k = m.top_k
    xt = x.reshape(lanes, t, d)

    # --- routing (float32, replicated over TP) ------------------------------
    probs, gate_vals, expert_ids = _route(p, cfg, xt)
    flat_e = expert_ids.reshape(lanes, t * k)
    pos_in_e, keep, cap_buf, counts = _keep(cfg, flat_e, t)

    # load-balance aux (Switch): E * sum_e f_e * P_e, f_e an exact count
    me = probs.mean(dim=1)                                       # [L, E]
    ce = counts.float() / (t * k)
    aux = m.n_experts * torch.sum(me * ce, dim=-1)               # [L]

    # --- dispatch into [E*cap_buf, D] a lane, one drop bin after all lanes --
    # kept choices have distinct rows; only the drop bin is written twice,
    # and it is cut off, so the scatter is a deterministic copy
    rows = m.n_experts * cap_buf
    lane0 = torch.arange(lanes, device=x.device)[:, None] * rows
    drop = lanes * rows
    dst = torch.where(keep, lane0 + flat_e * cap_buf + pos_in_e,
                      drop).reshape(lanes, t, k)
    buf = x.new_zeros(drop + 1, d)
    src = xt.reshape(lanes * t, d)
    for j in range(k):
        buf.index_put_((dst[..., j].reshape(-1),), src)
    buf = buf[:drop].view(lanes, rows, d)

    # --- EP all-to-all: the expert-major buffer is already shard-tiled -------
    buf = ops.ep_alltoall(buf)               # [L, tp*Eloc*cap, D]
    buf = buf.reshape(lanes, tp, e_loc, cap_buf, d).transpose(1, 2)
    buf = buf.reshape(lanes, e_loc, tp * cap_buf, d)

    # --- expert FFN ----------------------------------------------------------
    w_in = ops.fsdp_gather(p["w_in"], 1)     # [L, Eloc, D, F]
    w_gate = ops.fsdp_gather(p["w_gate"], 1)
    w_out = ops.fsdp_gather(p["w_out"], 2)   # [L, Eloc, F, D]
    h = torch.matmul(buf, w_in)
    g = torch.matmul(buf, w_gate)
    y = torch.matmul(F.silu(g) * h, w_out)   # [L, Eloc, tp*cap, D]

    # --- reverse all-to-all + combine ---------------------------------------
    y = y.reshape(lanes, e_loc, tp, cap_buf, d).transpose(1, 2).reshape(
        lanes, rows, d)
    y = ops.ep_alltoall(y).reshape(lanes * rows, d)   # [L*E*cap, D]
    # a dropped choice reads row 0 and is weighted by 0
    wgt = (gate_vals.to(y.dtype) * keep.reshape(lanes, t, k).to(y.dtype))
    at = torch.where(dst == drop, 0, dst)
    out = None
    for j in range(k):
        part = y[at[..., j].reshape(-1)].view(lanes, t, d) * wgt[..., j, None]
        out = part if out is None else out + part

    if m.n_shared:
        out = out + mlp(p["shared"], xt)
    return out.reshape(lanes, b, s, d), aux
