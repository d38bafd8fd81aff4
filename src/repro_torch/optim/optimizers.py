"""AdamW and Adafactor on stacked leaves.

Every parameter leaf is ``[p, *local_shape]`` (``models.params``), and
every per-leaf rule of the JAX package (``repro/optim/optimizers.py``) is
applied per rank: ``_factored`` looks at the per-rank ndim (a stacked
``[p, d]`` norm scale is not factored), and Adafactor's means and its
update rms run over the per-rank dims, never across dim 0.  State leaves
mirror the parameter's sharding, so optimizer memory is ZeRO-sharded
under FSDP as in the JAX package.

The updates write the parameters and the state IN PLACE and return them:
the JAX package's trainer donates both to its jitted step
(``donate_argnums``), so a caller there cannot reuse them either, and
in place the step needs no second copy of the model on the card.  The
step count is a 0-dim int32 tensor on the host, and so is the learning
rate: neither makes the device wait.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.params import (ParamSpec, tree_leaves,
                                       tree_map_specs, tree_unflatten)


def lr_schedule(step, *, base_lr=3e-4, warmup=100, total=10_000
                ) -> torch.Tensor:
    """Linear warm-up, then cosine decay to a floor of 0.1, in float32."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return base_lr * torch.minimum(warm, torch.tensor(1.0)) * torch.maximum(
        cos, torch.tensor(0.1))


def _map(fn, params, *trees):
    """``fn(p, *subtrees)`` for every parameter leaf ``p``; the other
    trees are walked only as deep as ``params`` (an Adafactor state leaf
    is a dict)."""
    if isinstance(params, dict):
        for k in params:
            _map(fn, params[k], *(t[k] for t in trees))
    elif isinstance(params, list):
        for i, p in enumerate(params):
            _map(fn, p, *(t[i] for t in trees))
    else:
        fn(params, *trees)


def _like(params, mk):
    """A state tree mirroring ``params``: ``mk(p)`` per leaf."""
    return tree_unflatten(params, [mk(p) for p in tree_leaves(params)])


def _count() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw_init(params):
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": _like(params, zeros), "v": _like(params, zeros),
            "count": _count()}


def adamw_update(grads, state, params, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1):
    c = state["count"] + 1
    cf = c.float()
    bc1, bc2 = 1 - b1 ** cf, 1 - b2 ** cf

    def upd(p, g, m, v):
        g = g.float()
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        mh = m / bc1
        vh = v / bc2
        pf = p.float()
        step = mh / (torch.sqrt(vh) + eps) + weight_decay * pf
        p.copy_(pf - lr * step)

    with torch.no_grad():
        _map(upd, params, grads, state["m"], state["v"])
    return params, {"m": state["m"], "v": state["v"], "count": c}


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; no first moment)
# ---------------------------------------------------------------------------


def _factored(p: torch.Tensor) -> bool:
    return p.dim() - 1 >= 2          # the per-rank ndim


def adafactor_init(params):
    def mk(p):
        z = dict(dtype=torch.float32, device=p.device)
        if _factored(p):
            return {"vr": torch.zeros(p.shape[:-1], **z),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
        return {"v": torch.zeros(p.shape, **z)}
    return {"f": _like(params, mk), "count": _count()}


def _rank_mean(u: torch.Tensor) -> torch.Tensor:
    """Mean over the per-rank dims, kept for broadcasting: ``[p, 1, ...]``."""
    if u.dim() == 1:
        return u
    return u.mean(dim=tuple(range(1, u.dim())), keepdim=True)


def adafactor_update(grads, state, params, *, lr, b2=0.999, eps=1e-30,
                     clip=1.0, weight_decay=0.0):
    c = state["count"] + 1

    def upd(p, g, s):
        g = g.float()
        g2 = g * g + eps
        if _factored(p):
            s["vr"].mul_(b2).add_((1 - b2) * g2.mean(-1))
            s["vc"].mul_(b2).add_((1 - b2) * g2.mean(-2))
            vr, vc = s["vr"], s["vc"]
            r = vr / torch.clamp(vr.mean(-1, keepdim=True), min=eps)
            u = g / torch.sqrt(
                r[..., None] * vc[..., None, :]
                / torch.clamp(vc.mean(-1, keepdim=True)[..., None, :],
                              min=eps) + eps)
        else:
            s["v"].mul_(b2).add_((1 - b2) * g2)
            u = g / torch.sqrt(s["v"] + eps)
        rms = torch.sqrt(_rank_mean(u * u) + eps)
        u = u / torch.clamp(rms / clip, min=1.0)
        pf = p.float()
        p.copy_(pf - lr * (u + weight_decay * pf))

    with torch.no_grad():
        _map(upd, params, grads, state["f"])
    return params, {"f": state["f"], "count": c}


def get_optimizer(name: str):
    if name == "adamw":
        return adamw_init, adamw_update
    if name == "adafactor":
        return adafactor_init, adafactor_update
    raise ValueError(f"unknown optimizer {name!r}")


def state_specs(name: str, spec_tree):
    """The optimizer state's spec tree at GLOBAL shapes (without the step
    count), for carrying a state between the stacked layout and the JAX
    package's global one (``params.from_reference`` / ``to_reference``).
    The JAX package keeps this as sharding metadata
    (``trainer.opt_state_pspecs``); the port needs no ``shard_map``
    specs, only the layout."""
    def f32(s: ParamSpec, shape, dims) -> ParamSpec:
        return ParamSpec(tuple(shape), tuple(dims), "zeros", None, "float32")

    if name == "adamw":
        ms = tree_map_specs(lambda s: f32(s, s.shape, s.dims), spec_tree)
        return {"m": ms, "v": ms}
    if name == "adafactor":
        def fac(s: ParamSpec):
            if len(s.shape) >= 2:
                return {"vr": f32(s, s.shape[:-1], s.dims[:-1]),
                        "vc": f32(s, s.shape[:-2] + s.shape[-1:],
                                  s.dims[:-2] + s.dims[-1:])}
            return {"v": f32(s, s.shape, s.dims)}
        return {"f": tree_map_specs(fac, spec_tree)}
    raise ValueError(f"unknown optimizer {name!r}")
