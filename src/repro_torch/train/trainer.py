"""The distributed training step on the stacked axis.

Structure of one step (all collectives through ``repro_torch.core.api``),
as in the JAX package's ``repro/train/trainer.py``:

1. microbatches with gradient accumulation (``n_micro``), each one
   forward and one autograd backward of the sum of the per-rank losses;
2. FSDP: per-layer all-gather fwd / reduce-scatter bwd (the
   ``torch.autograd.Function``s of ``dist/ops.py``); grads of
   "data"-sharded leaves arrive summed over the data axis;
3. replicated-leaf grads averaged over "data" with a tunable all-reduce
   (and the cross-pod all-reduce of the JAX package, optionally in bf16;
   the port never binds "pod");
4. the optimizer update (sharded states), in place.

The grad sync of (2)-(3) is backward-phase traffic: it runs under
``api.phase("bwd")``, so the trace-replay tuner may give it a profile of
its own.  The metrics (global mean loss, grad norm) add the JAX package's
small all-reduces in the forward phase; the grad norm counts a leaf that
is replicated over the model axis once per rank, as the JAX package does.

The JAX package wraps the step in ``shard_map`` over a mesh; the port
stacks the mesh's ranks on one device (``dist.axes``): ``data`` alone for
FSDP (each rank holds its ZeRO-3 shards and its slice of the batch),
``model`` alone for tensor parallelism (every rank sees the whole
batch), or both, two views of one ``StackedMesh`` of ``d*t`` lanes (data
rank i's batch slice on its t model ranks, every leaf cut over both of
its names; the row-parallel ``fsdp_dim=1`` sites then run
``matmul_reducescatter_2d``).  Its ``opt_state_pspecs`` is sharding
metadata for ``shard_map`` and has no counterpart here: optimizer states
are stacked like their parameters (``optim.state_specs`` gives their
global layout for checkpoints).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import api
from repro_torch.core._axis import StackedAxis, StackedMesh
from repro_torch.dist.axes import (AXES, axis_size_or_1, bind, get_axis,
                                   has_axis)
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import (ParamSpec, from_reference, init_tree,
                                       layout, stacked, to_reference,
                                       tree_leaves, tree_unflatten)
from repro_torch.optim import get_optimizer, lr_schedule, state_specs


# ---------------------------------------------------------------------------
# gradient finalization
# ---------------------------------------------------------------------------


def _map_with_specs(fn, tree, spec_tree):
    if isinstance(spec_tree, ParamSpec):
        return fn(tree, spec_tree)
    if isinstance(spec_tree, list):
        return [_map_with_specs(fn, t, s) for t, s in zip(tree, spec_tree)]
    return {k: _map_with_specs(fn, tree[k], s) for k, s in spec_tree.items()}


def _div(g: torch.Tensor, n: int) -> torch.Tensor:
    return g if n == 1 else g / n        # x / 1 is exact: skip the copy


def finalize_grads(grads, spec_tree, *, compress: str = "none"):
    """Cross-shard gradient reduction (see module docstring)."""
    d = axis_size_or_1(AXES.data)
    pod = axis_size_or_1(AXES.pod)

    def fin(g, spec: ParamSpec):
        fsdp = "data" in spec.dims
        if has_axis(AXES.data) and not fsdp:
            g = api.allreduce(g.contiguous(), get_axis(AXES.data))
        if has_axis(AXES.pod):
            if compress == "bf16":
                g = api.allreduce(g.to(torch.bfloat16),
                                  get_axis(AXES.pod)).float()
            else:
                g = api.allreduce(g, get_axis(AXES.pod))
        return _div(g, d * pod if not fsdp else pod)

    return _map_with_specs(fin, grads, spec_tree)


def _fsdp_mean(grads, spec_tree):
    """FSDP leaves got the SUM over data from the reduce-scatter; divide."""
    d = axis_size_or_1(AXES.data)
    return _map_with_specs(
        lambda g, s: _div(g, d) if "data" in s.dims else g, grads, spec_tree)


# ---------------------------------------------------------------------------
# step functions (called inside the axis binding)
# ---------------------------------------------------------------------------


def _value_and_grad(params, cfg: ModelConfig, batch):
    """``(loss [p], grads)``: one forward and one backward of the sum of
    the per-rank losses; rank r's cotangent is 1 for its own loss, as in
    the JAX package's per-shard ``value_and_grad``."""
    leaves = tree_leaves(params)
    req = [t.detach().requires_grad_(True) for t in leaves]
    loss, _ = lm.loss_fn(tree_unflatten(params, req), cfg, batch)
    gs = torch.autograd.grad(loss.sum(), req, allow_unused=True)
    gs = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, gs)]
    return loss.detach(), tree_unflatten(params, gs)


def _micro(batch: dict, i: int, n_micro: int) -> dict:
    """Microbatch i of n_micro: rows of each rank's batch (dim 1 under
    the data axis, dim 0 where every rank sees the whole batch)."""
    dim = 1 if has_axis(AXES.data) else 0

    def cut(x):
        b = x.shape[dim] // n_micro
        return x.narrow(dim, i * b, b)
    return {k: cut(v) for k, v in batch.items()}


def make_step_fns(cfg: ModelConfig, axis, name: str | None, *,
                  n_micro: int = 1, compress: str = "none",
                  base_lr: float = 3e-4, warmup: int = 100,
                  total_steps: int = 10_000):
    """Returns ``(init_fn, grad_fn, train_fn)`` on stacked values; the
    last two run inside ``bind(**{name: axis})`` (no binding when
    ``name`` is None, a single rank), or, for a ``StackedMesh`` ``axis``,
    inside the binding of each of its names to its view.

    init_fn(seed)                    -> (params, opt_state)
    grad_fn(params, batch)           -> (loss [p], finalized grads)
    train_fn(params, opt, batch, i)  -> (params, opt, metrics)

    ``train_fn`` updates ``params`` and ``opt`` in place (see
    ``optim.optimizers``)."""
    opt_init, opt_update = get_optimizer(cfg.optimizer)
    tp = dict(layout(axis, name)).get(AXES.model, 1)
    specs = lm.model_specs(cfg, tp)

    def init_fn(seed: int):
        gen = torch.Generator(device=axis.device).manual_seed(seed)
        params = init_tree(specs, gen, axis, name or AXES.model)
        return params, opt_init(params)

    def grad_fn(params, batch):
        if n_micro > 1:
            acc, losses = None, []
            for i in range(n_micro):
                loss, g = _value_and_grad(params, cfg,
                                          _micro(batch, i, n_micro))
                g = [(x / n_micro).float() for x in tree_leaves(g)]
                acc = g if acc is None else [a + x for a, x in zip(acc, g)]
                losses.append(loss)
            grads = tree_unflatten(params, acc)
            loss = torch.stack(losses).mean(0)
        else:
            loss, grads = _value_and_grad(params, cfg, batch)
        # grad sync is backward-phase traffic: the trace-replay tuner may
        # give these allreduces a different profile than fwd collectives
        with api.phase("bwd"):
            grads = _fsdp_mean(grads, specs)
            grads = finalize_grads(grads, specs, compress=compress)
        return loss, grads

    def train_fn(params, opt_state, batch, step_idx):
        loss, grads = grad_fn(params, batch)
        lr = lr_schedule(step_idx, base_lr=base_lr, warmup=warmup,
                         total=total_steps)
        params, opt_state = opt_update(grads, opt_state, params, lr=lr)

        # metrics: global mean loss + grad-norm (cheap diagnostics)
        gsq = sum(torch.sum(torch.square(g.float()).reshape(g.shape[0], -1),
                            dim=1) for g in tree_leaves(grads))
        for ax in (AXES.data, AXES.model, AXES.pod):
            if has_axis(ax):
                gsq = api.allreduce(gsq[:, None], get_axis(ax))[:, 0]
                if ax in (AXES.data, AXES.pod):
                    loss = api.allreduce(loss[:, None], get_axis(ax))[
                        :, 0] / axis_size_or_1(ax)
        metrics = {"loss": loss[0], "grad_norm": torch.sqrt(gsq)[0],
                   "lr": lr}
        return params, opt_state, metrics

    return init_fn, grad_fn, train_fn


# ---------------------------------------------------------------------------
# host-side trainer
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Trainer:
    """The host side of the training loop: ``mesh=(d, t)`` stacks d data
    ranks (FSDP) and t model ranks (TP) on ``device`` (the card unless the
    caller asks for the CPU).  One of them above 1 binds that axis alone
    (``axis`` a ``StackedAxis``); both above 1 bind the two views of a
    ``StackedMesh`` of ``d*t`` lanes (``axis`` the mesh, ``name`` None);
    (1, 1) binds no axis."""
    cfg: ModelConfig
    mesh: tuple[int, int] = (1, 1)       # (data, model)
    device: Any = None
    n_micro: int = 1
    compress: str = "none"
    profiles: Any = None
    phase_profiles: dict | None = None   # phase tag -> ProfileStore
    force: dict | None = None
    base_lr: float = 3e-4
    warmup: int = 100
    record: list | None = None           # shared dispatch-record sink

    def __post_init__(self):
        d, t = self.mesh
        if d < 1 or t < 1:
            raise ValueError(f"mesh {d}x{t}: both sizes must be >= 1")
        if d > 1 and t > 1:
            self.name = None
            self.axis = StackedMesh((d, t), (AXES.data, AXES.model),
                                    self.device)
        else:
            self.name = (AXES.data if d > 1
                         else (AXES.model if t > 1 else None))
            self.axis = StackedAxis(max(d, t), self.device,
                                    name=self.name or "")
        self.specs = lm.model_specs(self.cfg, t)
        self._init, self._grad, self._train = make_step_fns(
            self.cfg, self.axis, self.name, n_micro=self.n_micro,
            compress=self.compress, base_lr=self.base_lr,
            warmup=self.warmup)

    def _bound(self):
        if isinstance(self.axis, StackedMesh):
            return bind(**{n: self.axis[n] for n in self.axis.names})
        if self.name is None:
            return contextlib.nullcontext()
        return bind(**{self.name: self.axis})

    @contextlib.contextmanager
    def _tuned(self):
        with self._bound(), api.tuned(profiles=self.profiles,
                                      phase_profiles=self.phase_profiles,
                                      force=self.force,
                                      record=self.record) as ctx:
            yield ctx

    def init(self, seed: int = 0):
        return self._init(seed)

    def step(self, params, opt_state, batch, i: int):
        """One training step; ``params`` and ``opt_state`` are updated in
        place (the JAX package's step donates them)."""
        with self._tuned():
            return self._train(params, opt_state, batch, i)

    def grads(self, params, batch):
        """``(loss, grads)`` of one step without the update: the global
        mean loss (a 0-dim tensor) and the finalized gradients, the
        optimizer's input."""
        with self._tuned():
            loss, grads = self._grad(params, batch)
            if has_axis(AXES.data):
                loss = loss.mean()
        return loss if loss.dim() == 0 else loss[0], grads

    def put_batch(self, batch: dict) -> dict:
        """A global numpy batch -> tensors on the device; under the data
        axis each rank's contiguous slice of the rows, ``[p, B/p, ...]``
        (on a mesh ``[d*t, B/d, ...]``: data rank i's slice on each of its
        t model ranks)."""
        d, t_ = self.mesh
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(np.asarray(v), device=self.axis.device)
            if d > 1:
                if t.shape[0] % d:
                    raise ValueError(f"batch {t.shape[0]} does not split "
                                     f"over {d} data ranks")
                t = t.reshape(d, 1, -1, *t.shape[1:])
                t = t.expand(d, t_, *t.shape[2:]).reshape(
                    d * t_, *t.shape[2:])
            out[k] = t
        return out

    # -- checkpoints: the JAX package's global layout --------------------
    def global_specs(self) -> dict:
        """Spec tree of ``{"params", "opt"}`` in the JAX package's global
        layout (a scanned group's leaves stacked over its layers)."""
        opt = scanned(state_specs(self.cfg.optimizer, self.specs))
        opt["count"] = ParamSpec((), (), "zeros", None, "int32")
        return {"params": scanned(self.specs), "opt": opt}

    def to_global(self, params, opt_state) -> dict:
        """``{"params", "opt"}`` as CPU tensors in the global layout."""
        name = self.name or AXES.model
        osp = state_specs(self.cfg.optimizer, self.specs)
        opt = {k: to_reference(opt_state[k], s, self.axis, name)
               for k, s in osp.items()}
        opt["count"] = opt_state["count"].detach().cpu().clone()
        return {"params": to_reference(params, self.specs, self.axis, name),
                "opt": opt}

    def from_global(self, tree: dict):
        """The inverse of ``to_global``: ``(params, opt_state)`` stacked on
        the device."""
        name = self.name or AXES.model
        params = from_reference(tree["params"], self.specs, self.axis, name)
        osp = state_specs(self.cfg.optimizer, self.specs)
        opt = {k: from_reference(tree["opt"][k], s, self.axis, name)
               for k, s in osp.items()}
        opt["count"] = torch.as_tensor(np.asarray(tree["opt"]["count"]),
                                       dtype=torch.int32).reshape(())
        return params, opt


def scanned(specs):
    """A spec tree with each list node (the port's per-layer list of a
    scanned group) turned into the JAX package's stacked leaves."""
    if isinstance(specs, list):
        return _stack_specs(specs)
    if isinstance(specs, dict):
        return {k: scanned(v) for k, v in specs.items()}
    return specs


def _stack_specs(layers: list):
    first = layers[0]
    if isinstance(first, ParamSpec):
        return stacked(len(layers), first)
    return {k: _stack_specs([lay[k] for lay in layers]) for k in first}
