"""The distributed training step on the stacked axis.

Structure of one step (all collectives through ``repro_torch.core.api``),
as in the JAX package's ``repro/train/trainer.py``:

1. microbatches with gradient accumulation (``n_micro``), each one
   forward and one autograd backward of the sum of the per-rank losses;
2. FSDP: per-layer all-gather fwd / reduce-scatter bwd (the
   ``torch.autograd.Function``s of ``dist/ops.py``); grads of
   "data"-sharded leaves arrive summed over the data axis;
3. replicated-leaf grads averaged over "data" with a tunable all-reduce,
   then every leaf's cross-pod all-reduce over "pod" (optionally in
   bf16): with (2) this is the JAX package's hierarchical RS -> AR -> AG
   schedule;
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
``matmul_reducescatter_2d``), or the JAX package's three-axis mesh
``("pod", "data", "model")``: three views of one ``StackedMesh``, the
batch cut over pod x data, parameters replicated over ``pod`` (pure data
parallelism between pods).  Its ``opt_state_pspecs`` is sharding
metadata for ``shard_map`` and has no counterpart here: optimizer states
are stacked like their parameters (``optim.state_specs`` gives their
global layout for checkpoints).

Across processes (``Trainer(processes=True)``) the same mesh is laid
over the ranks of the initialized world, one lane a process: a
``GroupMesh`` where the stacked trainer builds a ``StackedMesh``, a
``GroupAxis`` where it builds a ``StackedAxis``; rank r holds lane r of
the stacked layout.  The step functions are unchanged: they work on a
leading lane dim, and a process holds one lane.  What the host side adds
is outside the dispatcher, as the JAX package's host side is: rank 0's
batch broadcast to every rank (each process salts ``hash(cfg.name)``,
which ``make_batch`` seeds from), the mean loss of ``grads`` over the
world, and the lanes gathered to rank 0 for a checkpoint.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import api
from repro_torch.core._axis import (GroupAxis, GroupMesh, StackedAxis,
                                    StackedMesh, is_mesh, spans_processes)
from repro_torch.dist.axes import (AXES, axis_size_or_1, bind, get_axis,
                                   has_axis)
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import (ParamSpec, from_reference, init_tree,
                                       layout, local, stacked, to_reference,
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
                g = api.allreduce(g.contiguous(), get_axis(AXES.pod))
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
    (1, 1) binds no axis.  ``mesh=(pod, d, t)`` always binds the three
    views of a ``StackedMesh`` of ``pod*d*t`` lanes, sizes of 1
    included, as the JAX package's mesh with a pod axis does.

    ``processes=True`` lays the same mesh over the processes of the
    initialized world (``launch.mesh.init_world``), whose size must be
    the mesh's: a ``GroupMesh`` for a mesh, a ``GroupAxis`` for one axis
    above 1 (or for (1, 1), which binds no axis).  Every rank then calls
    every method, each on its own lane."""
    cfg: ModelConfig
    mesh: tuple[int, ...] = (1, 1)       # (data, model) or (pod, d, t)
    device: Any = None
    n_micro: int = 1
    compress: str = "none"
    profiles: Any = None
    phase_profiles: dict | None = None   # phase tag -> ProfileStore
    force: dict | None = None
    base_lr: float = 3e-4
    warmup: int = 100
    record: list | None = None           # shared dispatch-record sink
    processes: bool = False              # one rank a process of the world

    def __post_init__(self):
        self.mesh = tuple(int(n) for n in self.mesh)
        if len(self.mesh) not in (2, 3) or min(self.mesh) < 1:
            raise ValueError(f"mesh {self.mesh}: (data, model) or (pod, "
                             "data, model), every size >= 1")
        d, t = self.mesh[-2:]
        if self.processes:
            world = dist.get_world_size() if dist.is_initialized() else 0
            if world != math.prod(self.mesh):
                raise ValueError(
                    f"mesh {self.mesh} has {math.prod(self.mesh)} ranks, "
                    f"the world {world} processes")
        if len(self.mesh) == 3 or (d > 1 and t > 1):
            self.name = None
            make = GroupMesh if self.processes else StackedMesh
            self.axis = make(
                self.mesh, (AXES.pod, AXES.data, AXES.model)[-len(self.mesh):],
                self.device)
        else:
            self.name = (AXES.data if d > 1
                         else (AXES.model if t > 1 else None))
            self.axis = (GroupAxis(self.device, name=self.name or "")
                         if self.processes else
                         StackedAxis(max(d, t), self.device,
                                     name=self.name or ""))
        self.specs = lm.model_specs(self.cfg, t)
        self._init, self._grad, self._train = make_step_fns(
            self.cfg, self.axis, self.name, n_micro=self.n_micro,
            compress=self.compress, base_lr=self.base_lr,
            warmup=self.warmup)

    def _bound(self):
        if is_mesh(self.axis):
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
                if spans_processes(self.axis):
                    # the lanes' mean: the model ranks of a data rank
                    # hold the same loss
                    dist.all_reduce(loss)
                    loss = loss / dist.get_world_size()
        return loss if loss.dim() == 0 else loss[0], grads

    def put_batch(self, batch: dict) -> dict:
        """A global numpy batch -> tensors on the device; under the data
        axis each rank's contiguous slice of the rows, ``[p, B/p, ...]``
        (on a mesh ``[d*t, B/d, ...]``: data rank i's slice on each of its
        t model ranks; with a pod axis ``[pod*d*t, B/(pod*d), ...]``, pod
        rank i's data rank j taking slice ``i*d + j``).

        Across processes every rank must call it, with arrays of the same
        shapes: each takes rank 0's batch (a broadcast, key by key in
        sorted order) and keeps its lane of that layout, ``[1, B/(pod*d),
        ...]``; without a data axis every rank sees the whole batch."""
        d, t_ = math.prod(self.mesh[:-1]), self.mesh[-1]
        procs = spans_processes(self.axis)
        out = {}
        for k in sorted(batch):
            # a copy across processes: the broadcast writes into it
            t = (torch.tensor if procs else torch.as_tensor)(
                np.asarray(batch[k]), device=self.axis.device)
            if procs:
                dist.broadcast(t, src=0)
            if d > 1 or len(self.mesh) == 3:
                if t.shape[0] % d:
                    raise ValueError(f"batch {t.shape[0]} does not split "
                                     f"over {d} data ranks")
                t = t.reshape(d, 1, -1, *t.shape[1:])
                if procs:
                    t = t[self.axis.mesh_rank // t_]
                else:
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

    def to_global(self, params, opt_state) -> dict | None:
        """``{"params", "opt"}`` as CPU tensors in the global layout.
        Across processes every rank must call it: each leaf's lanes are
        gathered to rank 0, which returns the tree; the other ranks
        return None."""
        name = self.name or AXES.model
        osp = state_specs(self.cfg.optimizer, self.specs)
        if spans_processes(self.axis):
            params = _gather_lanes(params)
            opt_state = dict(opt_state, **{k: _gather_lanes(opt_state[k])
                                           for k in osp})
            if dist.get_rank() != 0:
                return None
        opt = {k: to_reference(opt_state[k], s, self.axis, name)
               for k, s in osp.items()}
        opt["count"] = opt_state["count"].detach().cpu().clone()
        return {"params": to_reference(params, self.specs, self.axis, name),
                "opt": opt}

    def from_global(self, tree: dict):
        """The inverse of ``to_global``: ``(params, opt_state)`` stacked on
        the device; across processes each rank's lane of them, from the
        global tree every rank holds."""
        name = self.name or AXES.model
        params = local(from_reference(tree["params"], self.specs, self.axis,
                                      name), self.axis)
        osp = state_specs(self.cfg.optimizer, self.specs)
        opt = {k: local(from_reference(tree["opt"][k], s, self.axis, name),
                        self.axis)
               for k, s in osp.items()}
        opt["count"] = torch.as_tensor(np.asarray(tree["opt"]["count"]),
                                       dtype=torch.int32).reshape(())
        return params, opt


def _gather_lanes(tree):
    """Every rank's ``[1, ...]`` lane of each leaf, gathered to rank 0 of
    the world in rank order (its lanes' order) as ``[world, ...]``; the
    other ranks get their own lanes back.  A plain gather outside the
    dispatcher, as the JAX package's ``device_get`` of a checkpoint is."""
    if isinstance(tree, dict):
        return {k: _gather_lanes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_gather_lanes(v) for v in tree]
    x = tree.detach().contiguous()
    if dist.get_rank() != 0:
        dist.gather(x, dst=0)
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.gather(x, parts, dst=0)
    return torch.cat(parts)


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
