"""The assigned input-shape cells and each cell's argument specs.

Four cells per architecture (40 in all), the JAX package's
(``repro/launch/shapes.py``):

=============  ==========  ============  =========================
cell           seq_len     global_batch  program
=============  ==========  ============  =========================
train_4k       4,096       256           train step (fwd+bwd+opt)
prefill_32k    32,768      32            serve prefill
decode_32k     32,768      128           serve decode (1 new token)
long_500k      524,288     1             serve decode, seq-sharded KV
=============  ==========  ============  =========================

``long_500k`` applies only to the sub-quadratic archs
(``cfg.subquadratic``); a pure full-attention arch skips it.

``input_specs(cfg, cell, mesh)`` gives each argument leaf of the cell's
program as an ``ArgSpec``: its GLOBAL shape, dtype and the mesh axes each
dim is cut over (None: replicated; a tuple: cut over several axes, outer
first), the port's counterpart of the JAX package's ``(ShapeDtypeStruct,
PartitionSpec)`` pairs.  The trees are the port's: a scanned group is a
list of per-layer subtrees, and a cache's filled length is a host int,
not a leaf.  ``mesh`` is a ``StackedMesh`` or any object whose
``.shape`` maps axis names to sizes.

``local_args(cfg, cell, mesh)`` turns every leaf into a fake tensor of
its LOCAL shape (each global dim divided by the product of the mesh axes
it is cut over), the optimizer state of a train cell included, with the
lane dim in front: what one process of a ``GroupMesh`` holds, or the
``[L, ...]`` stack of a ``StackedMesh``.  It takes the place of the JAX
package's ``tree_pspecs``, ``tree_global_sds``, ``batch_pspec``,
``_cache_pspecs``, ``_opt_sds`` and ``trainer.opt_state_pspecs``: the
port has no ``PartitionSpec``, and ``launch.dryrun`` captures a cell on
these fake arguments.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core._axis import spans_processes
from repro_torch.data.synthetic import batch_specs
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamSpec, torch_dtype, tree_map_specs
from repro_torch.optim.optimizers import state_specs


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"
    seq_sharded: bool = False
    n_micro: int = 8


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill",
                             n_micro=1),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode", n_micro=1),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode",
                           seq_sharded=True, n_micro=1),
}


@dataclasses.dataclass(frozen=True)
class ArgSpec:
    """One argument leaf: global shape, dtype name, and per dim the mesh
    axis (or tuple of axes, outer first) it is cut over, or None."""
    shape: tuple[int, ...]
    dtype: str
    dims: tuple

    def local_shape(self, sizes: dict[str, int]) -> tuple[int, ...]:
        out = []
        for s, d in zip(self.shape, self.dims):
            div = 1
            for name in ((d,) if isinstance(d, str) else (d or ())):
                div *= sizes.get(name, 1)
            if s % div:
                raise ValueError(f"dim {s} not divisible by {d}={div}")
            out.append(s // div)
        return tuple(out)


def applicable(cfg: ModelConfig, cell: ShapeCell) -> tuple[bool, str]:
    if cell.name == "long_500k" and not cfg.subquadratic:
        return False, "full-attention arch: 500k KV decode skipped"
    return True, ""


def mesh_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``StackedMesh`` (``names``, ``shape``)
    or of an object whose ``.shape`` is that mapping."""
    if hasattr(mesh, "names"):
        return dict(zip(mesh.names, mesh.shape))
    return dict(mesh.shape)


def dp_axes(mesh) -> tuple[str, ...]:
    """The axes the batch is cut over: ``pod`` and ``data``, where the
    mesh has them."""
    sizes = mesh_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def _batch_dim(mesh):
    """The batch dim's entry: the one data-parallel axis by name, several
    as a tuple (outer first), none as None."""
    dp = dp_axes(mesh)
    return dp[0] if len(dp) == 1 else (dp or None)


def _arg(spec: ParamSpec, dims=None) -> ArgSpec:
    return ArgSpec(tuple(spec.shape), spec.dtype,
                   tuple(spec.dims if dims is None else dims))


def batch_arg_specs(cfg: ModelConfig, cell: ShapeCell, mesh) -> dict:
    """The global batch of a train or prefill cell (``data.synthetic.
    batch_specs``; prefill without labels), its batch dim cut over the
    data-parallel axes."""
    bp = _batch_dim(mesh)
    bs = batch_specs(cfg, cell.global_batch, cell.seq_len)
    if cell.kind == "prefill":
        bs.pop("labels", None)
    return {k: ArgSpec(shape, dt, (bp,) + (None,) * (len(shape) - 1))
            for k, (shape, dt) in bs.items()}


def _cache_args(cspec, mesh, cell):
    """Cache ``ArgSpec``s; the batch dim is also cut over ``pod`` where the
    mesh has it (not on a seq-sharded cell, where pod replicates)."""
    pod = "pod" in mesh_sizes(mesh) and not cell.seq_sharded

    def arg(s: ParamSpec) -> ArgSpec:
        dims = list(s.dims)
        if pod:
            for i, d in enumerate(dims):
                if d == "data":
                    dims[i] = ("pod", "data")
                    break
        return _arg(s, dims)
    return tree_map_specs(arg, cspec)


def input_specs(cfg: ModelConfig, cell: ShapeCell, mesh) -> tuple:
    """The cell's argument trees of ``ArgSpec`` leaves:

    train:   (params, opt_state, batch, step)
    prefill: (params, batch, caches)
    decode:  (params, token, caches, t)

    Parameters and optimizer state as laid out by ``lm.model_specs`` and
    ``optim.optimizers.state_specs`` (with the step count); the batch cut
    over the data-parallel axes; the decode token ``[B, 1]`` likewise, or
    replicated on a seq-sharded cell, whose caches cut the sequence over
    ``data`` instead of the batch."""
    tp = mesh_sizes(mesh).get("model", 1)
    spec_tree = lm.model_specs(cfg, tp)
    params = tree_map_specs(_arg, spec_tree)
    if cell.kind == "train":
        opt = tree_map_specs(_arg, state_specs(cfg.optimizer, spec_tree))
        opt["count"] = ArgSpec((), "int32", ())
        return (params, opt, batch_arg_specs(cfg, cell, mesh),
                ArgSpec((), "int32", ()))
    cspec = lm.cache_specs(cfg, cell.global_batch, cell.seq_len, tp,
                           seq_sharded=cell.seq_sharded)
    caches = _cache_args(cspec, mesh, cell)
    if cell.kind == "prefill":
        return params, batch_arg_specs(cfg, cell, mesh), caches
    tok = ArgSpec((cell.global_batch, 1), "int32",
                  (None, None) if cell.seq_sharded else (_batch_dim(mesh),
                                                          None))
    return params, tok, caches, ArgSpec((), "int32", ())


def map_args(fn, tree):
    """Apply ``fn`` to every ``ArgSpec`` leaf of nested tuples, dicts and
    lists (other leaves are kept)."""
    if isinstance(tree, ArgSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_args(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_args(fn, v) for v in tree]
    if isinstance(tree, tuple):
        return tuple(map_args(fn, v) for v in tree)
    return tree


def local_args(cfg: ModelConfig, cell: ShapeCell, mesh, *, device=None,
               mode=None) -> tuple:
    """``input_specs(cfg, cell, mesh)`` with every ``ArgSpec`` leaf a fake
    tensor ``[L, *local_shape]`` (a scalar leaf stays 0-d): ``L`` is 1 on
    a process mesh (``GroupMesh``, one lane a process) and the number of
    lanes on a stacked one.  The tensors live in ``mode`` (a new
    ``FakeTensorMode`` that lets the program's own real constants in) on
    ``device`` (default the mesh's), so a cell of any size costs no
    memory; ``analysis.graph.capture`` traces on them."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    sizes = mesh_sizes(mesh)
    lanes = 1 if spans_processes(mesh) else math.prod(sizes.values())
    mode = mode or FakeTensorMode(allow_non_fake_inputs=True)
    dev = device if device is not None else getattr(mesh, "device", "cpu")

    def fake(a: ArgSpec):
        shape = () if not a.shape else (lanes,) + a.local_shape(sizes)
        with mode:
            return torch.empty(shape, dtype=torch_dtype(a.dtype),
                               device=dev)
    return map_args(fake, input_specs(cfg, cell, mesh))
