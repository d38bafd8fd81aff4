"""What each rank of the training worlds of ``tests/test_torch_train_group.py``
and ``tests/test_torch_train_group_ckpt.py`` runs.

Module-level functions, pickled by reference into the spawned ranks
(``launch.mesh.spawn``), in a module that imports torch and the port
only: a rank starts from a fresh interpreter and never imports JAX.  The
parent makes every input (configs, global trees, numpy batches) and
passes it in; the ranks return numpy arrays, metrics and records.
"""
import numpy as np
import torch.distributed as dist

from repro_torch.ckpt import AsyncCheckpointer
from repro_torch.ckpt import checkpoint as ck
from repro_torch.core._axis import is_mesh
from repro_torch.models.params import tree_leaves, tree_paths
from repro_torch.train import Trainer


def raw(tree) -> dict:
    """A global tree as the checkpoint stores it: path -> numpy, raw
    bfloat16 bits."""
    return {k: ck._to_numpy(v) for k, v in tree_paths(tree)}


def lanes(tree) -> list[np.ndarray]:
    """Every tensor leaf as float32 numpy (a copy: steps update in
    place)."""
    return [t.detach().float().cpu().numpy().copy() for t in tree_leaves(tree)]


def axis_calls(tr) -> dict:
    """The library collectives the trainer's process axes issued."""
    axes = ([tr.axis[n] for n in tr.axis.names] if is_mesh(tr.axis)
            else [tr.axis])
    out: dict = {}
    for ax in axes:
        for k, v in ax.calls.items():
            out[k] = out.get(k, 0) + v
    return out


def train_steps(jobs: list) -> list[dict]:
    """For each job ``(cfg, mesh, tree, batches, start)``: a ``Trainer``
    over the world at ``mesh`` from the global ``tree`` (``from_global``),
    one step per numpy batch from step index ``start``; this rank's lanes
    of the params and optimizer state after the steps, each step's metrics
    and dispatch records, the collectives issued, and on rank 0 the
    params in the global layout (float32 numpy by path)."""
    out = []
    for cfg, mesh, tree, batches, start in jobs:
        tr = Trainer(cfg, mesh=mesh, device="cpu", processes=True, record=[])
        params, opt = tr.from_global(tree)
        metrics, records = [], []
        for i, b in enumerate(batches):
            n = len(tr.record)
            params, opt, m = tr.step(params, opt, tr.put_batch(b), start + i)
            metrics.append({k: float(v) for k, v in m.items()})
            records.append(tr.record[n:])
        g = tr.to_global(params, opt)
        out.append({"metrics": metrics, "records": records,
                    "global": None if g is None else
                    {k: v.float().numpy() for k, v in tree_paths(g["params"])},
                    "params": lanes(params),
                    "opt": lanes({k: v for k, v in opt.items()
                                  if k != "count"}),
                    "count": int(opt["count"]), "calls": axis_calls(tr),
                    "rank": dist.get_rank()})
    return out


def batch_lanes(cfg, meshes: list, batches: list) -> list[dict]:
    """For each mesh, ``put_batch`` of this rank's OWN batch
    (``batches[rank]``, as if each process had drawn its own): the lane
    it trains on, as numpy."""
    out = []
    for mesh in meshes:
        tr = Trainer(cfg, mesh=mesh, device="cpu", processes=True)
        got = tr.put_batch(batches[dist.get_rank()])
        out.append({k: v.numpy().copy() for k, v in got.items()})
    return out


def refusals(cfg) -> dict:
    """A mesh whose size is not the world's, as ``{mesh: error text}``."""
    got = {}
    for mesh in ((2, 2), (1, 1), (2, 1, 2)):
        try:
            Trainer(cfg, mesh=mesh, device="cpu", processes=True)
        except ValueError as e:
            got[mesh] = str(e)
    return got


def checkpoint_and_resume(cfg, mesh, tree, batches, ckpt_dir: str) -> dict:
    """Two steps from ``tree``, a checkpoint of step 2 (rank 0 writes it
    through ``AsyncCheckpointer``, then a barrier), the third step; then a
    fresh trainer restores the latest checkpoint on every rank and takes
    the third step again.  Rank 0 returns the global tree it wrote."""
    tr = Trainer(cfg, mesh=mesh, device="cpu", processes=True)
    params, opt = tr.from_global(tree)
    for i in range(2):
        params, opt, _ = tr.step(params, opt, tr.put_batch(batches[i]), i)
    g = tr.to_global(params, opt)
    if g is not None:
        acp = AsyncCheckpointer(ckpt_dir)
        acp.save(2, g)
        acp.wait()
    tr.axis.barrier()
    _, _, m = tr.step(params, opt, tr.put_batch(batches[2]), 2)
    fresh = Trainer(cfg, mesh=mesh, device="cpu", processes=True)
    step = ck.latest_step(ckpt_dir)
    p2, o2 = fresh.from_global(ck.restore(ckpt_dir, step,
                                          fresh.global_specs()))
    _, _, m2 = fresh.step(p2, o2, fresh.put_batch(batches[2]), step)
    return {"step": step, "loss": float(m["loss"]),
            "resumed_loss": float(m2["loss"]),
            "global": None if g is None else raw(g)}


def restore_global(cfg, mesh, ckpt_dir: str, step: int) -> dict | None:
    """A checkpoint (of any writer) restored on every rank and gathered
    back: rank 0's global tree, raw bits as numpy."""
    tr = Trainer(cfg, mesh=mesh, device="cpu", processes=True)
    params, opt = tr.from_global(ck.restore(ckpt_dir, step,
                                            tr.global_specs()))
    g = tr.to_global(params, opt)
    return None if g is None else raw(g)
