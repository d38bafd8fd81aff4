"""What each rank of ``tests/test_torch_group.py``'s process worlds runs.

Module-level functions, pickled by reference into the spawned ranks
(``launch.mesh.spawn``), in a module that imports torch and the port
only: a rank starts from a fresh interpreter and never imports JAX.  The
parent makes every input and passes it as arrays; no rank draws its own.
"""
import numpy as np
import torch

from repro_torch.core import api, profiles, selfcheck, tuner
from repro_torch.core._axis import GroupAxis, GroupMesh
from repro_torch.core.cell import OpCell
from repro_torch.core.trace import Trace, TraceEntry
from repro_torch.launch import serve
from repro_torch.models.params import local

#: the permutations every pshift check runs (p = 4): a full ring hop, a
#: partial shift (ranks without a source get zeros) and a partial map with
#: a self pair (a local copy)
PERMS = {"ring": [(i, (i + 1) % 4) for i in range(4)],
         "shift": [(i, i + 1) for i in range(3)],
         "self": [(0, 0), (1, 3), (3, 1)]}


def primitive_outputs(axis, x: torch.Tensor, xb: torch.Tensor) -> dict:
    """Every primitive of ``axis`` on ``x [L, n, ...]`` and ``xb [L, p*n,
    ...]`` (stacked; on a process axis ``[1, ...]``): name -> output."""
    out = {"all_gather": axis.all_gather(x),
           "all_gather_untiled": axis.all_gather(x, tiled=False),
           "all_to_all": axis.all_to_all(xb),
           "psum": axis.psum(x),
           "pmax": axis.pmax(x),
           "psum_scatter": axis.psum_scatter(xb)}
    if axis.size == 4:
        for k, pairs in PERMS.items():
            out[f"pshift_{k}"] = axis.pshift(x, pairs)
    else:
        out["pshift_ring"] = axis.pshift(x, [(i, (i + 1) % axis.size)
                                            for i in range(axis.size)])
        out["pshift_shift"] = axis.pshift(x, [(0, 1)])
    return out


def primitives(x: np.ndarray, xb: np.ndarray, dt: str) -> dict:
    """``{axis: {primitive: this rank's output}}`` on the world axis and
    on each axis of a (2, 2) mesh, for inputs in dtype ``dt`` (stacked
    ``[4, ...]`` arrays: this rank takes its lane), with the world axis'
    library calls under ``"calls"``."""
    world = GroupAxis("cpu")
    mesh = GroupMesh((2, 2), ("o", "i"), "cpu")
    axes = {"world": world, "o": mesh["o"], "i": mesh["i"]}
    r = world.rank
    mine = torch.from_numpy(x[r:r + 1]).to(getattr(torch, dt))
    mine_b = torch.from_numpy(xb[r:r + 1]).to(getattr(torch, dt))
    got = {nm: {k: v.float().numpy() for k, v in
                primitive_outputs(ax, mine, mine_b).items()}
           for nm, ax in axes.items()}
    got["calls"] = dict(world.calls)
    return got


def planted_selfcheck() -> list:
    """The group selfcheck with a broken ``pshift``: rank 1 receives its
    neighbour's block plus one."""
    ok = GroupAxis.pshift

    def broken(self, x, pairs):
        out = ok(self, x, pairs)
        if self.rank == 1 and any(d == 1 for _, d in pairs):
            out = out + 1
        return out
    GroupAxis.pshift = broken
    return selfcheck.run_group("cpu")


def measured_replay(out_dir: str) -> dict:
    """The counterpart of the JAX package's
    ``test_measured_backend_trace_replay_4dev`` on a world of 4 processes:
    the p 4 cell and the (2, 2) 2-D cell are measured, the p 8 cell is
    note-skipped; the picks are published (rank 0 writes them)."""
    axis = GroupAxis("cpu")
    t = Trace([TraceEntry(OpCell("allreduce", 4, 1024), "decode", count=5),
               TraceEntry(OpCell("allreduce", 8, 1024), "decode", count=5),
               TraceEntry(OpCell("matmul_reducescatter_2d", 2,
                                 2 * 64 * 6 * 4, "float32", mm_k=64, mm_m=8,
                                 mm_n=2 * 6, mm_role="2d", p2=2),
                          "decode", count=3)])
    backend = tuner.MeasuredBackend(axis=axis, K=2, max_nrep=3)
    rep = tuner.tune_trace(t, backend=backend)
    base, phases = profiles.publish(rep, out_dir, axis)
    return {
        "sup": backend.supported_axis_size,
        "n_meas": len(rep.measurements),
        "n_meas_2d": sum(1 for m in rep.measurements
                         if m.cell.op == "matmul_reducescatter_2d"),
        "skips": [n for n in rep.notes if "axis size" in n],
        "est_default": rep.est_default_s.get("decode", 0.0),
        "samples": [(m.cell.op, m.impl, m.latency, m.nrep)
                    for m in rep.measurements],
        "digest": profiles.stores_digest(base, phases),
        "n_profiles": sum(len(s) for s in phases.values()),
    }


def serve_tp(cfg, stacked_params, prompts: np.ndarray, s_max: int,
             n_tokens: int) -> dict:
    """``launch.serve.serve`` of ``cfg`` at TP = world on a ``GroupAxis``:
    this rank's lane of the parent's stacked ``[tp, ...]`` weights."""
    axis = GroupAxis("cpu")
    res = serve.serve(cfg, axis, local(stacked_params, axis),
                      torch.as_tensor(prompts), s_max, n_tokens)
    return {"tokens": res.tokens.numpy(),
            "logits": [lg.float().numpy() for lg in res.logits],
            "record": res.ctx.record, "calls": dict(axis.calls)}


def refusals() -> dict:
    """What a process axis refuses, as ``{case: exception text}``; every
    case must raise (a missing key is a case that did not)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core import collectives as C
    from repro_torch.kernels import collective_matmul_rdma as rdma
    from repro_torch.launch.shapes import SHAPES
    axis = GroupAxis("cpu")
    mesh = GroupMesh((2, 1), ("data", "model"), "cpu")
    cfg = dataclasses.replace(get_config("llama3.2-3b").smoke(),
                              attn_impl="flash")
    x = torch.ones(1, 2, 3)
    cases = {
        "gloo on the card": lambda: GroupAxis("cuda"),
        "gloo by default": lambda: GroupAxis(None),
        "groups": axis.groups,
        "stride": lambda: axis.stride,
        "two lanes": lambda: axis.psum(torch.ones(2, 3)),
        "one-kernel ring": lambda: rdma.ring_allgather_matmul_rdma(
            x, torch.ones(3, 4), axis),
        "seq-sharded decode": lambda: serve.build_decode(
            cfg, mesh, SHAPES["long_500k"]),
    }
    got = {}
    for k, f in cases.items():
        try:
            f()
        except (RuntimeError, ValueError, NotImplementedError) as e:
            got[k] = f"{type(e).__name__}: {e}"
    got["off_process_axis"] = [
        C.off_process_axis("allgather_matmul", "fused_ring", axis,
                           torch.device(d)) for d in ("cuda", "cpu")]
    cell = OpCell("allgather_matmul", 2, 2 * 3 * 2, mm_k=3, mm_m=4,
                  mm_n=4, mm_role="gather")
    got["admitted"] = [api._admit("allgather_matmul", "fused_ring", cell,
                                  None, axis, torch.device(d))
                       for d in ("cuda", "cpu")]
    return got
