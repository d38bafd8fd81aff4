"""What each rank of the analysis tests' process worlds runs
(``tests/test_torch_interpose.py``, ``tests/test_torch_dryrun.py``).

Module-level functions, pickled by reference into the spawned ranks
(``launch.mesh.spawn``), in a module that imports torch and the port
only: a rank starts from a fresh interpreter and never imports JAX.
"""
import numpy as np
import torch

from repro_torch.analysis.interpose import assert_bitexact, rewrite
from repro_torch.core import api
from repro_torch.core._axis import GroupAxis, GroupMesh, StackedAxis
from repro_torch.dist.axes import bind
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.models.params import init_tree, local

#: the movement mock-ups the rewrite substitutes (a reduction mock-up
#: reorders the sum and is legitimately not bit-exact)
REWRITE_FORCE = {"allgather": "allgather_as_ring",
                 "alltoall": "alltoall_as_ppermute"}


def rewrite_body(axis):
    """The JAX package's ``REWRITE_SCRIPT`` program
    (``tests/test_hlo_interpose.py``) on ``axis``: x ``[1, 4, 16]`` (this
    rank's rows), w ``[16, 16]`` replicated."""
    def body(x, w):
        g = api.allgather(x, axis)
        y = g @ w
        s = api.reducescatter(y, axis)
        z = api.allreduce(s * 2.0, axis)
        return api.alltoall(z, axis)
    return body


def rewrite_rank() -> dict:
    """The rewrite on a world of 4 processes (gloo, CPU): forced movement
    mock-ups, bit-exact, every dispatch matched to a graph site."""
    axis = GroupAxis("cpu")
    x = torch.arange(16 * 16, dtype=torch.float32).reshape(16, 16) / 7.0
    w = torch.ones((16, 16), dtype=torch.float32) * 0.5
    mine = x[4 * axis.rank:4 * axis.rank + 4][None]
    res = rewrite(rewrite_body(axis), mine, w, force=dict(REWRITE_FORCE))
    assert_bitexact(res)
    return {"matched": [(r.cell.op, s.base_op) for r, s in res.matched],
            "unmatched": [r.cell.op for r in res.unmatched_records],
            "extra": [s.name for s in res.extra_sites],
            "changed": sorted((r.cell.op, r.impl) for r in res.changed),
            "bitexact": res.bitexact,
            "out": res.tuned_out.numpy()}


def seq_decode_rank(cfg, mesh_shape, prompts: np.ndarray, s_max: int,
                    n_tokens: int, seed: int) -> dict:
    """The ``long_500k`` decode of ``cfg`` over a (data, model)
    ``GroupMesh``: the prompt prefilled unsharded on stacked model lanes
    (the same weights: one global draw from ``seed``), laid out as data
    shards, this process's shard decoded.  Returns the logits of every
    step and the data lanes' spread."""
    d, t = mesh_shape
    mesh = GroupMesh(mesh_shape, ("data", "model"), "cpu")
    maxis = StackedAxis(t, "cpu")
    specs = lm.model_specs(cfg, t)
    params = init_tree(specs, torch.Generator().manual_seed(seed), mesh)
    mparams = init_tree(specs, torch.Generator().manual_seed(seed), maxis)
    tokens = torch.as_tensor(prompts)
    with bind(model=maxis):
        caches = lm.init_caches(cfg, 1, s_max)
    logits, caches = serve.build_prefill(cfg, maxis)(
        mparams, {"tokens": tokens}, caches)
    lg0 = serve.full_vocab(logits)
    shards = local(serve.seq_shards(caches, d), mesh)
    res = serve.decode_from(cfg, mesh, params, shards, lg0,
                            tokens.shape[1], n_tokens,
                            cell=serve.SHAPES["long_500k"])
    return {"logits": [lg.float().numpy() for lg in res.logits],
            "tokens": res.tokens.numpy(), "spread": res.lane_spread}
