"""Training across processes: ``Trainer(processes=True)`` on gloo worlds
of spawned processes, held to the stacked ``Trainer`` at the same mesh
and to the JAX package's single-device step (the SPMD claim of its
``tests/test_spmd_subprocess.py``, ``EQUIV_SCRIPT``).

One world of 8 processes (``launch.mesh.spawn``, a hard timeout that
kills its ranks) runs every case, so its start-up is paid once: the
reference's four archs at (data, model) = (2, 4) and llama3.2-3b at
(pod, data, model) = (2, 2, 2), each from the reference's init
(``jax.random.key(7)``, its float32 smoke config) and two steps (step
indices 50 and 51, the reference's live learning rate) on numpy-seeded
batches (``make_batch`` seeds from ``hash(cfg.name)``, which each
process salts):

* against the same two steps of the stacked ``Trainer``, lane for lane.
  The primitives of a process axis are copies, bit-equal to the stacked
  axis' (``tests/test_torch_group.py``), and its sums are gloo's: a sum
  of two ranks is the stacked one bit for bit, so at (2, 2, 2), where
  every axis has two ranks, the whole state must be bit-equal.  At (2, 4)
  the model axis sums four ranks in gloo's order: losses within 1e-5
  relative; grad norms within ``NORM_RTOL`` and the AdamW moments (the
  gradients' record) within ``MOMENT_RTOL`` of each leaf's max, since
  some leaves' gradients are sums that cancel (rwkv6-3b's norm is 1e4
  at its init; zamba2-1.2b's ``d_skip`` and ``w_dt``,
  ``scripts/torch_grad_noise.py``); each parameter within ``ADAM_STEP``
  learning rates a step: AdamW divides each gradient element by its own
  running rms, so an element whose gradient is rounding noise moves by
  up to the learning rate whatever its size, in either direction;
* against the reference's single-device ``make_step_fns`` step in this
  process (the claim of ``EQUIV_SCRIPT``), with its bars: the first
  step's loss within 1e-2 (1e-1 for MoE, whose capacity follows the local
  token count), every parameter after both steps within 5e-2.  The second
  loss is not held to 1e-2: ``EQUIV_SCRIPT`` takes one step, and after
  one AdamW update whose noise-level gradient elements each moved by up
  to the learning rate, rwkv6-3b's second loss parts from the
  single-device one by ~2e-2 (the stacked step's too).  Float32, not the
  bf16 of ``EQUIV_SCRIPT``: the two packages' bf16 SSM stacks part from
  each other on some batches (rwkv6-3b's first loss by 2.7e-2 in one run
  here; ``tests/test_torch_ssm.py`` holds each to float32 instead).

Each rank's dispatch records of each step equal the stacked step's, and
every case issued gloo collectives.
"""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_train_group_ranks as ranks
import test_torch_ref  # noqa: F401  (the reference's import shims)
from test_torch_models import port_cfg

from repro.configs import get_config as rget_config
from repro.train.trainer import make_step_fns as rmake_step_fns
from repro_torch.launch.mesh import spawn
from repro_torch.models.params import tree_paths
from repro_torch.train import Trainer

ARCHS = ["llama3.2-3b", "phi3.5-moe-42b-a6.6b", "rwkv6-3b", "zamba2-1.2b"]
CASES = [(a, (2, 4)) for a in ARCHS] + [("llama3.2-3b", (2, 2, 2))]
IDS = [f"{a}-{'x'.join(map(str, m))}" for a, m in CASES]
WORLD = 8
B, S, START, STEPS = 8, 16, 50, 2
TIMEOUT_S = 300.0
NORM_RTOL = 1e-3
MOMENT_RTOL = 1e-2
ADAM_STEP = 2.01        # |m_hat / sqrt(v_hat)| <= 1.0013 at AdamW's count 2


def _f32(arch):
    return dataclasses.replace(rget_config(arch).smoke(), dtype="float32")


def _batch(cfg, i):
    rng = np.random.default_rng((30, i))
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return {"tokens": tokens, "labels": tokens.copy()}


def _stacked(cfg, mesh, tree, batches):
    tr = Trainer(cfg, mesh=mesh, device="cpu", record=[])
    params, opt = tr.from_global(tree)
    metrics, records = [], []
    for i, b in enumerate(batches):
        n = len(tr.record)
        params, opt, m = tr.step(params, opt, tr.put_batch(b), START + i)
        metrics.append({k: float(v) for k, v in m.items()})
        records.append(tr.record[n:])
    return {"metrics": metrics, "records": records,
            "params": ranks.lanes(params),
            "opt": ranks.lanes({k: v for k, v in opt.items()
                                if k != "count"})}


def _reference(rcfg, batches):
    """The reference's init and two single-device steps: its global init
    tree (numpy), each step's loss, and its params after the steps."""
    init_fn, train_fn = rmake_step_fns(rcfg, n_micro=1)
    p, o = jax.jit(init_fn)(jax.random.key(7))
    tree = jax.tree.map(np.asarray, {"params": p, "opt": o})
    fn, losses = jax.jit(train_fn), []
    for i, b in enumerate(batches):
        p, o, m = fn(p, o, {k: jnp.asarray(v) for k, v in b.items()},
                     jnp.int32(START + i))
        losses.append(float(m["loss"]))
    return tree, losses, {k: np.asarray(v, np.float32)
                          for k, v in tree_paths(jax.tree.map(np.asarray, p))}


@pytest.fixture(scope="module")
def world():
    jobs, stacked, refs = [], [], []
    for arch, mesh in CASES:
        rcfg = _f32(arch)
        batches = [_batch(rcfg, i) for i in range(STEPS)]
        tree, losses, rparams = _reference(rcfg, batches)
        refs.append((losses, rparams))
        cfg = port_cfg(rcfg)
        stacked.append(_stacked(cfg, mesh, tree, batches))
        jobs.append((cfg, mesh, tree, batches, START))
    got = spawn(ranks.train_steps, WORLD, backend="gloo", args=(jobs,),
                timeout_s=TIMEOUT_S)
    return got, stacked, refs


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_process_steps_equal_the_stacked_steps(world, case):
    got, stacked, _ = world
    arch, mesh = CASES[case]
    want = stacked[case]
    exact = all(n <= 2 for n in mesh)
    lr = sum(m["lr"] for m in want["metrics"])
    for r in range(WORLD):
        g = got[r][case]
        assert g["rank"] == r and g["count"] == STEPS
        for gm, wm in zip(g["metrics"], want["metrics"]):
            assert gm["lr"] == wm["lr"]
            for k in ("loss", "grad_norm"):
                if exact:
                    assert gm[k] == wm[k], (r, k)
                else:
                    tol = 1e-5 if k == "loss" else NORM_RTOL
                    assert _rel(gm[k], wm[k]) <= tol, (r, k, gm, wm)
        for kind in ("params", "opt"):
            assert len(g[kind]) == len(want[kind])
            for i, (a, w) in enumerate(zip(g[kind], want[kind])):
                w = w[r:r + 1]
                if exact:
                    np.testing.assert_array_equal(a, w, err_msg=f"{r} {i}")
                    continue
                err = np.abs(a - w).max(initial=0.0)
                bound = (ADAM_STEP * lr if kind == "params" else
                         MOMENT_RTOL * np.abs(w).max(initial=0.0)) + 1e-30
                assert err <= bound, (r, kind, i, err, bound)


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_process_steps_hold_the_reference_spmd_bars(world, case):
    got, _, refs = world
    arch, _ = CASES[case]
    losses, rparams = refs[case]
    moe = "moe" in arch
    for r in range(WORLD):
        first = got[r][case]["metrics"][0]["loss"]
        assert abs(first - losses[0]) < (1e-1 if moe else 1e-2), (r, first)
    mine = got[0][case]["global"]
    assert sorted(mine) == sorted(rparams)
    dp = max(np.abs(mine[k] - rparams[k]).max() for k in rparams)
    assert dp < 5e-2, dp


@pytest.mark.parametrize("case", range(len(CASES)), ids=IDS)
def test_each_rank_dispatches_the_stacked_steps_records(world, case):
    got, stacked, _ = world

    def key(rec):
        return collections.Counter((dataclasses.astuple(x.cell), x.impl,
                                    x.phase) for x in rec)
    want = stacked[case]["records"]
    phases = collections.Counter(x.phase for x in want[0])
    assert phases["bwd"] > 0 and phases["fwd"] > 0
    for r in range(WORLD):
        g = got[r][case]
        for step in range(STEPS):
            assert key(g["records"][step]) == key(want[step]), (r, step)
        calls = g["calls"]
        assert calls.get("psum", 0) > 0, calls
        if CASES[case][1] == (2, 4):
            assert calls.get("all_gather", 0) > 0, calls
