"""Training across processes, the host side: every rank's batch, the
checkpoints a world writes and reads, resuming, and the train CLI's
``--world``, on gloo worlds of spawned processes (rank code in
``tests/_torch_train_group_ranks.py``, which imports no JAX).

* every rank trains on rank 0's batch: each rank is handed a batch of its
  own (as processes that each salt ``hash(cfg.name)``, which
  ``make_batch`` seeds from, would draw) and must train on its lane of
  rank 0's;
* a checkpoint written by a world of 4 at (2, 2) (rank 0 gathers every
  leaf's lanes and writes, then a barrier) restores in the reference's
  ``restore`` and in a stacked ``Trainer`` bit for bit, and the stacked
  trainer's next step gives the world's loss bit for bit (every axis
  has two ranks: gloo's sums are the stacked ones); the reverse: a
  stacked trainer's and the reference's checkpoints restore in a world,
  which gathers back the same global arrays;
* a world resumed from its checkpoint takes the uninterrupted world's
  next step, bit for bit;
* ``python -m repro_torch.launch.train --smoke --world 4 --mesh 2x2
  --dist-backend gloo --device cpu`` runs, checkpoints and resumes, its
  resumed losses the uninterrupted run's; a world past its deadline
  fails, and a mesh that is not the world's size is refused.
"""
import copy

import jax
import numpy as np
import pytest

import _torch_train_group_ranks as ranks
import test_torch_ref  # noqa: F401  (the reference's import shims)
from test_torch_models import port_cfg, smoke

from repro.ckpt import checkpoint as rck
from repro.data import make_batch as rmake_batch
from repro.train import Trainer as RTrainer
from repro_torch.ckpt import checkpoint as tck
from repro_torch.configs import get_config
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import spawn
from repro_torch.models.params import tree_paths
from repro_torch.train import Trainer

#: seconds a world may run before its ranks are killed
TIMEOUT_S = 240.0
MESH = (2, 2)
B, S = 8, 16


def _world(fn, world, *args):
    return spawn(fn, world, backend="gloo", args=args, timeout_s=TIMEOUT_S)


def _batch(cfg, i):
    rng = np.random.default_rng((31, i))
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return {"tokens": tokens, "labels": tokens.copy()}


def _bf16():
    return port_cfg(smoke("bfloat16"))          # a scanned group


def test_every_rank_trains_on_rank_0s_batch():
    cfg = _bf16()
    batches = [_batch(cfg, r) for r in range(4)]
    meshes = [(2, 2), (4, 1), (1, 4), (2, 1, 2)]
    got = _world(ranks.batch_lanes, 4, cfg, meshes, batches)
    want = batches[0]
    for m, mesh in enumerate(meshes):
        d = mesh[0] * mesh[1] if len(mesh) == 3 else mesh[0]
        t = mesh[-1]
        for r, g in enumerate(got):
            for k, v in want.items():
                if d == 1:                   # every rank the whole batch
                    np.testing.assert_array_equal(g[m][k], v)
                else:
                    i = r // t
                    rows = v.reshape(d, -1, *v.shape[1:])[i][None]
                    np.testing.assert_array_equal(g[m][k], rows,
                                                  err_msg=f"{mesh} {r} {k}")


def _ref_like(rcfg):
    rp, ro = RTrainer(rcfg, mesh=None).init(0)
    return jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                        {"params": rp, "opt": ro})


def test_world_checkpoint_restores_in_both_packages_and_resumes(tmp_path):
    cfg = _bf16()
    st = Trainer(cfg, mesh=MESH, device="cpu")
    tree = copy.deepcopy(st.to_global(*st.init(5)))
    batches = [_batch(cfg, i) for i in range(3)]
    ck = tmp_path / "world"
    got = _world(ranks.checkpoint_and_resume, 4, cfg, MESH, tree, batches,
                 str(ck))
    for g in got:
        assert g["step"] == 2
        assert g["resumed_loss"] == g["loss"] == got[0]["loss"]
    written = got[0]["global"]
    assert all(g["global"] is None for g in got[1:])
    assert tck.latest_step(ck) == 2
    assert written["params/stack/g0/b0_attn/attn/w_q"].dtype == np.uint16
    # the reference's restore reads the world's arrays bit for bit
    back = rck.restore(ck, 2, _ref_like(smoke("bfloat16")))
    for k, v in tree_paths(back):
        np.testing.assert_array_equal(
            np.asarray(v).view(written[k].dtype), written[k], err_msg=k)
    # a stacked trainer restores them, and its next step is the world's
    tr = Trainer(cfg, mesh=MESH, device="cpu")
    params, opt = tr.from_global(tck.restore(ck, 2, tr.global_specs()))
    for k, v in ranks.raw(tr.to_global(params, opt)).items():
        np.testing.assert_array_equal(v, written[k], err_msg=k)
    _, _, m = tr.step(params, opt, tr.put_batch(batches[2]), 2)
    assert float(m["loss"]) == got[0]["loss"]


def test_stacked_and_reference_checkpoints_restore_in_a_world(tmp_path):
    cfg = _bf16()
    st = Trainer(cfg, mesh=(4, 1), device="cpu")
    params, opt = st.init(3)
    for i in range(2):
        params, opt, _ = st.step(params, opt, st.put_batch(_batch(cfg, i)),
                                 i)
    tck.save(tmp_path / "stacked", 2, st.to_global(params, opt))
    want = ranks.raw(st.to_global(params, opt))
    rcfg = smoke("bfloat16")
    rtr = RTrainer(rcfg, mesh=None)
    rp, ro = rtr.init(0)
    rp, ro, _ = rtr.step(rp, ro, rtr.put_batch(rmake_batch(rcfg, B, S, 0)),
                         0)
    rck.save(tmp_path / "ref", 1, {"params": rp, "opt": ro})
    rwant = {k: np.asarray(v) for k, v in tree_paths({"params": rp,
                                                      "opt": ro})}
    for name, step, ref in (("stacked", 2, want), ("ref", 1, rwant)):
        got = _world(ranks.restore_global, 4, cfg, MESH,
                     str(tmp_path / name), step)
        assert all(g is None for g in got[1:])
        assert sorted(got[0]) == sorted(ref)
        for k, v in got[0].items():
            np.testing.assert_array_equal(
                v, np.asarray(ref[k]).view(v.dtype).reshape(v.shape),
                err_msg=f"{name} {k}")


def _cli(capfd, *argv):
    assert tlaunch.main(["--smoke", "--device", "cpu", "--dist-backend",
                         "gloo", "--seq", "16", "--log-every", "1",
                         *argv]) == 0
    return capfd.readouterr().out


def _losses(out):
    return {int(ln.split()[1]): ln.split()[3] for ln in out.splitlines()
            if ln.startswith("step ")}


def test_train_cli_world_runs_checkpoints_and_resumes(tmp_path, capfd,
                                                      monkeypatch):
    monkeypatch.delenv("PGTUNE_PROFILE_DIR", raising=False)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    world = ["--world", "4", "--mesh", "2x2"]
    out = _cli(capfd, *world, "--steps", "3", "--ckpt-dir", a)
    assert "done: 3 steps over 4 processes (gloo, mesh 2x2)" in out
    assert tck.latest_step(a) == 3
    first = _losses(out)
    assert sorted(first) == [0, 1, 2]
    assert out.count("step ") == 3 and out.count("done:") == 1  # rank 0
    out = _cli(capfd, *world, "--steps", "5", "--ckpt-dir", a)
    assert "resumed from step 3" in out and "done: 2 steps" in out
    resumed = _losses(out)
    assert sorted(resumed) == [3, 4] and tck.latest_step(a) == 5
    out = _cli(capfd, *world, "--steps", "5", "--ckpt-dir", b)
    whole = _losses(out)
    assert whole == {**first, **resumed}
    # the checkpoint is the stacked layout's: a stacked trainer reads it
    tr = Trainer(get_config("llama3.2-3b").smoke(), mesh=MESH, device="cpu")
    params, opt = tr.from_global(tck.restore(a, 5, tr.global_specs()))
    assert int(opt["count"]) == 5


def test_a_world_past_its_deadline_fails(tmp_path, monkeypatch):
    monkeypatch.setattr(tlaunch, "CLI_TIMEOUT_S", 2.0)
    with pytest.raises(TimeoutError, match="ran past 2 s"):
        tlaunch.main(["--smoke", "--device", "cpu", "--dist-backend", "gloo",
                      "--world", "2", "--steps", "50", "--seq", "16",
                      "--ckpt-dir", str(tmp_path)])


def test_a_mesh_of_another_size_than_the_world_is_refused():
    cfg = _bf16()
    with pytest.raises(ValueError, match="the world 0 processes"):
        Trainer(cfg, mesh=(2, 1), device="cpu", processes=True)
    got = _world(ranks.refusals, 2, cfg)
    for g in got:
        assert set(g) == {(2, 2), (1, 1), (2, 1, 2)}
        assert "has 4 ranks, the world 2 processes" in g[(2, 2)]
        assert "has 1 ranks, the world 2 processes" in g[(1, 1)]
