"""Sequence-sharded decode (the ``long_500k`` cell) and ``launch.shapes``
against the JAX package on the CPU.

* ``_sdpa_partial``: the port's grouped partial (no repeated KV head)
  against the reference's on the repeated heads.
* ``_decode_seq_sharded``: the port on a (data d, model t)
  ``StackedMesh`` against the reference under ``vmap(vmap(f, "model"),
  "data")``, d in {2, 4}, t in {1, 2} (at t = 2 gemma's one KV head is
  replicated), the new token in the first, a middle and the last shard,
  ``causal`` and ``local`` (window 32 over shards of 16 slots); the
  updated shards and the two ``allreduce`` cells it dispatches must be the
  reference's.
* ``decode_step(seq_sharded=True)``: two layers (local, global) from one
  prefill, against the port's unsharded decode of the same cache and the
  reference's sharded decode.
* ``shapes.input_specs``: every arch x every cell against the reference's
  ``input_specs`` from shapes only, on a stand-in mesh object.

Tolerances: float32 differs from the reference in summation order only:
1e-5 of the output's max-norm for one attention block, 1e-4 for logits
through two layers.  bfloat16 rounds the weighted partial sums before the
allreduce as the reference does: 2e-2 max-norm relative (the JAX package's
bar for its two attention paths, ``tests/test_models_smoke.py:101-104``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_ref  # noqa: F401  (the reference's import shims)
from test_torch_models import port_cfg, ref_params, rel, tnp
from test_torch_train import ref_cut2

from repro import configs as rconfigs
from repro.core import api as rapi
from repro.launch import shapes as rshapes
from repro.models import attention as rattn
from repro.models import lm as rlm
from repro.train import trainer as rtrainer
from repro_torch import configs as tconfigs
from repro_torch.core import api as tapi
from repro_torch.core._axis import StackedAxis, StackedMesh
from repro_torch.dist.axes import bind
from repro_torch.launch import serve as tserve
from repro_torch.launch import shapes as tshapes
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models import params as tparams
from repro_torch.models.params import to_torch

S_LOC, B = 16, 2


def gemma(dtype="float32", **kw):
    return dataclasses.replace(rconfigs.get_config("gemma3-1b").smoke(),
                               dtype=dtype, **kw)


def _nested(f):
    return jax.vmap(jax.vmap(f, axis_name="model"), axis_name="data")


def _lanes(a, d, t):
    """``[d, t, ...]`` numpy -> ``[d*t, ...]`` torch."""
    a = np.asarray(a)
    return to_torch(a.reshape(d * t, *a.shape[2:]))


def _rec(ctx):
    return [(dataclasses.astuple(r.cell), r.impl) for r in ctx.record]


# ---------------------------------------------------------------------------
# the partial
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("softcap", [None, 20.0])
def test_sdpa_partial_matches_the_reference_on_repeated_heads(softcap):
    rng = np.random.default_rng(0)
    hk, g, sq, skv, dh = 2, 3, 1, 40, 16
    q = rng.normal(size=(B, sq, hk * g, dh)).astype(np.float32)
    k, v = (rng.normal(size=(B, skv, hk, dh)).astype(np.float32)
            for _ in range(2))
    mask = np.arange(skv)[None, None, :] < np.array([7, 31])[:, None, None]
    want = rattn._sdpa_partial(jnp.asarray(q),
                               rattn._repeat_kv(jnp.asarray(k), g),
                               rattn._repeat_kv(jnp.asarray(v), g),
                               jnp.asarray(mask), softcap=softcap)
    o, l, m = tattn._sdpa_partial(
        torch.from_numpy(q).reshape(B, sq, hk, g, dh), torch.from_numpy(k),
        torch.from_numpy(v), torch.from_numpy(mask), softcap=softcap)
    assert rel(tnp(o).reshape(B, sq, hk * g, dh), want[0]) < 1e-5
    assert rel(tnp(l).reshape(B, hk * g, sq), want[1]) < 1e-5
    np.testing.assert_allclose(tnp(m).reshape(B, hk * g, sq), want[2],
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# one sequence-sharded attention step
# ---------------------------------------------------------------------------

CASES = [(d, where, kind, t, "float32") for d in (2, 4)
         for where in ("first", "middle", "last")
         for kind in ("causal", "local") for t in (1, 2)]
CASES += [(4, "middle", "local", 1, "bfloat16"),
          (2, "last", "causal", 2, "bfloat16")]


@pytest.mark.parametrize("d,where,kind,t,dtype", CASES)
def test_decode_seq_sharded_matches_the_reference(d, where, kind, t, dtype):
    rcfg = gemma(dtype)
    cfg = port_cfg(rcfg)
    owner = {"first": 0, "middle": d // 2, "last": d - 1}[where]
    pos = owner * S_LOC + 5                  # the new token's position
    hq_loc, hd, n_kv = rcfg.heads_padded(t) // t, rcfg.hd, rcfg.n_kv_heads
    kv_loc = n_kv // t if n_kv % t == 0 else n_kv
    dt = getattr(jnp, dtype)
    rng = np.random.default_rng(d * 100 + pos + t)
    # each model rank's q heads, the same on every data rank; k/v of the
    # new token, every model rank's kv heads
    q = jnp.asarray(rng.normal(size=(t, B, 1, hq_loc, hd)), dt)
    kn, vn = (jnp.asarray(rng.normal(size=(t, B, 1, kv_loc, hd)), dt)
              for _ in range(2))
    # the global cache: slots before pos filled, the rest zero; data rank i
    # holds slots [i*S_LOC, (i+1)*S_LOC)
    full = rng.normal(size=(2, B, d * S_LOC, kv_loc, hd))
    full[:, :, pos:] = 0
    full = np.asarray(jnp.asarray(full, dt))
    shards = full.reshape(2, B, d, S_LOC, kv_loc, hd).transpose(
        2, 0, 1, 3, 4, 5)                                  # [d, 2, B, ...]
    rep = lambda a: np.broadcast_to(np.asarray(a)[None], (d,) + a.shape)
    kc = np.broadcast_to(shards[:, None, 0], (d, t) + shards.shape[2:])
    vc = np.broadcast_to(shards[:, None, 1], (d, t) + shards.shape[2:])

    def ref_fn(q_, kn_, vn_, kc_, vc_):
        o, c = rattn._decode_seq_sharded(
            rcfg, q_, kn_, vn_, {"k": kc_, "v": vc_, "len": jnp.int32(pos)},
            jnp.full((1, 1), pos, jnp.int32), kind=kind)
        return o, c["k"], c["v"]
    with rapi.tuned() as rctx:
        want = _nested(ref_fn)(rep(q), rep(kn), rep(vn), jnp.asarray(kc),
                               jnp.asarray(vc))

    mesh = StackedMesh((d, t), ("data", "model"), "cpu")
    cache = {"k": _lanes(kc, d, t).clone(), "v": _lanes(vc, d, t).clone(),
             "len": pos}
    with bind(data=mesh["data"], model=mesh["model"]), \
            tapi.tuned() as tctx:
        o, new = tattn._decode_seq_sharded(
            cfg, _lanes(rep(q), d, t), _lanes(rep(kn), d, t),
            _lanes(rep(vn), d, t), cache, kind=kind)
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert rel(tnp(o), np.asarray(want[0], np.float32).reshape(
        d * t, *want[0].shape[2:])) < tol
    assert new["len"] == pos + 1
    for got, w in ((new["k"], want[1]), (new["v"], want[2])):
        np.testing.assert_array_equal(
            tnp(got), np.asarray(w, np.float32).reshape(d * t, *w.shape[2:]))
    assert _rec(tctx) == _rec(rctx)
    assert [r.cell.op for r in tctx.record] == ["allreduce", "allreduce"]


def test_seq_sharded_decode_refuses_more_than_one_token():
    cfg = port_cfg(gemma())
    mesh = StackedMesh((2, 1), ("data", "model"), "cpu")
    q = torch.zeros(2, 1, 2, 4, 16)
    kv = torch.zeros(2, 1, 2, 1, 16)
    cache = {"k": torch.zeros(2, 1, 8, 1, 16), "v": torch.zeros(2, 1, 8, 1,
                                                                  16),
             "len": 3}
    with bind(data=mesh["data"], model=mesh["model"]), \
            pytest.raises(ValueError, match="one token"):
        tattn._decode_seq_sharded(cfg, q, kv, kv, cache, kind="causal")


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_seq_sharded_attention_refuses_other_modes(mode):
    cfg = port_cfg(gemma())
    x = torch.zeros(1, 1, 4, cfg.d_model)
    with pytest.raises(NotImplementedError, match=f"decode mode only, not "
                                                  f"{mode}"):
        tattn.attention({}, cfg, x, pos=torch.arange(4)[None], mode=mode,
                        seq_sharded=True)


# ---------------------------------------------------------------------------
# decode_step over a sequence-sharded cache
# ---------------------------------------------------------------------------


def _flat_caches(tree, out=None):
    """(path, tensor) of every cache tensor, in order."""
    out = [] if out is None else out
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flat_caches(tree[k], out)
    elif isinstance(tree, list):
        for v in tree:
            _flat_caches(v, out)
    elif isinstance(tree, torch.Tensor):
        out.append(tree)
    return out


@pytest.mark.parametrize("d,t", [(2, 1), (2, 2)])
def test_seq_sharded_decode_step_matches_unsharded_and_the_reference(d, t):
    rcfg = gemma(n_layers=2, layer_pattern=("attn_local", "attn"),
                 attn_impl="flash", scan_layers=False)
    cfg = port_cfg(rcfg)
    tree = ref_params(rcfg)
    s_max, s0, steps = d * S_LOC, 21, 2
    rng = np.random.default_rng(d + t)
    prompt = torch.as_tensor(rng.integers(0, rcfg.vocab_size, (1, s0)))
    toks = rng.integers(0, rcfg.vocab_size, (steps, 1, 1))

    # the prefill on the model axis, its cache laid out as d shards
    axis = StackedAxis(t, "cpu")
    mparams = tparams.from_reference(tree, tlm.model_specs(cfg, t), axis)
    with bind(model=axis):
        caches = tlm.init_caches(cfg, 1, s_max)
    _, caches = tserve.build_prefill(cfg, axis)(
        mparams, {"tokens": prompt}, caches)
    clone = tserve.clone_caches(caches)
    mesh = StackedMesh((d, t), ("data", "model"), "cpu")
    shards = tserve.seq_shards(caches, d)
    rshards = [tnp(x).reshape(d, t, *x.shape[1:])
               for x in _flat_caches(shards)]
    params = tparams.from_reference(tree, tlm.model_specs(cfg, t), mesh)
    seq = tserve.build_decode(cfg, mesh, tshapes.SHAPES["long_500k"])
    flat = tserve.build_decode(cfg, axis)

    rspecs = rlm.model_specs(rcfg, tp=t)
    rp = ref_cut2(tree, rspecs, d, t)
    it = iter(rshards)

    def fill(node):
        if isinstance(node, dict):
            return {k: fill(node[k]) for k in sorted(node)}
        if node.shape == ():
            return jnp.full((d, t), s0, jnp.int32)
        return jnp.asarray(next(it))
    rc = fill(rlm.cache_specs(rcfg, 1, s_max, t, seq_sharded=True))
    rdec = jax.jit(_nested(lambda p, tok, c, i: rlm.decode_step(
        p, rcfg, tok, c, i, seq_sharded=True)))

    for step in range(steps):
        tok = torch.as_tensor(toks[step])
        pos = s0 + step
        lg_seq, shards = seq(params, tok.unsqueeze(0).expand(d * t, 1, 1),
                             shards, pos)
        lg_flat, clone = flat(mparams, tok, clone, pos)
        rlg, rc = rdec(rp, jnp.broadcast_to(jnp.asarray(toks[step]),
                                            (d, t, 1, 1)),
                       rc, jnp.broadcast_to(jnp.int32(pos), (d, t)))
        per = tnp(lg_seq).reshape(d, t, *lg_seq.shape[1:])
        for i in range(1, d):           # every data rank the same logits
            np.testing.assert_array_equal(per[i], per[0])
        assert rel(per[0], tnp(lg_flat)) < 1e-4
        assert rel(per, np.asarray(rlg)) < 1e-4


def test_sharded_prefill_raises_naming_the_cause():
    cfg = port_cfg(gemma())
    with pytest.raises(NotImplementedError, match="seq_shards"):
        tlm.prefill({}, cfg, {"tokens": torch.zeros(1, 4, dtype=torch.long)},
                    {}, seq_sharded=True)


def test_seq_shards_is_a_view_at_one_model_lane():
    k = torch.arange(2 * 32 * 3, dtype=torch.float32).reshape(1, 1, 32, 1, 6)
    out = tserve.seq_shards({"stack": {"g": {"self": {
        "k": k, "v": k.clone(), "len": 9}}}}, 4)["stack"]["g"]["self"]
    assert out["len"] == 9 and out["k"].shape == (4, 1, 8, 1, 6)
    assert out["k"].data_ptr() == k.data_ptr()
    assert torch.equal(out["k"][2], k[0, :, 16:24])


# ---------------------------------------------------------------------------
# launch/shapes.py
# ---------------------------------------------------------------------------


class _Mesh:
    """A stand-in for a device mesh: only ``.shape``, as the JAX package's
    ``input_specs`` reads it."""

    def __init__(self, **sizes):
        self.shape = sizes


def _norm(ps, rank):
    """A PartitionSpec padded with None to the leaf's rank."""
    return tuple(ps) + (None,) * (rank - len(tuple(ps)))


def _walk(port, ref_sds, ref_ps, path=""):
    """Every port leaf against the reference's (a scanned group: the
    reference's stacked leaves sliced per layer; the reference's cache
    lengths are host ints in the port)."""
    if isinstance(port, list) and isinstance(ref_sds, list):
        for i, (p, s, q) in enumerate(zip(port, ref_sds, ref_ps)):
            _walk(p, s, q, f"{path}/{i}")
        return
    if isinstance(port, list):
        for i, p in enumerate(port):
            _walk(p, jax.tree.map(lambda s: jax.ShapeDtypeStruct(
                s.shape[1:], s.dtype), ref_sds), jax.tree.map(
                lambda ps: jax.sharding.PartitionSpec(*tuple(ps)[1:]),
                ref_ps, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec)), f"{path}/{i}")
        return
    if isinstance(port, tshapes.ArgSpec):
        assert port.shape == tuple(ref_sds.shape), path
        assert port.dtype == jnp.dtype(ref_sds.dtype).name, path
        assert port.dims == _norm(ref_ps, len(port.shape)), path
        return
    ref_keys = {k for k in ref_sds if k != "len"}
    assert set(port) == ref_keys, path
    for k in port:
        _walk(port[k], ref_sds[k], ref_ps[k], f"{path}/{k}")


@pytest.mark.parametrize("cell", sorted(rshapes.SHAPES))
@pytest.mark.parametrize("arch", rconfigs.ARCHS)
def test_input_specs_match_the_reference(arch, cell):
    rcfg, tcfg = rconfigs.get_config(arch), tconfigs.get_config(arch)
    rcell, tcell = rshapes.SHAPES[cell], tshapes.SHAPES[cell]
    assert dataclasses.asdict(rcell) == dataclasses.asdict(tcell)
    assert tshapes.applicable(tcfg, tcell) == rshapes.applicable(rcfg, rcell)
    mesh = _Mesh(data=16, model=16)
    sds, ps = rshapes.input_specs(rcfg, rcell, mesh)
    assert tshapes.dp_axes(mesh) == rshapes.dp_axes(mesh)
    got = tshapes.input_specs(tcfg, tcell, mesh)
    assert len(got) == len(sds)
    if tcell.kind == "train":
        # the port keeps a scanned group's optimizer state per layer (the
        # reference factors a stacked 1-D leaf [n_rep, D] as 2-D): hold it
        # to the reference's rules on the per-layer specs
        layers = _per_layer(rlm.model_specs(rcfg, tp=16), rcfg)
        sds = list(sds)
        ps = list(ps)
        sds[1] = rshapes._opt_sds(rcfg.optimizer, layers)
        ps[1] = rtrainer.opt_state_pspecs(rcfg.optimizer, layers)
    for g, s, p in zip(got, sds, ps):
        _walk(g, s, p)


def _per_layer(specs, rcfg):
    """The reference's spec tree with each scanned group's stacked leaves
    cut into a list of per-layer specs (the port's layout)."""
    from repro.models.params import ParamSpec as RSpec
    def layers(tree, n):
        return [jax.tree.map(
            lambda s: RSpec(s.shape[1:], s.dims[1:], s.init, s.scale,
                            s.dtype), tree,
            is_leaf=lambda x: isinstance(x, RSpec))] * n
    out = dict(specs, stack=dict(specs["stack"]))
    for g in rlm.stack_plan(rcfg):
        if g.n_rep > 1:
            out["stack"][g.name] = layers(specs["stack"][g.name], g.n_rep)
    if rcfg.encdec is not None:          # the encoder: always stacked
        out["encoder"] = layers(specs["encoder"], rcfg.encdec.n_enc_layers)
    return out


@pytest.mark.parametrize("cell", ["decode_32k", "long_500k"])
def test_input_specs_cut_caches_over_pod_as_the_reference(cell):
    rcfg, tcfg = (c.get_config("gemma3-1b") for c in (rconfigs, tconfigs))
    mesh = _Mesh(pod=2, data=16, model=16)
    sds, ps = rshapes.input_specs(rcfg, rshapes.SHAPES[cell], mesh)
    got = tshapes.input_specs(tcfg, tshapes.SHAPES[cell], mesh)
    for g, s, p in zip(got, sds, ps):
        _walk(g, s, p)


def test_input_specs_on_a_stacked_mesh_give_the_lanes_caches():
    """On a ``StackedMesh`` the cells' cache specs cut to the shapes that
    ``init_caches`` makes on the bound mesh (batch over data, or the
    sequence at long_500k)."""
    cfg = dataclasses.replace(tconfigs.get_config("gemma3-1b").smoke(),
                              scan_layers=False)
    mesh = StackedMesh((2, 2), ("data", "model"), "cpu")
    sizes = tshapes.mesh_sizes(mesh)
    for name, seq in (("decode_32k", False), ("long_500k", True)):
        cell = dataclasses.replace(tshapes.SHAPES[name], seq_len=64,
                                   global_batch=2 if seq else 4)
        _, _, caches, _ = tshapes.input_specs(cfg, cell, mesh)
        with bind(data=mesh["data"], model=mesh["model"]):
            made = tlm.init_caches(cfg, cell.global_batch, cell.seq_len,
                                   seq_sharded=seq)
        spec = caches["stack"]["u0"]["b0_attn_local"]["self"]["k"]
        k = made["stack"]["u0"]["b0_attn_local"]["self"]["k"]
        assert (mesh.lanes,) + spec.local_shape(sizes) == tuple(k.shape)


def test_serve_cli_long_500k_on_a_mesh(tmp_path, capsys):
    """The serve CLI at smoke size on the CPU: a sequence-sharded decode
    held to the unsharded one; default serve, ``tune_trace``, the tuned
    re-serve within 2e-2."""
    assert tserve.main(["--arch", "gemma3-1b", "--mesh", "2x1", "--shape",
                        "long_500k", "--device", "cpu", "--tokens", "4",
                        "--prompt-len", "12", "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "logits agree" in out and (tmp_path / "profiles").is_dir()
