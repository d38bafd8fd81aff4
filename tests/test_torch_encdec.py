"""The encoder-decoder family (whisper-medium) against the JAX package on
the CPU.

whisper-medium's smoke config (2 encoder and 4 decoder layers, d_model 64,
4 q heads over 2 KV heads of 16, stub frame embeddings): the port's
``sincos_positions``, spec trees, ``_encode``, ``forward``, ``prefill`` +
``decode_step`` (the encoder longer and shorter than the self cache),
``loss_fn`` and its gradients against the reference's under
``vmap(axis_name="model")``, the weights carried by ``from_reference``
(the encoder's stacked leaves into the port's per-layer list).  At tp 4
the smoke config's 2 KV heads are replicated; there the reference's flash
path treats the cross K/V as sharded (``src/repro/models/attention.py:
370-371``: an ``AssertionError`` at 4 q heads, the wrong KV heads at 8),
so the port's flash path is held to the reference's ``ref`` path.

Tolerance: float32 differs from the reference in summation order only,
1e-4 of the output's max-norm.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_ref  # noqa: F401  (the reference's import shims)
from test_torch_models import (port_cfg, port_params, ref_params, ref_shard,
                               rel, rvmap, specs_match, tnp)
from test_torch_train import pairs, ref_join

from repro import configs as rconfigs
from repro.data import make_batch as rmake_batch
from repro.launch import shapes as rshapes
from repro.models import layers as rlayers
from repro.models import lm as rlm
from repro_torch import configs as tconfigs
from repro_torch.data import make_batch
from repro_torch.dist.axes import bind
from repro_torch.launch import serve as tserve
from repro_torch.launch import shapes as tshapes
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models.params import (from_reference, to_reference,
                                       tree_leaves)
from repro_torch.train import Trainer

B, S_DEC, S_ENC, S_MAX = 2, 8, 24, 20
TOL = 1e-4


def whisper(**kw):
    return dataclasses.replace(
        rconfigs.get_config("whisper-medium").smoke(), dtype="float32",
        **kw)


@pytest.fixture(scope="module")
def weights():
    return ref_params(whisper(), seed=4)


def _batch(seed=7, s_enc=S_ENC, s_dec=S_DEC):
    rcfg = whisper()
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, rcfg.vocab_size, (B, s_dec)).astype(np.int32)
    return {"tokens": toks, "labels": toks.copy(),
            "frames": rng.standard_normal(
                (B, s_enc, rcfg.d_model)).astype(np.float32)}


def _jb(b, keys=("tokens", "frames")):
    return {k: jnp.asarray(b[k]) for k in keys}


def _tb(b, keys=("tokens", "frames")):
    return {k: torch.as_tensor(b[k]) for k in keys}


# ---------------------------------------------------------------------------
# layers, specs, data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d_model", [64, 1024, 7, 2])
def test_sincos_positions_match(d_model):
    pos = np.array([[0, 1, 5, 191, 448, 1499]])
    want = np.asarray(rlayers.sincos_positions(jnp.asarray(pos), d_model))
    got = tlayers.sincos_positions(torch.as_tensor(pos), d_model)
    assert got.dtype == torch.float32 and got.shape == want.shape
    # float32 angles of up to 1499 rad: a few ulp of the angle apart
    np.testing.assert_allclose(tnp(got), want, atol=5e-4, rtol=0)
    np.testing.assert_allclose(tnp(got[:, :3]), want[:, :3], atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_stack_plan_and_model_specs_match(tp):
    specs_match(whisper(), tp)
    specs = tlm.model_specs(port_cfg(whisper()), tp)
    assert len(specs["encoder"]) == whisper().encdec.n_enc_layers
    assert {"ln_x", "xattn"} <= set(specs["stack"]["g0"][0]["b0_attn"])


def _cache_walk(t, r, path=""):
    """The port's cache specs against the reference's (its stacked
    leaves sliced per layer; its lengths are host ints in the port)."""
    if isinstance(t, list):
        for i, ti in enumerate(t):
            _cache_walk(ti, jax.tree.map(
                lambda s: dataclasses.replace(s, shape=s.shape[1:],
                                              dims=s.dims[1:]), r,
                is_leaf=lambda x: hasattr(x, "dims")), f"{path}/{i}")
        return
    if hasattr(t, "dims"):
        assert (t.shape, t.dims, t.dtype) == (r.shape, r.dims, r.dtype), path
        return
    assert set(t) == {k for k in r if k != "len"}, path
    for k in t:
        _cache_walk(t[k], r[k], f"{path}/{k}")


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_cache_specs_match_and_size_the_encoder(tp):
    rcfg = whisper()
    _cache_walk(tlm.cache_specs(port_cfg(rcfg), B, S_MAX, tp),
                rlm.cache_specs(rcfg, B, S_MAX, tp))
    got = tlm.cache_specs(port_cfg(rcfg), B, S_MAX, tp, enc_len=S_ENC)
    blk = got["stack"]["g0"][0]["b0_attn"]
    kv = rcfg.n_kv_heads
    assert blk["cross_k"].shape == (B, S_ENC, kv, rcfg.hd)
    assert blk["self"]["k"].shape == (B, S_MAX, kv, rcfg.hd)


@pytest.mark.parametrize("tp", [1, 2])
def test_params_carry_the_encoders_stacked_leaves_both_ways(weights, tp):
    """``from_reference`` cuts the reference's stacked encoder leaves
    ``[n_enc, ...]`` into the port's per-layer list, and ``to_reference``
    stacks them back, bit for bit."""
    params, axis = port_params(weights, whisper(), tp)
    assert len(params["encoder"]) == whisper().encdec.n_enc_layers
    w_in = weights["encoder"]["ffn"]["w_in"]                # [2, 64, 128]
    np.testing.assert_array_equal(
        tnp(params["encoder"][1]["ffn"]["w_in"][tp - 1]),
        np.asarray(w_in[1])[:, (tp - 1) * 128 // tp:])
    back = to_reference(params, tlm.model_specs(port_cfg(whisper()), tp),
                        axis)
    n = 0
    for path, got, want in pairs(back, weights):
        np.testing.assert_array_equal(tnp(got), np.asarray(want), path)
        n += 1
    assert n == len(jax.tree.leaves(weights))


def test_frames_are_the_references_make_batch():
    rcfg, tcfg = (c.get_config("whisper-medium").smoke()
                  for c in (rconfigs, tconfigs))
    for step in (0, 3):
        want = rmake_batch(rcfg, 4, 32, step, shard=1, n_shards=2)
        got = make_batch(tcfg, 4, 32, step, shard=1, n_shards=2)
        assert sorted(got) == sorted(want) == ["frames", "labels", "tokens"]
        for k in want:
            assert got[k].dtype == np.asarray(want[k]).dtype
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))


@pytest.mark.parametrize("cell", sorted(rshapes.SHAPES))
def test_input_specs_build_whisper(cell):
    """Every cell's arguments on a (data 2, model 4) mesh: the frames and
    the decoder tokens at ``seq // dec_ratio`` (train, prefill), the
    caches' cross K/V at the cell's length, cut as the reference's."""
    cfg = tconfigs.get_config("whisper-medium")
    tcell = tshapes.SHAPES[cell]
    mesh = type("M", (), {"shape": {"data": 2, "model": 4}})()
    got = tshapes.input_specs(cfg, tcell, mesh)
    assert len(got[0]["encoder"]) == 24
    if tcell.kind == "decode":
        blk = got[2]["stack"]["g0"][0]["b0_attn"]
        assert blk["cross_k"].shape == (tcell.global_batch, tcell.seq_len,
                                        16, 64)
        bdim = None if tcell.seq_sharded else "data"
        assert blk["cross_k"].dims == (bdim, None, "model", None)
        return
    b = got[2] if tcell.kind == "train" else got[1]
    assert b["frames"].shape == (tcell.global_batch, tcell.seq_len, 1024)
    assert b["tokens"].shape == (tcell.global_batch, tcell.seq_len // 8)


# ---------------------------------------------------------------------------
# the encoder and the forward
# ---------------------------------------------------------------------------


def _want_impl(impl, tp, rcfg):
    """The reference path the port's ``impl`` is held to: its own,
    except flash with replicated KV heads (the reference fault)."""
    return "ref" if rcfg.n_kv_heads % tp else impl


@pytest.mark.parametrize("impl", ["ref", "flash"])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_encoder_matches_the_reference(weights, impl, tp):
    rcfg = whisper(attn_impl=impl)
    rp = ref_shard(weights, rcfg, tp)
    frames = _batch()["frames"]
    want = rvmap(lambda p: rlm._encode(p, rcfg, jnp.asarray(frames)), rp)
    params, axis = port_params(weights, rcfg, tp)
    with bind(model=axis):
        got = tlm._encode(params, port_cfg(rcfg), torch.as_tensor(frames))
    assert got.shape == (tp, B, S_ENC, rcfg.d_model)
    assert rel(tnp(got), want) < TOL


@pytest.mark.parametrize("impl", ["ref", "flash"])
@pytest.mark.parametrize("tp", [1, 2, 4])
def test_forward_matches_the_reference(weights, impl, tp):
    rcfg = whisper(attn_impl=impl)
    rp = ref_shard(weights, rcfg, tp)
    b = _batch()
    ref_cfg = whisper(attn_impl=_want_impl(impl, tp, rcfg))
    want = rvmap(lambda p: rlm.forward(p, ref_cfg, _jb(b))[0], rp)
    params, axis = port_params(weights, rcfg, tp)
    with bind(model=axis):
        got, _, _ = tlm.forward(params, port_cfg(rcfg), _tb(b))
    assert got.shape == (tp, B, S_DEC, rcfg.vocab_padded // tp)
    assert rel(tnp(got), want) < TOL


@pytest.mark.parametrize("impl", ["ref", "flash"])
def test_forward_with_eight_q_heads_over_two_kv_heads_at_tp4(impl):
    """Two q heads a rank over one of 2 replicated KV heads: the
    reference's flash path would pair them with both KV heads."""
    rcfg = whisper(attn_impl=impl, n_heads=8)
    tree = ref_params(rcfg, seed=5)
    rp = ref_shard(tree, rcfg, 4)
    b = _batch(seed=9)
    want = rvmap(lambda p: rlm.forward(p, whisper(attn_impl="ref",
                                                  n_heads=8), _jb(b))[0], rp)
    params, axis = port_params(tree, rcfg, 4)
    with bind(model=axis):
        got, _, _ = tlm.forward(params, port_cfg(rcfg), _tb(b))
    assert rel(tnp(got), want) < TOL


# ---------------------------------------------------------------------------
# prefill and decode, the cross caches
# ---------------------------------------------------------------------------


def _ref_serve(rcfg, rp, tp, b, toks):
    """The reference's prefill (its cross caches replaced by the
    encoder's length) and decode steps: the logits of each."""
    jb = _jb(b)
    init = jax.vmap(lambda _: rlm.init_caches(rcfg, B, S_MAX),
                    axis_name="model", axis_size=tp, in_axes=None)
    pf = jax.jit(jax.vmap(lambda p, c: rlm.prefill(p, rcfg, jb, c),
                          axis_name="model"))
    dc = jax.jit(jax.vmap(lambda p, t, c, i: rlm.decode_step(
        p, rcfg, t, c, i), axis_name="model", in_axes=(0, None, 0, None)))
    lg, c = pf(rp, init(0))
    out = [lg]
    for i, t in enumerate(toks):
        lg, c = dc(rp, jnp.asarray(t, jnp.int32), c, jnp.int32(S_DEC + i))
        out.append(lg)
    return out


@pytest.mark.parametrize("impl,tp,s_enc", [
    ("flash", 2, 12), ("flash", 2, 32), ("flash", 4, 12), ("flash", 4, 32),
    ("ref", 1, 32), ("ref", 4, 12)])
def test_prefill_and_decode_match_the_reference(weights, impl, tp, s_enc):
    """The encoder shorter (12) and longer (32) than the 20-slot self
    cache: the cross buffers take the encoder's length."""
    rcfg = whisper(attn_impl=impl)
    rp = ref_shard(weights, rcfg, tp)
    b = _batch(s_enc=s_enc)
    toks = np.random.default_rng(5).integers(0, rcfg.vocab_size, (3, B, 1))
    want = _ref_serve(whisper(attn_impl=_want_impl(impl, tp, rcfg)), rp, tp,
                      b, toks)
    cfg = port_cfg(rcfg)
    params, axis = port_params(weights, rcfg, tp)
    with bind(model=axis):
        caches = tlm.init_caches(cfg, B, S_MAX, enc_len=s_enc)
        assert caches["stack"]["g0"][0]["b0_attn"]["cross_k"].shape[2] == \
            s_enc
    lg, caches = tserve.build_prefill(cfg, axis)(params, _tb(b), caches)
    assert lg.shape == (tp, B, 1, rcfg.vocab_padded // tp)
    assert rel(tnp(lg), want[0]) < TOL
    dec = tserve.build_decode(cfg, axis)
    seq = b["tokens"]
    for i in range(3):
        lg, caches = dec(params, torch.as_tensor(toks[i]), caches, S_DEC + i)
        assert rel(tnp(lg), want[i + 1]) < TOL
        seq = np.concatenate([seq, toks[i]], axis=1)
    # the last decode step against the full forward at the last position
    with bind(model=axis):
        full, _, _ = tlm.forward(params, cfg, _tb(dict(b, tokens=seq)))
    assert rel(tnp(lg), tnp(full[:, :, -1:])) < TOL


def test_prefill_raises_naming_both_lengths(weights):
    cfg = port_cfg(whisper())
    params, axis = port_params(weights, whisper(), 2)
    with bind(model=axis):
        caches = tlm.init_caches(cfg, B, S_MAX)          # enc_len = S_MAX
    with pytest.raises(ValueError, match=rf"{S_MAX} encoder positions.*"
                                         rf"gave {S_ENC}"):
        tserve.build_prefill(cfg, axis)(params, _tb(_batch()), caches)


@pytest.mark.parametrize("impl", ["flash", "ref"])
def test_decode_never_reprojects_the_encoder(weights, impl):
    """After prefill every cross-attention K/V weight is set to NaN: the
    decode logits stay finite and equal."""
    rcfg = whisper(attn_impl=impl)
    cfg = port_cfg(rcfg)
    params, axis = port_params(weights, rcfg, 2)
    b = _batch()
    with bind(model=axis):
        caches = tlm.init_caches(cfg, B, S_MAX, enc_len=S_ENC)
    _, caches = tserve.build_prefill(cfg, axis)(params, _tb(b), caches)
    clone = tserve.clone_caches(caches)
    dec = tserve.build_decode(cfg, axis)
    tok = torch.as_tensor(b["tokens"][:, :1])
    want, _ = dec(params, tok, caches, S_DEC)
    for layer in params["stack"]["g0"]:
        for key in ("w_k", "w_v"):
            layer["b0_attn"]["xattn"][key].fill_(float("nan"))
    got, _ = dec(params, tok, clone, S_DEC)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, want)


def test_serve_runs_the_encoder_in_prefill(weights):
    """``serve(frames=)`` gives prefill + decode_step's logits placed by
    hand; an enc-dec model without frames is refused."""
    rcfg = whisper(attn_impl="flash")
    cfg = port_cfg(rcfg)
    params, axis = port_params(weights, rcfg, 2)
    b = _batch()
    prompts, frames = torch.as_tensor(b["tokens"]), torch.as_tensor(
        b["frames"])
    res = tserve.serve(cfg, axis, params, prompts, S_MAX, 3, frames=frames)
    with bind(model=axis):
        caches = tlm.init_caches(cfg, B, S_MAX, enc_len=S_ENC)
    lg, caches = tserve.build_prefill(cfg, axis)(params, _tb(b), caches)
    np.testing.assert_array_equal(tnp(tserve.full_vocab(lg)),
                                  tnp(res.logits[0]))
    lg, _ = tserve.build_decode(cfg, axis)(params, res.tokens[:, :1],
                                           caches, S_DEC)
    np.testing.assert_array_equal(tnp(tserve.full_vocab(lg)),
                                  tnp(res.logits[1]))
    with pytest.raises(ValueError, match="frames"):
        tserve.serve(cfg, axis, params, prompts, S_MAX, 3)


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", [1, 2])
def test_loss_and_gradients_match_jax_grad(weights, tp):
    rcfg = whisper(attn_impl="flash")
    b = _batch(seed=11)
    jb = _jb(b, ("tokens", "labels", "frames"))
    sharded = ref_shard(weights, rcfg, tp)
    loss, g = jax.jit(jax.vmap(jax.value_and_grad(
        lambda p: rlm.loss_fn(p, rcfg, jb)[0]), axis_name="model"))(sharded)
    want = ref_join(jax.tree.map(np.asarray, g), rlm.model_specs(rcfg, tp=tp),
                    "model")
    tr = Trainer(port_cfg(rcfg), mesh=(1, tp), device="cpu")
    params = from_reference(weights, tr.specs, tr.axis, "model")
    got_loss, grads = tr.grads(params, tr.put_batch(b))
    assert float(got_loss) == pytest.approx(float(loss[0]), rel=1e-5)
    got = to_reference(grads, tr.specs, tr.axis, "model")
    n = 0
    for path, gt, w in pairs(got, want):
        assert rel(tnp(gt), w) < TOL, path
        n += 1
    assert n == len(tree_leaves(got)) == len(jax.tree.leaves(want))


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------


def test_serve_cli_runs_whisper_on_the_cpu(tmp_path, capsys):
    assert tserve.main(["--device", "cpu", "--arch", "whisper-medium",
                        "--tokens", "6", "--prompt-len", "8",
                        "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "arch=whisper-medium (smoke)" in out
    assert (tmp_path / "trace.jsonl").exists()
    lines = {ln.split(":")[0]: ln.split(":", 1)[1] for ln in out.splitlines()
             if ln.startswith(("default tokens", "tuned tokens"))}
    assert lines["default tokens"].strip() == lines["tuned tokens"].strip()
