"""The prefix-LM VLM (paligemma-3b) against the JAX package on the CPU.

* The flash path's prefix-LM mask, two launches of the kernel (the prefix
  rows non-causal over the prefix keys, the text rows causal from their
  offset), against ``_flash_jnp(kind="prefix")`` with a prefix that is not
  a multiple of its KV chunk, and its gradients through
  ``FlashAttention`` against ``jax.vjp`` of it.
* paligemma-3b's smoke config (4 gemma layers, 8 stub patches of 48
  before the text): ``forward``, ``prefill`` + ``decode_step`` and
  ``loss_fn`` against the reference's under ``vmap(axis_name="model")``,
  the weights (``img_proj`` among them) carried by ``from_reference``.
* ``Trainer.grads`` of that loss against ``jax.grad`` of the reference's
  at tp 1 and 2.
* ``data.synthetic``'s patches are the reference's ``make_batch``'s, and
  every arch builds the reference's stack plan.

Tolerance: float32 differs from the reference in summation order only,
1e-4 of the output's max-norm (the kernel's plain version sums its chunks
in another order than ``_flash_jnp``'s: 1e-5 for one attention call).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_ref  # noqa: F401  (the reference's import shims)
from test_torch_models import (port_cfg, port_params, ref_params, ref_shard,
                               rel, rvmap, tnp)
from test_torch_train import pairs, ref_join

from repro import configs as rconfigs
from repro.data import make_batch as rmake_batch
from repro.models import attention as rattn
from repro.models import lm as rlm
from repro_torch import configs as tconfigs
from repro_torch.data import make_batch
from repro_torch.dist.axes import bind
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models.params import from_reference, to_reference, tree_leaves
from repro_torch.train import Trainer

B, S_TXT, S_MAX = 2, 12, 32


def pali(**kw):
    return dataclasses.replace(rconfigs.get_config("paligemma-3b").smoke(),
                               dtype="float32", **kw)


@pytest.fixture(scope="module")
def batch():
    rcfg = pali()
    rng = np.random.default_rng(7)
    return {"tokens": rng.integers(0, rcfg.vocab_size, (B, S_TXT)),
            "labels": rng.integers(0, rcfg.vocab_size, (B, S_TXT)),
            "patches": rng.standard_normal(
                (B, rcfg.vlm.n_patches, rcfg.vlm.patch_dim)).astype(
                    np.float32)}


@pytest.fixture(scope="module")
def weights():
    return ref_params(pali(), seed=3)


def _jbatch(b, keys=("tokens", "labels", "patches")):
    return {k: jnp.asarray(b[k], jnp.int32 if k != "patches" else
                           jnp.float32) for k in keys if k in b}


def _tbatch(b, keys=("tokens", "labels", "patches")):
    return {k: torch.as_tensor(b[k]) for k in keys if k in b}


def test_unsupported_names_only_encdec():
    """Every family is ported (the enc-dec, the last one named
    unsupported, included): all ten archs build the reference's stack
    plan."""
    assert len(tconfigs.ARCHS) == 10
    for arch in tconfigs.ARCHS:
        got, want = (
            [(g.name, tuple(g.unit), g.n_rep) for g in m.stack_plan(
                c.get_config(arch))]
            for m, c in ((tlm, tconfigs), (rlm, rconfigs)))
        assert got and got == want, arch


def test_patches_are_the_references_make_batch():
    rcfg, tcfg = (c.get_config("paligemma-3b").smoke()
                  for c in (rconfigs, tconfigs))
    for step in (0, 3):
        want = rmake_batch(rcfg, 4, 24, step, shard=1, n_shards=2)
        got = make_batch(tcfg, 4, 24, step, shard=1, n_shards=2)
        assert sorted(got) == sorted(want) == ["labels", "patches", "tokens"]
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))


# ---------------------------------------------------------------------------
# the flash prefix split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_prefix,q0,sq,grads", [
    (13, 0, 40, True), (40, 0, 40, False), (13, 9, 31, False),
    (13, 20, 20, False)])
def test_flash_prefix_split_matches_flash_jnp(n_prefix, q0, sq, grads):
    """Rows from ``q0`` over keys from 0 (train/prefill: q0 = 0; q0 > 0 is
    a chunk of rows that starts inside or after the prefix); the
    gradients through ``FlashAttention`` in the first case."""
    rng = np.random.default_rng(n_prefix + q0)
    n, skv, hk, g, dh = 2, q0 + sq, 1, 2, 16
    q = rng.normal(size=(n, sq, hk, g, dh)).astype(np.float32)
    k, v = (rng.normal(size=(n, skv, hk, dh)).astype(np.float32)
            for _ in range(2))
    dy = rng.normal(size=q.shape).astype(np.float32)

    def ref(q_, k_, v_):
        return rattn._flash_jnp(q_, k_, v_, jnp.arange(q0, q0 + sq)[None],
                                jnp.arange(skv), kind="prefix",
                                n_prefix=n_prefix, chunk=8)
    tq, tk, tv = (torch.tensor(a, requires_grad=grads) for a in (q, k, v))
    got = tattn._flash_prefix(tq, tk, tv, n_prefix=n_prefix, softcap=0.0,
                              q0=q0)
    if not grads:
        assert rel(tnp(got), jax.jit(ref)(q, k, v)) < 1e-5
        return
    want, vjp = jax.vjp(ref, *(jnp.asarray(a) for a in (q, k, v)))
    assert rel(tnp(got), want) < 1e-5
    got.backward(torch.from_numpy(dy))
    for t_, w in zip((tq, tk, tv), vjp(jnp.asarray(dy))):
        assert rel(tnp(t_.grad), w) < 1e-5


def test_flash_prefix_split_launches_the_kernel_twice(monkeypatch):
    calls = []
    real = tattn.flash_attention

    def counting(q, k, v, **kw):
        calls.append((q.shape[1], k.shape[1], kw["causal"], kw["q0"]))
        return real(q, k, v, **kw)
    monkeypatch.setattr(tattn, "flash_attention", counting)
    q = torch.randn(2, 20, 1, 2, 16)
    kv = torch.randn(2, 20, 1, 16)
    tattn._flash_prefix(q, kv, kv, n_prefix=8, softcap=0.0, q0=0)
    assert calls == [(8, 8, False, 0), (12, 20, True, 8)]


# ---------------------------------------------------------------------------
# paligemma-3b
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl,tp", [("flash", 2), ("ref", 1)])
def test_vlm_forward_matches_the_reference(batch, weights, impl, tp):
    rcfg = pali(attn_impl=impl)
    rp = ref_shard(weights, rcfg, tp)
    jb = _jbatch(batch, ("tokens", "patches"))
    want = rvmap(lambda p: rlm.forward(p, rcfg, jb)[0], rp)
    params, axis = port_params(weights, rcfg, tp)
    with bind(model=axis):
        got, _, _ = tlm.forward(params, port_cfg(rcfg),
                                _tbatch(batch, ("tokens", "patches")))
    assert got.shape == (tp, B, rcfg.vlm.n_patches + S_TXT,
                         rcfg.vocab_padded // tp)
    assert rel(tnp(got), want) < 1e-4


def test_vlm_loss_scores_text_only_and_matches_the_reference(batch,
                                                             weights):
    rcfg = pali(attn_impl="flash")
    rp = ref_shard(weights, rcfg, 2)
    jb = _jbatch(batch)
    want = rvmap(lambda p: rlm.loss_fn(p, rcfg, jb)[0], rp)
    params, axis = port_params(weights, rcfg, 2)
    with bind(model=axis):
        got, _ = tlm.loss_fn(params, port_cfg(rcfg), _tbatch(batch))
    np.testing.assert_allclose(tnp(got), np.asarray(want), rtol=1e-5)


def test_vlm_prefill_and_decode_match_the_reference(batch, weights):
    rcfg = pali(attn_impl="flash")
    tp, steps = 2, 3
    s0 = rcfg.vlm.n_patches + S_TXT
    rp = ref_shard(weights, rcfg, tp)
    jb = _jbatch(batch, ("tokens", "patches"))
    r_init = jax.vmap(lambda _: rlm.init_caches(rcfg, B, S_MAX),
                      axis_name="model", axis_size=tp, in_axes=None)
    r_pf = jax.jit(jax.vmap(lambda p, c: rlm.prefill(p, rcfg, jb, c),
                            axis_name="model"))
    r_dc = jax.jit(jax.vmap(lambda p, t, c, i: rlm.decode_step(
        p, rcfg, t, c, i), axis_name="model", in_axes=(0, None, 0, None)))
    rlg, rc = r_pf(rp, r_init(0))

    cfg = port_cfg(rcfg)
    params, axis = port_params(weights, rcfg, tp)
    with bind(model=axis):
        caches = tlm.init_caches(cfg, B, S_MAX)
    lg, caches = tserve.build_prefill(cfg, axis)(
        params, _tbatch(batch, ("tokens", "patches")), caches)
    assert lg.shape == (tp, B, 1, rcfg.vocab_padded // tp)
    assert rel(tnp(lg), rlg) < 1e-4
    dec = tserve.build_decode(cfg, axis)
    toks = np.random.default_rng(5).integers(0, rcfg.vocab_size,
                                             (steps, B, 1))
    for i in range(steps):
        rlg, rc = r_dc(rp, jnp.asarray(toks[i], jnp.int32), rc,
                       jnp.int32(s0 + i))
        lg, caches = dec(params, torch.as_tensor(toks[i]), caches, s0 + i)
        assert rel(tnp(lg), rlg) < 1e-4


def test_vlm_serve_counts_the_prefix_in_decode_positions(batch, weights):
    """``serve`` with patches decodes from position ``n_patches + S``: the
    same tokens and logits as prefill + decode_step placed by hand."""
    rcfg = pali(attn_impl="flash")
    cfg = port_cfg(rcfg)
    params, axis = port_params(weights, rcfg, 2)
    prompts = torch.as_tensor(batch["tokens"])
    patches = torch.as_tensor(batch["patches"])
    res = tserve.serve(cfg, axis, params, prompts, S_MAX, 3, patches=patches)
    with bind(model=axis):
        caches = tlm.init_caches(cfg, B, S_MAX)
    lg, caches = tserve.build_prefill(cfg, axis)(
        params, {"tokens": prompts, "patches": patches}, caches)
    tok = res.tokens[:, :1]
    s0 = rcfg.vlm.n_patches + S_TXT
    lg, _ = tserve.build_decode(cfg, axis)(params, tok, caches, s0)
    np.testing.assert_array_equal(tnp(tserve.full_vocab(lg)),
                                  tnp(res.logits[1]))
    with pytest.raises(ValueError, match="exceed"):
        tserve.serve(cfg, axis, params, prompts, s0 + 1, 3, patches=patches)


def test_vlm_serve_on_a_mesh_matches_the_model_axis(batch, weights):
    """The VLM served on a (data 2, model 2) mesh (the batch and its
    patches over data, the weights FSDP over it) gives the model axis'
    tokens and logits (float32: summation order only, 1e-5)."""
    from repro_torch.core._axis import StackedMesh
    from repro_torch.models import params as tparams
    rcfg = pali(attn_impl="flash")
    cfg = port_cfg(rcfg)
    params, axis = port_params(weights, rcfg, 2)
    mesh = StackedMesh((2, 2), ("data", "model"), "cpu")
    mparams = tparams.from_reference(weights, tlm.model_specs(cfg, 2), mesh)
    prompts = torch.as_tensor(batch["tokens"])
    patches = torch.as_tensor(batch["patches"])
    want = tserve.serve(cfg, axis, params, prompts, S_MAX, 3,
                        patches=patches)
    got = tserve.serve(cfg, mesh, mparams, prompts, S_MAX, 3,
                       patches=patches)
    assert torch.equal(got.tokens, want.tokens)
    for a, b in zip(got.logits, want.logits):
        assert rel(tnp(a), tnp(b)) < 1e-5


@pytest.mark.parametrize("tp", [1, 2])
def test_vlm_loss_and_gradients_match_jax_grad(batch, weights, tp):
    """``Trainer.grads`` of the text-only loss against ``jax.grad`` of the
    reference's ``loss_fn`` under ``vmap(axis_name="model")``, each leaf
    (``img_proj`` among them) within 1e-4 of its max-norm: float32, the
    two packages differ in summation order only."""
    rcfg = pali(attn_impl="flash")
    jb = _jbatch(batch)
    loss, g = jax.jit(jax.vmap(jax.value_and_grad(
        lambda p: rlm.loss_fn(p, rcfg, jb)[0]), axis_name="model"))(
        ref_shard(weights, rcfg, tp))
    want = ref_join(jax.tree.map(np.asarray, g), rlm.model_specs(rcfg, tp=tp),
                    "model")
    tr = Trainer(port_cfg(rcfg), mesh=(1, tp), device="cpu")
    params = from_reference(weights, tr.specs, tr.axis, "model")
    got_loss, grads = tr.grads(params, tr.put_batch(batch))
    assert float(got_loss) == pytest.approx(float(loss[0]), rel=1e-5)
    got = to_reference(grads, tr.specs, tr.axis, "model")
    n = 0
    for path, gt, w in pairs(got, want):
        assert rel(tnp(gt), w) < 1e-4, path
        n += 1
    assert n == len(tree_leaves(got)) == len(jax.tree.leaves(want))
    assert np.abs(tnp(got["img_proj"])).max() > 0
