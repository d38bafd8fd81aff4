"""Training through the kernels' autograd Functions on the CPU: the
port's ``FlashAttention``, ``RWKV6Scan`` and ``SSDScan`` against the JAX
package's differentiable jnp paths, and whole-model gradients against
``jax.grad`` of the reference's loss.

The same numpy inputs, made from a seed, go through:

* ``jax.vjp`` of the reference's ``models/attention.py:_flash_jnp``,
  ``models/ssm.py:_wkv_scan`` and ``_ssd_chunked`` (what the reference
  trains through), and the port's Functions (whose forward on CPU tensors
  is the plain version, and whose backward recomputes through it), with
  one random cotangent; each Function's gradients also equal autograd
  straight through its plain version, and ``torch.autograd.gradcheck``
  holds them in float64 (the plain versions compute in float64 there);
* the reference's ``lm.loss_fn`` under ``vmap(axis_name="model")`` with
  ``jax.value_and_grad``, and the port's ``Trainer.grads`` on a
  ``StackedAxis`` of the same size, from the reference's weights carried
  by ``params.from_reference`` and a Zipf batch made from a seed:
  llama3.2-3b with ``attn_impl="flash"``, rwkv6-3b (also with decays that
  underflow to 0 in float32: ``w0 = 5``, so ``exp(-exp(w0))`` is below
  float32's smallest value) and zamba2-1.2b (Mamba2 blocks and its shared
  flash attention), at tp 1 and 2.

Tolerance: atol 1e-4, rtol 1e-3 elementwise, as the reference holds its
flash gradients to its ref path's (``tests/test_attn_variants.py:106-108``);
losses 1e-5 relative (float32 summation order).  Whole-model gradients
are held to the exact ones, the reference's in float64: within that bar
plus twice the reference's own float32 error on the leaf.  rwkv6's
float32 gradients lie up to ~1e-3 from its float64 ones on some batches,
in both packages alike (a sum with cancellation: each package's error is
about half the distance between the two), so the bar alone between the
two float32 results would test the batch, not the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_ref  # noqa: F401  (the reference's import shims)
from test_torch_models import (port_cfg, randomized, ref_params, ref_shard,
                               smoke, ssm_params, ssm_smoke)
from test_torch_train import pairs, ref_join

from repro.models import lm as rlm
from repro.models import ssm as rssm
from repro.models.attention import _flash_jnp
from repro_torch.data import make_batch
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import rwkv6_scan as RW
from repro_torch.kernels import ssd_mamba2 as SSD
from repro_torch.models.params import from_reference, to_reference
from repro_torch.models.params import tree_leaves
from repro_torch.train import Trainer

ATOL, RTOL = 1e-4, 1e-3
KIND = {(True, 0): "causal", (True, 1): "local", (False, 0): "full"}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _close(got, want, atol=ATOL, rtol=RTOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def _normals(seed, shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]


def _leaves(*arrays, grad=True):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


def _plain_grads(fn, ins, g):
    """Gradients of ``fn(*ins)`` against ``g`` by autograd straight
    through ``fn`` (fresh leaves)."""
    xs = [t.detach().clone().requires_grad_(True) for t in ins]
    return torch.autograd.grad(fn(*xs), xs, g)


# ---------------------------------------------------------------------------
# the Functions against the reference's jnp paths
# ---------------------------------------------------------------------------

FLASH = [
    # (B, Sq, Skv, HK, G, dh, causal, window, softcap, q0, chunk)
    (2, 12, 12, 2, 3, 8, True, 0, 0.0, 0, 4),          # prefill, 3 chunks
    (2, 10, 10, 1, 2, 8, True, 4, 0.0, 0, 4),          # sliding window
    (1, 8, 8, 2, 1, 8, False, 0, 0.0, 0, 1024),        # full, one chunk
    (2, 3, 16, 2, 2, 8, True, 0, 5.0, 13, 8),          # 3 tokens, softcap
]


@pytest.mark.parametrize("case", FLASH)
def test_flash_function_gradients_match_flash_jnp(monkeypatch, case):
    b, sq, skv, hk, g, dh, causal, window, softcap, q0, chunk = case
    monkeypatch.setattr(FA, "CHUNK", chunk)
    q, k, v, gy = _normals(sum(case[:6]), [(b, sq, hk, g, dh),
                                          (b, skv, hk, dh), (b, skv, hk, dh),
                                          (b, sq, hk, g, dh)], 1.5)
    kind = KIND[(causal, int(window > 0))]
    out, vjp = jax.vjp(lambda q_, k_, v_: _flash_jnp(
        q_, k_, v_, q0 + jnp.arange(sq)[None], jnp.arange(skv), kind=kind,
        window=window, softcap=softcap or None, chunk=chunk), q, k, v)
    want = vjp(jnp.asarray(gy))
    ins = _leaves(q, k, v)
    args = (causal, window, softcap, q0, None, None)
    y = FA.FlashAttention.apply(*ins, *args)
    got = torch.autograd.grad(y, ins, torch.tensor(gy))
    _close(_np(y), out)
    for a, w in zip(got, want):
        _close(_np(a), w)
    plain = _plain_grads(lambda *t: FA.flash_attention_plain(
        *t, causal=causal, window=window, softcap=softcap, q0=q0), ins,
        torch.tensor(gy))
    for a, w in zip(got, plain):
        assert torch.equal(a, w)


RWKV = [(2, 40, 2, 8, None), (1, 70, 3, 4, None), (2, 33, 2, 8, 5.0)]


@pytest.mark.parametrize("n,s,h,hd,w0", RWKV)
def test_rwkv6_function_gradients_match_wkv_scan(n, s, h, hd, w0):
    """Gradients for r, k, v, u and the log-decay; the reference's
    ``_wkv_scan`` takes w, so its w-gradient times w is the log-decay's.
    With ``w0`` set, most of half the channels' decays underflow to 0 in
    float32, the others are subnormal: the gradients stay finite and still
    match."""
    r, k, v, dec, u, gy = _normals(n + s + h, [(n, s, h, hd)] * 4
                                   + [(h, hd), (n, s, h, hd)], 0.5)
    if w0 is not None:
        dec[..., ::2] += w0
    logw = -np.exp(dec)
    w = np.exp(logw)
    if w0 is not None:             # most are 0, the rest down to 1e-45
        assert (w[..., ::2] == 0).mean() > 0.5
    s0 = jnp.zeros((n, h, hd, hd), jnp.float32)
    (out, _), vjp = jax.vjp(lambda *a: rssm._wkv_scan(*a, s0), r, k, v, w, u)
    wr, wk, wv, ww, wu = vjp((jnp.asarray(gy), jnp.zeros_like(s0)))
    ins = _leaves(r, k, v, logw, u[None])
    y = RW.RWKV6Scan.apply(*ins)
    got = torch.autograd.grad(y, ins, torch.tensor(gy))
    _close(_np(y), out)
    for a, want in zip(got, (wr, wk, wv, np.asarray(ww) * w, wu[None])):
        _close(_np(a), want)
    plain = _plain_grads(lambda *t: RW.rwkv6_scan_plain_log(*t)[0], ins,
                         torch.tensor(gy))
    for a, b in zip(got, plain):
        assert torch.equal(a, b)


SSD_CASES = [(2, 64, 2, 8, 4, 16), (1, 40, 3, 4, 5, 8), (2, 128, 2, 8, 4, 64)]


@pytest.mark.parametrize("n,s,h,p,ns,chunk", SSD_CASES)
def test_ssd_function_gradients_match_ssd_chunked(n, s, h, p, ns, chunk):
    """Gradients for x, dt, a and the conv output whose two halves are B
    and C (strided views, as the model passes them); the reference chunks
    by ``chunk``, the port by its kernel's 64 rows."""
    x, dtr, alog, bc, gy = _normals(n + s + p, [(n, s, h, p), (n, s, h), (h,),
                                                (n, s, 2 * ns), (n, s, h, p)])
    dt = np.log1p(np.exp(dtr)) * 0.5
    a = np.exp(alog * 0.5)
    s0 = jnp.zeros((n, h, ns, p), jnp.float32)
    (out, _), vjp = jax.vjp(lambda x_, dt_, a_, bc_: rssm._ssd_chunked(
        x_, dt_, a_, bc_[..., :ns], bc_[..., ns:], s0, chunk), x, dt, a, bc)
    want = vjp((jnp.asarray(gy), jnp.zeros_like(s0)))
    xt, dtt, at, bct = _leaves(x, dt, a[None], bc)
    y = SSD.SSDScan.apply(xt, dtt, at, bct[..., :ns], bct[..., ns:])
    got = torch.autograd.grad(y, (xt, dtt, at, bct), torch.tensor(gy))
    _close(_np(y), out)
    for g_, w_ in zip(got, (want[0], want[1], want[2][None], want[3])):
        _close(_np(g_), w_)
    xs = [t.detach().clone().requires_grad_(True) for t in (xt, dtt, at, bct)]
    yp = SSD.ssd_scan_plain(*xs[:3], xs[3][..., :ns], xs[3][..., ns:])[0]
    for g_, w_ in zip(got, torch.autograd.grad(yp, xs, torch.tensor(gy))):
        assert torch.equal(g_, w_)


# ---------------------------------------------------------------------------
# gradcheck in float64, and the Functions' bookkeeping
# ---------------------------------------------------------------------------


def _f64(seed, shapes, scale=1.0):
    return [torch.tensor(a, dtype=torch.float64, requires_grad=True)
            for a in _normals(seed, shapes, scale)]


def test_flash_function_gradcheck_float64(monkeypatch):
    monkeypatch.setattr(FA, "CHUNK", 4)       # three chunks of the 10 keys
    q, k, v = _f64(1, [(1, 6, 1, 2, 4), (1, 10, 1, 4), (1, 10, 1, 4)])
    for args in ((True, 0, 0.0, 4, None), (True, 3, 2.0, 4, 9),
                 (False, 0, 0.0, 0, None)):
        assert torch.autograd.gradcheck(
            lambda *t: FA.FlashAttention.apply(*t, *args, None),
            (q, k, v))


def test_rwkv6_function_gradcheck_float64():
    r, k, v, dec, u = _f64(2, [(1, 35, 1, 4)] * 4 + [(1, 1, 4)], 0.5)
    logw = (-torch.exp(dec.detach())).requires_grad_(True)   # 2 chunks
    assert torch.autograd.gradcheck(RW.RWKV6Scan.apply, (r, k, v, logw, u))


def test_ssd_function_gradcheck_float64():
    x, dtr, alog, B, C = _f64(3, [(1, 66, 1, 2), (1, 66, 1), (1, 1),
                                  (1, 66, 2), (1, 66, 2)])   # 2 chunks
    dt = torch.nn.functional.softplus(dtr.detach()).requires_grad_(True)
    a = torch.exp(alog.detach() * 0.5).requires_grad_(True)
    assert torch.autograd.gradcheck(SSD.SSDScan.apply, (x, dt, a, B, C))


def test_functions_save_only_their_inputs_and_skip_unneeded_grads():
    """A Function keeps its inputs for the backward, nothing of the
    recomputation (no score matrix or chunk intermediate outlives the
    forward), and returns None for an input that needs no gradient."""
    q, k, v = _leaves(*_normals(4, [(1, 8, 1, 2, 4), (1, 8, 1, 4),
                                    (1, 8, 1, 4)]))
    y = FA.FlashAttention.apply(q, k, v, True, 0, 0.0, 0, None, None)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 3 and all(
        s.data_ptr() == t.data_ptr() for s, t in zip(saved, (q, k, v)))
    v.requires_grad_(False)
    y = FA.FlashAttention.apply(q, k, v, True, 0, 0.0, 0, None, None)
    y.sum().backward()
    assert v.grad is None and q.grad is not None
    r, kk, vv, dec, u = _leaves(*_normals(5, [(1, 5, 1, 4)] * 4
                                          + [(1, 1, 4)]), grad=False)
    r.requires_grad_(True)
    y = RW.RWKV6Scan.apply(r, kk, vv, -torch.exp(dec), u)
    assert len(y.grad_fn.saved_tensors) == 5
    (gr,) = torch.autograd.grad(y.sum(), [r])
    assert torch.isfinite(gr).all()


# ---------------------------------------------------------------------------
# whole models: Trainer.grads against jax.grad of the reference's loss
# ---------------------------------------------------------------------------

ARCHS = [("llama3.2-3b", False), ("rwkv6-3b", False), ("rwkv6-3b", True),
         ("zamba2-1.2b", False)]


def _rcfg(arch):
    if arch == "llama3.2-3b":
        return smoke("float32", attn_impl="flash", scan_layers=False)
    return ssm_smoke(arch, scan_layers=False)


def _underflow(tree, w0=5.0):
    """Every other channel of each RWKV decay bias set to ``w0``: the
    block's decay ``exp(-exp(w0 + lora))`` underflows to 0 there."""
    if isinstance(tree, dict):
        return {k: (_set_w0(v, w0) if k == "w0" else _underflow(v, w0))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_underflow(t, w0) for t in tree]
    return tree


def _set_w0(a, w0):
    a = np.array(a)
    a[..., ::2] = w0
    return a


def _zipf_batch(vocab: int, seed: int, b: int = 2, s: int = 16) -> dict:
    """``make_batch``'s token law (Zipf ids, a per-sequence offset) from a
    numpy seed, the same in every process."""
    rng = np.random.default_rng(seed)
    toks = ((rng.zipf(1.3, size=(b, s)) + rng.integers(0, 97, (b, 1)))
            % vocab).astype(np.int32)
    return {"tokens": toks, "labels": toks.copy()}


def _ref_grads(rcfg, tree, tp, batch, dtype):
    """The reference's per-rank loss and gradients (joined to the global
    layout) with weights and compute in ``dtype``."""
    cfg = dataclasses.replace(rcfg, dtype=dtype)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    sharded = jax.tree.map(lambda a: a.astype(dtype),
                           ref_shard(tree, rcfg, tp))
    loss, g = jax.jit(jax.vmap(jax.value_and_grad(
        lambda p: rlm.loss_fn(p, cfg, jb)[0]), axis_name="model"))(sharded)
    return (np.asarray(loss), ref_join(jax.tree.map(np.asarray, g),
                                       rlm.model_specs(cfg, tp=tp), "model"))


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("arch,underflow", ARCHS,
                         ids=[f"{a}{'-underflow' if u else ''}"
                              for a, u in ARCHS])
def test_model_gradients_match_jax_grad(arch, underflow, tp):
    rcfg = _rcfg(arch)
    tree = (randomized(ref_params(rcfg), 2) if arch == "llama3.2-3b"
            else ssm_params(rcfg, tp))
    if underflow:
        tree = _underflow(tree)
    batch = _zipf_batch(rcfg.vocab_size, 3)
    rl, want = _ref_grads(rcfg, tree, tp, batch, "float32")
    with jax.enable_x64(True):
        _, exact = _ref_grads(rcfg, tree, tp, batch, "float64")
    tr = Trainer(port_cfg(rcfg), mesh=(1, tp), device="cpu")
    params = from_reference(tree, tr.specs, tr.axis, "model")
    loss, grads = tr.grads(params, tr.put_batch(batch))
    assert float(loss) == pytest.approx(float(rl[0]), rel=1e-5)
    got = to_reference(grads, tr.specs, tr.axis, "model")
    n = 0
    for (path, g, w), (_, _, e) in zip(pairs(got, want), pairs(got, exact)):
        w, e = np.asarray(w, np.float64), np.asarray(e, np.float64)
        assert np.isfinite(w).all() and np.isfinite(e).all(), path
        ref_err = float(np.abs(w - e).max())
        g = _np(g).astype(np.float64)
        assert np.isfinite(g).all(), path
        np.testing.assert_allclose(g, e, atol=ATOL + 2 * ref_err, rtol=RTOL,
                                   err_msg=path)
        n += 1
    assert n == len(tree_leaves(grads))


@pytest.mark.parametrize("mesh", [(1, 1), (1, 2), (2, 1), (2, 2)])
@pytest.mark.parametrize("arch", ["llama3.2-3b", "rwkv6-3b", "zamba2-1.2b"])
def test_trainer_steps_through_the_kernels(arch, mesh):
    """``Trainer.step`` on the CPU through the Functions: finite loss and
    grad norm, every parameter updated in place."""
    cfg = port_cfg(dataclasses.replace(_rcfg(arch), dtype="float32"))
    tr = Trainer(cfg, mesh=mesh, device="cpu", base_lr=1e-2, warmup=1)
    params, opt = tr.init(0)
    before = [t.clone() for t in tree_leaves(params)]
    params, opt, m = tr.step(params, opt,
                             tr.put_batch(make_batch(cfg, 4, 16, 0)), 1)
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"]))
    changed = sum(not torch.equal(a, b)
                  for a, b in zip(before, tree_leaves(params)))
    assert changed >= len(before) - 2, (changed, len(before))
