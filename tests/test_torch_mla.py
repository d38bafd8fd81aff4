"""The port's multi-head latent attention (MLA) slice against the JAX
package on the CPU: ``flash_attention``'s MLA arguments (an explicit
scale, v narrower than q and k), ``models.attention._attention_mla`` in
both its forms, and deepseek-v3-671b's smoke model (MLA attention, MoE
with a shared expert) forward, prefill, decode and served.

Weights: the JAX package's ``init_tree`` (its norms given noise), carried
into the port by ``params.from_reference`` and cut along their "model"
dims by the JAX package's own specs for the reference side, which runs
under ``vmap(axis_name="model")``.  At the smoke config the absorbed
attention's q and k are kvr + rope = 16 + 8 = 24 wide and v 16.

Tolerances: float32 within 1e-4 of the max-norm (summation order only;
the JAX package's own bar for absorbed against naive,
``tests/test_attn_variants.py:45-55``); bfloat16 within the serve tests'
2e-2, held on one attention block (where the two packages round at the
same places).  The whole bf16 smoke model is not compared: four layers of
bf16 rounding and the MoE routes they tip move the JAX package's own
logits by up to ~9e-2 of the float32 ones at this size, and the port's by
as much, so the whole model is held in float32.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import (port_cfg, port_params, randomized,
                               ref_params, ref_shard, rel, rvmap, specs_match,
                               tnp)

from repro import configs as rconfigs
from repro.models import attention as rattn
from repro.models import lm as rlm
from repro.models.attention import _flash_jnp
from repro.models.params import ParamSpec as RSpec
from repro.models.params import init_tree as rinit
from repro_torch import configs as tconfigs
from repro_torch.core._axis import StackedAxis
from repro_torch.dist import axes as taxes
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models import params as tparams
from repro_torch.models.params import to_torch

ARCH = "deepseek-v3-671b"
B, S, S_MAX = 2, 12, 16
RTOL = {"float32": 1e-4, "bfloat16": 2e-2}


def ds(dtype="float32", **kw):
    """The smoke config, one layer per group (the serving layout)."""
    return dataclasses.replace(rconfigs.get_config(ARCH).smoke(),
                               dtype=dtype, scan_layers=False, **kw)


def no_drops(rcfg):
    """A capacity factor that drops no choice: the full forward and the
    decode step then route the same tokens alike."""
    return dataclasses.replace(rcfg, moe=dataclasses.replace(
        rcfg.moe, capacity_factor=8.0))


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_mla_model_and_cache_specs_match_the_reference(tp):
    """attn_specs (through the whole model's tree) and the MLA cache: the
    port's cache specs are the JAX package's without its ``"len"`` leaf,
    which the port keeps as a host int."""
    specs_match(ds(), tp)
    rcfg = ds()
    rc = rlm.cache_specs(rcfg, B, S_MAX, tp)
    tc = tlm.cache_specs(port_cfg(rcfg), B, S_MAX, tp)

    def walk(r, t):
        if isinstance(t, tparams.ParamSpec):
            assert (t.shape, t.dims, t.dtype) == (r.shape, r.dims, r.dtype)
            return
        assert sorted(t) == sorted(k for k in r if k != "len")
        for k in t:
            walk(r[k], t[k])
    walk(rc, tc)
    assert sorted(tc["stack"]["u0"]["b0_attn"]["self"]) == ["c_kv", "k_rope"]


def test_full_deepseek_specs_build_at_tp_8():
    cfg = tconfigs.get_config(ARCH)
    specs = tlm.model_specs(cfg, 8)
    attn = specs["stack"]["g0"][0]["b0_attn"]["attn"]
    assert attn["w_ukv"].local_shape({"model": 8}) == (512, 16 * 256)
    assert attn["w_uq"].local_shape({"model": 8}) == (1536, 16 * 192)
    assert len(specs["stack"]["g0"]) == 61


# ---------------------------------------------------------------------------
# flash_attention with the MLA arguments
# ---------------------------------------------------------------------------

# (B, Sq, Skv, G, dqk, dv, causal, window, softcap, q0, kv_len, chunk)
FLASH = [
    (2, 12, 12, 4, 24, 16, True, 0, 0.0, 0, None, 4),        # prefill
    (2, 1, 16, 4, 24, 16, True, 0, 0.0, 9, 10, 8),           # decode
    (1, 10, 10, 2, 24, 16, True, 4, 0.0, 0, None, 1024),     # window
    (2, 3, 16, 2, 40, 32, True, 0, 5.0, 13, None, 8),        # softcap
    # deepseek-v3's widths (q/k 576, v 512) in the MLA prefill kernel's
    # 64-key blocks: 16 q heads a rank, and a window with a softcap
    (1, 70, 70, 16, 576, 512, True, 0, 0.0, 0, None, 64),
    (1, 70, 70, 4, 576, 512, True, 40, 20.0, 0, None, 64),
]


def _flash_inputs(case, view):
    b, sq, skv, g, dqk, dv = case[:6]
    rng = np.random.default_rng(sum(case[:6]))
    q = (rng.normal(size=(b, sq, 1, g, dqk)) * 1.5).astype(np.float32)
    k = (rng.normal(size=(b, skv, 1, dqk)) * 1.5).astype(np.float32)
    v = k[..., :dv] if view else rng.normal(size=(b, skv, 1, dv)).astype(
        np.float32)
    return q, k, np.ascontiguousarray(v)


def _ref_flash(q, k, v, case, scale):
    _, sq, skv, _, _, _, causal, window, softcap, q0, kv_len, chunk = case
    kind = "local" if window else "causal"
    return _flash_jnp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      q0 + jnp.arange(sq)[None], jnp.arange(skv), kind=kind,
                      window=window, kv_valid=kv_len, softcap=softcap or None,
                      scale=scale, chunk=chunk)


@pytest.mark.parametrize("case", FLASH)
def test_flash_plain_with_scale_and_narrow_v_matches_flash_jnp(
        monkeypatch, case):
    monkeypatch.setattr(FA, "CHUNK", case[-1])
    q, k, v = _flash_inputs(case, view=False)
    scale = 1.0 / math.sqrt(case[4] - 8 + 16)
    want = _ref_flash(q, k, v, case, scale)
    causal, window, softcap, q0, kv_len = case[6:11]
    kw = dict(causal=causal, window=window, softcap=softcap, q0=q0,
              kv_len=kv_len)
    got = FA.flash_attention_plain(*map(torch.as_tensor, (q, k, v)),
                                   scale=scale, **kw)
    assert tuple(got.shape) == q.shape[:4] + (v.shape[-1],)
    assert rel(tnp(got), want) <= 1e-5
    # the wrapper on CPU tensors is the plain version; None keeps 1/sqrt(dh)
    assert torch.equal(FA.flash_attention(*map(torch.as_tensor, (q, k, v)),
                                          scale=scale, **kw), got)
    dflt = FA.flash_attention_plain(*map(torch.as_tensor, (q, k, v)), **kw)
    assert rel(tnp(dflt), _ref_flash(q, k, v, case, None)) <= 1e-5


def test_the_oracle_takes_the_mla_arguments():
    """``kernels.ref.flash_attention_ref`` with a scale and v narrower
    than k against the plain version (through the Pallas layout), and
    against the JAX package's oracle at the default scale."""
    from repro.kernels import ref as rref
    from repro_torch.kernels import ref as tref
    rng = np.random.default_rng(11)
    q, k = (rng.normal(size=s).astype(np.float32)
            for s in ((2, 4, 12, 24), (2, 1, 12, 24)))
    v = np.ascontiguousarray(k[..., :16])
    qt, kt, vt = map(torch.as_tensor, (q, k, v))
    scale = 1.0 / math.sqrt(24 + 8)
    want = FA.flash_attention(*FA.to_model_layout(qt, kt, vt),
                              scale=scale).permute(0, 2, 3, 1, 4).flatten(1, 2)
    got = tref.flash_attention_ref(qt, kt, vt, scale=scale)
    assert got.shape == (2, 4, 12, 16)
    assert rel(tnp(got), tnp(want)) <= 1e-5
    full = np.ascontiguousarray(k)
    np.testing.assert_allclose(
        tnp(tref.flash_attention_ref(qt, kt, torch.as_tensor(full))),
        np.asarray(rref.flash_attention_ref(q, k, full)), atol=1e-5)


@pytest.mark.parametrize("view", [True, False])
def test_flash_function_grads_at_mla_shapes_match_jax_vjp(monkeypatch,
                                                          view):
    """``FlashAttention`` with the MLA scale and v = k's first dv columns
    (a view: its gradient lands in k) or its own tensor, against
    ``jax.vjp`` of ``_flash_jnp``."""
    case = FLASH[0]
    monkeypatch.setattr(FA, "CHUNK", case[-1])
    q, k, v = _flash_inputs(case, view)
    dv, scale = case[5], 1.0 / math.sqrt(24)
    gy = np.random.default_rng(5).normal(size=q.shape[:4] + (dv,)).astype(
        np.float32)
    if view:
        fn = lambda q_, k_: _ref_flash(q_, k_, k_[..., :dv], case, scale)
        out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k))
    else:
        fn = lambda q_, k_, v_: _ref_flash(q_, k_, v_, case, scale)
        out, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(gy))
    qt = torch.tensor(q, requires_grad=True)
    kt = torch.tensor(k, requires_grad=True)
    vt = kt[..., :dv] if view else torch.tensor(v, requires_grad=True)
    y = FA.FlashAttention.apply(qt, kt, vt, True, 0, 0.0, 0, None, scale)
    ins = (qt, kt) if view else (qt, kt, vt)
    got = torch.autograd.grad(y, ins, torch.as_tensor(gy))
    assert rel(tnp(y), out) <= 1e-5
    for a, w in zip(got, want):
        assert rel(tnp(a), w) <= 1e-5


# ---------------------------------------------------------------------------
# _attention_mla
# ---------------------------------------------------------------------------


def _attn_tree(rcfg, seed=1):
    """One attention block's global weights (norms given noise)."""
    tree = rinit(rattn.attn_specs(rcfg, 1), jax.random.key(seed))
    return randomized(jax.tree.map(np.asarray, tree), seed)


def _cut(tree, rcfg, tp):
    specs = rattn.attn_specs(rcfg, tp)

    def cut(a, s):
        if "model" in s.dims:
            return jnp.stack(jnp.split(jnp.asarray(a), tp,
                                       axis=s.dims.index("model")))
        return jnp.stack([jnp.asarray(a)] * tp)
    return jax.tree.map(cut, tree, specs,
                        is_leaf=lambda x: isinstance(x, RSpec))


def _port_cache(c_kv, k_rope, t):
    """``[tp, B, S_MAX, ·]`` numpy latent and rope key -> the port's cache:
    the two column blocks of one buffer, as ``init_caches`` makes them."""
    buf = to_torch(np.concatenate([c_kv, k_rope], -1))
    kvr = c_kv.shape[-1]
    return {"c_kv": buf[..., :kvr], "k_rope": buf[..., kvr:], "len": t}


def _run_attn(rcfg, tp, mode, cache_of=_port_cache):
    """(port y, reference y, port cache, reference cache) for one block."""
    m = rcfg.mla
    tree = _attn_tree(rcfg)
    rp = _cut(tree, rcfg, tp)
    axis = StackedAxis(tp, "cpu")
    tcfg = port_cfg(rcfg)
    params = tparams.from_reference(tree, tattn.attn_specs(tcfg, tp), axis)
    rng = np.random.default_rng(7)
    sq, t0 = (1, 9) if mode == "decode" else (S, 0)
    dt = getattr(jnp, rcfg.dtype)
    x = np.asarray(jnp.asarray(rng.normal(size=(B, sq, rcfg.d_model)), dt))
    pos = t0 + np.arange(sq)[None]
    ckv = np.zeros((tp, B, S_MAX, m.kv_lora_rank), np.float32)
    kr = np.zeros((tp, B, S_MAX, m.rope_head_dim), np.float32)
    if mode == "decode":           # a filled prefix, the same on every rank
        ckv[:, :, :t0] = rng.normal(size=(B, t0, m.kv_lora_rank))
        kr[:, :, :t0] = rng.normal(size=(B, t0, m.rope_head_dim))
    ckv, kr = (np.asarray(jnp.asarray(a, dt)) for a in (ckv, kr))
    rcache = None if mode == "train" else {
        "c_kv": jnp.asarray(ckv), "k_rope": jnp.asarray(kr),
        "len": jnp.full((tp,), t0, jnp.int32)}

    def ref(p, c):
        out = rattn._attention_mla(p, rcfg, jnp.asarray(x), pos=jnp.asarray(
            pos), kind="causal", cache=c, mode=mode)
        return out.y, out.cache
    ry, rc = rvmap(ref, rp, rcache)
    tcache = None if mode == "train" else cache_of(ckv, kr, t0)
    xt = to_torch(x).expand(tp, *x.shape)
    with taxes.bind(model=axis):
        out = tattn.attention(params, tcfg, xt, pos=torch.as_tensor(pos),
                              kind="causal", cache=tcache, mode=mode)
    return out.y, ry, out.cache, rc


@pytest.mark.parametrize("tp,dtype", [(1, "float32"), (2, "float32"),
                                      (2, "bfloat16")])
@pytest.mark.parametrize("impl", ["flash", "ref"])
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_attention_mla_matches_the_reference(mode, impl, tp, dtype):
    rcfg = ds(dtype, attn_impl=impl)
    y, ry, cache, rc = _run_attn(rcfg, tp, mode)
    assert rel(tnp(y), ry) <= RTOL[dtype]
    if mode == "train":
        assert cache is None
        return
    assert cache["len"] == int(rc["len"][0])
    for k in ("c_kv", "k_rope"):
        assert rel(tnp(cache[k]), rc[k]) <= RTOL[dtype]


@pytest.mark.parametrize("impl", ["flash", "ref"])
def test_absorbed_decode_reads_the_joint_cache_as_a_view(impl):
    """The keys of the absorbed decode are a view of the cache (no copy of
    it); a cache whose latent and rope key are two tensors is refused on
    either path, not copied."""
    rcfg = ds(attn_impl=impl)
    _, _, cache, _ = _run_attn(rcfg, 2, "decode")
    keys = tattn.latent_keys(cache["c_kv"], cache["k_rope"])
    assert keys.data_ptr() == cache["c_kv"].data_ptr()
    assert torch.equal(keys, torch.cat([cache["c_kv"], cache["k_rope"]], -1))

    def apart(c_kv, k_rope, t):
        return {"c_kv": to_torch(c_kv), "k_rope": to_torch(k_rope), "len": t}
    for mode in ("prefill", "decode"):
        with pytest.raises(ValueError, match="adjacent column blocks"):
            _run_attn(rcfg, 2, mode, cache_of=apart)


def test_mla_dispatches_what_the_reference_dispatches():
    """The same cells, impls and phases, forward and backward, in both
    forms, at tp 2 (gradients taken through the flash Function)."""
    from repro.core import api as rapi
    from repro_torch.core import api as tapi
    from test_torch_serve import _rec
    for impl in ("flash", "ref"):
        rcfg = ds(attn_impl=impl, n_layers=1)
        tree = ref_params(rcfg, seed=3)
        rp = ref_shard(tree, rcfg, 2)
        params, axis = port_params(tree, rcfg, 2)
        toks = np.random.default_rng(3).integers(0, rcfg.vocab_size, (B, S))
        batch = {"tokens": jnp.asarray(toks, jnp.int32),
                 "labels": jnp.asarray(toks, jnp.int32)}
        with rapi.tuned() as rctx:
            jax.jit(jax.vmap(jax.grad(lambda p: rlm.loss_fn(
                p, rcfg, batch)[0]), axis_name="model"))(rp)
        for leaf in tparams.tree_leaves(params):
            leaf.requires_grad_(True)
        with taxes.bind(model=axis), tapi.tuned() as tctx:
            loss, _ = tlm.loss_fn(params, port_cfg(rcfg), {
                k: torch.as_tensor(toks) for k in ("tokens", "labels")})
            loss.sum().backward()
        got = sorted(_rec(r) for r in tctx.record)
        assert got == sorted(_rec(r) for r in rctx.record)
        assert any(r.phase == "bwd" for r in tctx.record)


# ---------------------------------------------------------------------------
# the whole deepseek smoke model
# ---------------------------------------------------------------------------


def _both(rcfg, tp, seed=2):
    tree = randomized(ref_params(rcfg, seed=seed), seed)
    return ref_shard(tree, rcfg, tp), *port_params(tree, rcfg, tp), tree


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("impl", ["flash", "ref"])
def test_deepseek_prefill_then_decode_matches_with_caches(tp, impl):
    """A prefill of 11 tokens and 2 decode steps in a 16-slot cache: each
    step's logits and, after the last, every layer's latent and rope
    cache against the reference's, in float32."""
    dtype = "float32"
    rcfg = ds(dtype, attn_impl=impl)
    tcfg = port_cfg(rcfg)
    rp, params, axis, _ = _both(rcfg, tp)
    n_pre, n_dec = 11, 2
    toks = np.random.default_rng(6).integers(0, rcfg.vocab_size,
                                             (B, n_pre + n_dec))
    jt = jnp.asarray(toks, jnp.int32)

    def ref_steps(p):
        c = rlm.init_caches(rcfg, B, S_MAX)
        lg, c = rlm.prefill(p, rcfg, {"tokens": jt[:, :n_pre]}, c)
        out = [lg]
        for i in range(n_pre, n_pre + n_dec):
            lg, c = rlm.decode_step(p, rcfg, jt[:, i:i + 1], c, i)
            out.append(lg)
        return out, c
    want, rc = rvmap(ref_steps, rp)
    tt = torch.as_tensor(toks)
    with taxes.bind(model=axis):
        caches = tlm.init_caches(tcfg, B, S_MAX)
        lg, caches = tlm.prefill(params, tcfg, {"tokens": tt[:, :n_pre]},
                                 caches)
        got = [lg]
        for i in range(n_pre, n_pre + n_dec):
            lg, caches = tlm.decode_step(params, tcfg, tt[:, i:i + 1],
                                         caches, i)
            got.append(lg)
    for g, w in zip(got, want):
        assert rel(tnp(g), w) <= RTOL[dtype]
    for li in range(rcfg.n_layers):
        tc = caches["stack"][f"u{li}"]["b0_attn"]["self"]
        rcl = rc["stack"][f"u{li}"]["b0_attn"]["self"]
        assert tc["len"] == n_pre + n_dec
        for k in ("c_kv", "k_rope"):
            assert rel(tnp(tc[k]), rcl[k]) <= RTOL[dtype]


@pytest.mark.parametrize("tp", [1, 2])
def test_absorbed_matches_naive_and_decode_is_consistent(tp):
    """``tests/test_attn_variants.py:45-69`` on the port, with the MoE
    blocks kept (no drops): the absorbed forward against the naive one,
    and the absorbed decode step against the full forward, within 1e-4."""
    rcfg = no_drops(ds(n_layers=2))
    _, params, axis, _ = _both(rcfg, tp, seed=1)
    toks = torch.as_tensor(np.random.default_rng(8).integers(
        0, rcfg.vocab_size, (B, S)))
    flash = port_cfg(dataclasses.replace(rcfg, attn_impl="flash"))
    with taxes.bind(model=axis):
        ref, _, _ = tlm.forward(params, port_cfg(rcfg), {"tokens": toks})
        full, _, _ = tlm.forward(params, flash, {"tokens": toks})
        caches = tlm.init_caches(flash, B, S_MAX)
        _, caches = tlm.prefill(params, flash, {"tokens": toks[:, :-1]},
                                caches)
        lg, _ = tlm.decode_step(params, flash, toks[:, -1:], caches, S - 1)
    assert rel(tnp(full), tnp(ref)) <= 1e-4
    assert rel(tnp(lg[:, :, 0]), tnp(full[:, :, -1])) <= 1e-4


@pytest.mark.parametrize("tp", [2, 4])
def test_from_and_to_reference_round_trip_the_mla_leaves(tp):
    rcfg = ds("bfloat16")
    _, params, axis, tree = _both(rcfg, tp)
    tcfg = port_cfg(rcfg)
    specs = tlm.model_specs(tcfg, tp)
    back = tparams.to_reference(params, specs, axis)
    for li in range(rcfg.n_layers):
        got = back["stack"][f"u{li}"]["b0_attn"]["attn"]
        want = tree["stack"][f"u{li}"]["b0_attn"]["attn"]
        assert sorted(got) == ["kv_norm", "q_norm", "w_dkv", "w_dq", "w_o",
                               "w_ukv", "w_uq"]
        for k in got:
            assert got[k].dtype == tparams.torch_dtype(
                specs["stack"][f"u{li}"]["b0_attn"]["attn"][k].dtype)
            np.testing.assert_array_equal(got[k].float().numpy(),
                                          np.asarray(want[k], np.float32))
    # the model-sharded leaves are cut by head blocks, the rest replicated
    w_ukv = params["stack"]["u0"]["b0_attn"]["attn"]["w_ukv"]
    full = np.asarray(tree["stack"]["u0"]["b0_attn"]["attn"]["w_ukv"],
                      np.float32)
    np.testing.assert_array_equal(
        w_ukv[tp - 1].float().numpy(),
        np.split(full, tp, axis=1)[tp - 1])


def test_large_leaves_draw_in_slabs_and_small_ones_do_not(monkeypatch):
    """A normal leaf above the slab threshold is drawn slab by slab along
    dim 0 (no float32 copy of the whole leaf), a smaller one whole, as
    before; both at the init's std."""
    spec = tparams.ParamSpec((8, 64, 32), ("model", None, None),
                             dtype="bfloat16")
    axis = StackedAxis(2, "cpu")
    whole = tparams._init_leaf(spec, torch.Generator().manual_seed(0), axis,
                               "model")
    want = torch.randn((8, 64, 32), generator=torch.Generator().manual_seed(
        0)).mul_(64 ** -0.5).bfloat16()
    assert torch.equal(tparams.unshard(whole, spec, axis), want)
    monkeypatch.setattr(tparams, "SLAB_ABOVE_BYTES", 4 * 8 * 64 * 32 - 1)
    monkeypatch.setattr(tparams, "SLAB_BYTES", 3 * 4 * 64 * 32)
    draws = []
    real = torch.randn
    monkeypatch.setattr(torch, "randn", lambda shape, **kw: draws.append(
        tuple(shape)) or real(shape, **kw))
    slabs = tparams._init_leaf(spec, torch.Generator().manual_seed(0), axis,
                               "model")
    assert draws == [(3, 64, 32), (3, 64, 32), (2, 64, 32)]
    assert slabs.shape == whole.shape and slabs.dtype == torch.bfloat16
    assert abs(float(slabs.float().std()) - 64 ** -0.5) < 0.01


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_deepseek_serve_records_and_logits_match_the_reference():
    """The serve at tp 2, float32, absorbed: the same records (every cell
    and phase), greedy tokens and logits as the JAX package's serve
    loop."""
    from test_torch_serve import (N_TOKENS, _check_records, _prompts,
                                  ref_serve)
    rcfg = ds(attn_impl="flash")
    rp, params, axis, _ = _both(rcfg, 2)
    prompts = _prompts(rcfg)
    r_toks, r_lgs, r_ctx = ref_serve(rcfg, 2, rp, prompts)
    res = tserve.serve(port_cfg(rcfg), axis, params,
                       torch.as_tensor(prompts), S_MAX, N_TOKENS)
    _check_records(res.ctx, r_ctx)
    np.testing.assert_array_equal(res.tokens.numpy(), r_toks)
    for a, b in zip(r_lgs, res.logits):
        assert np.abs(a - b.numpy()).max() / np.abs(a).max() <= 1e-4


def test_deepseek_cli_serves_tunes_and_reserves_on_the_cpu(tmp_path, capsys):
    assert tserve.main(["--device", "cpu", "--arch", ARCH, "--tp", "2",
                        "--batch", "2", "--prompt-len", "9", "--tokens", "3",
                        "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert f"arch={ARCH} (smoke)" in out and "logits agree" in out
    assert (tmp_path / "trace.jsonl").exists()
