"""Parity of the port's SSM scans and blocks (``repro_torch.kernels.
rwkv6_scan``, ``kernels.ssd_mamba2``, ``models.ssm``) with the JAX
package on the CPU.

The same numpy inputs, made from a seed, go through:

* the TPU kernels in interpret mode (``rwkv6_scan`` / ``ssd_scan`` with
  ``interpret=True``, as ``tests/test_kernels.py:78-140`` runs them), the
  oracles ``ref.rwkv6_ref`` / ``ref.ssd_ref``, and the port's versions in
  the Pallas layout (``*_bhsd``, which on CPU tensors are the plain
  versions) and its own oracles, at the reference test's cases, its strong
  decay and ragged lengths the TPU kernels refuse;
* the model's blocks ``rwkv_block`` / ``mamba_block`` under
  ``vmap(axis_name="model")`` and the port's on a ``StackedAxis``, at tp in
  {1, 2, 4}, and rwkv at tp 3 on a widened smoke config whose 4 heads are
  padded to 6; with and without a state, prefill then decode.

Tolerances: the kernels, the reference test's own (2e-4 absolute for
rwkv6, 3e-4 for ssd: float32 summation order over ~100 terms of size
~10).  Blocks: float32 differs only in summation order, 1e-4 of the
output's max-norm; bfloat16 is held to the JAX package's bar for its two
attention paths, 2e-2 max-norm relative (``tests/test_models_smoke.py:
101-104``).  The kernels themselves run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``), held to their plain
versions within the elementwise limits ``tolerance``; here those limits
are checked to admit the plain version in another chunking and to reject
planted faults.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_ref  # noqa: F401  (the reference's import shims)
from test_torch_models import port_cfg, randomized, rel, tnp

from repro import configs as rconfigs
from repro.kernels import ref as rref
from repro.kernels.rwkv6_scan import rwkv6_scan as pallas_rwkv6
from repro.kernels.ssd_mamba2 import ssd_scan as pallas_ssd
from repro.models import ssm as rssm
from repro.models.config import SSMConfig
from repro.models.params import ParamSpec as RSpec
from repro.models.params import init_tree as rinit
from repro_torch.core._axis import StackedAxis
from repro_torch.dist import axes as taxes
from repro_torch.kernels import rwkv6_scan as RW
from repro_torch.kernels import ssd_mamba2 as SSD
from repro_torch.models import params as tparams
from repro_torch.models import ssm as tssm
from repro_torch.models.params import to_torch

RWKV_TOL, SSD_TOL = 2e-4, 3e-4
RTOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _t(a) -> torch.Tensor:
    return to_torch(np.asarray(a))


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol)


def rwkv_inputs(seed, bh, s, hd, decay=None):
    """The reference test's draws: normal r, k, v, u; w in (0.4, 0.95)
    (or the constant ``decay``)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(bh, s, hd)).astype(np.float32)
               for _ in range(3))
    w = (np.full((bh, s, hd), decay, np.float32) if decay is not None else
         (1 / (1 + np.exp(-rng.normal(size=(bh, s, hd)))) * 0.55
          + 0.4).astype(np.float32))
    u = rng.normal(size=(bh, hd)).astype(np.float32)
    return r, k, v, w, u


def ssd_inputs(seed, bh, s, p, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bh, s, p)).astype(np.float32)
    dt = (np.abs(rng.normal(size=(bh, s))) * 0.4 + 0.05).astype(np.float32)
    a = (np.abs(rng.normal(size=(bh,))) + 0.3).astype(np.float32)
    B = rng.normal(size=(bh, s, n)).astype(np.float32)
    C = rng.normal(size=(bh, s, n)).astype(np.float32)
    return x, dt, a, B, C


# ---------------------------------------------------------------------------
# the scans against the TPU kernels and the oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bh,s,hd,chunk", [
    (2, 64, 16, 16), (1, 128, 32, 32), (3, 96, 64, 16), (1, 32, 8, 32),
])
def test_rwkv6_plain_matches_the_tpu_kernel_and_oracle(bh, s, hd, chunk):
    ins = rwkv_inputs(bh + s + hd, bh, s, hd)
    y_p, s_p = pallas_rwkv6(*map(jnp.asarray, ins), chunk=chunk,
                            interpret=True)
    y_r, s_r = rref.rwkv6_ref(*map(jnp.asarray, ins))
    y, sf = RW.rwkv6_scan_bhsd(*map(torch.as_tensor, ins))
    y_o, s_o = RW.rwkv6_ref(*map(torch.as_tensor, ins))
    for got in (y, y_o):
        _close(tnp(got), y_p, RWKV_TOL)
        _close(tnp(got), y_r, RWKV_TOL)
    for got in (sf, s_o):
        _close(tnp(got), s_p, RWKV_TOL)
        _close(tnp(got), s_r, RWKV_TOL)
    # the plain version in the TPU kernel's chunking
    y_c, _ = RW.rwkv6_scan_plain(*RW.to_model_layout(
        *map(torch.as_tensor, ins)), chunk=chunk)
    _close(tnp(y_c[:, :, 0]), y_p, RWKV_TOL)


def test_rwkv6_strong_decay_stays_finite_and_exact():
    """Near-zero decays (the overflow hazard of naive chunking)."""
    ins = rwkv_inputs(7, 1, 64, 16, decay=1e-3)
    y_p, _ = pallas_rwkv6(*map(jnp.asarray, ins), chunk=16, interpret=True)
    y_r, s_r = rref.rwkv6_ref(*map(jnp.asarray, ins))
    y, sf = RW.rwkv6_scan_bhsd(*map(torch.as_tensor, ins))
    assert bool(torch.isfinite(y).all())
    _close(tnp(y), y_p, RWKV_TOL)
    _close(tnp(y), y_r, RWKV_TOL)
    _close(tnp(sf), s_r, RWKV_TOL)


@pytest.mark.parametrize("s", [1, 31, 33, 75])
def test_rwkv6_ragged_lengths_match_the_oracle(s):
    """Lengths the TPU kernel refuses (S % chunk != 0): the port masks the
    last chunk."""
    ins = rwkv_inputs(s, 2, s, 16)
    y_r, s_r = rref.rwkv6_ref(*map(jnp.asarray, ins))
    y, sf = RW.rwkv6_scan_bhsd(*map(torch.as_tensor, ins))
    _close(tnp(y), y_r, RWKV_TOL)
    _close(tnp(sf), s_r, RWKV_TOL)


@pytest.mark.parametrize("bh,s,p,n,chunk", [
    (2, 64, 32, 16, 16), (1, 128, 64, 64, 64), (4, 96, 16, 8, 32),
])
def test_ssd_plain_matches_the_tpu_kernel_and_oracle(bh, s, p, n, chunk):
    ins = ssd_inputs(bh + s + p, bh, s, p, n)
    y_p, s_p = pallas_ssd(*map(jnp.asarray, ins), chunk=chunk,
                          interpret=True)
    y_r, s_r = rref.ssd_ref(*map(jnp.asarray, ins))
    y, sf = SSD.ssd_scan_bhsd(*map(torch.as_tensor, ins))
    y_o, s_o = SSD.ssd_ref(*map(torch.as_tensor, ins))
    for got in (y, y_o):
        _close(tnp(got), y_p, SSD_TOL)
        _close(tnp(got), y_r, SSD_TOL)
    for got in (sf, s_o):
        _close(tnp(got), s_p, SSD_TOL)
        _close(tnp(got), s_r, SSD_TOL)
    y_c, _ = SSD.ssd_scan_plain(*SSD.to_model_layout(
        *map(torch.as_tensor, ins)), chunk=chunk)
    _close(tnp(y_c[:, :, 0]), y_p, SSD_TOL)


@pytest.mark.parametrize("s", [1, 11, 63, 65, 130])
def test_ssd_ragged_lengths_match_the_oracle(s):
    ins = ssd_inputs(s, 3, s, 16, 8)
    y_r, s_r = rref.ssd_ref(*map(jnp.asarray, ins))
    y, sf = SSD.ssd_scan_bhsd(*map(torch.as_tensor, ins))
    _close(tnp(y), y_r, SSD_TOL)
    _close(tnp(sf), s_r, SSD_TOL)


def test_ssd_chunking_does_not_change_the_result():
    """The reference test's invariance (chunk 16 vs 64) on the plain
    version, and the reference's own ``_ssd_chunked`` (which halves its
    chunk until it divides S) against it at S = 12."""
    x, dt, a, B, C = ssd_inputs(3, 1, 128, 16, 8)
    m = SSD.to_model_layout(*map(torch.as_tensor, (x, dt, a, B, C)))
    y16, _ = SSD.ssd_scan_plain(*m, chunk=16)
    y64, _ = SSD.ssd_scan_plain(*m, chunk=64)
    _close(tnp(y16), tnp(y64), 2e-4)
    x, dt, a, B, C = ssd_inputs(4, 2, 12, 16, 8)
    xh = x.reshape(2, 12, 1, 16)
    want, s_want = rssm._ssd_chunked(
        jnp.asarray(xh), jnp.asarray(dt[..., None]), jnp.asarray(a[:1]),
        jnp.asarray(B), jnp.asarray(C), jnp.zeros((2, 1, 8, 16)), 8)
    got, s_got = SSD.ssd_scan(torch.as_tensor(xh),
                              torch.as_tensor(dt[..., None]),
                              torch.as_tensor(a[:1]).reshape(1, 1),
                              torch.as_tensor(B), torch.as_tensor(C))
    _close(tnp(got), want, SSD_TOL)
    _close(tnp(s_got), s_want, SSD_TOL)


# ---------------------------------------------------------------------------
# the state carry (s0 in, s_fin out) and the wrappers on the CPU
# ---------------------------------------------------------------------------


def _model_rwkv(seed, n, s, h, hd, nu):
    rng = np.random.default_rng(seed)
    r, k, v = (torch.as_tensor(rng.normal(size=(n, s, h, hd)),
                               dtype=torch.float32) for _ in range(3))
    w = torch.as_tensor(rng.uniform(0.3, 0.99, (n, s, h, hd)),
                        dtype=torch.float32)
    u = torch.as_tensor(rng.normal(size=(nu, h, hd)), dtype=torch.float32)
    s0 = torch.as_tensor(rng.normal(size=(n, h, hd, hd)),
                         dtype=torch.float32)
    return r, k, v, w, u, s0


def _model_ssd(seed, n, s, h, p, ns, na):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(n, s, h, p)), dtype=torch.float32)
    dt = torch.as_tensor(rng.uniform(0.05, 0.8, (n, s, h)),
                         dtype=torch.float32)
    a = torch.as_tensor(rng.uniform(0.3, 2.0, (na, h)), dtype=torch.float32)
    bc = torch.as_tensor(rng.normal(size=(n, s, 2 * ns)), dtype=torch.float32)
    s0 = torch.as_tensor(rng.normal(size=(n, h, ns, p)), dtype=torch.float32)
    return x, dt, a, bc[..., :ns], bc[..., ns:], s0


@pytest.mark.parametrize("s", [2, 33, 70])
def test_rwkv6_scan_over_s_equals_s_minus_1_then_one_step(s):
    """The scan from s0 over S rows equals the scan over S - 1 rows
    followed by one step from its s_fin, written in place (the serve
    path's prefill + decode); u shared by groups of rows (Nu < N)."""
    r, k, v, w, u, s0 = _model_rwkv(s, 4, s, 3, 8, 2)
    y, sf = RW.rwkv6_scan(r, k, v, w, u, s0)
    st = s0.clone()
    y1, out = RW.rwkv6_scan(r[:, :-1], k[:, :-1], v[:, :-1], w[:, :-1], u,
                            st, out_state=st)
    assert out is st
    y2, _ = RW.rwkv6_scan(r[:, -1:], k[:, -1:], v[:, -1:], w[:, -1:], u, st,
                          out_state=st)
    _close(tnp(torch.cat([y1, y2], 1)), tnp(y), 1e-4)
    _close(tnp(st), tnp(sf), 1e-4)
    # against the oracle, row by row with u's row n // 2
    uu = u.repeat_interleave(2, 0)
    for hh in range(3):
        yo, so = RW.rwkv6_ref(r[:, :, hh], k[:, :, hh], v[:, :, hh],
                              w[:, :, hh], uu[:, hh], s0[:, hh])
        _close(tnp(y[:, :, hh]), tnp(yo), 1e-4)
        _close(tnp(sf[:, hh]), tnp(so), 1e-4)


@pytest.mark.parametrize("s", [2, 65, 130])
def test_ssd_scan_over_s_equals_s_minus_1_then_one_step(s):
    x, dt, a, B, C, s0 = _model_ssd(s, 4, s, 3, 8, 6, 2)
    y, sf = SSD.ssd_scan(x, dt, a, B, C, s0)
    st = s0.clone()
    y1, _ = SSD.ssd_scan(x[:, :-1], dt[:, :-1], a, B[:, :-1], C[:, :-1], st,
                         out_state=st)
    y2, _ = SSD.ssd_scan(x[:, -1:], dt[:, -1:], a, B[:, -1:], C[:, -1:], st,
                         out_state=st)
    _close(tnp(torch.cat([y1, y2], 1)), tnp(y), 1e-4)
    _close(tnp(st), tnp(sf), 1e-4)
    aa = a.repeat_interleave(2, 0)
    for hh in range(3):
        yo, so = SSD.ssd_ref(x[:, :, hh], dt[:, :, hh], aa[:, hh], B, C,
                             s0[:, hh])
        _close(tnp(y[:, :, hh]), tnp(yo), 1e-4)
        _close(tnp(sf[:, hh]), tnp(so), 1e-4)


def test_cpu_tensors_take_the_plain_version_and_bad_inputs_raise(
        monkeypatch):
    r, k, v, w, u, s0 = _model_rwkv(1, 2, 5, 2, 4, 1)
    x, dt, a, B, C, t0 = _model_ssd(1, 2, 5, 2, 4, 3, 1)
    n0, m0 = RW.rwkv6_scan.launches, SSD.ssd_scan.launches
    for mod, name in ((RW, "_lib"), (SSD, "_lib")):
        monkeypatch.setattr(mod, name, lambda: pytest.fail("built a kernel"))
    RW.rwkv6_scan(r, k, v, w, u, s0)
    SSD.ssd_scan(x, dt, a, B, C, t0)
    assert (RW.rwkv6_scan.launches, SSD.ssd_scan.launches) == (n0, m0)
    with pytest.raises(ValueError, match="u"):
        RW.rwkv6_scan(r, k, v, w, u[:, :1], s0)
    with pytest.raises(ValueError, match="k"):
        RW.rwkv6_scan(r, k[:, :4], v, w, u)
    with pytest.raises(ValueError, match="s0"):
        RW.rwkv6_scan(r, k, v, w, u, s0[:1])
    with pytest.raises(ValueError, match="dt"):
        SSD.ssd_scan(x, dt[:, :4], a, B, C)
    with pytest.raises(ValueError, match="a"):
        SSD.ssd_scan(x, dt, a[:, :1], B, C)
    with pytest.raises(ValueError, match="B"):
        SSD.ssd_scan(x, dt, a, B[:, :, :2], C)


# ---------------------------------------------------------------------------
# the limits the card's kernels are held to
# ---------------------------------------------------------------------------


def _faults_rwkv(ins, want):
    r, k, v, w, u, s0 = ins
    n, s = r.shape[:2]
    per_chunk = torch.cat([RW.rwkv6_scan_plain(
        r[:, c:c + RW.CHUNK], k[:, c:c + RW.CHUNK], v[:, c:c + RW.CHUNK],
        w[:, c:c + RW.CHUNK], u, s0 if c == 0 else None)[0]
        for c in range(0, s, RW.CHUNK)], 1)
    last_row = want.clone()
    last_row[:, -1] = 0
    return {"carried state dropped": per_chunk,
            "bonus u left out": RW.rwkv6_scan_plain(
                r, k, v, w, torch.zeros_like(u), s0)[0],
            "ragged last row left out": last_row}


def _faults_ssd(ins, want):
    x, dt, a, B, C, s0 = ins
    s = x.shape[1]
    per_chunk = torch.cat([SSD.ssd_scan_plain(
        x[:, c:c + SSD.CHUNK], dt[:, c:c + SSD.CHUNK], a,
        B[:, c:c + SSD.CHUNK], C[:, c:c + SSD.CHUNK],
        s0 if c == 0 else None)[0] for c in range(0, s, SSD.CHUNK)], 1)
    diag = ((C * B).sum(-1)[..., None, None] * dt[..., None]
            * x)                                       # y_t's own input
    last_row = want.clone()
    last_row[:, -1] = 0
    return {"carried state dropped": per_chunk,
            "mask diagonal dropped": want - diag,
            "ragged last row left out": last_row}


@pytest.mark.parametrize("kind", ["rwkv", "ssd"])
def test_limits_admit_another_chunking_and_reject_planted_faults(kind):
    """At a ragged length over several chunks, from a non-zero s0: the
    plain version in half-size chunks (another summation order and
    other cumsums) lies inside the limit; each planted fault lands above
    it."""
    if kind == "rwkv":
        ins = _model_rwkv(5, 4, 2 * RW.CHUNK + 7, 2, 16, 2)
        plain, mod, faults = RW.rwkv6_scan_plain, RW, _faults_rwkv
        chunk = RW.CHUNK // 2
    else:
        ins = _model_ssd(5, 4, 2 * SSD.CHUNK + 7, 2, 16, 16, 2)
        plain, mod, faults = SSD.ssd_scan_plain, SSD, _faults_ssd
        chunk = SSD.CHUNK // 2
    want, s_want = plain(*ins)
    y_lim, s_lim = mod.tolerance(*ins)
    other, s_other = plain(*ins, chunk=chunk)
    assert float(((other - want).abs() / y_lim).max()) <= 0.25
    assert float(((s_other - s_want).abs() / s_lim).max()) <= 0.25
    for label, bad in faults(ins, want).items():
        share = float(((bad - want).abs() / y_lim).max())
        assert share > 4.0, (label, share)


# ---------------------------------------------------------------------------
# the blocks under vmap(axis_name="model")
# ---------------------------------------------------------------------------

B, S = 2, 12


def block_cfg(arch, dtype, **kw):
    return dataclasses.replace(rconfigs.get_config(arch).smoke(),
                               dtype=dtype, **kw)


# rwkv6 with heads padded at tp 3: d_model 96 in 4 heads of 24 -> 6
PADDED = dict(d_model=96, d_ff=192, vocab_size=768,
              ssm=SSMConfig(kind="rwkv6", state_dim=16, head_dim=24, chunk=8,
                            decay_lora_rank=8))


def cut(np_tree, specs, tp):
    """Global leaves -> stacked ``[tp, ...]`` shards for the reference's
    vmap, each "model" dim split into tp blocks."""
    def one(a, s):
        for i, d in enumerate(s.dims):
            if d == "model":
                return jnp.stack(jnp.split(jnp.asarray(a), tp, axis=i))
        return jnp.stack([jnp.asarray(a)] * tp)
    return jax.tree.map(one, np_tree, specs,
                        is_leaf=lambda x: isinstance(x, RSpec))


def _block_setup(kind, rcfg, tp, seed=3):
    rspecs = (rssm.rwkv_specs if kind == "rwkv" else rssm.mamba_specs)(
        rcfg, tp)
    tree = randomized(jax.tree.map(np.asarray, rinit(
        rspecs, jax.random.key(seed))), seed)
    tcfg = port_cfg(rcfg)
    tspecs = (tssm.rwkv_specs if kind == "rwkv" else tssm.mamba_specs)(
        tcfg, tp)
    axis = StackedAxis(tp, "cpu")
    return (cut(tree, rspecs, tp), tparams.from_reference(tree, tspecs, axis),
            tcfg, axis)


def _zero_state(kind, cfg, tp, dtype):
    d = cfg.d_model
    if kind == "rwkv":
        h = rssm.rwkv_heads_padded(cfg, tp) // tp
        hd = cfg.ssm.head_dim
        return {"last_tm": np.zeros((tp, B, 1, d), dtype),
                "last_cm": np.zeros((tp, B, 1, d), dtype),
                "s": np.zeros((tp, B, h, hd, hd), np.float32)}
    di = cfg.ssm.expand * d // tp
    k, n = cfg.ssm.conv_kernel, cfg.ssm.state_dim
    return {"conv_x": np.zeros((tp, B, k - 1, di), dtype),
            "conv_bc": np.zeros((tp, B, k - 1, 2 * n), dtype),
            "s": np.zeros((tp, B, di // cfg.ssm.head_dim, n,
                           cfg.ssm.head_dim), np.float32)}


BLOCK_CASES = ([("rwkv6-3b", tp, {}) for tp in (1, 2, 4)]
               + [("rwkv6-3b", 3, PADDED)]
               + [("zamba2-1.2b", tp, {}) for tp in (1, 2, 4)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,tp,kw", BLOCK_CASES,
                         ids=[f"{a}-tp{t}{'-padded' if k else ''}"
                              for a, t, k in BLOCK_CASES])
def test_ssm_block_matches_the_reference(arch, tp, kw, dtype):
    """Train mode (no state), then prefill over S rows from a zero state
    and one decode step from it: outputs and the carried state."""
    rcfg = block_cfg(arch, dtype, **kw)
    kind = rcfg.layer_pattern[0]
    block_r = rssm.rwkv_block if kind == "rwkv" else rssm.mamba_block
    block_t = tssm.rwkv_block if kind == "rwkv" else tssm.mamba_block
    rp, tp_, tcfg, axis = _block_setup(kind, rcfg, tp)
    rng = np.random.default_rng(tp)
    xs = [jnp.asarray(rng.normal(size=(B, s, rcfg.d_model)),
                      getattr(jnp, dtype)) for s in (S, 1)]
    zero = _zero_state(kind, rcfg, tp, np.asarray(xs[0]).dtype)

    def ref(p, st):
        y0, _ = block_r(p, rcfg, xs[0])
        y1, st1 = block_r(p, rcfg, xs[0], state=st)
        y2, st2 = block_r(p, rcfg, xs[1], state=st1)
        return y0, y1, y2, st2

    want = jax.jit(jax.vmap(ref, axis_name="model"))(
        rp, jax.tree.map(jnp.asarray, zero))
    tx = [_t(a).expand(tp, *a.shape) for a in xs]
    state = {k: _t(a) for k, a in zero.items()}
    with taxes.bind(model=axis):
        y0, _ = block_t(tp_, tcfg, tx[0])
        y1, st1 = block_t(tp_, tcfg, tx[0], state=state)
        assert st1["s"] is state["s"]               # updated in place
        y2, st2 = block_t(tp_, tcfg, tx[1], state=st1)
    for got, w in zip((y0, y1, y2), want[:3]):
        assert got.dtype == tx[0].dtype
        assert rel(tnp(got), w) <= RTOL[dtype]
    for key, w in want[3].items():
        assert rel(tnp(st2[key]), w) <= (RTOL[dtype] if key != "s"
                                          else max(RTOL[dtype], 1e-4)), key


@pytest.mark.parametrize("hd,offset,row,want", [
    (64, 0, 64, True), (40, 0, 40, True), (42, 0, 42, False),
    (64, 1, 64, False),        # base pointer one element off
    (40, 0, 43, False)])       # rows of 43: strides not multiples of 4
def test_rwkv6_quad_loads_need_aligned_rows(hd, offset, row, want):
    """The wrapper lets the kernel load four channels at a time only
    where every row of r, k, v, w starts on a four-element boundary."""
    buf = torch.zeros(2 * 3 * 2 * row + offset + 8, dtype=torch.bfloat16)
    r = buf[offset:offset + 2 * 3 * 2 * row].view(2, 3, 2, row)[..., :hd]
    w = torch.zeros(2, 3, 2, hd)
    assert RW._quads_ok(r, r, r, w) is want


def test_rwkv6_decode_form_matches_the_chunked_plain_version():
    """The decode kernel's one pass, y = r (S + diag(u) k^T v) and S <- w S
    + k^T v (w as exp(log(max(w, 1e-38)))), in float64 against the
    plain version at S = 1: within the kernel's limit, also at the
    clamped decay w = 0."""
    g = torch.Generator().manual_seed(7)
    n, h, hd = 4, 3, 16
    r, k, v = (torch.randn(n, 1, h, hd, generator=g) for _ in range(3))
    w = torch.rand(n, 1, h, hd, generator=g)
    w[0, 0, 0, :4] = 0.0
    u = torch.randn(2, h, hd, generator=g)
    s0 = torch.randn(n, h, hd, hd, generator=g)
    want, s_want = RW.rwkv6_scan_plain(r, k, v, w, u, s0)
    y_lim, s_lim = RW.tolerance(r, k, v, w, u, s0)
    rr, kk, vv = (t[:, 0].double() for t in (r, k, v))
    uu = u.double().repeat_interleave(2, 0)
    dd = torch.exp(torch.log(torch.clamp(w[:, 0].double(), min=1e-38)))
    kv = kk[..., :, None] * vv[..., None, :]
    y = (rr[..., :, None] * (s0.double() + uu[..., :, None] * kv)).sum(-2)
    st = dd[..., :, None] * s0.double() + kv
    assert bool(((y - want[:, 0].double()).abs() <= y_lim[:, 0]).all())
    assert bool(((st - s_want.double()).abs() <= s_lim).all())


def test_rwkv6_cpu_call_counts_no_kernel_path():
    g = torch.Generator().manual_seed(8)
    ins = [torch.randn(2, 5, 1, 8, generator=g) for _ in range(3)]
    ins += [torch.rand(2, 5, 1, 8, generator=g), torch.randn(1, 1, 8)]
    before = (RW.rwkv6_scan.launches, dict(RW.rwkv6_scan.launches_by_path))
    RW.rwkv6_scan(*ins)
    assert (RW.rwkv6_scan.launches,
            dict(RW.rwkv6_scan.launches_by_path)) == before
    assert set(RW.rwkv6_scan.launches_by_path) == {"chunked", "decode"}


# ---------------------------------------------------------------------------
# ssd_scan's kernels (csrc/ssd_scan.cu): their forms and partition in plain
# PyTorch, the 16-byte load rule, the path counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,h,p,ns", [(4, 3, 16, 8), (4, 8, 64, 64)])
@pytest.mark.parametrize("dt_scale", [0.01, 1.0, 300.0])
def test_ssd_decode_form_matches_the_chunked_plain_version(dt_scale, n, h,
                                                           p, ns):
    """The decode kernel's one pass, S <- exp(-dt a) S + B^T (dt x) and y =
    C S, in float64 against the plain version at S = 1 from a non-zero
    state (also at P = Ns = 64, the decode kernel's shape): within the
    kernel's limit, from a decay near 1 (dt_scale 0.01) to one so strong
    that the float32 decay underflows to 0 (dt_scale 300: dt a >= 90)."""
    g = torch.Generator().manual_seed(11)
    x = torch.randn(n, 1, h, p, generator=g)
    dt = (torch.rand(n, 1, h, generator=g) * 0.8 + 0.3) * dt_scale
    a = torch.rand(2, h, generator=g) * 1.7 + 0.3
    bc = torch.randn(n, 1, 2 * ns, generator=g)
    B, C = bc[..., :ns], bc[..., ns:]
    s0 = torch.randn(n, h, ns, p, generator=g)
    want, s_want = SSD.ssd_scan_plain(x, dt, a, B, C, s0)
    y_lim, s_lim = SSD.tolerance(x, dt, a, B, C, s0)
    aa = a.repeat_interleave(2, 0)                         # [N, H]
    d = torch.exp(-dt[:, 0] * aa).double()                 # float32's exp
    assert bool((d == 0).any()) is (dt_scale > 1)
    xb = x[:, 0].double() * dt[:, 0].double()[..., None]   # [N, H, P]
    st = (d[..., None, None] * s0.double()
          + B[:, 0].double()[:, None, :, None] * xb[:, :, None, :])
    y = (C[:, 0].double()[:, None, :, None] * st).sum(-2)  # [N, H, P]
    assert bool(((y - want[:, 0].double()).abs() <= y_lim[:, 0]).all())
    assert bool(((st - s_want.double()).abs() <= s_lim).all())


def test_ssd_cpu_call_counts_no_kernel_path():
    x, dt, a, B, C, s0 = _model_ssd(9, 2, 5, 2, 8, 4, 1)
    before = (SSD.ssd_scan.launches, dict(SSD.ssd_scan.launches_by_path))
    SSD.ssd_scan(x, dt, a, B, C, s0, out_state=s0)
    assert (SSD.ssd_scan.launches,
            dict(SSD.ssd_scan.launches_by_path)) == before
    assert tuple(SSD.ssd_scan.launches_by_path) == ("chunked", "decode",
                                                    "general")
    assert SSD.PATHS == ("chunked", "decode", "general")


def _bc_views(dtype, row, offset, ns=64, n=2, s=3):
    """B and C as views of one buffer of rows of ``row`` elements (the
    model's conv output has rows of 2 Ns), ``offset`` elements in."""
    buf = torch.zeros(n * s * row + offset + 2 * ns, dtype=dtype)
    bc = buf[offset:offset + n * s * row].view(n, s, row)
    return bc[..., :ns], bc[..., ns:2 * ns]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("row,offset,want", [
    (128, 0, True),            # the model's: rows of 2 Ns, C 64 in
    (136, 0, True),            # a wider row, still 16-byte strides
    (128, 8, True),            # an offset of whole 16-byte pieces
    (128, 1, False),           # base pointer one element off
    (129, 0, False),           # odd row stride
    (130, 0, False)])          # row stride not a multiple of 16 bytes
def test_ssd_vec_loads_need_aligned_rows(dtype, row, offset, want):
    B, C = _bc_views(dtype, row, offset)
    x = torch.zeros(2, 3, 8, 64, dtype=dtype)
    assert SSD._vec_ok(x, B, C) is want


def test_ssd_vec_rule_covers_x_and_the_states():
    B, C = _bc_views(torch.bfloat16, 128, 0)
    x = torch.zeros(2, 3, 8, 64, dtype=torch.bfloat16)
    assert SSD._vec_ok(x, B, C, torch.zeros(2, 8, 64, 64))
    wide = torch.zeros(2, 3, 8, 68, dtype=torch.bfloat16)[..., 1:65]
    assert not SSD._vec_ok(wide, B, C)                 # x one element off
    odd = torch.zeros(2, 3, 8, 66, dtype=torch.bfloat16)[..., :64]
    assert not SSD._vec_ok(odd, B, C)                  # head stride 66
    flat = torch.zeros(2 * 8 * 64 * 64 + 1)
    s0 = flat[1:].view(2, 8, 64, 64)                   # contiguous, 4 B off
    assert not SSD._vec_ok(x, B, C, s0)
    assert not SSD._vec_ok(x, B, C, None, s0)


def _emulate_chunk_kernel(x, dt, a, B, C, s0=None):
    """``csrc/ssd_scan.cu``'s ``ssd_chunk_kernel`` partition in plain
    PyTorch, float32: per chunk of ``CHUNK`` rows the cumsum as the
    kernel's scan (two rows a lane: a scan of the pair sums, then the even
    row from the lane before), C Bᵀ from the row's B and C (the same for
    every head of the row), each head's decay and dt folded into M, dt
    exp(last - cum) folded into a copy of x for the state update, y's
    inter term over q and its intra term over s each in four parts (q, s
    mod 4), summed last."""
    n, s, h, p = x.shape
    ns, L = B.shape[-1], SSD.CHUNK
    aa = a.float().repeat_interleave(n // a.shape[0], 0)     # [N, H]
    st = (torch.zeros(n, h, ns, p) if s0 is None else s0.float().clone())
    y = torch.empty(n, s, h, p)
    tri = torch.ones(L, L, dtype=torch.bool).tril()
    for c0 in range(0, s, L):
        lc = min(L, s - c0)
        d = torch.zeros(n, h, L)
        d[..., :lc] = dt[:, c0:c0 + lc].float().transpose(1, 2)
        xc = torch.zeros(n, h, L, p)
        xc[:, :, :lc] = x[:, c0:c0 + lc].float().transpose(1, 2)
        bc, cc = torch.zeros(n, L, ns), torch.zeros(n, L, ns)
        bc[:, :lc], cc[:, :lc] = B[:, c0:c0 + lc].float(), \
            C[:, c0:c0 + lc].float()
        v = -d * aa[..., None]
        v0, v1 = v[..., 0::2], v[..., 1::2]
        incl = torch.cumsum(v0 + v1, -1)
        excl = torch.cat([torch.zeros_like(incl[..., :1]), incl[..., :-1]],
                         -1)
        cum = torch.stack([excl + v0, incl], -1).flatten(-2)  # [N, H, L]
        last = cum[..., lc - 1:lc]
        w = d * torch.exp(last - cum)
        cb = cc @ bc.transpose(1, 2)                    # [N, t, s]
        m = (cb[:, None] * torch.exp(torch.clamp(
            cum[..., :, None] - cum[..., None, :], max=0.0))
            * d[..., None, :] * tri)                    # [N, H, t, s]
        ecum = torch.exp(cum)[..., None]
        parts = [ecum * (cc[:, None, :, k::4] @ st[:, :, k::4])
                 + m[..., k::4] @ xc[:, :, k::4] for k in range(4)]
        y[:, c0:c0 + lc] = ((parts[0] + parts[2]) + (parts[1] + parts[3]))[
            :, :, :lc].transpose(1, 2)
        st = (torch.exp(last)[..., None] * st
              + bc.transpose(1, 2)[:, None] @ (xc * w[..., None]))
    return y, st


@pytest.mark.parametrize("bc_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,s,h", [(2, 128, 3), (1, 64, 2), (1, 192, 8),
                                   (3, 64, 1)])
def test_ssd_kernel_partition_matches_the_tpu_kernel_and_oracle(bc_dtype, n,
                                                                 s, h):
    """The partition above at P = Ns = 64 (the chunked kernel's shapes),
    heads sharing B and C (float32, whose C Bᵀ the kernel forms on FMAs,
    or bfloat16, on mma.sync), against the TPU kernel in interpret mode
    (its layout, B and C broadcast to every head, as its wrapper takes
    them) and both oracles, at the reference test's 3e-4; and against the
    plain version within ``ssd_mamba2.tolerance``."""
    x, dt, a, B, C, _ = _model_ssd(100 + s + h, n, s, h, 64, 64, n)
    B, C = B.to(bc_dtype), C.to(bc_dtype)
    y, sf = _emulate_chunk_kernel(x, dt, a, B, C)
    xt = x.permute(0, 2, 1, 3).reshape(n * h, s, 64)
    dtt = dt.permute(0, 2, 1).reshape(n * h, s)
    at_ = a.reshape(n * h)
    bt, ct = (t.float().repeat_interleave(h, 0).contiguous() for t in (B, C))
    ins = [tnp(t) for t in (xt, dtt, at_, bt, ct)]
    y_p, s_p = pallas_ssd(*map(jnp.asarray, ins), interpret=True)
    y_r, s_r = rref.ssd_ref(*map(jnp.asarray, ins))
    y_o, s_o = SSD.ssd_ref(xt, dtt, at_, bt, ct)
    got_y = tnp(y.permute(0, 2, 1, 3).reshape(n * h, s, 64))
    got_s = tnp(sf.reshape(n * h, 64, 64))
    for want_y, want_s in ((y_p, s_p), (y_r, s_r), (tnp(y_o), tnp(s_o))):
        _close(got_y, want_y, SSD_TOL)
        _close(got_s, want_s, SSD_TOL)
    want, s_want = SSD.ssd_scan_plain(x, dt, a, B, C)
    y_lim, s_lim = SSD.tolerance(x, dt, a, B, C)
    assert float(((y - want).abs() / y_lim).max()) <= 1.0
    assert float(((sf - s_want).abs() / s_lim).max()) <= 1.0


@pytest.mark.parametrize("s", [1, 2, 63, 64, 65, 127, 128, 130])
def test_ssd_kernel_partition_from_a_state_matches_the_oracle(s):
    """Ragged lengths (which the TPU kernel refuses) from a non-zero
    state, a shared by two rows: the partition against the oracle at
    3e-4 and the plain version within the limit."""
    x, dt, a, B, C, s0 = _model_ssd(200 + s, 4, s, 2, 64, 64, 2)
    y, sf = _emulate_chunk_kernel(x, dt, a, B, C, s0)
    aa = a.repeat_interleave(2, 0)
    for hh in range(2):
        yo, so = SSD.ssd_ref(x[:, :, hh], dt[:, :, hh], aa[:, hh], B, C,
                             s0[:, hh])
        _close(tnp(y[:, :, hh]), tnp(yo), SSD_TOL)
        _close(tnp(sf[:, hh]), tnp(so), SSD_TOL)
    want, s_want = SSD.ssd_scan_plain(x, dt, a, B, C, s0)
    y_lim, s_lim = SSD.tolerance(x, dt, a, B, C, s0)
    assert float(((y - want).abs() / y_lim).max()) <= 1.0
    assert float(((sf - s_want).abs() / s_lim).max()) <= 1.0
