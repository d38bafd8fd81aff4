"""``repro_torch.kernels.ref`` and ``repro_torch.kernels.ops`` against the
JAX package's ``kernels/ref.py`` and ``kernels/ops.py`` on the CPU (its
kernels in interpret mode, the port's wrappers on their plain versions).

Tolerances: the copies (pack) and the wire round trip are exact; the
scans and attention in float32 are held to the JAX package's own bars
for its kernels against its oracles (``tests/test_kernels.py``: 2e-4 for
rwkv6, 3e-4 for ssd, 1e-4 for float32 attention).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_ref  # noqa: F401  (the reference's import shims)

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv6_scan as trw
from repro_torch.kernels import ssd_mamba2 as tssd


def _n(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("idx", [0, 2, 3])
def test_pack_ref_matches_the_reference(idx):
    x = _n(np.random.default_rng(idx), 5, 3)
    want = np.asarray(rref.pack_ref(jnp.asarray(x), idx, 4))
    np.testing.assert_array_equal(tref.pack_ref(torch.as_tensor(x), idx,
                                                4).numpy(), want)


@pytest.mark.parametrize("qmax", [127.0, 448.0])
def test_quant_roundtrip_ref_matches_the_reference_bit_for_bit(qmax):
    x = _n(np.random.default_rng(1), 13, 5) * 3      # a short last block
    x[8:] *= 1e-3
    want, wscales = rref.quant_roundtrip_ref(x, qmax)
    got, scales = tref.quant_roundtrip_ref(torch.as_tensor(x), qmax)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))
    np.testing.assert_array_equal(scales.numpy().view(np.uint32),
                                  wscales.view(np.uint32))


def test_ref_reexports_the_oracles_beside_the_kernels():
    assert tref.flash_attention_ref is tfa.flash_attention_ref
    assert tref.rwkv6_ref is trw.rwkv6_ref
    assert tref.ssd_ref is tssd.ssd_ref


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (24, 0.0), (0, 30.0)])
def test_ops_flash_attention_matches_the_reference(window, softcap):
    rng = np.random.default_rng(2)
    q, k, v = _n(rng, 2, 4, 64, 32), _n(rng, 2, 2, 64, 32), _n(rng, 2, 2,
                                                              64, 32)
    want = rops.flash_attention(*map(jnp.asarray, (q, k, v)), window=window,
                                softcap=softcap, bq=32, bkv=32)
    got = tops.flash_attention(*map(torch.as_tensor, (q, k, v)),
                               window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_ops_rwkv6_scan_matches_the_reference():
    rng = np.random.default_rng(3)
    bh, s, hd = 2, 64, 16
    r, k, v = _n(rng, bh, s, hd), _n(rng, bh, s, hd), _n(rng, bh, s, hd)
    w = (1 / (1 + np.exp(-_n(rng, bh, s, hd))) * 0.55 + 0.4).astype(
        np.float32)
    u = _n(rng, bh, hd)
    want = rops.rwkv6_scan(*map(jnp.asarray, (r, k, v, w, u)), chunk=16)
    got = tops.rwkv6_scan(*map(torch.as_tensor, (r, k, v, w, u)))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=2e-4)


def test_ops_ssd_scan_matches_the_reference():
    rng = np.random.default_rng(4)
    bh, s, p, n = 2, 64, 32, 16
    x = _n(rng, bh, s, p)
    dt = (np.abs(_n(rng, bh, s)) * 0.4 + 0.05).astype(np.float32)
    a = (np.abs(_n(rng, bh)) + 0.3).astype(np.float32)
    B, C = _n(rng, bh, s, n), _n(rng, bh, s, n)
    want = rops.ssd_scan(*map(jnp.asarray, (x, dt, a, B, C)), chunk=16)
    got = tops.ssd_scan(*map(torch.as_tensor, (x, dt, a, B, C)))
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=3e-4)


@pytest.mark.parametrize("idx", [0, 3])
def test_ops_guideline_pack_matches_the_reference(idx):
    x = _n(np.random.default_rng(5), 6, 8)
    want = rops.guideline_pack(jnp.asarray(x), idx, 4)
    got = tops.guideline_pack(torch.as_tensor(x), idx, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
