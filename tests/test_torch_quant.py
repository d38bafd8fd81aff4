"""The port's wire format (``repro_torch/kernels/quant.py``) against the
reference's jnp tier (``quantize`` / ``dequantize``) and its Pallas tier
in interpret mode (``quant_pack`` / ``dequant_unpack``).

Inputs are made from a numpy seed.  Against the jnp tier there is no
tolerance: the q bytes are bit-equal (int8 directly, e4m3 as ``uint8``
views against ml_dtypes' bytes), the scales are equal (0 ulp) and equal
to numpy's IEEE float32 division, and a dequantization is bit-equal.  The
reference's Pallas tier in interpret mode divides by QMAX with another
rounding for some blocks (1 ulp off IEEE on the e4m3 scale, so off its
own jnp tier too); against it the scales are held to 1 ulp and the q
bytes to bit-equality in every block whose scale agrees.  Stacked
payloads ``[p, n, d]`` are held to the reference applied to each rank's
``[n, d]`` on its own: scale blocks never cross a rank.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import test_torch_ref  # noqa: F401  (the reference's import shims)
from repro.kernels import quant as RQ
from repro_torch.kernels import quant as TQ

SHAPES = [(32, 16), (13, 5), (3, 7), (8, 1)]
JNP_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _payload(seed, shape, dtype="float32"):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape) * 3.0
    # rows spanning six decades (small values round to 0 in their block)
    # and an all-zero block (the scale floor)
    x *= np.logspace(-3, 3, shape[-2]).reshape((-1, 1))
    if shape[-2] > 8:
        x[..., 8:16, :] = 0.0
    return x.astype(np.float32).astype(
        ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32)


def _torch(a) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _q_bytes(q) -> np.ndarray:
    """Wire values as raw bytes (torch or jax/ml_dtypes)."""
    if isinstance(q, torch.Tensor):
        return q.view(torch.uint8).numpy()
    return np.asarray(q).view(np.uint8)


def _ieee_scales(x, wd) -> np.ndarray:
    """The per-block scales with numpy's IEEE float32 division."""
    n = x.shape[0]
    pad = -n % 8
    xf = np.abs(np.asarray(x, np.float32))
    amax = np.pad(xf, ((0, pad), (0, 0))).reshape(-1, 8 * x.shape[1]).max(1)
    return np.maximum(amax, np.float32(1e-30)) / np.float32(RQ.QMAX[wd])


def _ref_tiers(x, wd):
    """Reference jnp tier and Pallas tier (interpret) on one rank."""
    xj = jnp.asarray(x)
    qj, sj = RQ.quantize(xj, wd)
    qk, sk = RQ.quant_pack(xj, wire_dtype=wd, interpret=True)
    return (qj, sj), (qk, sk)


@pytest.mark.parametrize("wd", TQ.WIRE_DTYPES)
@pytest.mark.parametrize("n,d", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_matches_the_reference_tiers(wd, n, d, dtype):
    x = _payload(n * d, (n, d), dtype)
    (qj, sj), (qk, sk) = _ref_tiers(x, wd)
    q, s = TQ.quant_pack(_torch(x), wd)
    assert q.dtype == getattr(torch, wd) and tuple(q.shape) == (n, d)
    assert tuple(s.shape) == (-(-n // 8), 1) and s.dtype == torch.float32
    np.testing.assert_array_equal(_q_bytes(q), _q_bytes(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))       # 0 ulp
    np.testing.assert_array_equal(s.numpy()[:, 0], _ieee_scales(x, wd))
    ulps = np.abs(s.numpy().view(np.int32) - np.asarray(sk).view(np.int32))
    assert ulps.max() <= 1                                     # Pallas tier
    same = np.repeat(ulps[:, 0] == 0, 8)[:n]
    np.testing.assert_array_equal(_q_bytes(q)[same], _q_bytes(qk)[same])
    # dequantize is bit-equal, to float32 and back to the payload dtype
    for out_t, out_j in ((torch.float32, jnp.float32),
                         (TORCH_DT[dtype], JNP_DT[dtype])):
        got = TQ.dequant_unpack(q, s, out_t)
        want = RQ.dequantize(qj, sj, out_j)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))
        kern = RQ.dequant_unpack(qj, sj, out_dtype=out_j, interpret=True)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(kern, np.float32))


@pytest.mark.parametrize("wd", TQ.WIRE_DTYPES)
@pytest.mark.parametrize("n,d", SHAPES)
@pytest.mark.parametrize("p", [1, 3, 8])
def test_stacked_quantize_is_the_reference_per_rank(wd, n, d, p):
    x = _payload(100 + p * n + d, (p, n, d))
    q, s = TQ.quantize(_torch(x), wd)
    assert tuple(s.shape) == (p, -(-n // 8), 1)
    back = TQ.dequantize(q, s, torch.float32)
    for r in range(p):
        (qj, sj), _ = _ref_tiers(x[r], wd)
        np.testing.assert_array_equal(_q_bytes(q[r]), _q_bytes(qj))
        np.testing.assert_array_equal(s[r].numpy(), np.asarray(sj))
        np.testing.assert_array_equal(back[r].numpy(),
                                      np.asarray(RQ.dequantize(qj, sj)))


@pytest.mark.parametrize("wd", TQ.WIRE_DTYPES)
def test_trailing_dims_flatten_into_the_width(wd):
    x = _payload(5, (3, 11, 2, 3))
    q, s = TQ.quantize(_torch(x), wd)
    assert tuple(q.shape) == (3, 11, 2, 3) and tuple(s.shape) == (3, 2, 1)
    for r in range(3):
        qj, sj = RQ.quantize(jnp.asarray(x[r]), wd)
        np.testing.assert_array_equal(_q_bytes(q[r]), _q_bytes(qj))
        np.testing.assert_array_equal(s[r].numpy(), np.asarray(sj))
    rt = TQ.wire_roundtrip(_torch(x), wd)
    for r in range(3):
        np.testing.assert_array_equal(
            rt[r].numpy(), np.asarray(RQ.wire_roundtrip(jnp.asarray(x[r]),
                                                        wd)))


def test_int8_rounds_half_to_even_like_the_reference():
    # one block whose max is 127: x / scale is x itself, so k + 0.5 ties
    x = np.array([[127.0, 2.5, 3.5, -2.5, 0.5, -0.5, 1.5, 126.5]],
                 np.float32).T
    q, s = TQ.quant_pack(_torch(x), "int8")
    assert float(s) == 1.0
    assert q[:, 0].tolist() == [127, 2, 4, -2, 0, 0, 2, 126]
    qj, _ = RQ.quantize(jnp.asarray(x), "int8")
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))


def test_constants_and_tolerance_match_the_reference():
    assert TQ.WIRE_DTYPES == RQ.WIRE_DTYPES
    assert TQ.WIRE_ITEMSIZE == RQ.WIRE_ITEMSIZE
    assert TQ.QMAX == RQ.QMAX and TQ.BLOCK_ROWS == RQ.BLOCK_ROWS
    assert TQ.BASE_TOL == RQ.BASE_TOL
    for wd in TQ.WIRE_DTYPES:
        for hops in (0, 1, 3, 7):
            assert TQ.wire_tol(wd, hops) == RQ.wire_tol(wd, hops)


def test_roundtrip_error_is_within_half_a_step():
    x = _payload(9, (4, 29, 6))
    xt = _torch(x)
    q, s = TQ.quantize(xt, "int8")
    err = (TQ.dequantize(q, s) - xt).abs()
    step = s[:, torch.arange(29) // 8]              # [4, 29, 1]
    assert bool((err <= step / 2 * (1 + 2 ** -20)).all())


def test_wrappers_check_their_arguments():
    with pytest.raises(ValueError, match="wire dtype"):
        TQ.quant_pack(torch.ones(2, 3), "int4")
    with pytest.raises(ValueError, match="takes"):
        TQ.quant_pack(torch.ones(2, 3, 4, 5))
    q, s = TQ.quant_pack(torch.ones(2, 9, 4))
    with pytest.raises(ValueError, match="scales must be"):
        TQ.dequant_unpack(q, s[:, :1])
    with pytest.raises(ValueError, match="int8"):
        TQ.dequant_unpack(q.float(), s)
