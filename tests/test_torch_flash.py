"""Parity of the port's flash attention (``repro_torch.kernels.
flash_attention``) with the JAX package on the CPU.

The same numpy inputs, made from a seed, go through:

* the TPU kernel in interpret mode (``flash_attention(..., interpret=True)``,
  as ``tests/test_kernels.py`` runs it), the oracle
  ``ref.flash_attention_ref`` and the port's version in the Pallas layout
  (``flash_attention_bhsd``, which on CPU tensors is the plain version)
  and its oracle ``flash_attention_ref``;
* the model's flash path ``models/attention.py:_flash_jnp`` and the port's
  ``flash_attention`` on the model layout, with query offsets, valid-KV
  lengths, windows, softcap and ragged lengths.

Tolerances are the reference test's (``tests/test_kernels.py:22-23``):
3e-5 absolute in float32 (summation order), 3e-2 in bfloat16 (one
rounding of p and of the output).  The kernel itself runs only on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``), held to its plain
version within the finer elementwise limit ``FA.tolerance``; here that
limit is checked at the serve path's shapes (head dim 128, 256 and MLA's
576/512, prefill and decode): it admits the plain version run in the
kernel's key blocks (8 on the dense decodes, 32 on mma.sync, 64 at dh
256 and on the MLA paths) and rejects planted faults.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_ref  # noqa: F401  (the reference's import shims)

from repro.kernels import ref as rref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models.attention import _flash_jnp
from repro_torch.kernels import flash_attention as FA
from repro_torch.models.params import to_torch

TOL = {"float32": 3e-5, "bfloat16": 3e-2}


def _inputs(seed, shapes, dtype, scale=1.0):
    """numpy normals -> (jnp arrays, torch tensors) holding the same
    values in ``dtype``."""
    rng = np.random.default_rng(seed)
    js = [jnp.asarray(rng.normal(size=s) * scale, getattr(jnp, dtype))
          for s in shapes]
    return js, [to_torch(np.asarray(a)) for a in js]


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,hq,hkv,s,d,bq,bkv", [
    (1, 2, 2, 128, 64, 64, 64),        # MHA
    (2, 4, 2, 256, 64, 128, 64),       # GQA 2:1
    (1, 8, 1, 128, 128, 64, 128),      # MQA, wide head
    (1, 2, 2, 192, 32, 64, 64),        # ragged-ish seq (192 = 3 blocks)
])
def test_pallas_layout_matches_the_tpu_kernel_and_oracle(dtype, b, hq, hkv,
                                                         s, d, bq, bkv):
    (q, k, v), (tq, tk, tv) = _inputs(
        b * 1000 + s, [(b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d)], dtype)
    tpu = pallas_flash(q, k, v, bq=bq, bkv=bkv, interpret=True)
    oracle = rref.flash_attention_ref(q, k, v)
    mine = FA.flash_attention_bhsd(tq, tk, tv)
    assert mine.dtype == tq.dtype and tuple(mine.shape) == (b, hq, s, d)
    _close(_np(mine), tpu, TOL[dtype])
    _close(_np(mine), oracle, TOL[dtype])
    _close(_np(FA.flash_attention_ref(tq, tk, tv)), oracle, TOL[dtype])


@pytest.mark.parametrize("window", [32, 64, 100])
def test_window_matches_the_tpu_kernel(window):
    (q, k, v), (tq, tk, tv) = _inputs(window, [(1, 2, 256, 64)] * 3,
                                      "float32")
    tpu = pallas_flash(q, k, v, window=window, bq=64, bkv=64,
                       interpret=True)
    mine = FA.flash_attention_bhsd(tq, tk, tv, window=window)
    _close(_np(mine), tpu, 3e-5)
    _close(_np(FA.flash_attention_ref(tq, tk, tv, window=window)),
           rref.flash_attention_ref(q, k, v, window=window), 3e-5)


def test_softcap_matches_the_tpu_kernel():
    (q, k), (tq, tk) = _inputs(7, [(1, 2, 128, 64)] * 2, "float32", 4.0)
    (v,), (tv,) = _inputs(8, [(1, 2, 128, 64)], "float32")
    tpu = pallas_flash(q, k, v, softcap=30.0, bq=64, bkv=64, interpret=True)
    mine = FA.flash_attention_bhsd(tq, tk, tv, softcap=30.0)
    _close(_np(mine), tpu, 3e-5)
    _close(_np(FA.flash_attention_ref(tq, tk, tv, softcap=30.0)),
           rref.flash_attention_ref(q, k, v, softcap=30.0), 3e-5)


def test_causality_property():
    """Changing future K/V must not change past outputs."""
    _, (q, k, v) = _inputs(9, [(1, 2, 128, 32)] * 3, "float32")
    o1 = FA.flash_attention_bhsd(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 100:] = 9.9
    v2[:, :, 100:] = -9.9
    o2 = FA.flash_attention_bhsd(q, k2, v2)
    torch.testing.assert_close(o1[:, :, :100], o2[:, :, :100], rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,window,softcap", [(100, 0, 0.0), (37, 16, 0.0),
                                              (61, 0, 20.0)])
def test_ragged_lengths_match_the_oracle(dtype, s, window, softcap):
    """Lengths the TPU kernel's block grid refuses (not a multiple of its
    blocks): the port against the JAX package's oracle."""
    (q, k, v), (tq, tk, tv) = _inputs(s, [(2, 6, s, 48), (2, 2, s, 48),
                                          (2, 2, s, 48)], dtype)
    want = rref.flash_attention_ref(q, k, v, window=window, softcap=softcap)
    got = FA.flash_attention_bhsd(tq, tk, tv, window=window, softcap=softcap)
    _close(_np(got), want, TOL[dtype])


# ---------------------------------------------------------------------------
# the model's flash path, on the model layout
# ---------------------------------------------------------------------------

KIND = {(True, 0): "causal", (True, 1): "local", (False, 0): "full"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [
    # (B, Sq, Skv, HK, G, dh, causal, window, softcap, q0, kv_len)
    (2, 64, 64, 2, 3, 32, True, 0, 0.0, 0, None),       # prefill, GQA 3
    (2, 40, 40, 1, 2, 16, True, 0, 0.0, 0, None),       # ragged
    (2, 32, 32, 2, 2, 16, True, 9, 0.0, 0, None),       # sliding window
    (1, 48, 48, 2, 1, 32, False, 0, 0.0, 0, None),      # full (encoder)
    (2, 1, 128, 2, 3, 32, True, 0, 0.0, 70, 71),        # decode at t = 70
    (2, 1, 128, 1, 4, 16, True, 0, 0.0, 127, 128),      # decode, full cache
    (2, 1, 24, 2, 2, 16, True, 24, 0.0, 29, 24),        # windowed decode
    (2, 3, 96, 2, 2, 32, True, 0, 25.0, 50, 53),        # 3 tokens, softcap
    # head dim 256: gemma2-9b at TP 8 (2 q heads over 1 KV head, softcap
    # 50, its 4096-key window cut with S to 40 of 100 keys), rows after a
    # prefix (q0 > 0, paligemma's text rows), and 210 folded rows (not a
    # multiple of 64)
    (1, 100, 100, 1, 2, 256, True, 40, 50.0, 0, None),
    (2, 40, 72, 1, 1, 256, True, 0, 0.0, 32, None),
    (1, 70, 70, 1, 3, 256, True, 0, 0.0, 0, None),
    # the dh-256 decodes (fa_ring_kernel's function): gemma2-9b's TP 8
    # grouping (G 2, softcap 50) with its window cut to 40 keys of the 151
    # filled, a decode after paligemma's prefix (q0 90 of 96 slots), and
    # a 3-token step of 2 q heads after a prefix
    (1, 1, 160, 1, 2, 256, True, 40, 50.0, 150, 151),
    (2, 1, 96, 1, 1, 256, True, 0, 0.0, 90, 91),
    (2, 3, 96, 1, 2, 256, True, 0, 0.0, 60, 63),
    # dh 64 non-causal (whisper's encoder) over 1100 keys: the plain
    # version's 64-key chunks end in a chunk of 12
    (1, 40, 1100, 1, 2, 64, False, 0, 0.0, 0, None),
])
def test_model_layout_matches_flash_jnp(dtype, case):
    b, sq, skv, hk, g, dh, causal, window, softcap, q0, kv_len = case
    (q, k, v), (tq, tk, tv) = _inputs(
        sum(case[:6]), [(b, sq, hk, g, dh), (b, skv, hk, dh),
                        (b, skv, hk, dh)], dtype, scale=2.0)
    kind = KIND[(causal, int(window > 0))]
    # a windowed decode passes the window's slots starting at key
    # position `start`; positions relative to it give the same masks
    start = 6 if (window and sq == 1) else 0
    want = _flash_jnp(q, k, v, q0 + jnp.arange(sq)[None],
                      start + jnp.arange(skv), kind=kind, window=window,
                      kv_valid=None if kv_len is None else start + kv_len,
                      softcap=softcap or None)
    got = FA.flash_attention(tq, tk, tv, causal=causal, window=window,
                             softcap=softcap, q0=q0 - start, kv_len=kv_len)
    assert got.dtype == tq.dtype and tuple(got.shape) == tuple(tq.shape)
    _close(_np(got), want, TOL[dtype])


def test_cpu_tensors_take_the_plain_version_and_bad_inputs_raise():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing; a tensor on another device than the others raises."""
    _, (q, k, v) = _inputs(3, [(1, 4, 2, 2, 16), (1, 4, 2, 16),
                               (1, 4, 2, 16)], "float32")
    before = FA.flash_attention.launches
    torch.testing.assert_close(FA.flash_attention(q, k, v),
                               FA.flash_attention_plain(q, k, v), rtol=0,
                               atol=0)
    assert FA.flash_attention.launches == before
    with pytest.raises(ValueError, match="kv_len"):
        FA.flash_attention(q, k, v, kv_len=5)
    with pytest.raises(ValueError, match="do not match"):
        FA.flash_attention(q, k[:, :, :1], v[:, :, :1])
    meta = torch.empty(q.shape, device="meta")
    with pytest.raises(ValueError, match="on meta"):
        FA.flash_attention(meta, k, v)


# the kernel-vs-plain limit at the serve path's shapes (llama3.2-3b at TP 8
# stacked: one KV head and 3 q heads per rank; the prefill's 32 rows cut
# to 2 here); at head dim 256 gemma3-1b's prefill per lane on the (2, 4)
# mesh (16 lanes cut to 4) and paligemma-3b's text and prefix rows at TP 8
# (32 cut to 4); deepseek-v3's absorbed MLA prefill at TP 8 (q/k 576, v
# k's first 512 columns, 32 rows cut to 1) and its decode (32 rows cut to
# 4); gemma3-1b's dh-256 decode per lane (16 lanes) and whisper-medium's
# encoder self-attention at TP 8 (32 rows cut to 2)
SERVE_PREFILL = (2, 1024, 1024, 1, 3, 128)
SERVE_DECODE = (32, 1, 2048, 1, 3, 128)
GEMMA_LANE = (4, 1024, 1024, 1, 1, 256)
PALI_TEXT = (4, 1024, 1280, 1, 1, 256)
PALI_PREFIX = (4, 256, 1280, 1, 1, 256)
MLA_PREFILL = (1, 1024, 1024, 1, 16, 576, 512)
MLA_DECODE = (4, 1, 2048, 1, 16, 576, 512)
MLA_SCALE = 1.0 / 192 ** 0.5
GEMMA_DECODE = (16, 1, 2048, 1, 1, 256)
WHISPER_ENC = (2, 1500, 1500, 2, 1, 64)


def _serve_inputs(shape):
    """q, k, v in bf16; a seventh entry dv makes v k's first dv columns
    (MLA's view)."""
    n, sq, skv, hk, g, dh = shape[:6]
    gen = torch.Generator().manual_seed(sum(shape))
    q, k, v = [torch.randn(*s, generator=gen).to(torch.bfloat16)
               for s in ((n, sq, hk, g, dh), (n, skv, hk, dh),
                         (n, skv, hk, dh))]
    return (q, k, k[..., :shape[6]]) if len(shape) > 6 else (q, k, v)


def _block_keys(shape) -> int:
    """The key block of the kernel a shape takes: 8 on a decode of at most
    16 folded rows that is not MLA (a warp's keys of fa_ring_kernel's
    block), 64 at dh 256 and on the MLA paths (the MLA decode's block,
    whose running maxima every warp shares, and the prefill's), 32 keys
    on the other paths the limit is checked for (the mma.sync kernel's
    block, finer than wgmma's 128)."""
    if shape[5] <= 256 and len(shape) == 6 and shape[1] * shape[4] <= 16:
        return 8
    return 64 if shape[5] >= 256 else 32


def _within(got, want, limit) -> bool:
    return bool(((got.float() - want.float()).abs() <= limit).all())


@pytest.mark.parametrize("shape,kw", [
    (SERVE_PREFILL, {}),
    (SERVE_DECODE, dict(q0=1024, kv_len=1025)),
    (SERVE_DECODE, dict(q0=1055, kv_len=1056)),
    (GEMMA_LANE, {}),
    (GEMMA_LANE, dict(window=512)),                      # a local layer
    (PALI_TEXT, dict(q0=256)),
    (MLA_PREFILL, dict(scale=MLA_SCALE)),
    (MLA_DECODE, dict(q0=1055, kv_len=1056, scale=MLA_SCALE)),
    (GEMMA_DECODE, dict(q0=1055, kv_len=1056)),
    (WHISPER_ENC, dict(causal=False))])
def test_limit_admits_the_kernels_block_schedule(monkeypatch, shape, kw):
    """The plain version in the kernel's key blocks (``_block_keys``)
    rounds p after the running maxima those blocks give; it stays within
    the limit."""
    q, k, v = _serve_inputs(shape)
    want = FA.flash_attention_plain(q, k, v, **kw)
    limit = FA.tolerance(q, k, v, want, **kw)
    monkeypatch.setattr(FA, "CHUNK", _block_keys(shape))
    assert _within(FA.flash_attention_plain(q, k, v, **kw), want, limit)


@pytest.mark.parametrize("shape,kw,bad", [
    (SERVE_PREFILL, {}, dict(q0=1)),                     # causal edge late
    (SERVE_PREFILL, {}, dict(window=1024 - 32)),         # first block dropped
    (SERVE_DECODE, dict(q0=1024, kv_len=1025),
     dict(q0=1024, kv_len=1024)),                        # last slot left out
    (SERVE_DECODE, dict(q0=1055, kv_len=1056),
     dict(q0=1056, kv_len=1057)),                        # one slot too many
    # head dim 256 and the MLA prefill, 64-key blocks
    (GEMMA_LANE, {}, dict(window=1024 - 64)),            # first block dropped
    (GEMMA_LANE, {}, dict(q0=1)),                        # causal edge late
    (PALI_TEXT, dict(q0=256), dict(q0=257)),             # causal edge late
    (PALI_PREFIX, dict(causal=False, kv_len=256),
     dict(causal=False, kv_len=257)),                    # prefix edge late
    (MLA_PREFILL, dict(scale=MLA_SCALE),
     dict(scale=MLA_SCALE, window=1024 - 64)),           # first block dropped
    (MLA_PREFILL, dict(scale=MLA_SCALE), dict(scale=MLA_SCALE, q0=1)),
    # the MLA decode's last filled slot left out, and one slot too many
    (MLA_DECODE, dict(q0=1055, kv_len=1056, scale=MLA_SCALE),
     dict(q0=1055, kv_len=1055, scale=MLA_SCALE)),
    (MLA_DECODE, dict(q0=1055, kv_len=1056, scale=MLA_SCALE),
     dict(q0=1056, kv_len=1057, scale=MLA_SCALE)),
    # the dh-256 decode's last filled slot left out; the encoder's ragged
    # last 128-key block lost
    (GEMMA_DECODE, dict(q0=1055, kv_len=1056), dict(q0=1055, kv_len=1055)),
    (WHISPER_ENC, dict(causal=False), dict(causal=False, kv_len=1408)),
])
def test_limit_rejects_planted_faults(shape, kw, bad):
    q, k, v = _serve_inputs(shape)
    want = FA.flash_attention_plain(q, k, v, **kw)
    limit = FA.tolerance(q, k, v, want, **kw)
    assert not _within(FA.flash_attention_plain(q, k, v, **bad), want, limit)
