"""The serving slice end to end on the CPU: the port's ``launch.serve``
on ``StackedAxis(tp, device="cpu")`` against the JAX package's serve
pattern (``examples/serve_decode.py:36-66``: jitted prefill and decode
steps under ``vmap(axis_name="model")``, phase-tagged, then
``tune_trace`` and a re-serve under the per-phase profiles).

Two deliberate differences on the reference side, both in this test:

* greedy decoding takes the argmax over the FULL vocabulary (the vmapped
  logits' vocab shards concatenated), as the port's ``serve`` does; the
  example takes it over ``logits[0]``, the first rank's vocab shard only
  (ROADMAP queue 3);
* ``scan_layers=False`` (the config's own serving setting: one group per
  layer), so the JAX package records one dispatch per layer, as the
  port's Python loop does; with a ``lax.scan`` it would record one layer
  body per trace.

The JAX package records while it traces: its record holds the prefill
and ONE decode step (the decode step is traced once); the port records
every call, so its first prefill + decode records must equal the
reference's exactly and every later decode step must repeat the first.

Tolerance: logits within the JAX package's own bar for its two attention
paths, 2e-2 max-norm relative (``tests/test_models_smoke.py:101-104``),
and the same greedy tokens wherever the reference's top-2 margin exceeds
twice the logits' absolute error.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import (port_cfg, port_params, ref_params, ref_shard,
                               ssm_params)
from test_torch_tuning import reference_without_wire

from repro.core import api as rapi
from repro.core import costmodel as rcm
from repro.core import profiles as rprof
from repro.core import trace as rtrace
from repro.core import tuner as rtuner
from repro.models import lm as rlm
from repro_torch.core import api as tapi
from repro_torch.core import costmodel as tcm
from repro_torch.core import profiles as tprof
from repro_torch.core import trace as ttrace
from repro_torch.core import tuner as ttuner
from repro_torch.core._axis import StackedAxis
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import rwkv6_scan as RW
from repro_torch.kernels import ssd_mamba2 as SSD
from repro_torch.launch import serve as tserve

B, S0, S_MAX, N_TOKENS = 2, 8, 16, 4
RTOL = 2e-2


def _cfg(arch="llama3.2-3b", **kw):
    from repro import configs as rconfigs
    return dataclasses.replace(rconfigs.get_config(arch).smoke(),
                               attn_impl="flash", scan_layers=False, **kw)


def _prompts(rcfg):
    return np.random.default_rng(12).integers(0, rcfg.vocab_size, (B, S0))


def ref_serve(rcfg, tp, params, prompts, *, phase_profiles=None):
    """The example's serve loop, full-vocab greedy: (tokens [B, n],
    per-token logits [B, V_pad], ctx)."""
    prompts = jnp.asarray(prompts, jnp.int32)
    j_init = jax.jit(jax.vmap(lambda _: rlm.init_caches(rcfg, B, S_MAX),
                              axis_name="model", axis_size=tp,
                              in_axes=None, out_axes=0))
    j_pf = jax.jit(jax.vmap(
        lambda p, c: rlm.prefill(p, rcfg, {"tokens": prompts}, c),
        axis_name="model"))
    j_dc = jax.jit(jax.vmap(
        lambda p, t, c, i: rlm.decode_step(p, rcfg, t, c, i),
        axis_name="model", in_axes=(0, None, 0, None)))

    def greedy(lg):
        full = jnp.transpose(lg[:, :, -1], (1, 0, 2)).reshape(B, -1)
        return full, (jnp.argmax(full, -1).astype(jnp.int32)[:, None]
                      % rcfg.vocab_size)

    with rapi.tuned(phase_profiles=phase_profiles) as ctx:
        caches = j_init(0)
        with rapi.phase("prefill"):
            logits, caches = j_pf(params, caches)
        lg, tok = greedy(logits)
        toks, lgs = [tok], [lg]
        with rapi.phase("decode"):
            for step in range(N_TOKENS - 1):
                logits, caches = j_dc(params, tok, caches,
                                      jnp.int32(S0 + step))
                lg, tok = greedy(logits)
                toks.append(tok)
                lgs.append(lg)
    return (np.asarray(jnp.concatenate(toks, 1)),
            [np.asarray(a, np.float32) for a in lgs], ctx)


def _rec(r):
    return (dataclasses.astuple(r.cell), r.impl, r.phase)


def _check_records(port_ctx, ref_ctx):
    ref = [_rec(r) for r in ref_ctx.record]
    mine = [_rec(r) for r in port_ctx.record]
    n_pf = sum(r[2] == "prefill" for r in ref)
    n_dc = len(ref) - n_pf
    assert n_pf and n_dc
    assert mine[:n_pf + n_dc] == ref
    assert len(mine) == n_pf + (N_TOKENS - 1) * n_dc
    for i in range(1, N_TOKENS - 1):
        assert mine[n_pf + i * n_dc:n_pf + (i + 1) * n_dc] == ref[n_pf:]


def _check_logits(res, ref_toks, ref_lgs):
    """``launch.serve.check_serves`` with the reference's serve as the
    baseline; returns the first step whose tokens differ, or None."""
    ref = tserve.ServeResult(torch.as_tensor(ref_toks),
                             [torch.as_tensor(a) for a in ref_lgs], 0.0, 0.0,
                             None)
    report = tserve.check_serves(ref, res, RTOL)
    assert report["steps"] == (N_TOKENS if report["diverged_at"] is None
                               else report["diverged_at"] + 1)
    return report["diverged_at"]


def _serve_both(tp, dtype="bfloat16", **kw):
    rcfg = _cfg(dtype=dtype, **kw)
    tree = ref_params(rcfg, seed=2)
    rp = ref_shard(tree, rcfg, tp)
    tp_, axis = port_params(tree, rcfg, tp)
    return rcfg, rp, tp_, axis


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_serve_records_tunes_and_reserves_like_the_reference(tp, tmp_path):
    rcfg, rp, params, axis = _serve_both(tp)
    tcfg = port_cfg(rcfg)
    prompts = _prompts(rcfg)
    r_toks, r_lgs, r_ctx = ref_serve(rcfg, tp, rp, prompts)
    launches = FA.flash_attention.launches
    res = tserve.serve(tcfg, axis, params, torch.as_tensor(prompts), S_MAX,
                       N_TOKENS)
    assert FA.flash_attention.launches == launches     # CPU: the plain one
    assert res.tokens.shape == (B, N_TOKENS) and len(res.logits) == N_TOKENS
    _check_records(res.ctx, r_ctx)
    assert _check_logits(res, r_toks, r_lgs) is None

    # tune the recorded traffic on the cost model (the JAX package's
    # presets as parity data): the same per-phase profiles
    r_trace = rtrace.Trace.from_context(r_ctx)
    t_trace = ttrace.Trace.from_context(res.ctx)
    assert set(t_trace.phases()) == set(r_trace.phases()) == {"prefill",
                                                              "decode"}
    with reference_without_wire():
        r_rep = rtuner.tune_trace(
            r_trace, rtuner.CostModelBackend(rcm.BGQ_LIKE))
    t_rep = ttuner.tune_trace(t_trace,
                              ttuner.CostModelBackend(tcm.BGQ_LIKE))
    assert sorted(t_rep.phase_profiles) == sorted(r_rep.phase_profiles)
    for ph, store in r_rep.phase_profiles.items():
        assert sorted(p.to_text() for p in t_rep.phase_profiles[ph]) == \
            sorted(p.to_text() for p in store)
    t_rep.save(tmp_path / "port")
    _, phases = tprof.resolve_stores(tmp_path / "port")

    # re-serve under the per-phase profiles: the same picks, same logits
    r_toks2, r_lgs2, r_ctx2 = ref_serve(rcfg, tp, rp, prompts,
                                        phase_profiles=r_rep.phase_profiles)
    res2 = tserve.serve(tcfg, axis, params, torch.as_tensor(prompts),
                        S_MAX, N_TOKENS, phase_profiles=phases)
    _check_records(res2.ctx, r_ctx2)
    assert _check_logits(res2, r_toks2, r_lgs2) is None
    report = tserve.check_serves(res, res2, RTOL)
    assert report["steps"] == N_TOKENS and report["diverged_at"] is None
    assert tapi.format_footer(res2.ctx).splitlines() == \
        rapi.format_footer(r_ctx2).splitlines()


@pytest.mark.parametrize("impl", ["ref", "flash"])
def test_float32_serve_matches_closely(impl):
    """In float32 the two packages differ only in summation order."""
    rcfg, rp, params, axis = _serve_both(2, "float32")
    rcfg = dataclasses.replace(rcfg, attn_impl=impl)
    prompts = _prompts(rcfg)
    r_toks, r_lgs, _ = ref_serve(rcfg, 2, rp, prompts)
    res = tserve.serve(port_cfg(rcfg), axis, params,
                       torch.as_tensor(prompts), S_MAX, N_TOKENS)
    np.testing.assert_array_equal(res.tokens.numpy(), r_toks)
    for a, b in zip(r_lgs, res.logits):
        assert np.abs(a - b.numpy()).max() / np.abs(a).max() <= 1e-4


def test_check_serves_catches_drift_and_flipped_tokens():
    rcfg, _, params, axis = _serve_both(2)
    res = tserve.serve(port_cfg(rcfg), axis, params,
                       torch.as_tensor(_prompts(rcfg)), S_MAX, N_TOKENS)
    assert tserve.check_serves(res, res, 0.0) == {
        "steps": N_TOKENS, "max_rel_err": 0.0, "diverged_at": None}
    bad = dataclasses.replace(res, logits=[lg * 1.5 for lg in res.logits])
    with pytest.raises(RuntimeError, match="logits differ"):
        tserve.check_serves(res, bad, RTOL)
    flipped = dataclasses.replace(res, tokens=res.tokens.flip(0))
    if not torch.equal(flipped.tokens[:, 0], res.tokens[:, 0]):
        with pytest.raises(RuntimeError, match="tokens differ"):
            tserve.check_serves(res, flipped, RTOL)


def test_steps_phase_tag_and_inherit_an_ambient_context(tmp_path):
    """build_* with no tuning inputs tag the ambient context's records;
    record-only builders inherit the ambient force table
    (the JAX package's ``_serving_ctx``)."""
    rcfg, _, params, axis = _serve_both(2)
    tcfg = port_cfg(rcfg)
    from repro_torch.dist.axes import bind
    from repro_torch.models import lm as tlm
    with bind(model=axis):
        caches = tlm.init_caches(tcfg, B, S_MAX)
    prompts = torch.as_tensor(_prompts(rcfg))
    sink: list = []
    pf = tserve.build_prefill(tcfg, axis)
    dc = tserve.build_decode(tcfg, axis, record=sink)
    with tapi.tuned(force={"allreduce": "allreduce_as_doubling"}) as ctx:
        lg, caches = pf(params, {"tokens": prompts}, caches)
        dc(params, prompts[:, :1], caches, S0)
    assert {(r.phase, r.impl) for r in ctx.record} == {
        ("prefill", "allreduce_as_doubling")}
    assert {(r.phase, r.impl) for r in sink} == {
        ("decode", "allreduce_as_doubling")}
    assert lg.shape == (2, B, 1, tcfg.vocab_padded // 2)


def test_resolve_stores_precedence(tmp_path, monkeypatch):
    """Explicit directory > $PGTUNE_PROFILE_DIR > none; a broken env path
    warns and serves untuned, an explicit one raises (the JAX package's
    ``profiles.py:692-735``)."""
    store = tprof.ProfileStore()
    store.add(tprof.Profile(op="allreduce", axis_size=2, ranges=[
        tprof.Range(0, 1 << 20, "allreduce_as_doubling")]))
    store.save(tmp_path / "a" / "decode")
    store.save(tmp_path / "b")
    monkeypatch.delenv(tprof.PROFILE_DIR_ENV, raising=False)
    assert tprof.resolve_stores() == (None, {})
    monkeypatch.setenv(tprof.PROFILE_DIR_ENV, str(tmp_path / "b"))
    base, phases = tprof.resolve_stores()
    assert len(base) == 1 and phases == {}
    base, phases = tprof.resolve_stores(tmp_path / "a")
    assert base is None and sorted(phases) == ["decode"]
    # the JAX package reads the same directory the same way
    rb, rph = rprof.resolve_stores(str(tmp_path / "a"))
    assert rb is None and sorted(rph) == ["decode"]
    monkeypatch.setenv(tprof.PROFILE_DIR_ENV, str(tmp_path / "missing"))
    with pytest.warns(UserWarning, match="does not exist"):
        assert tprof.resolve_stores() == (None, {})
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "x.pgtune").write_text("garbage\n")
    monkeypatch.setenv(tprof.PROFILE_DIR_ENV, str(tmp_path / "bad"))
    with pytest.warns(UserWarning, match="failed to load"):
        assert tprof.resolve_stores() == (None, {})
    with pytest.raises(FileNotFoundError):
        tprof.resolve_stores(tmp_path / "missing")
    # serve picks the env directory up when given no profiles, and
    # explicit phase_profiles win over it
    monkeypatch.setenv(tprof.PROFILE_DIR_ENV, str(tmp_path / "a"))
    rcfg, _, params, axis = _serve_both(2)
    tcfg = port_cfg(rcfg)
    prompts = torch.as_tensor(_prompts(rcfg))
    res = tserve.serve(tcfg, axis, params, prompts, S_MAX, 2)
    assert {r.impl for r in res.ctx.record if r.phase == "decode"} == {
        "allreduce_as_doubling"}
    res = tserve.serve(tcfg, axis, params, prompts, S_MAX, 2,
                       phase_profiles={"prefill": tprof.ProfileStore()})
    assert {r.impl for r in res.ctx.record if r.phase == "decode"} == {
        "default"}


def test_cli_serves_tunes_and_reserves_on_the_cpu(tmp_path, capsys):
    assert tserve.main(["--device", "cpu", "--tp", "2", "--batch", "2",
                        "--prompt-len", "6", "--tokens", "3", "--out",
                        str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "#@pgmpi alg MPI_Allreduce" in out
    assert (tmp_path / "trace.jsonl").exists()
    assert (tmp_path / "profiles").is_dir()


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b"])
def test_ssm_serve_records_tunes_and_reserves_like_the_reference(
        arch, tp, tmp_path):
    """The SSM and hybrid serves, in float32 (where the two packages differ
    only in summation order, so the bf16 noise that grows with the SSM
    stacks' depth does not blur the comparison; see
    ``test_torch_models.test_ssm_lm_forward_matches``): the same records,
    tokens, logits within 1e-4 max-norm relative, per-phase profiles and
    re-served picks, tokens and logits as the JAX package; the scans'
    launch counters stay put (CPU: the plain versions)."""
    rcfg = _cfg(arch, dtype="float32")
    tree = ssm_params(rcfg, tp, seed=2)
    rp = ref_shard(tree, rcfg, tp)
    params, axis = port_params(tree, rcfg, tp)
    tcfg = port_cfg(rcfg)
    prompts = _prompts(rcfg)
    r_toks, r_lgs, r_ctx = ref_serve(rcfg, tp, rp, prompts)
    launches = (RW.rwkv6_scan.launches, SSD.ssd_scan.launches,
                FA.flash_attention.launches)
    res = tserve.serve(tcfg, axis, params, torch.as_tensor(prompts), S_MAX,
                       N_TOKENS)
    assert (RW.rwkv6_scan.launches, SSD.ssd_scan.launches,
            FA.flash_attention.launches) == launches
    _check_records(res.ctx, r_ctx)
    np.testing.assert_array_equal(res.tokens.numpy(), r_toks)
    for a, b in zip(r_lgs, res.logits):
        assert np.abs(a - b.numpy()).max() / np.abs(a).max() <= 1e-4

    r_trace = rtrace.Trace.from_context(r_ctx)
    t_trace = ttrace.Trace.from_context(res.ctx)
    with reference_without_wire():
        r_rep = rtuner.tune_trace(
            r_trace, rtuner.CostModelBackend(rcm.BGQ_LIKE))
    t_rep = ttuner.tune_trace(t_trace,
                              ttuner.CostModelBackend(tcm.BGQ_LIKE))
    for ph, store in r_rep.phase_profiles.items():
        assert sorted(p.to_text() for p in t_rep.phase_profiles[ph]) == \
            sorted(p.to_text() for p in store)
    t_rep.save(tmp_path / "port")
    _, phases = tprof.resolve_stores(tmp_path / "port")
    r_toks2, r_lgs2, r_ctx2 = ref_serve(rcfg, tp, rp, prompts,
                                        phase_profiles=r_rep.phase_profiles)
    res2 = tserve.serve(tcfg, axis, params, torch.as_tensor(prompts),
                        S_MAX, N_TOKENS, phase_profiles=phases)
    # the cost model may pick a wire impl (quantized, so lossy) for the
    # rwkv channel mix's allgather in both packages: the re-serve is held
    # to the reference's re-serve, not to the first serve
    _check_records(res2.ctx, r_ctx2)
    np.testing.assert_array_equal(res2.tokens.numpy(), r_toks2)
    for a, b in zip(r_lgs2, res2.logits):
        assert np.abs(a - b.numpy()).max() / np.abs(a).max() <= 1e-4
    assert tapi.format_footer(res2.ctx).splitlines() == \
        rapi.format_footer(r_ctx2).splitlines()


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b"])
def test_ssm_cli_serves_tunes_and_reserves_on_the_cpu(arch, tmp_path,
                                                      capsys):
    assert tserve.main(["--device", "cpu", "--arch", arch, "--tp", "2",
                        "--batch", "2", "--prompt-len", "9", "--tokens", "3",
                        "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert f"arch={arch} (smoke)" in out and "logits agree" in out
    assert (tmp_path / "trace.jsonl").exists()


def test_cli_without_a_card_refuses_to_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; nothing to refuse")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.main(["--tokens", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StackedAxis(2)

