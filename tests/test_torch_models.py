"""Per-module parity of the port's model stack (``repro_torch.models``,
``dist``, ``configs``) with the JAX package on the CPU.

Weights: the JAX package's global parameter tree (its ``init_tree`` at
tp = 1, as numpy) carried into the port by ``params.from_reference`` and
cut along its "model" dims by the JAX package's own specs for the
reference side, which runs each module under ``vmap(axis_name="model")``
at tp in {1, 2, 4}.  The smoke config of llama3.2-3b has 2 KV heads, so
tp = 4 takes the replicated-KV branch.

Tolerances: float32 configs differ only in summation order: 1e-4 of the
output's max-norm.  bfloat16 configs are held to the JAX package's own bar
for its two attention paths, 2e-2 max-norm relative
(``tests/test_models_smoke.py:101-104``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_ref  # noqa: F401  (the reference's import shims)

from repro import configs as rconfigs
from repro.models import attention as rattn
from repro.models import layers as rlayers
from repro.models import lm as rlm
from repro.models.params import ParamSpec as RSpec
from repro.models.params import init_tree as rinit
from repro_torch import configs as tconfigs
from repro_torch.core._axis import StackedAxis
from repro_torch.dist import axes as taxes
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import params as tparams
from repro_torch.models.params import to_torch

TPS = [1, 2, 4]
B, S = 2, 12
RTOL = {"float32": 1e-4, "bfloat16": 2e-2}


def smoke(dtype="float32", **kw):
    return dataclasses.replace(
        rconfigs.get_config("llama3.2-3b").smoke(), dtype=dtype, **kw)


def port_cfg(rcfg):
    """The port's ModelConfig with the same fields."""
    tcfg = tconfigs.get_config(rcfg.name)
    return dataclasses.replace(tcfg, **{
        f.name: getattr(rcfg, f.name) for f in dataclasses.fields(rcfg)})


def ref_params(rcfg, seed=1):
    """The JAX package's global parameter tree, as numpy."""
    tree = rinit(rlm.model_specs(rcfg, tp=1), jax.random.key(seed))
    return jax.tree.map(np.asarray, tree)


def ref_shard(np_tree, rcfg, tp):
    """The global tree cut for ``vmap(axis_name="model")`` at tp: every
    "model" dim of the JAX package's specs split into tp shards,
    replicated leaves repeated; stacked ``[tp, ...]`` jnp arrays."""
    specs = rlm.model_specs(rcfg, tp=tp)

    def cut(a, s):
        for i, d in enumerate(s.dims):
            if d == "model":
                return jnp.stack(jnp.split(jnp.asarray(a), tp, axis=i))
        return jnp.stack([jnp.asarray(a)] * tp)
    return jax.tree.map(cut, np_tree, specs,
                        is_leaf=lambda x: isinstance(x, RSpec))


def randomized(np_tree, seed):
    """Every leaf that its init leaves constant (zeros / ones: norms,
    token-shift mixes, decay biases, the rwkv bonus) gets normal(0, 0.3)
    noise in its own dtype, so that a parity test sees each of them."""
    rng = np.random.default_rng(seed)

    def f(a):
        a = np.asarray(a)
        if a.size and np.all(a == a.flat[0]):
            return (a.astype(np.float32) + rng.normal(
                0, 0.3, a.shape)).astype(a.dtype)
        return a
    return jax.tree.map(f, np_tree)


def port_params(np_tree, rcfg, tp):
    axis = StackedAxis(tp, "cpu")
    return tparams.from_reference(np_tree, tlm.model_specs(
        port_cfg(rcfg), tp), axis), axis


def rel(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.isfinite(got).all()
    return float(np.max(np.abs(got - want)) / (np.max(np.abs(want)) + 1e-9))


def tnp(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def rvmap(fn, *args, in_axes=0):
    return jax.jit(jax.vmap(fn, axis_name="model", in_axes=in_axes))(*args)


def _x(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    a = jnp.asarray(rng.normal(size=shape), getattr(jnp, dtype))
    return a, to_torch(np.asarray(a))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", rconfigs.ARCHS)
def test_configs_equal_the_reference(arch):
    r = rconfigs.get_config(arch)
    t = tconfigs.get_config(arch)
    assert tconfigs.ARCHS == rconfigs.ARCHS
    for a, b in ((r, t), (r.smoke(), t.smoke())):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert (b.hd, b.vocab_padded, b.pattern(), b.param_count(),
                b.active_param_count()) == (a.hd, a.vocab_padded,
                                            a.pattern(), a.param_count(),
                                            a.active_param_count())
        for tp in (1, 2, 4, 8, 16):
            assert b.heads_padded(tp) == a.heads_padded(tp)
            if a.n_kv_heads < tp or a.n_kv_heads % tp == 0:
                assert b.kv_heads_padded(tp) == a.kv_heads_padded(tp)


@pytest.mark.parametrize("arch,kind", [
    ("deepseek-v3-671b", "mla"), ("whisper-medium", "encdec"),
    ("paligemma-3b", "vlm")])
def test_blocks_not_ported_yet_raise_naming_the_kind(arch, kind):
    with pytest.raises(NotImplementedError, match=kind):
        tlm.model_specs(tconfigs.get_config(arch).smoke(), 2)


@pytest.mark.parametrize("scan", [True, False])
@pytest.mark.parametrize("tp", TPS)
def test_model_specs_match_the_reference(scan, tp):
    rcfg = smoke(scan_layers=scan)
    specs_match(rcfg, tp)


def specs_match(rcfg, tp):
    """The port's stack plan and spec tree equal the JAX package's (a
    scanned group's stacked leaves against the port's per-layer list)."""
    rspec = rlm.model_specs(rcfg, tp=tp)
    tspec = tlm.model_specs(port_cfg(rcfg), tp)
    assert [(g.name, g.unit, g.n_rep) for g in tlm.stack_plan(
        port_cfg(rcfg))] == [(g.name, g.unit, g.n_rep)
                             for g in rlm.stack_plan(rcfg)]

    def walk(r, t):
        if isinstance(t, list):       # a scanned group: n_rep layers
            for i, ti in enumerate(t):
                walk(jax.tree.map(
                    lambda s: RSpec(s.shape[1:], s.dims[1:], s.init,
                                    s.scale, s.dtype), r,
                    is_leaf=lambda x: isinstance(x, RSpec)), ti)
            return
        if isinstance(t, tparams.ParamSpec):
            assert (t.shape, t.dims, t.init, t.scale, t.dtype) == (
                r.shape, r.dims, r.init, r.scale, r.dtype)
            return
        assert sorted(t) == sorted(r)
        for k in t:
            walk(r[k], t[k])
    walk(rspec, tspec)


def test_from_reference_carries_bfloat16_bits_and_cuts_model_dims():
    rcfg = smoke("bfloat16")
    tree = ref_params(rcfg)
    params, _ = port_params(tree, rcfg, 2)
    w_q = tree["stack"]["g0"]["b0_attn"]["attn"]["w_q"]       # [4, 64, 64]
    got = params["stack"]["g0"][3]["b0_attn"]["attn"]["w_q"]  # [2, 64, 32]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(tnp(got[1]),
                                  np.asarray(w_q[3][:, 32:], np.float32))
    table = tree["embed"]["table"]                           # [512, 64]
    np.testing.assert_array_equal(tnp(params["embed"]["table"][0]),
                                  np.asarray(table[:256], np.float32))


def test_init_tree_draws_the_global_leaf_and_cuts_it():
    """init_tree's shards are cuts of one global draw: the model is the
    same whatever tp, and replicated leaves equal on every rank."""
    cfg = port_cfg(smoke("bfloat16"))
    trees = {}
    for tp in (1, 2):
        g = torch.Generator(device="cpu").manual_seed(3)
        trees[tp] = tparams.init_tree(tlm.model_specs(cfg, tp), g,
                                      StackedAxis(tp, "cpu"))
    w1 = trees[1]["stack"]["g0"][0]["b0_attn"]["ffn"]["w_in"][0]
    w2 = trees[2]["stack"]["g0"][0]["b0_attn"]["ffn"]["w_in"]
    assert torch.equal(torch.cat([w2[0], w2[1]], dim=1), w1)
    assert float(w1.float().std()) == pytest.approx(64 ** -0.5, rel=0.1)
    ln = trees[2]["stack"]["g0"][1]["b0_attn"]["ln1"]
    assert ln.dtype == torch.float32 and torch.equal(ln[0], ln[1])
    assert not bool(ln.any())


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope_match(dtype):
    x, tx = _x(1, (3, B, S, 4, 16), dtype)
    sc, tsc = _x(2, (16,), "float32")
    want = rlayers.rms_norm(x, sc, 1e-6)
    got = tlayers.rms_norm(tx, tsc.expand(3, 16), 1e-6)
    assert rel(tnp(got), want) <= RTOL[dtype] / 10
    pos = 5 + jnp.arange(S)[None]
    want = rlayers.rope(x, pos, 500_000.0)
    got = tlayers.rope(tx, 5 + torch.arange(S)[None], 500_000.0)
    assert got.dtype == tx.dtype
    assert rel(tnp(got), want) <= RTOL[dtype] / 10


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tp", TPS)
def test_mlp_embed_and_logits_match(dtype, tp):
    rcfg = smoke(dtype)
    tree = ref_params(rcfg)
    rp = ref_shard(tree, rcfg, tp)
    tp_, axis = port_params(tree, rcfg, tp)
    x, tx = _x(4, (B, S, rcfg.d_model), dtype)
    ffn_r = jax.tree.map(lambda a: a[:, 0], rp["stack"]["g0"]["b0_attn"][
        "ffn"])
    with taxes.bind(model=axis):
        want = rvmap(lambda p, a: rlayers.mlp(p, a), ffn_r, x,
                     in_axes=(0, None))
        got = tlayers.mlp(tp_["stack"]["g0"][0]["b0_attn"]["ffn"],
                          tx.expand(tp, *tx.shape))
        assert rel(tnp(got), want) <= RTOL[dtype]

        toks = np.random.default_rng(5).integers(0, rcfg.vocab_size, (B, S))
        want = rvmap(lambda p, t: rlayers.embed_lookup(p, t), rp["embed"],
                     jnp.asarray(toks, jnp.int32), in_axes=(0, None))
        got = tlayers.embed_lookup(tp_["embed"], torch.as_tensor(toks))
        assert rel(tnp(got), want) == 0.0       # a lookup: exact

        want = rvmap(lambda p, a: rlayers.lm_logits(p, a), rp["embed"], x,
                     in_axes=(0, None))
        got = tlayers.lm_logits(tp_["embed"], tx.expand(tp, *tx.shape))
        assert got.dtype == torch.float32
        assert rel(tnp(got), want) <= RTOL[dtype]


def test_embedding_backward_sums_repeated_rows_in_float32():
    """Zipf ids repeat a few rows hundreds of times.  A bfloat16 table's
    gradient is each row's sum taken in float32 and rounded once, so it is
    within one unit in the last place of the exact sum; a float32 table's
    is ``index_select``'s own backward."""
    rng = np.random.default_rng(11)
    n, d, v = 2048, 16, 64
    rows = torch.as_tensor(rng.zipf(1.3, n) % v)
    assert int(torch.bincount(rows).max()) > 500
    g = torch.as_tensor(rng.normal(size=(n, d))).to(torch.bfloat16)
    want = torch.zeros(v, d, dtype=torch.float64).index_add_(
        0, rows, g.double())
    grads = {}
    for dtype in (torch.bfloat16, torch.float32):
        table = torch.zeros(v, d, dtype=dtype, requires_grad=True)
        tlayers._TakeRows.apply(table, rows).backward(g.to(dtype))
        assert table.grad.dtype == dtype
        grads[dtype] = table.grad
    ulp = torch.finfo(torch.bfloat16).eps * want.abs()
    assert bool(((grads[torch.bfloat16].double() - want).abs()
                 <= ulp).all())
    table = torch.zeros(v, d, requires_grad=True)
    table.index_select(0, rows).backward(g.float())
    torch.testing.assert_close(grads[torch.float32], table.grad)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _attn_both(rcfg, tp, seed=6):
    tree = ref_params(rcfg)
    key = f"b0_{rcfg.layer_pattern[0]}"
    rp = jax.tree.map(lambda a: a[:, 0],
                      ref_shard(tree, rcfg, tp)["stack"]["g0"][key]["attn"])
    tparams_, axis = port_params(tree, rcfg, tp)
    return rp, tparams_["stack"]["g0"][0][key]["attn"], axis


@pytest.mark.parametrize("impl", ["ref", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tp", TPS)
def test_attention_prefill_then_decode_matches(impl, dtype, tp):
    rcfg = smoke(dtype, attn_impl=impl)
    tcfg = port_cfg(rcfg)
    rp, tpar, axis = _attn_both(rcfg, tp)
    x, tx = _x(7, (B, S, rcfg.d_model), dtype)
    x1, tx1 = _x(8, (B, 1, rcfg.d_model), dtype)
    smax = 20
    kv_loc = (rcfg.n_kv_heads // tp if rcfg.n_kv_heads % tp == 0
              else rcfg.n_kv_heads)
    zeros = jnp.zeros((tp, B, smax, kv_loc, rcfg.hd), getattr(jnp, dtype))

    def ref_steps(p, kc, vc):
        cache = {"k": kc, "v": vc, "len": jnp.int32(0)}
        a = rattn.attention(p, rcfg, x, pos=jnp.arange(S)[None],
                            cache=cache, mode="prefill")
        b = rattn.attention(p, rcfg, x1, pos=S + jnp.arange(1)[None],
                            cache=a.cache, mode="decode")
        return a.y, b.y, b.cache["k"], b.cache["v"]

    ry, ry1, rk, rv = rvmap(ref_steps, rp, zeros, zeros)
    cache = {"k": torch.zeros(tuple(zeros.shape), dtype=tx.dtype),
             "v": torch.zeros(tuple(zeros.shape), dtype=tx.dtype), "len": 0}
    with taxes.bind(model=axis):
        a = tattn.attention(tpar, tcfg, tx.expand(tp, *tx.shape),
                            pos=torch.arange(S)[None], cache=cache,
                            mode="prefill")
        assert a.cache["len"] == S
        b = tattn.attention(tpar, tcfg, tx1.expand(tp, *tx1.shape),
                            pos=S + torch.arange(1)[None], cache=a.cache,
                            mode="decode")
    assert b.cache["len"] == S + 1
    assert rel(tnp(a.y), ry) <= RTOL[dtype]
    assert rel(tnp(b.y), ry1) <= RTOL[dtype]
    assert rel(tnp(b.cache["k"]), rk) <= RTOL[dtype] / 10
    assert rel(tnp(b.cache["v"]), rv) <= RTOL[dtype] / 10


def test_windowed_flash_decode_matches_the_reference():
    """A local-attention layer decoding past its window slices the cache
    (JAX package ``attention.py:359-368``)."""
    rcfg = smoke("float32", attn_impl="flash", window=6,
                 layer_pattern=("attn_local",))
    tcfg = port_cfg(rcfg)
    tp = 2
    rp, tpar, axis = _attn_both(rcfg, tp)
    x, tx = _x(9, (B, S, rcfg.d_model), "float32")
    x1, tx1 = _x(10, (B, 1, rcfg.d_model), "float32")
    zeros = jnp.zeros((tp, B, 16, 1, rcfg.hd), jnp.float32)

    def ref_steps(p, kc, vc):
        cache = {"k": kc, "v": vc, "len": jnp.int32(0)}
        a = rattn.attention(p, rcfg, x, pos=jnp.arange(S)[None],
                            kind="local", cache=cache, mode="prefill")
        return rattn.attention(p, rcfg, x1, pos=S + jnp.arange(1)[None],
                               kind="local", cache=a.cache, mode="decode").y

    want = rvmap(ref_steps, rp, zeros, zeros)
    cache = {"k": torch.zeros(tuple(zeros.shape)),
             "v": torch.zeros(tuple(zeros.shape)), "len": 0}
    with taxes.bind(model=axis):
        a = tattn.attention(tpar, tcfg, tx.expand(tp, *tx.shape),
                            pos=torch.arange(S)[None], kind="local",
                            cache=cache, mode="prefill")
        got = tattn.attention(tpar, tcfg, tx1.expand(tp, *tx1.shape),
                              pos=S + torch.arange(1)[None], kind="local",
                              cache=a.cache, mode="decode").y
    assert rel(tnp(got), want) <= RTOL["float32"]


# ---------------------------------------------------------------------------
# the whole forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["ref", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tp", TPS)
def test_lm_forward_matches(impl, dtype, tp):
    rcfg = smoke(dtype, attn_impl=impl)
    tree = ref_params(rcfg)
    rp = ref_shard(tree, rcfg, tp)
    tp_, axis = port_params(tree, rcfg, tp)
    toks = np.random.default_rng(11).integers(0, rcfg.vocab_size, (B, S))
    want, _, _ = rvmap(lambda p: rlm.forward(
        p, rcfg, {"tokens": jnp.asarray(toks, jnp.int32)}), rp)
    with taxes.bind(model=axis):
        got, caches, aux = tlm.forward(tp_, port_cfg(rcfg),
                                       {"tokens": torch.as_tensor(toks)})
    assert caches is None and aux == 0.0
    assert got.dtype == torch.float32
    assert rel(tnp(got), want) <= RTOL[dtype]


# ---------------------------------------------------------------------------
# the dense archs besides llama3.2-3b: gemma2-9b (attention softcap, local
# and global layers), gemma3-1b (qk-norm, one KV head: replicated at
# tp >= 2) and llama3-8b, float32, randomized leaves
# ---------------------------------------------------------------------------

DENSE_ARCHS = ["gemma2-9b", "gemma3-1b", "llama3-8b"]


def dense_smoke(arch, impl, **kw):
    return dataclasses.replace(rconfigs.get_config(arch).smoke(),
                               dtype="float32", attn_impl=impl, **kw)


@pytest.mark.parametrize("impl", ["ref", "flash"])
@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_arch_prefill_then_decode_matches(arch, tp, impl):
    """window 6, below the prompt: a prefill of 11 tokens, then 5 decode
    steps in a 20-slot cache, each step's logits against the reference
    and against the port's own forward at that position (1e-4 max-norm
    relative: summation order only)."""
    rcfg = dense_smoke(arch, impl, window=6)
    tcfg = port_cfg(rcfg)
    tree = randomized(ref_params(rcfg), 5)
    rp = ref_shard(tree, rcfg, tp)
    tp_, axis = port_params(tree, rcfg, tp)
    n_pre, n_dec, slots = 11, 5, 20
    toks = np.random.default_rng(13).integers(0, rcfg.vocab_size,
                                              (B, n_pre + n_dec))
    jt = jnp.asarray(toks, jnp.int32)

    def ref_steps(p):
        c = rlm.init_caches(rcfg, B, slots)
        lg, c = rlm.prefill(p, rcfg, {"tokens": jt[:, :n_pre]}, c)
        out = [lg]
        for i in range(n_pre, n_pre + n_dec):
            lg, c = rlm.decode_step(p, rcfg, jt[:, i:i + 1], c, i)
            out.append(lg)
        return out
    want = rvmap(ref_steps, rp)
    tt = torch.as_tensor(toks)
    with taxes.bind(model=axis):
        caches = tlm.init_caches(tcfg, B, slots)
        lg, caches = tlm.prefill(tp_, tcfg, {"tokens": tt[:, :n_pre]},
                                 caches)
        got = [lg]
        for i in range(n_pre, n_pre + n_dec):
            lg, caches = tlm.decode_step(tp_, tcfg, tt[:, i:i + 1], caches,
                                         i)
            got.append(lg)
        full, _, _ = tlm.forward(tp_, tcfg, {"tokens": tt})
    for g, w in zip(got, want):
        assert rel(tnp(g), w) <= RTOL["float32"]
    for i in range(n_dec):
        assert rel(tnp(got[1 + i][:, :, 0]),
                   tnp(full[:, :, n_pre + i])) <= RTOL["float32"]


@pytest.mark.parametrize("impl", ["ref", "flash"])
@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_dense_arch_forward_matches(arch, tp, impl):
    """The whole forward at the smoke config's own window."""
    rcfg = dense_smoke(arch, impl)
    tree = randomized(ref_params(rcfg), 6)
    rp = ref_shard(tree, rcfg, tp)
    tp_, axis = port_params(tree, rcfg, tp)
    toks = np.random.default_rng(14).integers(0, rcfg.vocab_size, (B, S))
    want, _, _ = rvmap(lambda p: rlm.forward(
        p, rcfg, {"tokens": jnp.asarray(toks, jnp.int32)}), rp)
    with taxes.bind(model=axis):
        got, _, _ = tlm.forward(tp_, port_cfg(rcfg),
                                {"tokens": torch.as_tensor(toks)})
    assert rel(tnp(got), want) <= RTOL["float32"]


# ---------------------------------------------------------------------------
# dist.ops, forward, with the axis each op runs over bound
# ---------------------------------------------------------------------------

# (op, bound axis, per-rank x shape, per-rank w shape or None, call);
# shapes use p, the axis size
OPS = [
    ("tp_allgather", "model", lambda p: (3, 4, 5), None,
     lambda o, x, w: o.tp_allgather(x, 1)),
    ("tp_reducescatter", "model", lambda p: (2 * p, 5), None,
     lambda o, x, w: o.tp_reducescatter(x, 0)),
    ("tp_allreduce", "model", lambda p: (2, 3, 5), None,
     lambda o, x, w: o.tp_allreduce(x)),
    ("fsdp_gather", "data", lambda p: (4, 3), None,
     lambda o, x, w: o.fsdp_gather(x, 1)),
    ("col_matmul", "model", lambda p: (2, 3, 6), (6, 5),
     lambda o, x, w: o.col_matmul(x, w)),
    ("row_matmul rows divide", "model", lambda p: (2, p, 6), (6, 5),
     lambda o, x, w: o.row_matmul(x, w)),
    ("row_matmul ragged rows", "model", lambda p: (1, 3, 6), (6, 5),
     lambda o, x, w: o.row_matmul(x, w)),
    ("row_matmul fsdp_dim=1", "model", lambda p: (2, p, 6), (6, 5),
     lambda o, x, w: o.row_matmul(x, w, fsdp_dim=1)),
    ("allgather_matmul", "model", lambda p: (3, 6), (6, 5),
     lambda o, x, w: o.allgather_matmul(x, w)),
    ("matmul_reducescatter", "model", lambda p: (2 * p, 6), (6, 5),
     lambda o, x, w: o.matmul_reducescatter(x, w)),
    ("fsdp_matmul", "data", lambda p: (2, 3, 6), (6, 4),
     lambda o, x, w: o.fsdp_matmul(x, w)),
    ("matmul_accumulate", "data", lambda p: (2, 3, 4 * p), (4, 5),
     lambda o, x, w: o.matmul_accumulate(x, w)),
    ("matmul_accumulate padded", "data", lambda p: (2, 3, 4 * p - 1),
     (4, 5), lambda o, x, w: o.matmul_accumulate(x, w)),
    ("col_matmul fsdp_dim=0", "data", lambda p: (2, 3, 4 * p), (4, 5),
     lambda o, x, w: o.col_matmul(x, w, fsdp_dim=0)),
]


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("case", OPS, ids=[c[0] for c in OPS])
def test_dist_ops_forward_match_the_reference(case, p):
    """Integer-valued float32 operands: every summation order is exact,
    so outputs must be equal; the dispatch records too."""
    from repro.core import api as rapi
    from repro.dist import ops as rops
    from repro_torch.core import api as tapi
    from repro_torch.dist import ops as tops
    _, axis_name, xs_of, w_shape, call = case
    rng = np.random.default_rng(p)
    xs = rng.integers(-3, 4, (p,) + xs_of(p)).astype(np.float32)
    ws = (rng.integers(-3, 4, (p,) + w_shape).astype(np.float32)
          if w_shape else np.zeros((p, 1), np.float32))
    with rapi.tuned() as rctx:
        want = jax.vmap(lambda x, w: call(rops, x, w), axis_name=axis_name)(
            jnp.asarray(xs), jnp.asarray(ws))
    axis = StackedAxis(p, "cpu")
    with taxes.bind(**{axis_name: axis}), tapi.tuned() as tctx:
        got = call(tops, torch.as_tensor(xs), torch.as_tensor(ws))
    np.testing.assert_array_equal(tnp(got), np.asarray(want))
    assert [(dataclasses.astuple(r.cell), r.impl, r.phase)
            for r in tctx.record] == [
        (dataclasses.astuple(r.cell), r.impl, r.phase) for r in rctx.record]


def test_axes_bind_nest_and_refuse_unknown_names():
    a2, a4 = StackedAxis(2, "cpu"), StackedAxis(4, "cpu")
    assert not taxes.has_axis("model") and taxes.axis_size_or_1("model") == 1
    with taxes.bind(model=a2):
        with taxes.bind(model=a4, data=a2):
            assert taxes.axis_size("model") == 4
            assert taxes.axis_index("data").tolist() == [0, 1]
        assert taxes.get_axis("model") is a2 and not taxes.has_axis("data")
    with pytest.raises(LookupError, match="not bound"):
        taxes.get_axis("model")
    with pytest.raises(ValueError, match="unknown axis"):
        with taxes.bind(tensor=a2):
            pass


# ---------------------------------------------------------------------------
# the SSM and hybrid models (rwkv6-3b, zamba2-1.2b)
# ---------------------------------------------------------------------------

SSM_ARCHS = ["rwkv6-3b", "zamba2-1.2b"]


def ssm_smoke(arch, dtype="float32", **kw):
    return dataclasses.replace(rconfigs.get_config(arch).smoke(),
                               dtype=dtype, attn_impl="flash", **kw)


def ssm_params(rcfg, tp, seed=1):
    """The JAX package's global tree at tp (rwkv heads are padded to a
    multiple of tp, so the tree depends on it), with its constant leaves
    randomized (``randomized``), as numpy."""
    tree = rinit(rlm.model_specs(rcfg, tp=tp), jax.random.key(seed))
    return randomized(jax.tree.map(np.asarray, tree), seed)


@pytest.mark.parametrize("scan", [True, False])
@pytest.mark.parametrize("arch,tp", [(a, tp) for a in SSM_ARCHS
                                     for tp in TPS] + [("rwkv6-3b", 3)])
def test_ssm_model_specs_match_the_reference(arch, tp, scan):
    """Stack plans (zamba2's shared_attn markers), the rwkv heads padded
    at tp 3 (4 heads -> 6), the top-level shared_attn subtree.  (Mamba's
    8 smoke heads do not divide by 3 in either package.)"""
    specs_match(ssm_smoke(arch, scan_layers=scan), tp)


def test_ssm_stack_plans_at_full_size():
    """zamba2-1.2b: 6 units of (mamba x 6, shared_attn) and a remainder
    (mamba, mamba); rwkv6-3b: one group of 32."""
    for arch in SSM_ARCHS:
        r = rconfigs.get_config(arch)
        assert [(g.name, g.unit, g.n_rep) for g in tlm.stack_plan(
            port_cfg(r))] == [(g.name, g.unit, g.n_rep)
                              for g in rlm.stack_plan(r)]
    plan = tlm.stack_plan(tconfigs.get_config("zamba2-1.2b"))
    assert [(len(g.unit), g.n_rep) for g in plan] == [(7, 6), (2, 1)]


def test_from_reference_carries_padded_rwkv_and_shared_attn_trees():
    """bfloat16 bits carried and "model" dims cut: rwkv at tp 3, where the
    40-head layout of the smoke config's 4 heads is padded to 6; zamba2's
    shared block outside the stack."""
    from test_torch_ssm import PADDED
    rcfg = ssm_smoke("rwkv6-3b", "bfloat16", **PADDED)
    tree = ssm_params(rcfg, 3)
    params, _ = port_params(tree, rcfg, 3)
    w_r = tree["stack"]["g0"]["b0_rwkv"]["w_r"]              # [4, 96, 144]
    assert w_r.shape == (4, 96, 144)
    got = params["stack"]["g0"][2]["b0_rwkv"]["w_r"]         # [3, 96, 48]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(tnp(got[1]),
                                  np.asarray(w_r[2][:, 48:96], np.float32))
    u = params["stack"]["g0"][0]["b0_rwkv"]["u"]             # [3, 48]
    np.testing.assert_array_equal(tnp(u).reshape(-1),
                                  tree["stack"]["g0"]["b0_rwkv"]["u"][0])
    rcfg = ssm_smoke("zamba2-1.2b", "bfloat16")
    tree = ssm_params(rcfg, 2)
    params, _ = port_params(tree, rcfg, 2)
    sa = tree["shared_attn"]
    np.testing.assert_array_equal(
        tnp(params["shared_attn"]["proj_in"][1]),
        np.asarray(sa["proj_in"], np.float32))
    np.testing.assert_array_equal(
        tnp(params["shared_attn"]["attn"]["w_q"][1]),
        np.asarray(sa["attn"]["w_q"][:, 32:], np.float32))


SSM_FWD = ([(a, tp, {}) for a in SSM_ARCHS for tp in TPS]
           + [("rwkv6-3b", 3, "padded")])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,tp,kw", SSM_FWD,
                         ids=[f"{a}-tp{t}{'-padded' if k else ''}"
                              for a, t, k in SSM_FWD])
def test_ssm_lm_forward_matches(arch, tp, kw, dtype):
    """float32: 1e-4 of the logits' max-norm (summation order).  bfloat16:
    the two packages round at other places (the JAX package's CPU
    compiler may keep float32 between fused elementwise ops), and in the
    SSM stacks that noise grows with depth: on these 4-layer smoke models
    the JAX package's own bf16 logits lie up to ~8 % (max-norm relative)
    from the float32 forward on the same bf16-valued weights, past the
    2e-2 bar of a dense model.  So the port's bf16 logits are held to
    that float32 forward, no farther than twice the JAX package's bf16
    logits are (and the float32 case pins the function down)."""
    from test_torch_ssm import PADDED
    rcfg = ssm_smoke(arch, dtype, **(PADDED if kw else {}))
    tree = ssm_params(rcfg, tp)
    rp = ref_shard(tree, rcfg, tp)
    tp_, axis = port_params(tree, rcfg, tp)
    toks = np.random.default_rng(11).integers(0, rcfg.vocab_size, (B, S))

    def ref_fwd(cfg, p):
        return rvmap(lambda q: rlm.forward(
            q, cfg, {"tokens": jnp.asarray(toks, jnp.int32)}), p)[0]
    want = ref_fwd(rcfg, rp)
    with taxes.bind(model=axis):
        got, caches, _ = tlm.forward(tp_, port_cfg(rcfg),
                                     {"tokens": torch.as_tensor(toks)})
    assert caches is None and got.dtype == torch.float32
    if dtype == "float32":
        assert rel(tnp(got), want) <= RTOL[dtype]
        return
    cfg32 = dataclasses.replace(rcfg, dtype="float32")
    exact = ref_fwd(cfg32, jax.tree.map(lambda a: a.astype(jnp.float32),
                                        rp))
    assert rel(tnp(got), exact) <= 2 * rel(want, exact)


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_prefill_then_decode_matches(arch, tp):
    """float32: prefill over S - 1 = 11 tokens (not a multiple of any
    chunk) then one decode step, against the JAX package's and against
    the port's own full forward at the last position; the caches' SSM
    states and the shared blocks' KV lengths."""
    rcfg = ssm_smoke(arch)
    tcfg = port_cfg(rcfg)
    tree = ssm_params(rcfg, tp)
    rp = ref_shard(tree, rcfg, tp)
    tp_, axis = port_params(tree, rcfg, tp)
    toks = np.random.default_rng(12).integers(0, rcfg.vocab_size, (B, S))
    jt = jnp.asarray(toks, jnp.int32)

    def ref_steps(p):
        c = rlm.init_caches(rcfg, B, 16)
        lg1, c = rlm.prefill(p, rcfg, {"tokens": jt[:, :-1]}, c)
        lg2, c = rlm.decode_step(p, rcfg, jt[:, -1:], c, S - 1)
        return lg1, lg2
    want1, want2 = rvmap(ref_steps, rp)
    with taxes.bind(model=axis):
        caches = tlm.init_caches(tcfg, B, 16)
        lg1, caches = tlm.prefill(tp_, tcfg, {"tokens": torch.as_tensor(
            toks[:, :-1])}, caches)
        lg2, caches = tlm.decode_step(tp_, tcfg, torch.as_tensor(
            toks[:, -1:]), caches, S - 1)
        full, _, _ = tlm.forward(tp_, tcfg, {"tokens": torch.as_tensor(
            toks)})
    assert rel(tnp(lg1), want1) <= RTOL["float32"]
    assert rel(tnp(lg2), want2) <= RTOL["float32"]
    assert rel(tnp(lg2[:, :, 0]), tnp(full[:, :, -1])) <= RTOL["float32"]
    g0 = caches["stack"]["g0"]
    if arch == "zamba2-1.2b":
        assert [c["b2_shared_attn"]["self"]["len"] for c in g0] == [S, S]
        assert g0[0]["b0_mamba"]["s"].shape == (tp, B, 8 // tp, 16, 16)
    else:
        assert g0[0]["b0_rwkv"]["s"].shape == (tp, B, 4 // tp, 16, 16)
