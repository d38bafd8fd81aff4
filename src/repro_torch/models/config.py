"""Unified model configuration covering all ten assigned architectures.

One ``ModelConfig`` describes dense / MoE / SSM / hybrid / enc-dec / VLM
stacks through a per-layer ``block_pattern``.  Exact arch instances live in
``repro_torch/configs/<id>.py``; reduced smoke variants come from
``ModelConfig.smoke()``.  The port's own copy of the JAX package's
``repro/models/config.py``: the same fields, defaults and derived sizes,
so a configuration means the same model in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

BlockKind = Literal["attn", "attn_local", "mamba", "rwkv", "shared_attn"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0               # always-on shared experts (DeepSeek)
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    # capacity from the GLOBAL token count: per-expert keep decisions use a
    # data-axis-wide position (one extra tunable allreduce on router
    # stats), so data-sharded runs drop exactly the tokens a single-device
    # run would — at the cost of a dp-times-larger worst-case dispatch
    # buffer.  Off by default (the classic local-capacity GShard behavior).
    global_capacity: bool = False


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: Literal["rwkv6", "mamba2"] = "mamba2"
    state_dim: int = 64             # N (mamba) / head size (rwkv)
    head_dim: int = 64              # P
    expand: int = 2                 # d_inner = expand * d_model (mamba2)
    conv_kernel: int = 4            # causal depthwise conv (mamba2)
    decay_lora_rank: int = 32       # data-dependent decay LoRA (rwkv6)
    chunk: int = 64                 # chunked-scan block length


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    n_enc_layers: int = 24
    dec_ratio: int = 8              # dec_len = seq_len // dec_ratio


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    patch_dim: int = 1152           # SigLIP output width (stub frontend)
    n_patches: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "audio", "vlm", "ssm", "hybrid"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    # attention features ------------------------------------------------
    layer_pattern: tuple[BlockKind, ...] = ("attn",)   # cycled over layers
    window: int = 4096              # sliding window for attn_local
    attn_softcap: float | None = None
    final_softcap: float | None = None
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    attn_impl: str = "ref"          # "ref" (paper-faithful baseline) |
                                    # "flash" (chunked online-softmax, §Perf)
    mla: MLAConfig | None = None
    # moe ----------------------------------------------------------------
    moe: MoEConfig | None = None
    # ssm / hybrid ---------------------------------------------------------
    ssm: SSMConfig | None = None
    hybrid_period: int = 0          # shared_attn every k layers (zamba2)
    # enc-dec / vlm ---------------------------------------------------------
    encdec: EncDecConfig | None = None
    vlm: VLMConfig | None = None
    # embeddings / output ---------------------------------------------------
    tie_embeddings: bool = True
    scale_embed: bool = False       # gemma-style sqrt(d_model) scaling
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # long-context capability (which serve shapes are lowered)
    subquadratic: bool = False
    # training ---------------------------------------------------------------
    scan_layers: bool = True        # False: unroll (serving — per-layer
                                    # cache buffers alias in place)
    remat: bool = True
    optimizer: str = "adamw"        # "adamw" | "adafactor"

    # -- derived ---------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return -(-self.vocab_size // 256) * 256   # Megatron-style pad

    def heads_padded(self, tp: int) -> int:
        return -(-self.n_heads // tp) * tp

    def kv_heads_padded(self, tp: int) -> int:
        # replicate KV heads up to the TP degree when kv < tp (GQA)
        if self.n_kv_heads >= tp:
            assert self.n_kv_heads % tp == 0
            return self.n_kv_heads
        return tp

    def pattern(self) -> tuple[BlockKind, ...]:
        """Per-layer block kinds, length n_layers (decoder for enc-dec)."""
        out = []
        for i in range(self.n_layers):
            out.append(self.layer_pattern[i % len(self.layer_pattern)])
        return tuple(out)

    def param_count(self) -> int:
        """Approximate dense-equivalent parameter count (for 6ND roofline)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_padded
        hq = self.n_heads * self.hd
        hkv = self.n_kv_heads * self.hd
        if self.mla is not None:
            m = self.mla
            attn = (d * m.q_lora_rank
                    + m.q_lora_rank * self.n_heads * (m.nope_head_dim + m.rope_head_dim)
                    + d * (m.kv_lora_rank + m.rope_head_dim)
                    + m.kv_lora_rank * self.n_heads * (m.nope_head_dim + m.v_head_dim)
                    + self.n_heads * m.v_head_dim * d)
        else:
            attn = d * hq + 2 * d * hkv + hq * d
        mlp = 3 * d * f
        if self.moe is not None:
            mlp = (3 * d * self.moe.d_ff_expert
                   * (self.moe.n_experts + self.moe.n_shared)
                   + d * self.moe.n_experts)
        ssm = 0
        if self.ssm is not None:
            di = self.ssm.expand * d
            if self.ssm.kind == "mamba2":
                ssm = d * (2 * di + 2 * self.ssm.state_dim
                           + di // self.ssm.head_dim) + di * d
            else:
                ssm = 5 * d * d + d * self.d_ff * 2
        per_layer = {"attn": attn + mlp, "attn_local": attn + mlp,
                     "mamba": ssm, "rwkv": ssm, "shared_attn": 0}
        total = sum(per_layer[k] for k in self.pattern())
        if self.hybrid_period:
            total += attn + mlp  # one shared block
        if self.encdec is not None:
            # encoder layers + cross-attention in decoder
            total += self.encdec.n_enc_layers * (attn + mlp)
            total += self.n_layers * attn
        total += v * d * (1 if self.tie_embeddings else 2)
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        moe_total = 3 * d * self.moe.d_ff_expert * (
            self.moe.n_experts + self.moe.n_shared)
        moe_active = 3 * d * self.moe.d_ff_expert * (
            self.moe.top_k + self.moe.n_shared)
        n_moe_layers = sum(1 for k in self.pattern()
                           if k in ("attn", "attn_local"))
        return self.param_count() - n_moe_layers * (moe_total - moe_active)

    # -- smoke variant ------------------------------------------------------
    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for 1-device CPU tests."""
        return dataclasses.replace(
            self,
            n_layers=min(4, self.n_layers),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            head_dim=16,
            d_ff=128,
            vocab_size=512,
            window=32,
            moe=None if self.moe is None else MoEConfig(
                n_experts=4, top_k=2, d_ff_expert=64,
                n_shared=min(self.moe.n_shared, 1)),
            mla=None if self.mla is None else MLAConfig(
                q_lora_rank=32, kv_lora_rank=16, rope_head_dim=8,
                nope_head_dim=16, v_head_dim=16),
            ssm=None if self.ssm is None else dataclasses.replace(
                self.ssm, state_dim=16, head_dim=16, chunk=8,
                decay_lora_rank=8),
            encdec=None if self.encdec is None else EncDecConfig(
                n_enc_layers=2, dec_ratio=2),
            vlm=None if self.vlm is None else VLMConfig(
                patch_dim=48, n_patches=8),
            hybrid_period=2 if self.hybrid_period else 0,
        )
