"""deepseek-v3-671b [moe] — 61L d=7168 128H ff(expert)=2048 V=129280;
MLA, 1 shared + 256 routed top-8.  [arXiv:2412.19437; hf]

Simplifications vs the full paper model (documented in DESIGN.md): every
layer is MoE (the real model has 3 dense lead-in layers) and the MTP head is
omitted.  Optimizer is Adafactor — bf16-Adam state for 671B params does not
fit a single v5e-256 pod (see EXPERIMENTS.md memory table)."""
from repro_torch.models.config import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=2048, vocab_size=129_280,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  rope_head_dim=64, nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048, n_shared=1),
    tie_embeddings=False, optimizer="adafactor",
)
