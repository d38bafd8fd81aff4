"""phi3.5-moe-42b-a6.6b [moe] — 32L d=4096 32H (kv=8) expert-ff=6400
V=32064, 16 experts top-2.  [hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from repro_torch.models.config import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=6400, vocab_size=32_064, head_dim=128,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=6400),
    tie_embeddings=False,
)
