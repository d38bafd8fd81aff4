"""zamba2-1.2b [hybrid] — 38L mamba2 d=2048, shared attn block (32H kv=32,
ff=8192) every 6 layers, ssm_state=64, V=32000.  [arXiv:2411.15242; hf]"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32_000, head_dim=64,
    layer_pattern=("mamba",),
    ssm=SSMConfig(kind="mamba2", state_dim=64, head_dim=64, expand=2),
    hybrid_period=6,
    tie_embeddings=False, subquadratic=True,
)
