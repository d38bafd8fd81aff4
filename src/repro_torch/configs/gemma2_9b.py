"""gemma2-9b [dense] — 42L d=3584 16H (kv=8) ff=14336 V=256000;
local+global alternating, logit softcaps.  [arXiv:2408.00118; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8,
    d_ff=14336, vocab_size=256_000, head_dim=256,
    layer_pattern=("attn_local", "attn"),
    window=4096, attn_softcap=50.0, final_softcap=30.0,
    tie_embeddings=True, scale_embed=True,
)
