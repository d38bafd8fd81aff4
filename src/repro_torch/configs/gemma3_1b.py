"""gemma3-1b [dense] — 26L d=1152 4H (kv=1) ff=6912 V=262144; 5:1
local:global, 128k context.  [hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1,
    d_ff=6912, vocab_size=262_144, head_dim=256,
    layer_pattern=("attn_local",) * 5 + ("attn",),
    window=512, qk_norm=True, rope_theta=1_000_000.0,
    tie_embeddings=True, scale_embed=True,
    subquadratic=True,   # 5:1 local; global layers use seq-sharded decode
)
