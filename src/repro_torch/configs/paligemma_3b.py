"""paligemma-3b [vlm] — 18L d=2048 8H (kv=1) ff=16384 V=257216; SigLIP
patch embeddings STUBBED, gemma backbone, prefix-LM mask.
[arXiv:2407.07726; hf]"""
from repro_torch.models.config import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
    d_ff=16384, vocab_size=257_216, head_dim=256,
    vlm=VLMConfig(patch_dim=1152, n_patches=256),
    tie_embeddings=True, scale_embed=True,
)
