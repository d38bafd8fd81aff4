"""rwkv6-3b [ssm] — 32L d=2560 (attn-free) ff=8960 V=65536; Finch
data-dependent decay.  40 wkv heads (hd=64) padded to 48 for TP=16.
[arXiv:2404.05892; hf]"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=8960, vocab_size=65_536, head_dim=64,
    layer_pattern=("rwkv",),
    ssm=SSMConfig(kind="rwkv6", head_dim=64, decay_lora_rank=32),
    tie_embeddings=False, subquadratic=True,
)
