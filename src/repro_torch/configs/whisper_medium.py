"""whisper-medium [audio] — 24+24L d=1024 16H ff=4096 V=51865; enc-dec,
conv frontend STUB (input_specs provides frame embeddings).
[arXiv:2212.04356; unverified]"""
from repro_torch.models.config import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=51_865, head_dim=64,
    encdec=EncDecConfig(n_enc_layers=24, dec_ratio=8),
    tie_embeddings=True,
)
