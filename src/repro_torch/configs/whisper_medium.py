"""whisper-medium — enc-dec, conv frontend (stub) [arXiv:2212.04356; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
    vocab=51_865, head_dim=64,
    enc_dec=True, n_enc_layers=24, enc_frames=1500,
    act="gelu", rope_theta=10_000.0, tie_embeddings=True,
)
