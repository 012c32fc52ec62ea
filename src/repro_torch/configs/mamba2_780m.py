"""mamba2-780m — SSD (state-space duality) [arXiv:2405.21060; unverified]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, d_ff=0,
    vocab=50_280, head_dim=64,
    layer_pattern=("ssd",), ssm_state=128, ssm_head_dim=64, ssm_chunk=256,
    conv_width=4, tie_embeddings=True,
)
