"""qwen2-vl-72b — M-RoPE, dynamic resolution (stub frontend)
[arXiv:2409.12191; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
    vocab=152_064, head_dim=128, qkv_bias=True, mrope=True,
    vis_patches=256, rope_theta=1_000_000.0, act="silu",
)
