"""recurrentgemma-2b — RG-LRU + local attention, 1:2 [arXiv:2402.19427; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab=256_000, head_dim=256,
    layer_pattern=("rec", "rec", "attn_local"), window=2048,
    lru_width=2560, conv_width=4, act="gelu",
    rope_theta=10_000.0, tie_embeddings=True,
)
