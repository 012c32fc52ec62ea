"""Architecture registry: ``--arch <id>`` → ModelConfig.

All ten configurations of the reference are here as plain data; the port's
model builds every one of them."""
from .base import ModelConfig, ShapeConfig, SHAPES, smoke_variant
from . import (recurrentgemma_2b, llama3_2_1b, qwen2_1_5b, qwen3_8b,
               qwen1_5_110b, granite_moe_1b_a400m, dbrx_132b, whisper_medium,
               mamba2_780m, qwen2_vl_72b)

REGISTRY = {m.CONFIG.name: m.CONFIG for m in (
    recurrentgemma_2b, llama3_2_1b, qwen2_1_5b, qwen3_8b, qwen1_5_110b,
    granite_moe_1b_a400m, dbrx_132b, whisper_medium, mamba2_780m,
    qwen2_vl_72b)}

ARCH_IDS = tuple(REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def is_subquadratic(cfg: ModelConfig) -> bool:
    """Archs that can run long_500k (DESIGN.md §Arch-applicability)."""
    kinds = set(cfg.pattern_layers)
    return "attn" not in kinds and "moe" not in kinds and not cfg.enc_dec


__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "REGISTRY", "ARCH_IDS",
           "get_config", "smoke_variant", "is_subquadratic"]
