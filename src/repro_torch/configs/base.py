"""Config schema for the LM substrate (the port's copy of the reference's
``repro/configs/base.py``; plain data, field for field the same).

One :class:`ModelConfig` per assigned architecture (see sibling modules);
:class:`ShapeConfig` encodes the four assigned input-shape cells.  Configs are
frozen dataclasses — hashable, usable as dictionary keys.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    # attention flavour
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    mrope: bool = False               # qwen2-vl M-RoPE (3-section rotary)
    window: int = 2048                # local-attention window
    # layer pattern, cycled to n_layers (e.g. recurrentgemma: rec,rec,attn_local)
    layer_pattern: Tuple[str, ...] = ("attn",)
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4
    # RG-LRU
    lru_width: Optional[int] = None
    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_frames: int = 1500
    # VLM stub frontend
    vis_patches: int = 0              # prefix patch embeddings (precomputed)
    # numerics / training
    act: str = "silu"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"           # activation dtype
    param_dtype: str = "float32"
    remat: str = "full"               # none | full | dots
    # beyond-paper perf knobs (see EXPERIMENTS.md §Perf)
    seq_shard_long: bool = True       # sequence-parallel halo attention for long ctx
    seq_shards_mixer: int = 1         # SSD sequence-domain decomposition (§3.3 pattern)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pattern_layers(self) -> Tuple[str, ...]:
        """The pattern cycled out to exactly n_layers entries."""
        p = self.layer_pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    def param_count(self) -> int:
        """Analytic parameter count (embedding included once if tied)."""
        d, hd = self.d_model, self.hd
        n = 0
        for kind in self.pattern_layers:
            if kind in ("attn", "attn_local", "attn_bidir"):
                qkv = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
                if self.qkv_bias:
                    qkv += (self.n_heads + 2 * self.n_kv_heads) * hd
                n += qkv + (self.n_heads * hd) * d          # o_proj
                n += self._mlp_params()
                n += 2 * d                                   # norms
            elif kind == "moe":
                qkv = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
                n += qkv + (self.n_heads * hd) * d
                n += d * self.n_experts                      # router
                n += self.n_experts * 3 * d * self.d_ff_expert
                n += 2 * d
            elif kind == "rec":
                w = self.lru_width or d
                n += 2 * d * w + 2 * w * d                   # in/out projections
                n += self.conv_width * w + 3 * w             # conv + gates(diag-ish)
                n += 2 * w * w // 4                          # gate projections (block)
                n += self._mlp_params() + 2 * d
            elif kind == "ssd":
                d_in = 2 * d
                nheads = d_in // self.ssm_head_dim
                n += d * (2 * d_in + 2 * self.ssm_state + nheads)  # in_proj
                n += self.conv_width * (d_in + 2 * self.ssm_state)
                n += nheads * 2                                # A, D
                n += d_in * d + d                              # out_proj + norm
            n += 0
        n += self.vocab * d                                   # embed
        if not self.tie_embeddings:
            n += self.vocab * d                               # unembed
        if self.enc_dec:
            # encoder stack (attn_bidir + mlp) + cross-attn in decoder
            qkv = self.d_model * (self.n_heads * self.hd) * 4
            n += self.n_enc_layers * (qkv + self._mlp_params() + 2 * d)
            n += self.n_layers * (qkv + 2 * d)                # cross attn
        return n

    def _mlp_params(self) -> int:
        if self.d_ff == 0:
            return 0
        gates = 3 if self.act in ("silu", "swiglu", "geglu") else 2
        return gates * self.d_model * self.d_ff


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                          # train | prefill | decode


SHAPES = {
    "train_4k":    ShapeConfig("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeConfig("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeConfig("long_500k",   524_288, 1,   "decode"),
}


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return dataclasses.replace(
        cfg,
        n_layers=max(len(cfg.layer_pattern), 2 if not cfg.enc_dec else 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) or 1,
        d_ff=128 if cfg.d_ff else 0,
        d_ff_expert=32 if cfg.d_ff_expert else 0,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        capacity_factor=8.0,      # no capacity drops → decode ≡ forward

        vocab=512,
        head_dim=16,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else cfg.ssm_head_dim,
        ssm_chunk=8,
        lru_width=64 if cfg.lru_width else None,
        window=16,
        n_enc_layers=2 if cfg.enc_dec else 0,
        enc_frames=24 if cfg.enc_dec else cfg.enc_frames,
        vis_patches=8 if cfg.vis_patches else 0,
        dtype="float32",
        param_dtype="float32",
        remat="none",
    )
