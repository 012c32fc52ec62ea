"""The dense decoder: prefill forward and one-token decode with a KV cache.

The port of the reference's ``repro/models/transformer.py`` for the dense
architectures (every layer ``attn``, no encoder): llama3.2-1b, qwen2-1.5b
(QKV bias), qwen3-8b (qk-norm), qwen1.5-110b and qwen2-vl-72b (M-RoPE and
prefix patch embeddings).  The reference scans a stacked layer period; here
the layers are an ``nn.ModuleList`` walked by a plain loop.  The model
serves: its parameters are frozen (``requires_grad=False``) and remat is
not ported.  MoE, recurrent (RG-LRU, SSD), local-attention and
encoder-decoder models raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..core._device import resolve_device
from . import attention as attn
from .layers import MLP, Embed, RMSNorm, adtype, pdtype

#: what a layer kind or an encoder needs, for the error of a model whose
#: parts are not ported yet (ROADMAP, slice 7)
_UNPORTED = {
    "moe": "MoE layers (models/moe.py)",
    "rec": "RG-LRU recurrent layers (models/ssm.py)",
    "ssd": "SSD (Mamba-2) layers (models/ssm.py)",
    "attn_local": "local (sliding-window) attention layers",
    "enc_dec": "the encoder-decoder stack (whisper encoder, cross-attention)",
}


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless every part of ``cfg`` is ported."""
    needs = [k for k in dict.fromkeys(cfg.pattern_layers) if k != "attn"]
    if cfg.enc_dec:
        needs.append("enc_dec")
    if needs:
        what = "; ".join(_UNPORTED.get(k, f"layer kind {k!r}") for k in needs)
        raise NotImplementedError(
            f"{cfg.name}: {what} not ported yet; they come with a later slice "
            "of the LM port (ROADMAP, slice 7). This slice builds the dense "
            "decoder (every layer 'attn', no encoder).")


class DecoderLayer(nn.Module):
    """``x + attn(ln1(x))``, then ``x + mlp(ln2(x))`` when ``d_ff``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        dt = pdtype(cfg)
        self.cfg = cfg
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
        self.attn = attn.Attention(cfg, gen, device)
        self.ln2 = self.mlp = None
        if cfg.d_ff:
            self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
            self.mlp = MLP(cfg, gen, device)

    def _mlp(self, x):
        return x if self.mlp is None else x + self.mlp(self.ln2(x))

    def forward(self, x, positions):
        x = x + attn.attention(self.attn, self.ln1(x), self.cfg,
                               positions=positions, mode="causal")
        return self._mlp(x)

    def decode(self, x, cache: dict, pos):
        y, cache = attn.decode_attention(self.attn, self.ln1(x), cache,
                                         self.cfg, pos=pos, mode="causal")
        return self._mlp(x + y), cache


class Transformer(nn.Module):
    """Dense decoder LM.  ``device=None`` means ``"cuda"`` and raises without
    a card; weights come from a seeded ``torch.Generator`` on that device
    (the reference's scales) or from the reference through
    ``convert.model_from_jax``."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device=None):
        super().__init__()
        check_ported(cfg)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.cfg = cfg
        self.embed = Embed(cfg, gen, dev)
        self.layers = nn.ModuleList(DecoderLayer(cfg, gen, dev)
                                    for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, pdtype(cfg), dev)

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device

    def forward(self, tokens: torch.Tensor, positions: Optional[torch.Tensor]
                = None, patches: Optional[torch.Tensor] = None,
                last_only: bool = False, return_hidden: bool = False):
        """Full-sequence forward.  Returns (logits (B, S, V) f32, aux), aux
        the zero f32 scalar of the reference's MoE loss slot.
        ``patches`` (B, P, d) are prefix embeddings (the VLM stub);
        ``last_only`` unembeds only the last position (prefill serving);
        ``return_hidden`` returns the final-normed hidden states instead."""
        x = self.embed.embed(tokens)
        if patches is not None:
            x = torch.cat([patches.to(x.dtype), x], dim=1)
        B, S, _ = x.shape
        if positions is None:
            positions = torch.arange(S, device=x.device)[None].expand(B, S)
        for layer in self.layers:
            x = layer(x, positions)
        x = self.final_norm(x)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if return_hidden:
            return x, aux
        if last_only:
            x = x[:, -1:]
        return self.embed.logits(x), aux

    def init_decode_state(self, batch: int, seq_len: int) -> dict:
        """KV caches for a ``seq_len`` context, one per layer."""
        cap = attn.cache_capacity(self.cfg, "causal", seq_len)
        return {"layers": [
            attn.init_cache(self.cfg, batch, cap, "causal", adtype(self.cfg),
                            self.device) for _ in self.layers]}

    def decode_step(self, state: dict, token: torch.Tensor, pos):
        """One serve step: ``token`` (B, 1) at absolute position ``pos`` →
        (logits (B, 1, V) f32, state).  The caches in ``state`` are updated
        in place."""
        x = self.embed.embed(token)
        caches = state["layers"]
        for i, layer in enumerate(self.layers):
            x, caches[i] = layer.decode(x, caches[i], pos)
        return self.embed.logits(self.final_norm(x)), state
