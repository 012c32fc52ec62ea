"""Shared layers: norms, MLPs, rotary embeddings, token embedding.

The port of the reference's ``repro/models/layers.py``.  Parameters live in
``nn.Module``s under the reference's names and layouts (a projection is
``x @ w`` with ``w`` of shape (fan_in, fan_out)), kept in the config's
``param_dtype`` and cast to the activation dtype at every product, as the
reference does.  Init draws from an explicit ``torch.Generator`` with the
reference's scales (1/√fan_in; 0.02 for the token table); the numbers
differ from ``jax.random``'s, so parity tests carry the reference's weights
across (``convert.py``).  Parameters are created trainable
(``requires_grad=True``); serving runs under ``torch.no_grad()``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..launch.shardings import logical, unshard


def adtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def at_least_f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` in f32, or as it is in f64: the reference's f32 islands (norms,
    logits, the SSD's decays) stay f64 in an f64 model."""
    return t if t.dtype == torch.float64 else t.float()


def dense_init(gen: torch.Generator, shape, dtype, device,
               scale: Optional[float] = None) -> nn.Parameter:
    """N(0, 1)·scale, scale 1/√fan_in by default (fan_in = shape[0]), a
    trainable parameter; on the meta device a storage-free one of that
    shape (a skeleton draws nothing)."""
    if torch.device(device).type == "meta":
        return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))
    scale = scale if scale is not None else 1.0 / shape[0] ** 0.5
    w = torch.randn(shape, generator=gen, device=device) * scale
    return nn.Parameter(w.to(dtype))


def const_param(shape, value: float, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, value, dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

class RMSNorm(nn.Module):
    """x / rms(x) · scale over the last axis, in f32 (f64 for f64), cast
    back to x's dtype."""

    def __init__(self, d: int, eps: float, dtype, device):
        super().__init__()
        self.eps = eps
        self.scale = const_param((d,), 1.0, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = at_least_f32(x)
        var = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps)
        return (y * self.scale.to(xf.dtype)).to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (gated or plain)
# ---------------------------------------------------------------------------

def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name in ("silu", "swiglu"):
        return torch.nn.functional.silu(x)
    if name in ("gelu", "geglu"):
        # jax.nn.gelu's default is the tanh approximation
        return torch.nn.functional.gelu(x, approximate="tanh")
    return torch.relu(x)


class MLP(nn.Module):
    """``act(x @ gate) * (x @ up) @ down`` (gated) or ``act(x @ up) @ down``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        d, f, dt = cfg.d_model, cfg.d_ff, pdtype(cfg)
        self.act = cfg.act
        self.up = dense_init(gen, (d, f), dt, device)
        self.down = dense_init(gen, (f, d), dt, device)
        if cfg.act in ("silu", "swiglu", "geglu"):
            self.gate = dense_init(gen, (d, f), dt, device)
        else:
            self.gate = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        up = logical(x @ self.up.to(dt), "batch", "seq", "ff")
        if self.gate is not None:
            h = _act(self.act, x @ self.gate.to(dt)) * up
        else:
            h = _act(self.act, up)
        return logical(h @ self.down.to(dt), "batch", "seq", "embed")


# ---------------------------------------------------------------------------
# rotary position embeddings (RoPE + M-RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope: bool = False) -> torch.Tensor:
    """``x``: (B, S, H, hd); ``positions``: (B, S) or (B, S, 3) for M-RoPE.

    M-RoPE (qwen2-vl) drives 1/2 of the rotary dims with the temporal
    position id and 1/4 each with the h and w ids; with all three equal to
    the text position it is standard RoPE.  sin and cos are cast to x's
    dtype before the rotation, as in the reference."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)               # (hd/2,)
    if mrope:
        if positions.dim() == 2:
            positions = torch.stack([positions] * 3, dim=-1)
        n = hd // 2
        n_t = n - n // 2
        sec = torch.cat([
            torch.zeros(n_t, dtype=torch.int64),
            torch.ones(n // 4, dtype=torch.int64),
            torch.full((n - n_t - n // 4,), 2, dtype=torch.int64)]
        ).to(x.device)
        pos = positions.float()[..., sec]                  # (B, S, hd/2)
        ang = pos * freqs[None, None, :]
    else:
        ang = positions.float()[..., None] * freqs[None, None, :]
    sin = torch.sin(ang)[..., None, :].to(x.dtype)        # (B, S, 1, hd/2)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------

class Embed(nn.Module):
    """Token table ``tok`` (vocab, d), and ``unembed`` (d, vocab) unless the
    embeddings are tied."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        dt = pdtype(cfg)
        self.cfg = cfg
        self.tok = dense_init(gen, (cfg.vocab, cfg.d_model), dt, device,
                              scale=0.02)
        if not cfg.tie_embeddings:
            self.unembed = dense_init(gen, (cfg.d_model, cfg.vocab), dt,
                                      device)
        else:
            self.unembed = None

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = torch.nn.functional.embedding(tokens, self.tok)
        return logical(x.to(adtype(self.cfg)), "batch", "seq", "embed")

    def logits(self, x: torch.Tensor, *, sliced: bool = True) -> torch.Tensor:
        """Vocabulary logits in f32 (f64 for f64).  ``sliced=False`` keeps
        the reference's shardable layout: the vocab axis padded to a
        multiple of 256 (zero columns of the unembedding, their logits
        −1e30)."""
        w = self.unembed if self.unembed is not None else self.tok.T
        V = self.cfg.vocab
        Vp = -(-V // 256) * 256
        x = at_least_f32(unshard(x, 1))
        w = w.to(x.dtype)
        if Vp != V and not sliced:
            w = torch.cat([w, torch.zeros((w.shape[0], Vp - V), dtype=x.dtype,
                                          device=x.device)], dim=1)
        logits = x @ w
        if Vp != V and not sliced:
            keep = torch.arange(Vp, device=x.device) < V
            logits = torch.where(keep, logits, -1e30)
        return logical(logits, "batch", "seq", "vocab")
