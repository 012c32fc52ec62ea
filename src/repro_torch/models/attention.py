"""Attention: GQA with optional qk-norm / QKV bias / RoPE / M-RoPE; full,
local (sliding-window), bidirectional and cross variants; and the
ring-buffer KV cache of one-token decode, whose capacity is
``min(seq, window)`` for local layers.

The port of the reference's ``repro/models/attention.py``: modes
``causal``, ``local``, ``bidir`` and ``cross``.  On every device the
score/softmax/PV core of :func:`attention` is ONE call of
``kernels.flash_attention.flash_attention_gqa`` on q (B, S, H, hd) and
k, v (B, S, K, hd) as the projections leave them — the kernel reads them in
place, query head h on KV head h // (H/K), and writes (B, S, H, hd), so no
head-expanded or transposed copies are made: the hand-written kernel on a
CUDA tensor, its plain version on a CPU tensor.  ``local`` passes the
window to the kernel (keys i − window < j ≤ i; the kernel walks only the
band's tiles); ``cross`` reads K/V projected from the encoder output with
K = H heads, no RoPE, unmasked.  The kernel, like the
reference's flash kernel, keeps the probabilities at f32 precision (in bf16
as two bf16 halves); the reference model's own formula (dense scores,
query-chunked above 2·512 queries) and the port's decode round them to
bf16 once before p·v, so the two agree to f32 rounding in f32 and to one
bf16 rounding of p in bf16.  Decode attention is plain torch, as in the
reference (no kernel).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..kernels.flash_attention import flash_attention_gqa
from .layers import RMSNorm, apply_rope, const_param, dense_init, pdtype

NEG_INF = -1e30


class Attention(nn.Module):
    """Projections ``wq`` (d, H·hd), ``wk``/``wv`` (d, K·hd), ``wo``
    (H·hd, d); ``bq``/``bk``/``bv`` with ``qkv_bias``; ``q_norm``/``k_norm``
    (RMSNorm over hd) with ``qk_norm``.  ``cross``: K = H (whisper's cross
    attention is MHA)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device,
                 cross: bool = False):
        super().__init__()
        d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        if cross:
            K = H
        dt = pdtype(cfg)
        self.wq = dense_init(gen, (d, H * hd), dt, device)
        self.wk = dense_init(gen, (d, K * hd), dt, device)
        self.wv = dense_init(gen, (d, K * hd), dt, device)
        self.wo = dense_init(gen, (H * hd, d), dt, device)
        self.bq = self.bk = self.bv = None
        if cfg.qkv_bias:
            self.bq = const_param((H * hd,), 0.0, dt, device)
            self.bk = const_param((K * hd,), 0.0, dt, device)
            self.bv = const_param((K * hd,), 0.0, dt, device)
        self.q_norm = self.k_norm = None
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, cfg.norm_eps, dt, device)
            self.k_norm = RMSNorm(hd, cfg.norm_eps, dt, device)


def _project_q(p: Attention, x, cfg: ModelConfig):
    B, S, _ = x.shape
    q = x @ p.wq.to(x.dtype)
    if p.bq is not None:
        q = q + p.bq.to(x.dtype)
    return q.reshape(B, S, cfg.n_heads, cfg.hd)


def _project_kv(p: Attention, src, cfg: ModelConfig, cross: bool = False):
    B, T, _ = src.shape
    k = src @ p.wk.to(src.dtype)
    v = src @ p.wv.to(src.dtype)
    if p.bk is not None:
        k = k + p.bk.to(src.dtype)
        v = v + p.bv.to(src.dtype)
    K = cfg.n_heads if cross else cfg.n_kv_heads
    return k.reshape(B, T, K, cfg.hd), v.reshape(B, T, K, cfg.hd)


def _expand_kv(kv, H: int):
    """Repeat the KV heads to the query-head count: (B, T, K, hd) →
    (B, T, H, hd), query head h reading KV head h // (H // K)."""
    B, T, K, hd = kv.shape
    if K == H:
        return kv
    return kv[:, :, :, None, :].expand(B, T, K, H // K, hd).reshape(
        B, T, H, hd)


def _sqrt_hd(q) -> torch.Tensor:
    """√hd in q's dtype (the reference rounds it to the activation dtype)."""
    return torch.tensor(q.shape[-1] ** 0.5, dtype=q.dtype)


def _gqa_scores(q, k, cfg: ModelConfig):
    """q: (B, S, H, hd), k: (B, T, K, hd) → scores (B, H, S, T) in q's dtype."""
    ke = _expand_kv(k, cfg.n_heads)
    return torch.einsum("bshd,bthd->bhst", q, ke) / _sqrt_hd(q)


def _gqa_out(probs, v, wo, B: int, S: int, cfg: ModelConfig):
    ve = _expand_kv(v, cfg.n_heads)
    o = torch.einsum("bhst,bthd->bshd", probs, ve)
    return o.reshape(B, S, cfg.n_heads * cfg.hd) @ wo.to(o.dtype)


def attention(p: Attention, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, mode: str = "causal",
              enc_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Prefill attention over ``x`` (B, S, d); ``mode``: causal | local |
    bidir | cross (keys and values from ``enc_out`` (B, T, d))."""
    if mode not in ("causal", "local", "bidir", "cross"):
        raise ValueError(f"unknown attention mode {mode!r}")
    B, S, _ = x.shape
    cross = mode == "cross"
    q = _project_q(p, x, cfg)
    k, v = _project_kv(p, enc_out if cross else x, cfg, cross)
    if p.q_norm is not None:
        q = p.q_norm(q)
        k = p.k_norm(k)
    if not cross:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope)
    o = flash_attention_gqa(
        q, k, v, causal=mode in ("causal", "local"),
        window=cfg.window if mode == "local" else 0)
    return o.reshape(B, S, cfg.n_heads * cfg.hd) @ p.wo.to(x.dtype)


# ---------------------------------------------------------------------------
# KV cache (decode)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, capacity: int, mode: str,
               dtype, device) -> dict:
    """Ring-buffer cache (``mode`` causal or local): keys and values
    (B, capacity, K, hd) and the absolute position held by each slot (−1:
    empty)."""
    if mode not in ("causal", "local"):
        raise ValueError(f"attention mode {mode!r} keeps no KV cache")
    K, hd = cfg.n_kv_heads, cfg.hd
    return {
        "k": torch.zeros((batch, capacity, K, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, capacity, K, hd), dtype=dtype, device=device),
        "pos": torch.full((capacity,), -1, dtype=torch.int32, device=device),
    }


def cache_capacity(cfg: ModelConfig, mode: str, seq_len: int) -> int:
    """``min(seq_len, window)`` for local layers, else ``seq_len``."""
    if mode == "local":
        return min(seq_len, cfg.window)
    return seq_len


def decode_attention(p: Attention, x: torch.Tensor, cache: Optional[dict],
                     cfg: ModelConfig, *, pos, mode: str = "causal",
                     cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]]
                     = None):
    """One-token decode.  ``x``: (B, 1, d); ``pos``: the absolute position.

    Keys are stored after RoPE in ring slot ``pos % capacity``; validity
    comes from the per-slot absolute-position table, which handles the
    full and the sliding-window masks alike (``local`` keeps slots with
    pos − window < position ≤ pos).  The cache is updated in place (the
    reference returns a new one) and returned.  ``cross`` attends over the
    encoder's ``cross_kv`` = (k, v) (B, T, H, hd) and leaves ``cache`` as
    it is."""
    B = x.shape[0]
    if mode == "cross":
        q = _project_q(p, x, cfg)
        if p.q_norm is not None:
            q = p.q_norm(q)
        k, v = cross_kv
        probs = torch.softmax(_gqa_scores(q, k, cfg).float(), dim=-1)
        return _gqa_out(probs.to(x.dtype), v, p.wo, B, 1, cfg), cache
    if mode not in ("causal", "local"):
        raise ValueError(f"attention mode {mode!r} has no one-token decode")
    pos = int(pos)
    q = _project_q(p, x, cfg)
    k_new, v_new = _project_kv(p, x, cfg)
    if p.q_norm is not None:
        q = p.q_norm(q)
        k_new = p.k_norm(k_new)
    pos_b = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, pos_b, cfg.rope_theta, cfg.mrope)
    k_new = apply_rope(k_new, pos_b, cfg.rope_theta, cfg.mrope)

    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    slot = pos % ck.shape[1]
    ck[:, slot] = k_new[:, 0]
    cv[:, slot] = v_new[:, 0]
    cpos[slot] = pos

    scores = _gqa_scores(q, ck, cfg).float()               # (B, H, 1, cap)
    valid = (cpos >= 0) & (cpos <= pos)
    if mode == "local":
        valid &= cpos > pos - cfg.window
    scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    return _gqa_out(probs, cv, p.wo, B, 1, cfg), cache
