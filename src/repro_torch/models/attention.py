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

Under sharding rules (``launch.shardings``) on ``DTensor`` activations the
kernel call runs through ``local_map`` on each rank's batch rows and query
heads (:func:`_sharded_flash`), and the decode ring writes go to the rank
whose cache shard holds the slot (:func:`_ring_write`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..configs.base import ModelConfig
from ..kernels.flash_attention import flash_attention_gqa
from ..launch.shardings import local_shape_and_offset, logical, unshard
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


def _split_heads(t, n: int, hd: int):
    """(B, T, n·hd) → (B, T, n, hd).  A ``DTensor`` whose last dimension is
    sharded over more parts than the n heads divide into is made whole on
    it first: ``DTensor`` cannot split such a shard between two
    dimensions (GSPMD reshards it silently)."""
    if isinstance(t, DTensor):
        last = Shard(t.ndim - 1)
        mesh, pl = t.device_mesh, t.placements
        parts = 1
        for m, p in enumerate(pl):
            if p == last:
                parts *= mesh.size(m)
        if n % parts:
            t = t.redistribute(mesh, [Replicate() if p == last else p
                                      for p in pl])
    return t.reshape(*t.shape[:-1], n, hd)


def _merge_heads(o):
    """(B, S, H, hd) → (B, S, H·hd).  On a ``DTensor`` whose heads are
    whole, the merge runs on the local shard: the output projection's
    gradient comes back split along H·hd (row-parallel), which ``DTensor``
    could not unflatten into heads that the split does not divide (10 or
    12 heads on a 16-way axis); ``from_local`` hands it back whole."""
    B, S, H, hd = o.shape
    if not isinstance(o, DTensor) or any(
            isinstance(p, Shard) and p.dim >= 2 for p in o.placements):
        return o.reshape(B, S, H * hd)
    local = o.to_local()
    return DTensor.from_local(
        local.reshape(*local.shape[:2], H * hd), o.device_mesh,
        o.placements, run_check=False, shape=torch.Size((B, S, H * hd)),
        stride=(S * H * hd, H * hd, 1))


def _project_q(p: Attention, x, cfg: ModelConfig):
    q = x @ p.wq.to(x.dtype)
    if p.bq is not None:
        q = q + p.bq.to(x.dtype)
    return _split_heads(q, cfg.n_heads, cfg.hd)


def _project_kv(p: Attention, src, cfg: ModelConfig, cross: bool = False):
    k = src @ p.wk.to(src.dtype)
    v = src @ p.wv.to(src.dtype)
    if p.bk is not None:
        k = k + p.bk.to(src.dtype)
        v = v + p.bv.to(src.dtype)
    K = cfg.n_heads if cross else cfg.n_kv_heads
    return _split_heads(k, K, cfg.hd), _split_heads(v, K, cfg.hd)


def _expand_kv(kv, H: int):
    """Repeat the KV heads to the query-head count: (B, T, K, hd) →
    (B, T, H, hd), query head h reading KV head h // (H // K)."""
    B, T, K, hd = kv.shape
    if K == H:
        return kv
    return kv[:, :, :, None, :].expand(B, T, K, H // K, hd).reshape(
        B, T, H, hd)


def _sqrt_hd(q) -> float:
    """√hd rounded to q's dtype (the reference rounds it to the activation
    dtype)."""
    return float(torch.tensor(q.shape[-1] ** 0.5, dtype=q.dtype))


def _gqa_scores(q, k, cfg: ModelConfig):
    """q: (B, S, H, hd), k: (B, T, K, hd) → scores (B, H, S, T) in q's dtype.

    On ``DTensor``\\ s q's heads are made whole first and the scores keep
    the cache's layout (batch, and the cache length over the model axis):
    the reference asks for the scores by heads (``logical(s, "batch",
    "heads", …)``), which the (batch, heads) products here could only
    take as a strided shard, whose redistribution plans cost minutes on a
    3-D mesh.  The softmax then gathers the cache length, and p·v sums
    over it (a ``Partial``), as a split-KV decode does."""
    ke = _expand_kv(k, cfg.n_heads)
    return torch.einsum("bshd,bthd->bhst", unshard(q, 2), ke) / _sqrt_hd(q)


def _gqa_out(probs, v, wo, B: int, S: int, cfg: ModelConfig):
    ve = _expand_kv(v, cfg.n_heads)
    o = torch.einsum("bhst,bthd->bshd", probs, ve)
    return _merge_heads(o) @ wo.to(o.dtype)


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
    q = logical(q, "batch", "seq", "heads", "head_dim")
    k = logical(k, "batch", "seq", "kv_heads", "head_dim")
    v = logical(v, "batch", "seq", "kv_heads", "head_dim")
    flash = _sharded_flash if isinstance(q, DTensor) else flash_attention_gqa
    o = flash(q, k, v, causal=mode in ("causal", "local"),
              window=cfg.window if mode == "local" else 0)
    y = _merge_heads(o) @ p.wo.to(x.dtype)
    return logical(y, "batch", "seq", "embed")


def _sharded_flash(q, k, v, *, causal: bool, window: int):
    """:func:`flash_attention_gqa` on ``DTensor`` q (B, S, H, hd) and k, v
    (B, T, K, hd) through ``local_map``: each rank runs the kernel (its
    plain version on the CPU) on its own batch rows and query heads over
    the whole sequence.  q keeps its batch and head shards (a sequence or
    head-dim shard, or a partial sum, is made whole first); k and v take
    q's batch shards, and its head shards where K divides as H does, else
    stay whole.  Then the rank picks its query heads' KV heads itself — the
    kernel's GQA map works on local indices, and rank r's local head j is
    global head h0 + j with KV head (h0 + j) // (H/K): a slice where the
    rank's heads cover whole groups, else one gathered KV head a query
    head.  Their gradient is then the rank's part of a sum
    (``Partial``)."""
    mesh = q.device_mesh
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qp = tuple(p if p in (Shard(0), Shard(2)) else Replicate()
               for p in q.placements)
    split = 1
    for m, p in enumerate(qp):
        if p == Shard(2):
            split *= mesh.size(m)
    kv_split = K % split == 0
    kp = tuple(p if p == Shard(0) or kv_split else Replicate() for p in qp)
    gp = tuple(Partial() if p == Shard(2) and not kv_split else kp[m]
               for m, p in enumerate(qp))
    h0 = local_shape_and_offset(q.shape, mesh, qp)[1][2]

    def body(ql, kl, vl):
        n = ql.shape[2]
        if not kv_split:
            if h0 % G == 0 and n % G == 0:
                kl = kl[:, :, h0 // G:(h0 + n) // G]
                vl = vl[:, :, h0 // G:(h0 + n) // G]
            else:
                idx = torch.arange(h0, h0 + n, device=kl.device) // G
                kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
        return flash_attention_gqa(ql, kl, vl, causal=causal, window=window)

    return local_map(body, out_placements=list(qp), in_placements=(qp, kp, kp),
                     in_grad_placements=(qp, gp, gp), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


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


def _ring_write(buf, dim: int, slot: int, val) -> None:
    """``buf[..., slot, ...] = val`` in place, ``slot`` indexing dimension
    ``dim``.  On a ``DTensor`` cache only the rank whose shard of ``dim``
    holds the slot writes, into its local shard, ``val`` laid out as the
    cache's other dimensions are."""
    if isinstance(buf, DTensor):
        mesh, pl = buf.device_mesh, buf.placements
        shape, off = local_shape_and_offset(buf.shape, mesh, pl)
        if isinstance(val, DTensor):
            vp = tuple(Shard(p.dim - (p.dim > dim))
                       if isinstance(p, Shard) and p.dim != dim
                       else Replicate() for p in pl)
            val = val.redistribute(mesh, vp).to_local()
        buf, slot = buf.to_local(), slot - off[dim]
        if not 0 <= slot < shape[dim]:
            return
    buf[(slice(None),) * dim + (slot,)] = val


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
    _ring_write(ck, 1, slot, k_new[:, 0])
    _ring_write(cv, 1, slot, v_new[:, 0])
    _ring_write(cpos, 0, slot, pos)
    ck = logical(ck, "batch", "seq_kv", "kv_heads_cache", None)
    cv = logical(cv, "batch", "seq_kv", "kv_heads_cache", None)

    scores = _gqa_scores(q, ck, cfg).float()               # (B, H, 1, cap)
    valid = (cpos >= 0) & (cpos <= pos)
    if mode == "local":
        valid &= cpos > pos - cfg.window
    scores = torch.where(valid[None, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    return _gqa_out(probs, cv, p.wo, B, 1, cfg), cache
