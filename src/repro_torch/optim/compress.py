"""Gradient / halo compression with error feedback (the port of the
reference's ``repro/optim/compress.py``).

``quantize_int8`` is a per-tensor max-abs int8 quantizer; ``ef_compress``
carries the quantization residual into the next call (error feedback,
Karimireddy et al. 2019), so a compressed sum is unbiased over steps.
The collectives work on the distributed layer's stacks (``core.
distributed``: a rank holds the rows ``mesh.shards`` of a (P, ...) stack):
``compressed_psum`` sums the P shards' int8-quantized values under one
shared scale, ``compressed_halo_exchange`` sends int8 halo payloads and
each sender's scale through the layer's halo exchange H.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core import distributed as _dist


def _scale(x: torch.Tensor) -> torch.Tensor:
    return x.abs().max() / 127.0 + 1e-30


def _acc(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.promote_types(x.dtype, torch.float32))


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale): q = round(x / scale) clipped to ±127, scale =
    max |x| / 127 (a scalar in x's dtype, f32 at least)."""
    x = _acc(x)
    scale = _scale(x)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(scale.dtype) * scale


def ef_compress(x: torch.Tensor, err: torch.Tensor):
    """Error-feedback compression: (q, scale, new residual)."""
    corrected = x + err
    q, scale = quantize_int8(corrected)
    return q, scale, corrected - dequantize_int8(q, scale)


def compressed_psum(x: torch.Tensor, mesh) -> torch.Tensor:
    """Σ over the P shards of the stack ``x`` (P_loc, ...) — the rank's
    rows — through int8 payload semantics: the shared scale is the maximum
    of the shards' max-abs scales (an all-reduce ``MAX`` over the mesh's
    group), each shard's values are quantized with it and summed as int32
    (an all-reduce ``SUM``), then scaled back.  Returns the sum (...), the
    same on every rank."""
    xf = _acc(x)
    scale = (xf.reshape(xf.shape[0], -1).abs().amax(1) / 127.0 + 1e-30).max()
    if mesh.group is not None:
        import torch.distributed as dist
        dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=mesh.group)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int32)
    return _dist._shard_sum(mesh, q).to(xf.dtype) * scale


def compressed_halo_exchange(x: torch.Tensor, h_lo: int, h_hi: int,
                             mesh) -> torch.Tensor:
    """Quantized halo exchange (forward only) on the stack ``x`` (P_loc,
    n_loc): each shard quantizes its values with its own max-abs scale,
    sends its int8 tail and head through H, and sends its scale beside
    them; a halo is dequantized with the sender's scale.  Returns (P_loc,
    h_lo + n_loc + h_hi) — [left neighbour's tail | own | right
    neighbour's head] in x's dtype (f32 at least) — with the own segment
    exact and zeros at the ends of the shard line."""
    xf = _acc(x)
    scale = xf.abs().amax(-1) / 127.0 + 1e-30                 # (P_loc,)
    q = torch.clamp(torch.round(xf / scale[:, None]), -127,
                    127).to(torch.int8)
    qh = _dist._halo_run(_dist.halo_program(h_lo, h_hi, mesh), q)
    sh = _dist._halo_run(_dist.halo_program(1, 1, mesh), scale[:, None])
    n = x.shape[-1]
    parts = []
    if h_lo:
        parts.append(qh[:, :h_lo].to(xf.dtype) * sh[:, :1])
    parts.append(xf)
    if h_hi:
        parts.append(qh[:, h_lo + n:].to(xf.dtype) * sh[:, 2:])
    return torch.cat(parts, -1)
