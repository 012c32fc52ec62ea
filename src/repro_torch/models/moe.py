"""Mixture-of-Experts layer (granite-moe, dbrx).

The port of the reference's ``repro/models/moe.py``: sort-based capacity
dispatch.  Within each sequence (a row of the batch) the token copies are
stably sorted by expert id, gathered into an (E, C, d) buffer of C slots
an expert, run through the batched expert MLPs at their active-parameter
FLOPs, and gathered back with the renormalised top-k gate weights.  Copies
past an expert's capacity C are dropped (the residual stream carries the
token).  The expert products are plain batched matrix products (the
reference leaves them to XLA, outside any Pallas kernel); the routing is
gathers only, as in the reference.  On ``DTensor`` activations the routing
runs on each rank's batch rows (``local_map``) and the expert products
shard the experts over the model axis.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..configs.base import ModelConfig
from ..launch.shardings import logical
from .layers import dense_init, pdtype


def moe_capacity(cfg: ModelConfig, seq: int) -> int:
    """Slots an expert takes per sequence: seq·k/E·capacity_factor,
    rounded up to a multiple of 8, at least 8."""
    c = int(seq * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


class MoE(nn.Module):
    """``router`` (d, E) and the experts' ``w_gate``, ``w_up`` (E, d, f)
    and ``w_down`` (E, f, d), initialised at the reference's scales
    (0.02 for the router, 1/√shape[0] for the experts)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        d, E, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
        dt = pdtype(cfg)
        self.router = dense_init(gen, (d, E), dt, device, scale=0.02)
        self.w_gate = dense_init(gen, (E, d, f), dt, device)
        self.w_up = dense_init(gen, (E, d, f), dt, device)
        self.w_down = dense_init(gen, (E, f, d), dt, device)


def route(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """(router probabilities (B, S, E) f32, top-k gates (B, S, k) f32 and
    their expert ids (B, S, k))."""
    logits = (x @ p.router.to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, cfg.top_k, dim=-1)
    return probs, gate_vals, expert_idx


def _dispatch(x, expert_idx, E: int, C: int):
    """Per batch row: (the (B, E, C, d) expert buffer, each token copy's
    slot (B, S·k) — E·C for a dropped copy — and the share of copies
    routed to each expert (B, E) f32)."""
    B, S, d = x.shape
    k = expert_idx.shape[-1]
    dt, dev = x.dtype, x.device
    # sort-based routing: copy j of token t is entry t·k + j
    eidx = expert_idx.reshape(B, S * k)
    order = torch.argsort(eidx, dim=1, stable=True)           # sorted → copy
    se = torch.gather(eidx, 1, order)                         # sorted experts
    st = order // k                                           # token of copy
    # bincount per row, as a scatter-add of known length (torch.bincount
    # reads its input's max on the host: a sync a layer in decode)
    rows = torch.arange(B, device=dev)[:, None] * E
    counts = torch.zeros(B * E, dtype=eidx.dtype, device=dev).index_add_(
        0, (eidx + rows).reshape(-1), torch.ones_like(eidx).reshape(-1)
    ).reshape(B, E)
    seg_start = torch.cumsum(counts, dim=1) - counts
    rank = (torch.arange(S * k, device=dev)[None, :]
            - torch.gather(seg_start, 1, se))

    # dispatch: slot (e, c) ← token st[seg_start[e] + c]
    c_idx = torch.arange(C, device=dev)
    pos = seg_start[:, :, None] + c_idx[None, None, :]        # (B, E, C)
    valid = (c_idx[None, None, :] < counts[:, :, None]).reshape(B, E * C)
    pos_c = pos.clamp(0, S * k - 1).reshape(B, E * C)
    tok = torch.gather(st, 1, pos_c)                          # (B, E·C)
    xin = torch.gather(x, 1, tok[..., None].expand(B, E * C, d))
    buf = torch.where(valid[..., None], xin,
                      torch.zeros((), dtype=dt, device=dev)).reshape(
                          B, E, C, d)

    # copy j of token t reads its slot (E·C: the zero row of a dropped copy)
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(S * k, device=dev).expand(B, S * k))
    slot_flat = torch.where(rank < C, se * C + rank, E * C)
    slot_of_copy = torch.gather(slot_flat, 1, inv)            # (B, S·k)
    return buf, slot_of_copy, counts.float() / (S * k)


def _combine(out, slot_of_copy, gate_vals):
    """Per batch row: each token's gate-weighted sum of its copies' expert
    outputs (a dropped copy reads a zero row)."""
    B, E, C, d = out.shape
    S, k = gate_vals.shape[1:]
    flat = torch.cat([out.reshape(B, E * C, d),
                      torch.zeros((B, 1, d), dtype=out.dtype,
                                  device=out.device)], dim=1)
    per_copy = torch.gather(flat, 1,
                            slot_of_copy[..., None].expand(B, S * k, d))
    per_copy = per_copy.reshape(B, S, k, d) * gate_vals[..., None]
    return per_copy.sum(dim=2)


def _per_row(fn, like, n_in: int, n_out: int):
    """``fn`` itself on plain tensors; on ``DTensor``\\ s (``like`` the
    activations) ``fn`` under ``local_map`` on each rank's batch rows —
    every tensor in and out sharded by batch as ``like`` is, whole
    otherwise.  The routing is row-local: sorts, gathers and scatter-adds
    need no other rank."""
    if not isinstance(like, DTensor):
        return fn
    rows = tuple(p if p == Shard(0) else Replicate() for p in like.placements)
    return local_map(fn, out_placements=(rows,) * n_out if n_out > 1
                     else list(rows), in_placements=(rows,) * n_in,
                     device_mesh=like.device_mesh, redistribute_inputs=True)


def moe_mlp(p: MoE, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) → (y (B, S, d), the Switch-style load-balance loss, an
    f32 scalar)."""
    B, S, d = x.shape
    E = cfg.n_experts
    C = moe_capacity(cfg, S)
    dt = x.dtype

    probs, gate_vals, expert_idx = route(p, x, cfg)
    gate_vals = (gate_vals / gate_vals.sum(-1, keepdim=True)).to(dt)
    buf, slot_of_copy, frac_routed = _per_row(
        lambda x_, i_: _dispatch(x_, i_, E, C), x, 2, 3)(x, expert_idx)

    # load-balance aux from the routing counts
    mean_prob = probs.mean(dim=1)
    aux = E * (frac_routed * mean_prob).sum(-1).mean()

    # the expert-parallel boundary: batch → data, experts → model
    buf = logical(buf, "batch", "experts", "expert_cap", "embed")

    # the batched expert MLPs
    g = torch.einsum("becd,edf->becf", buf, p.w_gate.to(dt))
    u = torch.einsum("becd,edf->becf", buf, p.w_up.to(dt))
    h = torch.nn.functional.silu(g) * u
    out = torch.einsum("becf,efd->becd", h, p.w_down.to(dt))
    out = logical(out, "batch", "experts", "expert_cap", "embed")

    y = _per_row(_combine, x, 3, 1)(out, slot_of_copy, gate_vals)
    return logical(y, "batch", "seq", "embed"), aux
