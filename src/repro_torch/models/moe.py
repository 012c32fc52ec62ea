"""Mixture-of-Experts layer (granite-moe, dbrx).

The port of the reference's ``repro/models/moe.py``: sort-based capacity
dispatch.  Within each sequence (a row of the batch) the token copies are
stably sorted by expert id, gathered into an (E, C, d) buffer of C slots
an expert, run through the batched expert MLPs at their active-parameter
FLOPs, and gathered back with the renormalised top-k gate weights.  Copies
past an expert's capacity C are dropped (the residual stream carries the
token).  The expert products are plain batched matrix products (the
reference leaves them to XLA, outside any Pallas kernel); the routing is
gathers only, as in the reference.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
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


def moe_mlp(p: MoE, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) → (y (B, S, d), the Switch-style load-balance loss, an
    f32 scalar)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = moe_capacity(cfg, S)
    dt, dev = x.dtype, x.device

    probs, gate_vals, expert_idx = route(p, x, cfg)
    gate_vals = (gate_vals / gate_vals.sum(-1, keepdim=True)).to(dt)

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

    # load-balance aux from the routing counts
    frac_routed = counts.float() / (S * k)
    mean_prob = probs.mean(dim=1)
    aux = E * (frac_routed * mean_prob).sum(-1).mean()

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

    # the batched expert MLPs
    g = torch.einsum("becd,edf->becf", buf, p.w_gate.to(dt))
    u = torch.einsum("becd,edf->becf", buf, p.w_up.to(dt))
    h = torch.nn.functional.silu(g) * u
    out = torch.einsum("becf,efd->becd", h, p.w_down.to(dt))

    # combine: copy j of token t reads its slot (E·C: the zero row of a
    # dropped copy)
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(S * k, device=dev).expand(B, S * k))
    slot_flat = torch.where(rank < C, se * C + rank, E * C)
    slot_of_copy = torch.gather(slot_flat, 1, inv)            # (B, S·k)
    flat = torch.cat([out.reshape(B, E * C, d),
                      torch.zeros((B, 1, d), dtype=dt, device=dev)], dim=1)
    per_copy = torch.gather(flat, 1,
                            slot_of_copy[..., None].expand(B, S * k, d))
    per_copy = per_copy.reshape(B, S, k, d) * gate_vals[..., None]
    return per_copy.sum(dim=2), aux
