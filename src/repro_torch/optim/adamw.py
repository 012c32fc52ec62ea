"""AdamW with decoupled weight decay, global-norm clipping and schedules.

The port of the reference's ``repro/optim/adamw.py``, under its names and
semantics: plain functions over ``dict[str, Tensor]`` keyed by a model's
``named_parameters()`` names, the state ``{"m", "v", "step"}`` with f32
moments and an int32 step count on the parameters' device.  Not a wrapper
of ``torch.optim.AdamW``, whose decay and rounding order differ: here the
gradient is clipped by the global norm, the update is computed in f32, the
decay is decoupled and applies only to tensors of two or more dimensions,
and the result is cast back to the parameter's dtype.  Every function is
out of place: the state it is given stays as it was.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    schedule: str = "cosine"        # cosine | linear | constant


def init_opt_state(params: dict) -> dict:
    """Zero f32 moments beside each parameter and step 0 (int32)."""
    dev = next(iter(params.values())).device
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return {"m": {k: zeros(p) for k, p in params.items()},
            "v": {k: zeros(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an f32 scalar tensor): linear warm-up
    over ``warmup_steps``, then cosine or linear decay to ``min_lr_frac`` of
    ``lr`` at ``total_steps``, or constant."""
    if cfg.schedule not in ("cosine", "linear", "constant"):
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    frac = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * frac))
    else:
        decay = 1.0 - (1.0 - cfg.min_lr_frac) * frac
    return cfg.lr * warm * decay


def global_norm(tree: dict) -> torch.Tensor:
    """√(Σ x²) over every tensor of ``tree``, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree.values()))


def adamw_update(cfg: AdamWConfig, params: dict, grads: dict, state: dict):
    """One AdamW step.  Returns (new params, new state, metrics
    ``{"grad_norm", "lr"}``)."""
    return adamw_apply(cfg, params, grads, state, global_norm(grads))


def adamw_apply(cfg: AdamWConfig, params: dict, grads: dict, state: dict,
                gnorm: torch.Tensor):
    """:func:`adamw_update` with the gradients' global norm given: the rest
    is elementwise, so it runs as well on a rank's shards of params, grads
    and moments placed alike."""
    step = state["step"] + 1
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip > 0 else 1.0)
    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    t = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, t)
    bc2 = 1 - torch.pow(b2, t)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k].to(torch.float32) * scale
        m = b1 * state["m"][k] + (1 - b1) * g
        v = b2 * state["v"][k] + (1 - b2) * g * g
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        pf = p.to(torch.float32)
        if p.dim() >= 2:                       # decoupled decay on matrices
            upd = upd + cfg.weight_decay * pf
        new_p[k] = (pf - lr * upd).to(p.dtype)
        new_m[k], new_v[k] = m, v
    return (new_p, {"m": new_m, "v": new_v, "step": step},
            {"grad_norm": gnorm, "lr": lr})
