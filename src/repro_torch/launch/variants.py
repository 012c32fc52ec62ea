"""Named configuration variants for the hypothesis → change → measure loop.

The port of the reference's ``repro/launch/variants.py``: each variant is
(rules builder, config transform), and the dry run records its cells under
the variant's name so that roofline terms before and after a change sit
side by side in its JSONL.
"""
from __future__ import annotations

import dataclasses

from ..configs.base import ModelConfig
from . import shardings as sh


def _identity(cfg: ModelConfig) -> ModelConfig:
    return cfg


def _tp_allreduce_rules(mesh) -> sh.Rules:
    """Paper-naive TP: seq-replicated residual stream (all-reduce after every
    row-parallel matmul, full-size remat saves) — the pre-seq_res baseline."""
    r = sh.baseline_rules(mesh)
    r.table["seq_res"] = None
    return r


def _bf16_params(cfg: ModelConfig) -> ModelConfig:
    """H1: parameters in bf16 (f32 optimizer moments unchanged) — halves the
    FSDP all-gather / grad reduce-scatter payloads and the parameter HBM
    traffic."""
    return dataclasses.replace(cfg, param_dtype="bfloat16")


def _moe_tight_capacity(cfg: ModelConfig) -> ModelConfig:
    """H2 (MoE): capacity factor 1.25 → 1.0 — cuts the (B,E,C,d) all-to-all
    payload and expert FLOPs by 20% at the cost of more dropped tokens."""
    return dataclasses.replace(_bf16_params(cfg), capacity_factor=1.0)


def _ssm_seqpar(cfg: ModelConfig) -> ModelConfig:
    """H3 (SSM): sequence-domain decomposition of the SSD mixer across the
    model axis with neighbour state passing (``models.ssm.
    _ssd_seq_parallel``); per-card mixer work drops ~16×."""
    return dataclasses.replace(_bf16_params(cfg), seq_shards_mixer=16)


def _seqpar_rules(mesh) -> sh.Rules:
    """The segments of the SSD mixer (``seq_mixer``) over the model axis,
    which then belongs to the sequence, not to heads or ff."""
    r = sh.baseline_rules(mesh)
    r.table["seq_mixer"] = "model"
    r.table["seq"] = sh.SKIP        # let seq sharding propagate from seq_res
    r.table["heads"] = None
    r.table["kv_heads"] = None
    r.table["ff"] = None
    return r


def _h5_rules(mesh) -> sh.Rules:
    """H5: pin bf16 norm outputs to the sequence-sharded layout, so the
    gather moves the 2-byte tensor, not the f32 rmsnorm internals."""
    r = sh.baseline_rules(mesh)
    r.table["seq_norm"] = "model"
    return r


def _dots_remat(cfg: ModelConfig) -> ModelConfig:
    """H4: remat policy full → dots-saveable (keeps matmul outputs, skips
    recompute) — trades HBM bytes for compute-term FLOPs."""
    return dataclasses.replace(_bf16_params(cfg), remat="dots")


def _pack2(cfg: ModelConfig) -> ModelConfig:
    """H7 (memory): two layers a period.  The reference scans periods, so
    its saved remat carries halve; the port checkpoints each layer, so for
    it this variant only renames the pattern."""
    return dataclasses.replace(cfg, layer_pattern=cfg.layer_pattern * 2)


VARIANTS: dict = {
    "baseline": (sh.baseline_rules, _identity),
    "tp_allreduce": (_tp_allreduce_rules, _identity),
    "bf16_params": (sh.baseline_rules, _bf16_params),
    "moe_cap1.0": (sh.baseline_rules, _moe_tight_capacity),
    "ssm_seqpar": (_seqpar_rules, _ssm_seqpar),
    "dots_remat": (sh.baseline_rules, _dots_remat),
    "h5_norm_shard": (_h5_rules, _identity),
    "h5+cap1.0": (_h5_rules, _moe_tight_capacity),
    "pack2": (sh.baseline_rules, _pack2),
}
