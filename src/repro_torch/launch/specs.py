"""Input stand-ins for every (arch × shape) cell: ``device="meta"`` tensors
with the reference's shapes and dtypes, no storage.

The port of the reference's ``repro/launch/specs.py``.  Modality frontends
are stubs, as in the reference: whisper takes precomputed frame
embeddings, qwen2-vl precomputed patch embeddings.  The decode state comes
from the port's own ``init_decode_state`` layout (one entry a layer) on a
storage-free skeleton; its position is a Python ``int``, as the decode path
reads it (``int(pos)``), which a stand-in tensor could not give.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models.layers import adtype
from ..models.transformer import Transformer


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Inputs for train and prefill: the full-sequence forward."""
    B, S = shape.global_batch, shape.seq_len
    act = adtype(cfg)
    specs = {}
    if cfg.vis_patches:
        P = cfg.vis_patches
        specs["tokens"] = _sds((B, S - P), torch.int32)
        specs["patches"] = _sds((B, P, cfg.d_model), act)
    else:
        specs["tokens"] = _sds((B, S), torch.int32)
        if cfg.enc_dec:
            specs["enc_frames"] = _sds((B, cfg.enc_frames, cfg.d_model), act)
    specs["labels"] = _sds((B, S), torch.int32)
    return specs


def decode_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Inputs of one serve step: (state, token, pos).  The state is each
    layer's ``init_state`` on a meta skeleton — ring-capped for local
    layers, O(1) for recurrent ones; an encoder-decoder's cross K/V are
    projected from a stand-in of the encoder's output (B, enc_frames,
    d_model), the shape the encoder gives."""
    B, S = shape.global_batch, shape.seq_len
    act = adtype(cfg)
    model = Transformer(cfg, device="meta")
    enc_out = _sds((B, cfg.enc_frames, cfg.d_model), act) if cfg.enc_dec \
        else None
    with torch.no_grad():
        state = {"layers": [layer.init_state(B, S, act, enc_out)
                            for layer in model.layers]}
    return {"state": state, "token": _sds((B, 1), torch.int32), "pos": 0}


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    if shape.kind == "decode":
        return decode_specs(cfg, shape)
    return batch_specs(cfg, shape)
