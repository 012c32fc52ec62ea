"""Architecture assembly: one decoder (and, for whisper, an encoder) that
covers all ten architectures of the registry through the config's layer
pattern — prefill forward and one-token decode.

The port of the reference's ``repro/models/transformer.py``.  Layer kinds:
``attn`` (causal), ``attn_local`` (sliding window), ``attn_bidir`` (the
encoder's), ``moe`` (causal attention + a MoE in place of the MLP), ``rec``
(RG-LRU) and ``ssd`` (Mamba-2); an encoder-decoder model gives every decoder
layer an ``ln_x`` + ``cross`` attention sub-layer over the encoder's output.
The reference scans a stacked layer period; here the layers are an
``nn.ModuleList`` walked by a plain loop, named as the reference's parameter
keys (``layers.{n}.moe.router``, ``layers.{n}.ssd.conv.w``,
``encoder.layers.{n}.attn.wq``, ``encoder.final_norm.scale``, …).  The
parameters are trainable; ``cfg.remat`` is the reference's ``_maybe_remat``
with the layer as its unit (the reference checkpoints a scanned period; the
gradients are the same): ``none``, ``full`` (each layer under
``torch.utils.checkpoint``, only its input saved) or ``dots`` (a selective
checkpoint that saves the layer's 2-D matrix products and recomputes the
rest, the reference's ``checkpoint_dots_with_no_batch_dims``).  Decode
never differentiates: ``init_decode_state`` and ``decode_step`` run under
``torch.no_grad()``.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from ..configs.base import ModelConfig
from ..core._device import resolve_device
from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import MLP, Embed, RMSNorm, adtype, pdtype

#: the 2-D matrix products that ``remat="dots"`` keeps (a ``x @ w`` of any
#: rank lowers to one of them; batched products are recomputed)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (_ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(fn, cfg: ModelConfig):
    """``fn`` under the remat policy of ``cfg`` when gradients are being
    recorded (the reference's ``_maybe_remat``); ``fn`` itself otherwise."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat policy {cfg.remat!r}")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            _ckpt.create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(_ckpt.checkpoint, fn, use_reentrant=False, **kw)


#: attention mode of each attention-bearing layer kind
ATTN_MODE = {"attn": "causal", "attn_local": "local", "attn_bidir": "bidir",
             "moe": "causal"}


class DecoderLayer(nn.Module):
    """``x + mixer(ln1(x))`` (attention, RG-LRU or SSD), then with
    ``cross`` ``x + cross(ln_x(x), enc_out)``, then ``x + mlp(ln2(x))`` (or
    the MoE for ``moe``; no MLP without ``d_ff``)."""

    def __init__(self, cfg: ModelConfig, kind: str, gen: torch.Generator,
                 device, *, cross: bool):
        super().__init__()
        if kind not in ATTN_MODE and kind not in ("rec", "ssd"):
            raise ValueError(f"unknown layer kind {kind!r}")
        dt = pdtype(cfg)
        self.cfg, self.kind = cfg, kind
        self.ln1 = RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
        self.attn = self.rec = self.ssd = None
        if kind in ATTN_MODE:
            self.attn = attn.Attention(cfg, gen, device)
        elif kind == "rec":
            self.rec = ssm_mod.RGLRU(cfg, gen, device)
        else:
            self.ssd = ssm_mod.SSD(cfg, gen, device)
        self.ln2 = self.mlp = self.moe = None
        if kind == "moe":
            self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
            self.moe = moe_mod.MoE(cfg, gen, device)
        elif cfg.d_ff:
            self.ln2 = RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
            self.mlp = MLP(cfg, gen, device)
        self.ln_x = self.cross = None
        if cross:
            self.ln_x = RMSNorm(cfg.d_model, cfg.norm_eps, dt, device)
            self.cross = attn.Attention(cfg, gen, device, cross=True)

    def _ffn(self, x):
        """(x + the MLP or MoE of ln2(x), MoE aux or None)."""
        if self.mlp is not None:
            return x + self.mlp(self.ln2(x)), None
        if self.moe is not None:
            y, aux = moe_mod.moe_mlp(self.moe, self.ln2(x), self.cfg)
            return x + y, aux
        return x, None

    def forward(self, x, positions, enc_out=None):
        """(x, MoE aux or None) over the whole sequence."""
        cfg = self.cfg
        h = self.ln1(x)
        if self.attn is not None:
            x = x + attn.attention(self.attn, h, cfg, positions=positions,
                                   mode=ATTN_MODE[self.kind])
        elif self.rec is not None:
            x = x + ssm_mod.rglru_forward(self.rec, h, cfg)
        else:
            x = x + ssm_mod.ssd_forward(self.ssd, h, cfg)
        if self.cross is not None:
            x = x + attn.attention(self.cross, self.ln_x(x), cfg,
                                   positions=positions, mode="cross",
                                   enc_out=enc_out)
        return self._ffn(x)

    def init_state(self, batch: int, seq_len: int, dtype, enc_out=None
                   ) -> dict:
        """This layer's decode state: the KV ring (``k``, ``v``, ``pos``)
        or the recurrent state (``h``, ``conv``), and the cross K/V
        (``cross_k``, ``cross_v``) projected once from the encoder."""
        cfg, dev = self.cfg, self.ln1.scale.device
        if self.kind == "rec":
            c = ssm_mod.init_rglru_state(cfg, batch, dtype, dev)
        elif self.kind == "ssd":
            c = ssm_mod.init_ssd_state(cfg, batch, dtype, dev)
        else:
            mode = ATTN_MODE[self.kind]
            c = attn.init_cache(cfg, batch,
                                attn.cache_capacity(cfg, mode, seq_len),
                                mode, dtype, dev)
        if self.cross is not None:
            c["cross_k"], c["cross_v"] = attn._project_kv(
                self.cross, enc_out, cfg, cross=True)
        return c

    def decode(self, x, c: dict, pos):
        """One token: (x, c) with ``c`` updated in place."""
        cfg = self.cfg
        h = self.ln1(x)
        if self.attn is not None:
            y, _ = attn.decode_attention(self.attn, h, c, cfg, pos=pos,
                                         mode=ATTN_MODE[self.kind])
        elif self.rec is not None:
            y, st = ssm_mod.rglru_step(self.rec, h, c, cfg)
            c.update(st)
        else:
            y, st = ssm_mod.ssd_step(self.ssd, h, c, cfg)
            c.update(st)
        x = x + y
        if self.cross is not None:
            y, _ = attn.decode_attention(
                self.cross, self.ln_x(x), None, cfg, pos=pos, mode="cross",
                cross_kv=(c["cross_k"], c["cross_v"]))
            x = x + y
        return self._ffn(x)[0], c


class Encoder(nn.Module):
    """Whisper's encoder over precomputed frame embeddings (the frontend is
    a stub in the reference too): ``attn_bidir`` layers and a final norm."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, "attn_bidir", gen, device, cross=False)
            for _ in range(cfg.n_enc_layers))
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, pdtype(cfg),
                                  device)

    def forward(self, enc_frames: torch.Tensor) -> torch.Tensor:
        x = enc_frames.to(adtype(self.cfg))
        B, F = x.shape[:2]
        pos = torch.arange(F, device=x.device)[None].expand(B, F)
        for layer in self.layers:
            x, _ = _maybe_remat(layer, self.cfg)(x, pos)
        return self.final_norm(x)


class Transformer(nn.Module):
    """The LM of any registry architecture.  ``device=None`` means
    ``"cuda"`` and raises without a card; weights come from a seeded
    ``torch.Generator`` on that device (the reference's scales) or from the
    reference through ``convert.model_from_jax``.  ``device="meta"`` builds
    a skeleton with no storage (the train step binds its parameters)."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = None
        if dev.type != "meta":
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
        self.cfg = cfg
        self.embed = Embed(cfg, gen, dev)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, kind, gen, dev, cross=cfg.enc_dec)
            for kind in cfg.pattern_layers)
        self.final_norm = RMSNorm(cfg.d_model, cfg.norm_eps, pdtype(cfg), dev)
        self.encoder = Encoder(cfg, gen, dev) if cfg.enc_dec else None

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device

    def _encode(self, enc_frames: Optional[torch.Tensor]):
        if self.encoder is None:
            return None
        if enc_frames is None:
            raise ValueError(f"{self.cfg.name} is an encoder-decoder: pass "
                             "enc_frames (B, frames, d_model)")
        return self.encoder(enc_frames)

    def forward(self, tokens: torch.Tensor, positions: Optional[torch.Tensor]
                = None, patches: Optional[torch.Tensor] = None,
                enc_frames: Optional[torch.Tensor] = None,
                last_only: bool = False, return_hidden: bool = False):
        """Full-sequence forward.  Returns (logits (B, S, V) f32, f64 for an
        f64 model; aux), aux the f32 sum of the MoE layers' load-balance
        losses (0 without).
        ``patches`` (B, P, d) are prefix embeddings (the VLM stub);
        ``enc_frames`` (B, F, d) the encoder's input (encoder-decoders);
        ``last_only`` unembeds only the last position (prefill serving);
        ``return_hidden`` returns the final-normed hidden states instead."""
        x = self.embed.embed(tokens)
        if patches is not None:
            x = torch.cat([patches.to(x.dtype), x], dim=1)
        B, S, _ = x.shape
        if positions is None:
            positions = torch.arange(S, device=x.device)[None].expand(B, S)
        enc_out = self._encode(enc_frames)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for layer in self.layers:
            x, a = _maybe_remat(layer, self.cfg)(x, positions, enc_out)
            if a is not None:
                aux = aux + a
        x = self.final_norm(x)
        if return_hidden:
            return x, aux
        if last_only:
            x = x[:, -1:]
        return self.embed.logits(x), aux

    @torch.no_grad()
    def init_decode_state(self, batch: int, seq_len: int,
                          enc_frames: Optional[torch.Tensor] = None) -> dict:
        """One entry a layer for a ``seq_len`` context: a KV ring (capped at
        the window for local layers), a recurrent state, and for an
        encoder-decoder the cross K/V of the encoded ``enc_frames``."""
        enc_out = self._encode(enc_frames)
        dt = adtype(self.cfg)
        return {"layers": [layer.init_state(batch, seq_len, dt, enc_out)
                           for layer in self.layers]}

    @torch.no_grad()
    def decode_step(self, state: dict, token: torch.Tensor, pos):
        """One serve step: ``token`` (B, 1) at absolute position ``pos`` →
        (logits (B, 1, V) as :meth:`forward`'s, state).  The entries of
        ``state`` are updated in place."""
        x = self.embed.embed(token)
        caches = state["layers"]
        for i, layer in enumerate(self.layers):
            x, caches[i] = layer.decode(x, caches[i], pos)
        return self.embed.logits(self.final_norm(x)), state
