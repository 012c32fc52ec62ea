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

Sharding is name-based, as in the reference: :func:`param_axes` and
:func:`cache_axes` give each parameter and decode-state entry its logical
axes from the last component of its name, and the residual stream is
constrained between blocks (``launch.shardings.logical``; a no-op on plain
tensors).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn
from torch.utils import checkpoint as _ckpt

from ..configs.base import ModelConfig
from ..core._device import resolve_device
from ..launch.shardings import logical, unshard
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


def _residual(y):
    """``y`` placed as the residual stream (``seq_res``).  Applied to each
    block's output before it is added, so the sum's placement is decided
    here — an explicit redistribution, whose backward hands the block's
    products a gradient whole on the sequence — and not by the addition
    (whose own redistribution would hand them a (batch, sequence)-sharded
    one: a strided shard in the products' backward)."""
    return logical(y, "batch", "seq_res", "embed")


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

    def _ffn(self, x, full_seq: bool = False):
        """(x + the MLP or MoE of ln2(x), MoE aux or None).  ``full_seq``
        (the full-sequence forward): ln2(x) pinned by ``seq_norm`` and made
        whole on the sequence for the products, their output placed as the
        residual stream (:func:`_residual`)."""
        if self.ln2 is None:
            return x, None
        h = self.ln2(x)
        if full_seq:
            h = unshard(logical(h, "batch", "seq_norm", "embed"), 1)
        if self.mlp is not None:
            y, aux = self.mlp(h), None
        else:
            y, aux = moe_mod.moe_mlp(self.moe, h, self.cfg)
        return x + (_residual(y) if full_seq else y), aux

    def forward(self, x, positions, enc_out=None):
        """(x, MoE aux or None) over the whole sequence; the residual stream
        is held sequence-sharded between blocks (``seq_res``), each block's
        normed input made whole on the sequence for its products."""
        cfg = self.cfg
        x = _residual(x)
        h = unshard(logical(self.ln1(x), "batch", "seq_norm", "embed"), 1)
        if self.attn is not None:
            y = attn.attention(self.attn, h, cfg, positions=positions,
                               mode=ATTN_MODE[self.kind])
        elif self.rec is not None:
            y = ssm_mod.rglru_forward(self.rec, h, cfg)
        else:
            y = ssm_mod.ssd_forward(self.ssd, h, cfg)
        x = x + _residual(y)
        if self.cross is not None:
            x = x + _residual(attn.attention(
                self.cross, unshard(self.ln_x(x), 1), cfg,
                positions=positions, mode="cross",
                enc_out=unshard(enc_out, 1)))
        x, aux = self._ffn(x, full_seq=True)
        return _residual(x), aux

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


# ---------------------------------------------------------------------------
# shapes and name-based sharding axes
# ---------------------------------------------------------------------------

def param_shapes(cfg: ModelConfig) -> dict:
    """{parameter name: shape} of ``cfg``'s model, from a storage-free
    ``device="meta"`` skeleton."""
    return {k: p.shape for k, p in
            Transformer(cfg, device="meta").named_parameters()}


_AXES_TABLE = {
    "wq": ("p_embed", "p_heads"), "wk": ("p_embed", "p_kv_heads"),
    "wv": ("p_embed", "p_kv_heads"), "wo": ("p_heads", "p_embed"),
    "bq": ("p_heads",), "bk": ("p_kv_heads",), "bv": ("p_kv_heads",),
    "up": ("p_embed", "p_ff"), "gate": ("p_embed", "p_ff"),
    "down": ("p_ff", "p_embed"),
    "tok": ("p_vocab", "p_embed"), "unembed": ("p_embed", "p_vocab"),
    "router": ("p_embed", None),
    "w_gate": ("p_experts", "p_embed", "p_expert_ff"),
    "w_up": ("p_experts", "p_embed", "p_expert_ff"),
    "w_down": ("p_experts", "p_expert_ff", "p_embed"),
    "in_proj": ("p_embed", "p_ff"), "out_proj": ("p_ff", "p_embed"),
    "w_main": ("p_embed", "p_ff"), "w_gate_br": ("p_embed", "p_ff"),
    "w_r": ("p_ff", None), "w_i": ("p_ff", None), "w_out": ("p_ff", "p_embed"),
    "w": (None, "p_ff"),                       # conv kernels
    "scale": (None,), "lam": ("p_ff",),
    "A_log": (None,), "D": (None,), "dt_bias": (None,),
}

# KV caches shard on the SEQUENCE dim over the model axis ("seq_kv"):
# kv_heads (often 8) rarely divide a 16-way model axis, and the
# divisibility fallback would replicate the dominant decode buffer
_CACHE_AXES_TABLE = {
    "k": ("batch", "seq_kv", "kv_heads_cache", None),
    "v": ("batch", "seq_kv", "kv_heads_cache", None),
    "pos": ("seq_kv",),
    "cross_k": ("batch", "seq_kv", "kv_heads_cache", None),
    "cross_v": ("batch", "seq_kv", "kv_heads_cache", None),
    "conv": ("batch", None, "ff"),
}


def _axes(table: dict, name: str, ndim: int) -> tuple:
    """The reference's ``_axes_by_name`` rule for one leaf: the table's axes
    of the name's last component; one short, a leading ``"layers"`` axis
    (the reference's stacked period dimension, replicated by every rule
    set); any other length, or no entry, replicated."""
    ax = table.get(name.rpartition(".")[2])
    if ax is None:
        return (None,) * ndim
    if len(ax) == ndim - 1:
        ax = ("layers",) + tuple(ax)
    return tuple(ax) if len(ax) == ndim else (None,) * ndim


def param_axes(shapes: dict) -> dict:
    """{parameter name: logical axes} for {name: shape} (or tensors)."""
    return {k: _axes(_AXES_TABLE, k, len(s)) for k, s in
            ((k, getattr(v, "shape", v)) for k, v in shapes.items())}


def cache_axes(state: dict) -> dict:
    """Logical axes parallel to a decode state (``init_decode_state``):
    KV rings by :data:`_CACHE_AXES_TABLE`, an SSD state ``h`` (B, H, N, P)
    by batch and heads, an RG-LRU ``h`` (B, w) by batch and ff."""
    def one(name, t):
        if name == "h":
            return (("batch", "heads", None, None) if t.dim() >= 4
                    else ("batch", "ff"))
        return _axes(_CACHE_AXES_TABLE, name, t.dim())
    return {"layers": [{k: one(k, t) for k, t in c.items()}
                       for c in state["layers"]]}
