"""Sequence mixers without attention: Mamba-2 SSD and RG-LRU (Griffin).

The port of the reference's ``repro/models/ssm.py``.  SSD runs in its
chunked form: within a chunk the quadratic "attention" form, across chunks
the state recurrence as a loop over the chunks (the reference's
``lax.scan``); with ``cfg.seq_shards_mixer > 1`` the sequence is split into
segments that run with zero initial state and are corrected by the states
passed from segment to segment.  The RG-LRU's linear recurrence
h_t = a_t h_{t−1} + b_t runs as a Hillis–Steele scan, ⌈log₂ S⌉ passes of
(a, b) ← (a_{t−s} a_t, a_t b_{t−s} + b_t) over the whole sequence (the
reference's ``associative_scan``), so a prefill launches O(log S) kernels,
not O(S), and never takes a cumulative product (a ∈ (0.9, 0.999) would
underflow over thousands of steps).  Its state h stays f32.  Decode keeps an
O(1) state a layer: the conv window and h.  No kernel of the reference
lies on these paths; the products are plain torch.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..configs.base import ModelConfig
from ..launch.shardings import logical, unshard
from .layers import RMSNorm, at_least_f32, dense_init, pdtype

# ---------------------------------------------------------------------------
# causal depthwise conv1d (width w, shared by both mixers)
# ---------------------------------------------------------------------------


class Conv1d(nn.Module):
    """Depthwise causal convolution taps ``w`` (width, channels)."""

    def __init__(self, gen: torch.Generator, channels: int, width: int,
                 dtype, device):
        super().__init__()
        self.w = dense_init(gen, (width, channels), dtype, device, scale=0.5)


def conv1d(p: Conv1d, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C) → the causal depthwise convolution, by static shifts."""
    w = p.w.to(x.dtype)
    width = w.shape[0]
    y = x * w[-1]
    for i in range(1, width):
        shifted = F.pad(x, (0, 0, i, 0))[:, :-i]
        y = y + shifted * w[-1 - i]
    return y


def conv1d_step(p: Conv1d, x_t: torch.Tensor, cache: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_t: (B, C); cache: (B, width − 1, C) past inputs → (y, new cache)."""
    w = p.w.to(x_t.dtype)
    hist = torch.cat([cache, x_t[:, None]], dim=1)          # (B, width, C)
    y = torch.einsum("bwc,wc->bc", hist, w)
    return y, hist[:, 1:]


# ---------------------------------------------------------------------------
# Mamba-2 / SSD (state-space duality, chunked)
# ---------------------------------------------------------------------------

def ssd_dims(cfg: ModelConfig):
    """(inner width, heads, head dim, state size)."""
    d_in = 2 * cfg.d_model
    nheads = d_in // cfg.ssm_head_dim
    return d_in, nheads, cfg.ssm_head_dim, cfg.ssm_state


class SSD(nn.Module):
    """``in_proj`` (d, 2·d_in + 2N + H) → [z | x | B | C | dt], ``conv``
    over [x | B | C], ``A_log``, ``D``, ``dt_bias`` (H,), ``norm`` over
    d_in, ``out_proj`` (d_in, d)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        d = cfg.d_model
        d_in, H, Pd, N = ssd_dims(cfg)
        dt = pdtype(cfg)
        self.in_proj = dense_init(gen, (d, 2 * d_in + 2 * N + H), dt, device)
        self.conv = Conv1d(gen, d_in + 2 * N, cfg.conv_width, dt, device)
        a_log = torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32))
        self.A_log = nn.Parameter(a_log.to(dt).to(device))
        self.D = nn.Parameter(torch.ones((H,), dtype=dt, device=device))
        self.dt_bias = nn.Parameter(torch.zeros((H,), dtype=dt,
                                                device=device))
        self.norm = RMSNorm(d_in, cfg.norm_eps, dt, device)
        self.out_proj = dense_init(gen, (d_in, d), dt, device)


def _ssd_scan(Xd, a, Bm, Cm, chunk: int, h0=None):
    """Core SSD: Xd (B, S, H, P) dt-scaled inputs, a (B, S, H) log-decay
    (≤ 0), Bm / Cm (B, S, N).  Returns (Y (B, S, H, P), final state
    (B, H, N, P))."""
    Bsz, S, H, Pd = Xd.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    S_orig = S
    if S % L:
        pad = L - S % L          # zero pad: a = 0 → decay 1, Xd = 0 → no input
        Xd = F.pad(Xd, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        S = S + pad
    nc = S // L
    acc = torch.promote_types(Xd.dtype, torch.float32)   # f32, f64 for f64

    Xc = Xd.reshape(Bsz, nc, L, H, Pd)
    ac = a.reshape(Bsz, nc, L, H).to(acc)
    Bc = Bm.reshape(Bsz, nc, L, N)
    Cc = Cm.reshape(Bsz, nc, L, N)

    cum = torch.cumsum(ac, dim=2)                            # (B, nc, L, H)
    # intra-chunk: att[i, j] = C_i·B_j · exp(seg_ij), j ≤ i, with
    # seg_ij = Σ_{j<k≤i} a_k summed term by term (a masked cumulative sum):
    # the reference's cum_i − cum_j cancels two sums that reach ~10³ at
    # mamba2-780m's init and keeps only ~|cum|·2⁻²⁴ of the exponent in f32
    # (enough to fail its f32 decode ≡ forward check, PERF.md)
    dev = Xd.device
    cb = torch.einsum("bcin,bcjn->bcij", Cc.to(acc), Bc.to(acc))
    k_gt_j = (torch.arange(L, device=dev)[:, None]
              > torch.arange(L, device=dev)[None, :])
    seg = torch.cumsum(torch.where(k_gt_j, ac.permute(0, 1, 3, 2)[
        ..., :, None], 0.0), dim=-2).permute(0, 1, 3, 4, 2)  # (B, nc, i, j, H)
    tri = (torch.arange(L, device=dev)[:, None]
           >= torch.arange(L, device=dev)[None, :])[None, None, :, :, None]
    # clamp BEFORE exp: the masked upper triangle must not reach the exp
    seg = torch.where(tri, seg, -torch.inf)
    att = torch.where(tri, torch.exp(seg) * cb[..., None], 0.0)
    Y_intra = torch.einsum("bcijh,bcjhp->bcihp", att.to(Xd.dtype), Xc)

    # chunk-final local states: S_c = Σ_j exp(seg_Lj) B_j ⊗ Xd_j
    decay_out = torch.exp(seg[:, :, -1])                     # (B, nc, L, H)
    Sloc = torch.einsum("bcjh,bcjn,bcjhp->bchnp", decay_out.to(Xd.dtype), Bc,
                        Xc)

    # inter-chunk recurrence: h entering chunk c, then h after it
    chunk_decay = torch.exp(cum[:, :, -1, :])                # (B, nc, H)
    h = (torch.zeros((Bsz, H, N, Pd), dtype=Xd.dtype, device=Xd.device)
         if h0 is None else h0)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None].to(h.dtype) + Sloc[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                    # (B, nc, H, N, P)

    Y_inter = torch.einsum("bcin,bchi,bchnp->bcihp", Cc,
                           torch.exp(cum).to(Cc.dtype).permute(0, 1, 3, 2),
                           h_prevs)
    Y = (Y_intra + Y_inter).reshape(Bsz, S, H, Pd)
    return Y[:, :S_orig], h


def _scan(Xd, a, Bm, Cm, chunk: int, lead: int = 1):
    """:func:`_ssd_scan` over ``lead`` leading batch-like dimensions
    (flattened into its batch).  On ``DTensor``\\ s it runs on each rank's
    own rows and heads (``local_map``): those dimensions keep their shards,
    every other is made whole, and B/C — shared by all heads — take a summed
    (``Partial``) gradient where the heads are split.  The chunk products
    would otherwise batch over (rows, heads) together, a strided shard whose
    redistribution plans take a minute an op on a 3-D mesh."""
    def fn(X, a_, B_, C_):
        flat = lambda t: t.reshape(-1, *t.shape[lead:])  # noqa: E731
        Y, h = _ssd_scan(flat(X), flat(a_), flat(B_), flat(C_), chunk)
        return (Y.reshape(*X.shape[:lead], *Y.shape[1:]),
                h.reshape(*X.shape[:lead], *h.shape[1:]))

    if not isinstance(Xd, DTensor):
        return fn(Xd, a, Bm, Cm)
    heads = Shard(lead + 1)
    xp = tuple(p if isinstance(p, Shard) and (p.dim < lead or p == heads)
               else Replicate() for p in Xd.placements)
    bp = tuple(Replicate() if p == heads else p for p in xp)
    bg = tuple(Partial() if p == heads else p for p in xp)
    hp = tuple(Shard(lead) if p == heads else p for p in xp)
    return local_map(fn, out_placements=(xp, hp),
                     in_placements=(xp, xp, bp, bp),
                     in_grad_placements=(xp, xp, bg, bg),
                     device_mesh=Xd.device_mesh,
                     redistribute_inputs=True)(Xd, a, Bm, Cm)


def _ssd_seq_parallel(Xd, a, Bm, Cm, chunk: int, n_sp: int):
    """Sequence-decomposed SSD: each of ``n_sp`` segments runs SSD with zero
    initial state (the segments ride the batch axis of one
    :func:`_ssd_scan`); the boundary states then pass from segment to
    segment and a per-position correction folds the incoming state into
    each segment's output."""
    B, S, H, Pd = Xd.shape
    N = Bm.shape[-1]
    Sl = S // n_sp
    r3 = lambda t: t.reshape(B, n_sp, Sl, *t.shape[2:])
    Xs, as_, Bs, Cs = r3(Xd), r3(a), r3(Bm), r3(Cm)
    Xs = logical(Xs, "batch", "seq_mixer", None, "heads", "head_dim")
    Yl, hf = _scan(Xs, as_, Bs, Cs, chunk, lead=2)

    cum_seg = torch.cumsum(at_least_f32(as_), dim=2)         # (B, n_sp, Sl, H)
    seg_decay = torch.exp(cum_seg[:, :, -1])                  # (B, n_sp, H)
    hf = unshard(hf, 1)       # every segment's boundary state on every rank
    h = torch.zeros_like(hf[:, 0])
    h_ins = []                                               # state entering j
    for j in range(n_sp):
        h_ins.append(h)
        h = seg_decay[:, j, :, None, None].to(h.dtype) * h + hf[:, j]
    h_ins = torch.stack(h_ins, dim=1)

    Y_extra = torch.einsum("bjtn,bjth,bjhnp->bjthp", Cs,
                           torch.exp(cum_seg).to(Cs.dtype), h_ins)
    # laid out as the segments are before the sum (an explicit
    # redistribution: its backward hands the product a gradient whole over
    # the segments, not a (batch, segment)-sharded one)
    Y_extra = logical(Y_extra, "batch", "seq_mixer", None, "heads",
                      "head_dim")
    return (Yl + Y_extra).reshape(B, S, H, Pd)


def _ssd_inputs(p: SSD, zxbcdt, conv_out, cfg: ModelConfig):
    """Split the projections: (z, x, B, C, dt (f32, softplus'd), A (f32))."""
    d_in, H, Pd, N = ssd_dims(cfg)
    z = zxbcdt[..., :d_in]
    dth = zxbcdt[..., 2 * d_in + 2 * N:]
    xs, Bm, Cm = torch.split(conv_out, [d_in, N, N], dim=-1)
    dth = at_least_f32(dth)
    dth = F.softplus(dth + p.dt_bias.to(dth.dtype))
    A = -torch.exp(p.A_log.to(dth.dtype))
    return z, xs, Bm, Cm, dth, A


def ssd_forward(p: SSD, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence SSD mixer (prefill).  With ``cfg.seq_shards_mixer`` > 1
    the sequence is decomposed as in :func:`_ssd_seq_parallel`."""
    B, S, d = x.shape
    d_in, H, Pd, N = ssd_dims(cfg)
    dt_ = x.dtype
    zxbcdt = x @ p.in_proj.to(dt_)
    conv_out = F.silu(conv1d(p.conv, zxbcdt[..., d_in:2 * d_in + 2 * N]))
    z, xs, Bm, Cm, dth, A = _ssd_inputs(p, zxbcdt, conv_out, cfg)
    a = dth * A[None, None, :]                                # log-decay
    Xh = xs.reshape(B, S, H, Pd)
    Xd = Xh * dth[..., None].to(dt_)
    n_sp = cfg.seq_shards_mixer
    if n_sp > 1 and S % n_sp == 0 and (S // n_sp) >= 2:
        Y = unshard(_ssd_seq_parallel(Xd, a, Bm, Cm,
                                      min(cfg.ssm_chunk, S // n_sp), n_sp), 1)
    else:
        Xd = logical(Xd, "batch", "seq", "heads", "head_dim")
        Y, _ = _scan(Xd, a, Bm, Cm, cfg.ssm_chunk)
    Y = Y + Xh * p.D.to(dt_)[None, None, :, None]
    Y = Y.reshape(B, S, d_in)
    Y = p.norm(Y * F.silu(z))
    return logical(Y @ p.out_proj.to(dt_), "batch", "seq", "embed")


def init_ssd_state(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    d_in, H, Pd, N = ssd_dims(cfg)
    return {
        "h": torch.zeros((batch, H, N, Pd), dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, d_in + 2 * N),
                            dtype=dtype, device=device),
    }


def ssd_step(p: SSD, x: torch.Tensor, state: dict, cfg: ModelConfig
             ) -> Tuple[torch.Tensor, dict]:
    """One-token decode.  x: (B, 1, d) → (y (B, 1, d), new state)."""
    B = x.shape[0]
    d_in, H, Pd, N = ssd_dims(cfg)
    dt_ = x.dtype
    zxbcdt = x[:, 0] @ p.in_proj.to(dt_)
    conv_out, conv_cache = conv1d_step(
        p.conv, zxbcdt[..., d_in:2 * d_in + 2 * N], state["conv"])
    z, xs, Bm, Cm, dth, A = _ssd_inputs(p, zxbcdt, F.silu(conv_out), cfg)
    dec = torch.exp(dth * A[None, :])                         # (B, H)
    Xh = xs.reshape(B, H, Pd)
    h = state["h"] * dec[..., None, None].to(dt_)
    h = h + torch.einsum("bn,bhp,bh->bhnp", Bm, Xh, dth.to(dt_))
    y = torch.einsum("bn,bhnp->bhp", Cm, h) + Xh * p.D.to(dt_)[None, :, None]
    y = p.norm(y.reshape(B, d_in) * F.silu(z))
    return (y @ p.out_proj.to(dt_))[:, None], {"h": h, "conv": conv_cache}


# ---------------------------------------------------------------------------
# RG-LRU recurrent block (Griffin / recurrentgemma)
# ---------------------------------------------------------------------------

def lru_width(cfg: ModelConfig) -> int:
    return cfg.lru_width or cfg.d_model


class RGLRU(nn.Module):
    """``w_main``, ``w_gate_br`` (d, w), ``conv`` over w, ``w_r``, ``w_i``
    (w, w), ``lam`` (w,) and ``w_out`` (w, d); Λ is set so that
    a = exp(−8·softplus(Λ)) spans (0.9, 0.999) at r = 1."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device):
        super().__init__()
        d = cfg.d_model
        w = lru_width(cfg)
        dt = pdtype(cfg)
        self.w_main = dense_init(gen, (d, w), dt, device)
        self.w_gate_br = dense_init(gen, (d, w), dt, device)
        self.conv = Conv1d(gen, w, cfg.conv_width, dt, device)
        self.w_r = dense_init(gen, (w, w), dt, device)
        self.w_i = dense_init(gen, (w, w), dt, device)
        lam = torch.log(torch.expm1(-torch.log(torch.linspace(
            0.9, 0.999, w, dtype=torch.float32)) / 8.0))
        self.lam = nn.Parameter(lam.to(dt).to(device))
        self.w_out = dense_init(gen, (w, d), dt, device)


def _rglru_gates(p: RGLRU, u: torch.Tensor):
    """(a, b) of h_t = a_t h_{t−1} + b_t, both f32."""
    r = torch.sigmoid((u @ p.w_r.to(u.dtype)).float())
    i = torch.sigmoid((u @ p.w_i.to(u.dtype)).float())
    log_a = -8.0 * F.softplus(p.lam.float()) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * i * u.float()


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t−1} + b_t along axis 1 from h_{−1} = 0: Hillis–Steele,
    ⌈log₂ S⌉ passes of (a, b)_t ← (a_{t−s} a_t, a_t b_{t−s} + b_t), t ≥ s."""
    S = a.shape[1]
    s = 1
    while s < S:
        b = torch.cat([b[:, :s], torch.addcmul(b[:, s:], a[:, s:], b[:, :-s])],
                      dim=1)
        if 2 * s < S:                   # the last pass needs no new a
            a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return b


def _gelu(x):
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default


def rglru_forward(p: RGLRU, x: torch.Tensor, cfg: ModelConfig
                  ) -> torch.Tensor:
    """Griffin recurrent block over the whole sequence: gate branch ⊙
    (conv → RG-LRU)."""
    dt_ = x.dtype
    gate = _gelu(x @ p.w_gate_br.to(dt_))
    u = logical(conv1d(p.conv, x @ p.w_main.to(dt_)), "batch", "seq", "ff")
    a, b = _rglru_gates(p, u)
    h = linear_scan(a, b).to(dt_)
    return logical((gate * h) @ p.w_out.to(dt_), "batch", "seq", "embed")


def init_rglru_state(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    w = lru_width(cfg)
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                            device=device),
    }


def rglru_step(p: RGLRU, x: torch.Tensor, state: dict, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, dict]:
    """One-token decode.  x: (B, 1, d) → (y (B, 1, d), new state)."""
    dt_ = x.dtype
    x0 = x[:, 0]
    gate = _gelu(x0 @ p.w_gate_br.to(dt_))
    u, conv_cache = conv1d_step(p.conv, x0 @ p.w_main.to(dt_), state["conv"])
    a, b = _rglru_gates(p, u)
    h = a * state["h"] + b
    y = ((gate * h.to(dt_)) @ p.w_out.to(dt_))[:, None]
    return y, {"h": h, "conv": conv_cache}
