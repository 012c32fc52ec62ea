"""Flash attention (online softmax) — wrapper of ``csrc/flash_attention.cu``.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::flash_attention``.
Two forms: :func:`flash_attention_gqa` reads q (B, S, H, d) and k, v
(B, T, K, d) in place through their strides, query head h reading KV head
h // (H/K), and writes o (B, S, H, d); :func:`flash_attention` is the
reference's (BH, S, d) form, the case B = BH, H = K = 1.  On a CUDA tensor
they launch a hand-written Hopper kernel or raise: bf16 runs on the tensor
cores (``wgmma``, K/V tiles by TMA into a warp-specialised pipeline; p·v
as two bf16 passes, p = hi + lo, so p keeps ~16 bits), f32 on the FMA
pipes (all f32, no TF32): a block takes the query heads of one KV head that
share its K/V tiles, loaded by ``cp.async`` into separate double-buffered K
and single V buffers, register tiles fed by 128-bit shared loads, at 128 or
32 query rows a block as :func:`f32_tile` picks.  On a CPU tensor they run
the plain version ``ref.flash_attention_ref`` (p in f32; ``round_p=True``
rounds p to bf16 once, as the reference model's jnp attention does).
``window`` > 0 is the local-attention band i − window < j ≤ i: both
kernels start their KV loop at the first tile the block's band reaches, so
tiles outside it are never loaded.  Bound: operations — 4·d flops per kept
(query, key) pair, 4·B·H·S·T·d without a mask (about halved by the causal
mask at S = T, B·H·d·Σᵢ min(i + 1, window) with a window) — against
(q + k + v + o) bytes.

Training.  :func:`flash_attention_gqa` is one custom operator
(``torch.ops.repro_torch.flash_attention_gqa``, with a fake implementation
for tracers and a FLOP formula) on both devices, differentiable through its
registered backward.  Its forward is the kernel on a CUDA tensor (always: there
is no switch) and the plain version on a CPU tensor; it saves q, k, v and
o.  Its backward, :func:`flash_attention_gqa_bwd`, is plain torch and the
same on both devices, so the CPU tests cover the math the card runs: it
walks blocks of 512 query rows (the reference model's training chunk),
recomputes each block's scores and softmax in f32 under the mask and forms
dq, dk and dv from them.  The reference has no backward kernel either: its
flash kernel has no VJP, and it trains through jnp attention differentiated
by XLA, outside any Pallas kernel.
"""
from __future__ import annotations

import contextlib
import ctypes
import math
import threading

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

from . import _build
from . import ref as _ref

#: launches of the CUDA kernels (plain integers; reset by the caller):
#: the bf16 tensor-core kernel and the f32 SIMT kernel
LAUNCHES = {"flash_attention": 0, "flash_attention_f32": 0}
#: head dims the kernels are built for
HEAD_DIMS = (16, 32, 64, 128, 256)
#: query rows a bf16 block takes (the grid's query tiles must fit 65535)
BF16_ROWS = 128


def f32_tile(B: int, H: int, K: int, S: int, sms: int, d: int = 64
             ) -> tuple:
    """(rows, heads) of the f32 kernel's block for q (B, S, H, d) and K KV
    heads on a card of ``sms`` streaming multiprocessors: the block takes
    ``heads`` query heads of one KV head (the largest of 8, 4, 2, 1
    dividing H/K, so each K/V tile it loads serves all of them) at
    rows/heads query positions.  128 rows when that grid still fills the
    SMs twice over, else 32 rows, so a small batch covers the card (B 2 ×
    32 heads at S 128 on 132 SMs: 256 blocks of 32 rows, not 64 of 128).
    Head dim 256 takes 32 rows always: a 128-row Q tile alone would fill
    133 KB of the block's 227 KB of shared memory."""
    G = H // K
    heads = next(c for c in (8, 4, 2, 1) if G % c == 0)
    if d > 128:
        return 32, heads

    def blocks(rows):
        return B * K * (G // heads) * -(-S // (rows // heads))

    return (128 if blocks(128) >= 2 * sms else 32), heads


def _plain(q, k, v, causal: bool, window: int = 0) -> torch.Tensor:
    """The plain version on the (B, S, H, d) / (B, T, K, d) layout: the KV
    heads expanded to (B·H, T, d), one ``ref.flash_attention_ref`` call."""
    B, S, H, d = q.shape
    T, K = k.shape[1], k.shape[2]

    def heads(t, n):
        t = t.permute(0, 2, 1, 3)[:, :, None]
        return t.expand(B, t.shape[1], H // t.shape[1], n, d).reshape(
            B * H, n, d)

    o = _ref.flash_attention_ref(heads(q, S), heads(k, T), heads(v, T),
                                 causal=causal, window=window)
    return o.reshape(B, H, S, d).transpose(1, 2).contiguous()


def _kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernel can read it in place (head dim
    contiguous; base and strides 16-byte aligned, as TMA needs), else a
    contiguous copy."""
    def ok(x):
        return x.stride(3) == 1 and x.data_ptr() % 16 == 0 and all(
            (x.stride(i) * x.element_size()) % 16 == 0 for i in range(3))
    if ok(t):
        return t
    t = t.contiguous()
    return t if ok(t) else t.clone()


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0
                        ) -> torch.Tensor:
    """softmax(q·kᵀ/√d)·v per batch and query head, f32 inside, out in q's
    dtype, (B, S, H, d) contiguous; differentiable in q, k and v (the
    backward is :func:`flash_attention_gqa_bwd`).

    ``q``: (B, S, H, d); ``k``, ``v``: (B, T, K, d) with K dividing H —
    query head h reads KV head h // (H/K).  ``causal`` keeps key j ≤ query
    i (absolute indices, top-left aligned when T ≠ S); ``window`` > 0
    (causal, T ≥ S, so that every query keeps a key) keeps only
    i − window < j ≤ i.  Any S and T ≥ 1; d in :data:`HEAD_DIMS`; float32
    or bfloat16 on the card."""
    _check_args(q, k, v, causal, int(window))
    return torch.ops.repro_torch.flash_attention_gqa(q, k, v, bool(causal),
                                                     int(window))


# The forward and the backward are custom operators: one op each to the
# dispatcher, so that a shape-only trace (``FakeTensorMode``, or meta
# tensors inside :func:`shape_only` — the dry run) takes their shapes from
# the fake implementations without building or launching the kernel, and a
# FLOP counter counts each once by its formula below.  Elsewhere a
# ``device="meta"`` tensor is refused, as any device but the CPU and a card
# is: a storage-free tensor reaching the kernel outside such a trace is a
# fault (a parameter of a skeleton left unbound).
_TRACE = threading.local()


@contextlib.contextmanager
def shape_only():
    """Let meta tensors through the kernel's fake implementation (its
    output's shape, no values) while the block runs."""
    prev = getattr(_TRACE, "on", False)
    _TRACE.on = True
    try:
        yield
    finally:
        _TRACE.on = prev


@torch.library.custom_op("repro_torch::flash_attention_gqa", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, window: int) -> torch.Tensor:
    return _forward(q, k, v, causal, window)


def _tracer_only(*ts) -> None:
    if getattr(_TRACE, "on", False) and all(t.device.type == "meta"
                                            for t in ts):
        return
    if not all(isinstance(t, FakeTensor) for t in ts):
        raise ValueError("flash_attention: tensors on "
                         f"{' / '.join(str(t.device) for t in ts)}")


@_flash_op.register_fake
def _(q, k, v, causal, window):
    _tracer_only(q, k, v)
    return q.new_empty(q.shape)


@torch.library.custom_op("repro_torch::flash_attention_gqa_bwd",
                         mutates_args=())
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, do: torch.Tensor, causal: bool,
                  window: int) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    return flash_attention_gqa_bwd(q, k, v, o, do, causal=causal,
                                   window=window)


@_flash_bwd_op.register_fake
def _(q, k, v, o, do, causal, window):
    _tracer_only(q, k, v, o, do)
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _flash_setup(ctx, inputs, output):
    q, k, v, causal, window = inputs
    ctx.save_for_backward(q, k, v, output)
    ctx.causal, ctx.window = causal, window


def _flash_backward(ctx, do):
    q, k, v, o = ctx.saved_tensors
    dq, dk, dv = torch.ops.repro_torch.flash_attention_gqa_bwd(
        q, k, v, o, do, ctx.causal, ctx.window)
    return dq, dk, dv, None, None


_flash_op.register_autograd(_flash_backward, setup_context=_flash_setup)


def kept_pairs(S: int, T: int, causal: bool, window: int = 0) -> int:
    """(query, key) pairs the mask keeps for one batch row and head."""
    if not causal:
        return S * T
    cap = min(T, window) if window else T
    # Σ_{i<S} min(i + 1, cap)
    m = min(S, cap)
    return m * (m + 1) // 2 + (S - m) * cap


def _pairs(q_shape, k_shape, causal, window) -> int:
    B, S, H, d = q_shape
    return B * H * kept_pairs(S, k_shape[1], causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_attention_gqa)
def _flash_flops(q_shape, k_shape, v_shape, causal, window, *args,
                 **kwargs) -> int:
    """4·d a kept pair: q·kᵀ and p·v."""
    return 4 * q_shape[3] * _pairs(q_shape, k_shape, causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_attention_gqa_bwd)
def _flash_bwd_flops(q_shape, k_shape, v_shape, o_shape, do_shape, causal,
                     window, *args, **kwargs) -> int:
    """10·d a kept pair: q·kᵀ again, dv, dp, dk and dq (14·d with the
    forward)."""
    return 10 * q_shape[3] * _pairs(q_shape, k_shape, causal, window)


def _check_args(q, k, v, causal: bool, window: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, H, d = q.shape
    T, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != d or K == 0 or H % K:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k/v "
                         f"{tuple(k.shape)} disagree")
    if window < 0 or (window and (not causal or T < S)):
        raise ValueError(f"flash_attention: window {window} needs "
                         f"causal=True and T >= S (got causal={causal}, "
                         f"S={S}, T={T})")


def _forward(q, k, v, causal: bool, window: int) -> torch.Tensor:
    """The forward: the kernel on a CUDA tensor, the plain version on a CPU
    tensor."""
    B, S, H, d = q.shape
    T, K = k.shape[1], k.shape[2]
    if q.device.type == "cpu":
        return _plain(q, k, v, causal, window)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash_attention: tensors on {q.device} / "
                         f"{k.device} / {v.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: dtypes {q.dtype} / {k.dtype} / "
                        f"{v.dtype} differ")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    tag = _build.cuda_dtype_tag(q.dtype, allowed=("f32", "bf16"))
    tile = f32_tile(B, H, K, S, torch.cuda.get_device_properties(
        q.device).multi_processor_count, d) if tag == "f32" else ()
    span = tile[0] // tile[1] if tile else BF16_ROWS    # positions a block
    if T == 0 or -(-S // span) > 65535:
        raise ValueError(f"flash_attention: needs 1 <= T and S <= "
                         f"{65535 * span:,} at {span} query positions a "
                         f"block, got T={T}, S={S}")
    o = torch.empty((B, S, H, d), dtype=q.dtype, device=q.device)
    if B == 0 or S == 0:
        return o
    q, k, v = (_kernel_layout(t) for t in (q, k, v))
    strides = (ctypes.c_longlong * 9)(*(t.stride(i) for t in (q, k, v)
                                        for i in range(3)))
    fn = getattr(_build.lib(), f"flash_attention_{tag}")
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    strides, B, H, K, S, T, d, int(causal), window, *tile,
                    _build.stream_ptr(q)), "flash_attention")
    LAUNCHES["flash_attention" if tag == "bf16" else
             "flash_attention_f32"] += 1
    return o


#: query rows a block of the backward takes (the reference model's chunk)
BWD_ROWS = 512


def flash_attention_gqa_bwd(q, k, v, o, do, *, causal: bool = True,
                            window: int = 0):
    """(dq, dk, dv) of :func:`flash_attention_gqa` for the output gradient
    ``do``, given its inputs and its output ``o``; plain torch, f32 inside
    (f64 for f64), each gradient in its input's dtype.

    A block of :data:`BWD_ROWS` query rows at a time: s = q·kᵀ/√d over the
    keys the mask can reach (up to the block's last row when causal, from
    its first row's band start with a window), p = softmax(s), then
    dv += pᵀ·do,
    ds = p∘(do·vᵀ − rowsum(do∘o)), dq = ds·k/√d, dk += dsᵀ·q/√d.  The H/K
    query heads of a KV head sum into its dk and dv."""
    B, S, H, d = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    acc = torch.promote_types(q.dtype, torch.float32)
    scale = 1.0 / math.sqrt(d)
    kf = k.to(acc).permute(0, 2, 1, 3)                    # (B, K, T, d)
    vf = v.to(acc).permute(0, 2, 1, 3)
    dk = torch.zeros((B, K, T, d), dtype=acc, device=q.device)
    dv = torch.zeros_like(dk)
    dq = torch.empty((B, S, H, d), dtype=q.dtype, device=q.device)
    for i0 in range(0, S, BWD_ROWS):
        i1 = min(S, i0 + BWD_ROWS)
        n = i1 - i0
        lo, hi = 0, T
        if causal:
            hi = min(T, i1)
            if window:
                lo = max(0, i0 - window + 1)

        def heads(t):                                   # (B, K, G, n, d)
            return t[:, i0:i1].to(acc).reshape(B, n, K, G, d).permute(
                0, 2, 3, 1, 4)

        qb, ob, dob = heads(q), heads(o), heads(do)
        kb, vb = kf[:, :, lo:hi], vf[:, :, lo:hi]
        s = torch.einsum("bkgsd,bktd->bkgst", qb, kb) * scale
        if causal:
            i = torch.arange(i0, i1, device=q.device)[:, None]
            j = torch.arange(lo, hi, device=q.device)[None, :]
            keep = j <= i
            if window:
                keep &= j > i - window
            s = torch.where(keep, s, _ref.ATTN_NEG_INF)
        p = torch.softmax(s, dim=-1)
        del s
        dv[:, :, lo:hi] += torch.einsum("bkgst,bkgsd->bktd", p, dob)
        dp = torch.einsum("bkgsd,bktd->bkgst", dob, vb)
        ds = p * (dp - (dob * ob).sum(-1, keepdim=True))
        del p, dp
        dk[:, :, lo:hi] += torch.einsum("bkgst,bkgsd->bktd", ds, qb) * scale
        dqb = torch.einsum("bkgst,bktd->bkgsd", ds, kb) * scale
        dq[:, i0:i1] = dqb.permute(0, 3, 1, 2, 4).reshape(B, n, H, d)
    back = lambda t, like: t.permute(0, 2, 1, 3).to(  # noqa: E731
        like.dtype, memory_format=torch.contiguous_format)
    return dq, back(dk, k), back(dv, v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """The reference's form: ``q`` (BH, S, d), ``k``, ``v`` (BH, T, d) with
    the KV heads already expanded; returns (BH, S, d).  See
    :func:`flash_attention_gqa`."""
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    return flash_attention_gqa(q[:, :, None], k[:, :, None], v[:, :, None],
                               causal=causal)[:, :, 0]
