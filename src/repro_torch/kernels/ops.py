"""Differentiable operator wrappers over the kernels (port of
``repro.kernels.ops``).

``bell_matvec`` and ``stencil5_matvec`` are ``torch.autograd.Function``\\ s
with the reference's backward formulas: the product is bilinear in
(val, x), so ∂/∂x = Aᵀg — run through the SAME kernel, on the transposed
stencil planes or on the Aᵀ block-ELL layout (``t_bell``) — and ∂/∂val is
the pattern-restricted outer product g[row]·x[col].
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.sparse import BellMeta
from . import ref as _ref
from .spmv_bell import bell_spmv
from .stencil5 import Stencil5Meta, stencil5


# ---------------------------------------------------------------------------
# block-ELL
# ---------------------------------------------------------------------------

def bell_assemble(meta: BellMeta, perm: torch.Tensor,
                  val: torch.Tensor) -> torch.Tensor:
    """Scatter COO values into the dense (n_rb, k, bm, bn) block tensor.

    ``perm[e] == -1`` marks entries dropped by a max_k cap; they scatter a
    zero into slot 0 (harmless: kept slots are distinct, so the sum is
    exact).  Differentiable (the transpose is a gather)."""
    size = meta.n_rb * meta.k * meta.bm * meta.bn
    keep = perm >= 0
    safe = torch.where(keep, perm, torch.zeros_like(perm))
    contrib = torch.where(keep, val, torch.zeros_like(val))
    flat = torch.zeros(size, dtype=val.dtype, device=val.device)
    flat.index_add_(0, safe, contrib)      # in place: one tile-sized buffer
    return flat.reshape(meta.n_rb, meta.k, meta.bm, meta.bn)


def _bell_entry_coords(meta: BellMeta, block_cols, perm):
    """(row, col) of every kept COO entry, decoded from its BELL slot."""
    keep = perm >= 0
    p = torch.where(keep, perm, torch.zeros_like(perm))
    lc = p % meta.bn
    t = p // meta.bn
    lr = t % meta.bm
    t = t // meta.bm
    slot = t % meta.k
    rb = t // meta.k
    row = rb * meta.bm + lr
    col = block_cols.long()[rb, slot] * meta.bn + lc
    return keep, row, col


class _BellMatvec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, val, x, meta, block_cols, perm, n, t_bell, tiles):
        bv = bell_assemble(meta, perm, val) if tiles is None else tiles
        ctx.meta, ctx.n, ctx.t_bell = meta, n, t_bell
        ctx.save_for_backward(val, x, block_cols, perm)
        return bell_spmv(meta, block_cols, bv, x, n)

    @staticmethod
    def backward(ctx, g):
        val, x, block_cols, perm = ctx.saved_tensors
        meta, n = ctx.meta, ctx.n
        g = g.contiguous()
        gval = gx = None
        if ctx.needs_input_grad[1]:
            m = x.shape[0]
            if ctx.t_bell is not None:
                # Aᵀg through the same kernel on Aᵀ's block-ELL layout
                tmeta, tcols, tperm = ctx.t_bell
                gx = bell_spmv(tmeta, tcols, bell_assemble(tmeta, tperm, val),
                               g, m)
            else:
                # reference formula: scatter blkᵀ·g_band into block columns
                bv = bell_assemble(meta, perm, val)
                gp = F.pad(g, (0, meta.n_pad - n)).reshape(meta.n_rb, meta.bm)
                contrib = torch.einsum("rkab,ra->rkb", bv, gp)
                gxb = torch.zeros(meta.n_cb, meta.bn, dtype=x.dtype,
                                  device=x.device)
                gxb.index_add_(0, block_cols.long().reshape(-1),
                               contrib.reshape(-1, meta.bn))
                gx = gxb.reshape(meta.m_pad)[:m]
        if ctx.needs_input_grad[0]:
            # ∂/∂val_e = g[row_e]·x[col_e], coordinates decoded from perm
            keep, row, col = _bell_entry_coords(meta, block_cols, perm)
            gp = F.pad(g, (0, meta.n_pad - n))
            xp = F.pad(x, (0, meta.m_pad - x.shape[0]))
            gval = torch.where(keep, gp[row] * xp[col], torch.zeros_like(val))
        return gval, gx, None, None, None, None, None, None


def bell_matvec(meta: BellMeta, block_cols: torch.Tensor, perm: torch.Tensor,
                val: torch.Tensor, x: torch.Tensor, n: int, t_bell=None,
                tiles=None) -> torch.Tensor:
    """Differentiable block-ELL y = A x (first n rows).  ``t_bell`` (Aᵀ's
    ``(meta, block_cols, perm)``) routes the backward's Aᵀg through the BELL
    kernel; ``tiles`` reuses tiles already assembled from ``val``."""
    return _BellMatvec.apply(val, x, meta, block_cols, perm, n, t_bell, tiles)


def bell_matvec_ref(meta: BellMeta, block_cols, perm, val, x, n):
    bv = bell_assemble(meta, perm, val)
    xp = F.pad(x, (0, meta.m_pad - x.shape[0]))
    return _ref.bell_matvec_ref(bv, block_cols, xp, n)


# ---------------------------------------------------------------------------
# 5-point stencil
# ---------------------------------------------------------------------------

def stencil_transpose_planes(v5: torch.Tensor) -> torch.Tensor:
    """Planes of Aᵀ: each neighbour plane swaps with its mirror and shifts
    by its own offset (reference ``ops._stencil_transpose_planes``)."""
    C, N, S, W, E = v5
    Nt = F.pad(S, (0, 0, 1, 0))[:-1, :]   # S shifted down   → plays N
    St = F.pad(N, (0, 0, 0, 1))[1:, :]    # N shifted up     → plays S
    Wt = F.pad(E, (1, 0, 0, 0))[:, :-1]   # E shifted right  → plays W
    Et = F.pad(W, (0, 1, 0, 0))[:, 1:]    # W shifted left   → plays E
    return torch.stack([C, Nt, St, Wt, Et])


class _Stencil5Matvec(torch.autograd.Function):
    @staticmethod
    def forward(ctx, val, x, meta):
        ctx.meta = meta
        ctx.save_for_backward(val, x)
        v5 = val.reshape(5, meta.nx, meta.ny)
        return stencil5(meta, v5, x.reshape(meta.nx, meta.ny)).reshape(-1)

    @staticmethod
    def backward(ctx, g):
        val, x = ctx.saved_tensors
        meta = ctx.meta
        v5 = val.reshape(5, meta.nx, meta.ny)
        x2 = x.reshape(meta.nx, meta.ny)
        g2 = g.reshape(meta.nx, meta.ny).contiguous()
        gval = gx = None
        if ctx.needs_input_grad[1]:
            # Aᵀ g — the same kernel on transposed planes
            gx = stencil5(meta, stencil_transpose_planes(v5), g2).reshape(-1)
        if ctx.needs_input_grad[0]:
            # ∂/∂val_d[i,j] = g[i,j] · x[i+off_d, j+off_d]
            xn = F.pad(x2, (0, 0, 1, 0))[:-1, :]
            xs = F.pad(x2, (0, 0, 0, 1))[1:, :]
            xw = F.pad(x2, (1, 0, 0, 0))[:, :-1]
            xe = F.pad(x2, (0, 1, 0, 0))[:, 1:]
            gval = torch.stack([g2 * x2, g2 * xn, g2 * xs, g2 * xw,
                                g2 * xe]).reshape(-1)
        return gval, gx, None


def stencil5_matvec(meta: Stencil5Meta, val: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """``val``: (5·nx·ny,) flattened signed planes; ``x``: (nx·ny,)."""
    return _Stencil5Matvec.apply(val, x, meta)


def stencil5_matvec_ref(meta: Stencil5Meta, val, x):
    v5 = val.reshape(5, meta.nx, meta.ny)
    x2 = x.reshape(meta.nx, meta.ny)
    return _ref.stencil5_ref(v5, x2).reshape(meta.nx * meta.ny)
