"""Differentiable operator wrappers over the kernels (port of
``repro.kernels.ops``).

``bell_matvec`` and ``stencil5_matvec`` are ``torch.autograd.Function``\\ s
with the reference's backward formulas: the product is bilinear in
(val, x), so ∂/∂x = Aᵀg — run through the SAME kernel, on the transposed
stencil planes or on Aᵀ's sliced-ELL layout (``t_bell``) — and ∂/∂val is
the pattern-restricted outer product g[row]·x[col].  The block-ELL product
builds no dense tiles: values go straight into the sliced-ELL array.

Both take lanes: ``val`` (B, nnz) and/or ``x`` (B, m) — B value arrays on
one pattern, k right-hand sides on one matrix, or both — through the
lane-batched kernels (``bell_spmv_batched`` / ``bell_spmm``,
``stencil5_batched``); an operand without the lane axis is shared by every
lane, and its gradient is summed over the lanes.  Both compose with
``torch.func`` (``jvp``, ``vmap``, ``vjp``): the ``jvp`` rule launches the
same kernel once per term, and the ``vmap`` rule moves the mapped axis to
the front and calls the lane-batched kernel once.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..core.sparse import BellLayout, BellMeta, SellLayout, sum_to_shape
from . import ref as _ref
from .spmv_bell import bell_spmm, bell_spmv, bell_spmv_batched
from .stencil5 import Stencil5Meta, stencil5, stencil5_batched


# ---------------------------------------------------------------------------
# block-ELL
# ---------------------------------------------------------------------------

def bell_assemble(meta: BellMeta, perm,
                  val: torch.Tensor) -> torch.Tensor:
    """Scatter COO values into the dense (n_rb, k, bm, bn) block tensor —
    the reference's layout, kept only to hold the kernel to it in tests.

    ``perm[e] == -1`` marks entries dropped by a max_k cap; they scatter a
    zero into slot 0 (harmless: kept slots are distinct, so the sum is
    exact).  ``perm`` may lie on the host.  Differentiable (the transpose
    is a gather)."""
    perm = torch.as_tensor(perm, dtype=torch.int64, device=val.device)
    size = meta.n_rb * meta.k * meta.bm * meta.bn
    keep = perm >= 0
    safe = torch.where(keep, perm, torch.zeros_like(perm))
    contrib = torch.where(keep, val, torch.zeros_like(val))
    flat = torch.zeros(size, dtype=val.dtype, device=val.device)
    flat.index_add_(0, safe, contrib)      # in place: one tile-sized buffer
    return flat.reshape(meta.n_rb, meta.k, meta.bm, meta.bn)


def sell_assemble(sell: SellLayout, val: torch.Tensor) -> torch.Tensor:
    """Scatter COO values (..., nnz) into the sliced-ELL value array
    (..., n_slots): one slot per kept entry, zeros in the padding.  Entries
    the block-ELL plan dropped (``spos == -1``) scatter a zero into slot 0.
    Differentiable."""
    keep = sell.spos >= 0
    safe = torch.where(keep, sell.spos, torch.zeros_like(sell.spos))
    contrib = torch.where(keep, val, torch.zeros_like(val))
    flat = val.new_zeros(val.shape[:-1] + (sell.n_slots,))
    return flat.index_add_(-1, safe, contrib)


def sell_product(sell: SellLayout, vals, x, n):
    """y = A x on an assembled sliced-ELL value array, through the kernel
    for the operands' lanes: single vector, batched values (x batched or
    shared) or one value array times k right-hand sides.  Not
    differentiable (:func:`bell_matvec` is)."""
    if vals.dim() == 2:
        return bell_spmv_batched(sell, vals, x, n)
    if x.dim() == 2:
        return bell_spmm(sell, vals, x, n)
    return bell_spmv(sell, vals, x, n)


def _front(t, dim):
    """``t`` with its vmapped axis ``dim`` moved to the front."""
    return t if dim is None or t is None else t.movedim(dim, 0)


def _unbatch(t, dim, i):
    """Instance ``i`` of a tensor batched along ``dim`` (None: unbatched)."""
    return t if dim is None or t is None else t.select(dim, i)


def _loop_vmap(fn, info, in_dims, *args):
    """The ``vmap`` rule where the lane-batched kernel does not apply (an
    instance that is itself batched): one call per batch instance, stacked
    along dim 0."""
    outs = [fn(*(_unbatch(a, d, i) for a, d in zip(args, in_dims)))
            for i in range(info.batch_size)]
    return torch.stack(outs), 0


class _BellMatvec(torch.autograd.Function):
    """y = A(val)·x through the sliced-ELL kernel.  Composes with
    ``torch.func``: the map is bilinear, so the ``jvp`` rule is
    ẏ = A(val)·ẋ + A(val̇)·x (both terms on the same kernel), and the
    ``vmap`` rule launches the lane-batched kernel once for the batch."""

    @staticmethod
    def forward(val, x, bell, n, t_bell, packed):
        vals = sell_assemble(bell.sell, val) if packed is None else packed
        return sell_product(bell.sell, vals, x, n)

    @staticmethod
    def setup_context(ctx, inputs, output):
        val, x, bell, n, t_bell, packed = inputs
        ctx.bell, ctx.n, ctx.t_bell, ctx.packed = bell, n, t_bell, packed
        # an input without a tangent reaches ``jvp`` as None, not as zeros
        # (a zero tangent would cost a launch)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(val, x)
        ctx.save_for_forward(val, x)

    @staticmethod
    def backward(ctx, g):
        val, x = ctx.saved_tensors
        bell, n = ctx.bell, ctx.n
        meta = bell.meta
        g = g.contiguous()
        gval = gx = None
        need_coords = ctx.needs_input_grad[0] or (
            ctx.needs_input_grad[1] and ctx.t_bell is None)
        if need_coords:
            keep, row, col = bell.sell.entry_coords()
            gp = F.pad(g, (0, meta.n_pad - n))
        if ctx.needs_input_grad[1]:
            m = x.shape[-1]
            if ctx.t_bell is not None:
                # Aᵀg through the same kernel on Aᵀ's layout
                tsell = ctx.t_bell.sell
                gx = sell_product(tsell, sell_assemble(tsell, val), g, m)
            else:
                # Aᵀg as a scatter of val·g[row] into the columns
                contrib = torch.where(keep, val * gp[..., row],
                                      torch.zeros_like(val))
                gx = contrib.new_zeros(contrib.shape[:-1] + (meta.m_pad,))
                gx = gx.index_add_(-1, col, contrib)[..., :m]
            gx = sum_to_shape(gx, x.shape)
        if ctx.needs_input_grad[0]:
            # ∂/∂val_e = g[row_e]·x[col_e], coordinates decoded from spos
            xp = F.pad(x, (0, meta.m_pad - x.shape[-1]))
            gval = torch.where(keep, gp[..., row] * xp[..., col],
                               torch.zeros_like(val))
            gval = sum_to_shape(gval, val.shape)
        return gval, gx, None, None, None, None

    @staticmethod
    def jvp(ctx, val_t, x_t, *_):
        val, x = ctx.saved_tensors
        y_t = None
        if x_t is not None:
            y_t = _BellMatvec.apply(val, x_t, ctx.bell, ctx.n, ctx.t_bell,
                                    ctx.packed)
        if val_t is not None:
            term = _BellMatvec.apply(val_t, x, ctx.bell, ctx.n, ctx.t_bell,
                                     None)
            y_t = term if y_t is None else y_t + term
        return y_t

    @staticmethod
    def vmap(info, in_dims, val, x, bell, n, t_bell, packed):
        vd, xd, pd = in_dims[0], in_dims[1], in_dims[5]
        if val.dim() - (vd is not None) == 1 and \
                x.dim() - (xd is not None) == 1 and \
                (packed is None or pd is not None or vd is None):
            # one launch of the lane-batched kernel for the whole batch
            return _BellMatvec.apply(_front(val, vd), _front(x, xd), bell, n,
                                     t_bell, _front(packed, pd)), 0
        return _loop_vmap(lambda v, xx, p: _BellMatvec.apply(
            v, xx, bell, n, t_bell, p), info, (vd, xd, pd), val, x, packed)


def bell_matvec(bell: BellLayout, val: torch.Tensor, x: torch.Tensor, n: int,
                t_bell: Optional[BellLayout] = None,
                packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable block-ELL y = A x (first n rows) through the sliced-ELL
    kernel.  ``val`` (nnz,) or (B, nnz), ``x`` (m,) or (B, m) (see the
    module's note on lanes).  ``t_bell`` (Aᵀ's layout) routes the backward's
    Aᵀg through the same kernel; ``packed`` reuses the value array already
    assembled from ``val`` (:func:`sell_assemble`)."""
    return _BellMatvec.apply(val, x, bell, n, t_bell, packed)


def bell_matvec_ref(bell: BellLayout, val, x, n):
    """The same product on the reference's dense tiles (the old layout),
    with the host slot table and ``perm`` moved to ``val``'s device."""
    meta = bell.meta
    bv = bell_assemble(meta, bell.perm, val)
    xp = F.pad(x, (0, meta.m_pad - x.shape[0]))
    block_cols = torch.as_tensor(bell.block_cols, device=val.device)
    return _ref.bell_matvec_ref(bv, block_cols, xp, n)


# ---------------------------------------------------------------------------
# 5-point stencil
# ---------------------------------------------------------------------------

def stencil_transpose_planes(v5: torch.Tensor) -> torch.Tensor:
    """Planes of Aᵀ, (..., 5, nx, ny): each neighbour plane swaps with its
    mirror and shifts by its own offset (reference
    ``ops._stencil_transpose_planes``)."""
    C, N, S, W, E = v5.unbind(-3)
    Nt = F.pad(S, (0, 0, 1, 0))[..., :-1, :]   # S shifted down  → plays N
    St = F.pad(N, (0, 0, 0, 1))[..., 1:, :]    # N shifted up    → plays S
    Wt = F.pad(E, (1, 0, 0, 0))[..., :, :-1]   # E shifted right → plays W
    Et = F.pad(W, (0, 1, 0, 0))[..., :, 1:]    # W shifted left  → plays E
    return torch.stack([C, Nt, St, Wt, Et], dim=-3)


def _stencil_product(meta, v5, x2):
    """The kernel for the operands' lanes (planes (5, nx, ny) or
    (B, 5, nx, ny), x (nx, ny) or (B, nx, ny))."""
    if v5.dim() == 3 and x2.dim() == 2:
        return stencil5(meta, v5, x2)
    return stencil5_batched(meta, v5, x2)


def stencil5_product(meta: Stencil5Meta, val: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """y = A x on flattened planes (…, 5·nx·ny) and x (…, nx·ny), through
    the kernel for the operands' lanes.  Not differentiable
    (:func:`stencil5_matvec` is)."""
    nx, ny = meta.nx, meta.ny
    v5 = val.reshape(val.shape[:-1] + (5, nx, ny))
    y = _stencil_product(meta, v5, x.reshape(x.shape[:-1] + (nx, ny)))
    return y.reshape(y.shape[:-2] + (nx * ny,))


class _Stencil5Matvec(torch.autograd.Function):
    """y = A(val)·x on the stencil kernel, with the same ``torch.func``
    rules as :class:`_BellMatvec`."""

    @staticmethod
    def forward(val, x, meta):
        return stencil5_product(meta, val, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        val, x, meta = inputs
        ctx.meta = meta
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(val, x)
        ctx.save_for_forward(val, x)

    @staticmethod
    def backward(ctx, g):
        val, x = ctx.saved_tensors
        meta = ctx.meta
        nx, ny = meta.nx, meta.ny
        v5 = val.reshape(val.shape[:-1] + (5, nx, ny))
        x2 = x.reshape(x.shape[:-1] + (nx, ny))
        g2 = g.reshape(g.shape[:-1] + (nx, ny)).contiguous()
        gval = gx = None
        if ctx.needs_input_grad[1]:
            # Aᵀ g — the same kernel on transposed planes
            gx = _stencil_product(meta, stencil_transpose_planes(v5), g2)
            gx = sum_to_shape(gx.reshape(gx.shape[:-2] + (nx * ny,)), x.shape)
        if ctx.needs_input_grad[0]:
            # ∂/∂val_d[i,j] = g[i,j] · x[i+off_d, j+off_d]
            xn = F.pad(x2, (0, 0, 1, 0))[..., :-1, :]
            xs = F.pad(x2, (0, 0, 0, 1))[..., 1:, :]
            xw = F.pad(x2, (1, 0, 0, 0))[..., :, :-1]
            xe = F.pad(x2, (0, 1, 0, 0))[..., :, 1:]
            gval = torch.stack([g2 * x2, g2 * xn, g2 * xs, g2 * xw,
                                g2 * xe], dim=-3)
            gval = sum_to_shape(gval.reshape(gval.shape[:-3] + (-1,)),
                                val.shape)
        return gval, gx, None

    @staticmethod
    def jvp(ctx, val_t, x_t, _):
        val, x = ctx.saved_tensors
        y_t = None
        if x_t is not None:
            y_t = _Stencil5Matvec.apply(val, x_t, ctx.meta)
        if val_t is not None:
            term = _Stencil5Matvec.apply(val_t, x, ctx.meta)
            y_t = term if y_t is None else y_t + term
        return y_t

    @staticmethod
    def vmap(info, in_dims, val, x, meta):
        vd, xd = in_dims[:2]
        if val.dim() - (vd is not None) == 1 and \
                x.dim() - (xd is not None) == 1:
            return _Stencil5Matvec.apply(_front(val, vd), _front(x, xd),
                                         meta), 0
        return _loop_vmap(lambda v, xx: _Stencil5Matvec.apply(v, xx, meta),
                          info, (vd, xd), val, x)


def stencil5_matvec(meta: Stencil5Meta, val: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """``val``: (5·nx·ny,) flattened signed planes, or (B, 5·nx·ny);
    ``x``: (nx·ny,) or (B, nx·ny)."""
    return _Stencil5Matvec.apply(val, x, meta)


def stencil5_matvec_ref(meta: Stencil5Meta, val, x):
    v5 = val.reshape(5, meta.nx, meta.ny)
    x2 = x.reshape(meta.nx, meta.ny)
    return _ref.stencil5_ref(v5, x2).reshape(meta.nx * meta.ny)
