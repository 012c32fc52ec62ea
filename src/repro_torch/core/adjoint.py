"""O(1)-graph adjoints of the linear solve and the log-determinant (port
of ``repro.core.adjoint``).

The solve is ONE ``torch.autograd.Function`` — torch-sla's own form — so the
autograd graph gains a single node whatever the number of Krylov
iterations.  The forward stashes only (A's values, x*); the backward solves
Aᵀλ = g on ``plan.transpose()`` and returns

    ∂L/∂b = λ,    ∂L/∂A_ij = −λ_i x_j   (on the sparsity pattern, O(nnz)).

``sparse_slogdet`` is one Function as well: (sign, log|det A|) from the
direct backend's cached factors, with ∂ log|det A| / ∂A_ij = (A⁻ᵀ)_ij on
the pattern from transposed solves on the same factors.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import dispatch as _dispatch
from . import options as _options
from .dispatch import SolverConfig
from .sparse import SparseTensor

__all__ = ["sparse_solve", "sparse_solve_with_info", "sparse_slogdet"]

#: right-hand sides per transposed multi-RHS solve in the slogdet backward
SLOGDET_CHUNK = 256


class _SparseSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, val, b, plan, cfg, x0):
        x, _ = plan.solve(plan.matrix(val), b, x0, cfg=cfg)
        ctx.plan, ctx.cfg = plan, cfg
        # keep the values object itself (and its version) on the plan side:
        # the backward's setup memo keys on its identity, so the symmetric
        # adjoint reuses the forward's setup (PLAN_STATS["setup_reuse"])
        ctx.val, ctx.val_version = val, val._version
        ctx.save_for_backward(x)
        return x

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        plan, cfg, val = ctx.plan, ctx.cfg, ctx.val
        if val._version != ctx.val_version:
            raise RuntimeError(
                "the values of a solved SparseTensor were modified in place "
                "before the backward pass")
        tplan = plan.transpose()
        lam, _ = tplan.solve(tplan.matrix(val), g.contiguous(), None,
                             cfg=tplan.adapt(cfg))
        gval = gb = None
        if ctx.needs_input_grad[0]:
            gval = -(lam[plan.row] * x[plan.col])
        if ctx.needs_input_grad[1]:
            gb = lam
        return gval, gb, None, None, None


def sparse_solve(cfg: SolverConfig, A: SparseTensor, b: torch.Tensor,
                 x0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable ``A.solve(b)``; ``cfg`` must already be resolved.

    The forward fetches (or analyzes once) the pattern's cached plan; the
    backward solves Aᵀλ = g through ``plan.transpose()`` — the SAME plan
    for symmetric patterns, a layout-sharing or once-analyzed sibling
    otherwise.  No re-dispatch and no re-analysis per call."""
    plan = _dispatch.get_plan(A, cfg)
    if A.batch_shape or b.dim() != 1:
        raise NotImplementedError(
            "batched values or right-hand sides come with slice 5 of the "
            "PyTorch port (batching and serving)")
    return _SparseSolve.apply(A.val, b, plan, cfg, x0)


def sparse_solve_with_info(cfg: SolverConfig, A: SparseTensor, b, x0=None):
    """Non-differentiable variant that also returns SolveInfo."""
    return _dispatch.solve_impl(cfg, A, b, x0)


# ---------------------------------------------------------------------------
# log-determinant — sparse via the cached LDLᵀ/LU factors within the
# direct_budget option, dense fallback beyond
# ---------------------------------------------------------------------------

def _slogdet_direct_plan(A: SparseTensor):
    """The direct-backend plan for a slogdet, or None when the sparse path
    does not apply (batched values, oversize pattern, missing structural
    diagonal)."""
    n, m = A.shape
    if n != m or A.batch_shape:
        return None
    if n > _options.current().direct_budget:
        return None
    if not _dispatch.BACKENDS["direct"].applicable(A):
        return None
    cfg = SolverConfig(backend="direct", method="auto").resolved(A)
    return _dispatch.get_plan(A, cfg)


def _inv_t_on_pattern(plan, C, row, col, n, dtype):
    """(A⁻ᵀ)[row, col] from the forward factors, without forming A⁻¹.

    Column j of A⁻ᵀ solves Aᵀ x = e_j; entry e needs column ``col[e]`` at
    row ``row[e]``.  The unit right-hand sides go through the transposed
    sweeps ``SLOGDET_CHUNK`` columns at a time, as one multi-RHS solve
    each, and only the pattern's entries of each chunk are kept."""
    from . import direct as _direct
    art = plan.artifacts["direct"]
    transposed = not plan.artifacts["transposed"]
    out = torch.empty(row.shape[0], dtype=dtype, device=row.device)
    order = torch.argsort(col)
    cs = col[order]
    for c0 in range(0, n, SLOGDET_CHUNK):
        c1 = min(c0 + SLOGDET_CHUNK, n)
        lo, hi = (int(v) for v in torch.searchsorted(
            cs, torch.tensor([c0, c1], device=cs.device)))
        if lo == hi:
            continue
        E = torch.zeros(n, c1 - c0, dtype=dtype, device=row.device)
        E[torch.arange(c0, c1, device=row.device),
          torch.arange(c1 - c0, device=row.device)] = 1.0
        X = _direct.factored_solve(art, C, E, transposed=transposed)
        sel = order[lo:hi]
        out[sel] = X[row[sel], col[sel] - c0]
    return out


class _SparseSlogdet(torch.autograd.Function):
    """(sign, log|det A|) as one autograd node.  ``plan`` is the direct
    backend's plan (the factors come from its setup memo, shared with
    ``backend="direct"`` solves) or None for the dense fallback."""

    @staticmethod
    def forward(ctx, val, plan, A):
        ctx.plan, ctx.A = plan, A
        # the values object itself: the backward's setup memo keys on it
        ctx.val, ctx.val_version = val, val._version
        if plan is None:
            sign, logabs = torch.linalg.slogdet(A.with_values(val).todense())
        else:
            from . import direct as _direct
            C = plan.setup(plan.matrix(val))      # memoized numeric factors
            # pivot-block aware: 2x2 Bunch–Kaufman pairs contribute their
            # block determinant, not the raw diagonal product
            sign, logabs = _direct.factor_slogdet(plan.artifacts["direct"], C)
        ctx.mark_non_differentiable(sign)
        return sign, logabs

    @staticmethod
    def backward(ctx, gsign, glog):
        plan, A, val = ctx.plan, ctx.A, ctx.val
        if val._version != ctx.val_version:
            raise RuntimeError(
                "the values of a SparseTensor were modified in place between "
                "slogdet and its backward pass")
        if plan is None:
            dense = A.with_values(val.detach()).todense()
            inv_t = torch.linalg.inv(dense).transpose(-1, -2)
            # d log|det| / dA_ij = (A⁻ᵀ)_ij restricted to the pattern
            return glog[..., None] * inv_t[..., A.row, A.col], None, None
        C = plan.setup(plan.matrix(val))          # memo hit: no refactorize
        gval = glog * _inv_t_on_pattern(plan, C, A.row, A.col, A.shape[0],
                                        val.dtype)
        return gval, None, None


def sparse_slogdet(A: SparseTensor):
    """(sign, log|det A|) with gradients on the sparsity pattern.

    Square concrete patterns within the ``direct_budget`` option run on the
    plan engine's cached LDLᵀ/LU factors (the same numeric factorization a
    ``backend="direct"`` solve memoizes): with the symmetric fill-reducing
    permutation det(P A Pᵀ) = det(A) and unit-diagonal L, the determinant is
    the product of the stored pivots (2x2 pair blocks included) — O(nnz_L)
    work and memory, no densification.  The backward solves Aᵀ X = I on the
    SAME factors, in column chunks, keeping only X's entries on the pattern:
    never an n×n matrix.  Batched values, oversize or diagonal-deficient
    patterns take the dense fallback."""
    return _SparseSlogdet.apply(A.val, _slogdet_direct_plan(A), A)
