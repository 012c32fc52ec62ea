"""O(1)-graph adjoint of the linear solve (port of ``repro.core.adjoint``).

The solve is ONE ``torch.autograd.Function`` — torch-sla's own form — so the
autograd graph gains a single node whatever the number of Krylov
iterations.  The forward stashes only (A's values, x*); the backward solves
Aᵀλ = g on ``plan.transpose()`` and returns

    ∂L/∂b = λ,    ∂L/∂A_ij = −λ_i x_j   (on the sparsity pattern, O(nnz)).
"""
from __future__ import annotations

from typing import Optional

import torch

from . import dispatch as _dispatch
from .dispatch import SolverConfig
from .sparse import SparseTensor

__all__ = ["sparse_solve", "sparse_solve_with_info"]


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
