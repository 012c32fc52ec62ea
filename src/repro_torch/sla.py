"""repro_torch.sla — public surface of the PyTorch port.

The names match the reference's ``repro.sla``::

    import torch
    from repro_torch import sla

    A = sla.SparseTensor(val, row, col, (n, n), device="cuda")
    x = sla.solve(A, b)                          # auto-dispatch + adjoint
    res = sla.solve_with_info(A, b, tol=1e-10)   # typed SolveResult

    with sla.options(fused_step="off"):          # scoped option override
        x = sla.solve(A, b)

Ported so far: the iterative route (``jnp``/``pallas``/``stencil``
backends; CG, BiCGStab and restarted GMRES; Jacobi, block-Jacobi,
Chebyshev, geometric multigrid ``mg`` on stencil operators,
smoothed-aggregation ``amg`` and ILU(0) preconditioners), the sparse-direct
route
(``direct``: supernodal LDLᵀ/LU, the auto choice for mid-size systems, with
``SparseTensor.slogdet`` on the same factors) and the dense route; the rest
of the reference's surface arrives with later slices.
"""
from __future__ import annotations

from .core.dispatch import (PLAN_STATS, SolverConfig, SolverPlan, get_plan,
                            make_config, reset_plan_stats, solve_impl)
from .core.options import Options
from .core.options import current as get_options
from .core.options import options, set_options
from .core.solvers import SolveResult, as_solve_result
from .core.sparse import SparseTensor

__all__ = [
    "SparseTensor",
    "SolverConfig",
    "SolverPlan",
    "SolveResult",
    "Options",
    "solve",
    "solve_with_info",
    "get_plan",
    "set_options",
    "options",
    "get_options",
    "PLAN_STATS",
    "reset_plan_stats",
]


def solve(A, b, **kw):
    """Solve ``A @ x = b`` with adjoint gradients.  Keyword options:
    ``backend`` ("auto", "dense", "direct", "jnp", "pallas", "stencil"),
    ``method`` ("cg", "bicgstab", "gmres"; "ldlt"/"lu" for direct;
    "lu"/"cholesky" for dense), ``precond`` ("none", "jacobi",
    "block_jacobi", "chebyshev", "mg", "amg", "ilu"), ``tol``, ``atol``,
    ``maxiter``, ``x0`` (GMRES restarts every 32 steps; ``solve_with_info``
    also takes ``restart``)."""
    return A.solve(b, **kw)


def solve_with_info(A, b, *, x0=None, **kw) -> SolveResult:
    """Like :func:`solve`, returning a typed :class:`SolveResult` (``x``,
    ``iterations``, ``residual``, ``converged``, ``reason``).
    Un-differentiated."""
    cfg = make_config(A, **kw)
    x, info = solve_impl(cfg, A, b, x0)
    return as_solve_result(x, info)
