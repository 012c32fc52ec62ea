"""repro_torch.sla — public surface of the PyTorch port.

The names match the reference's ``repro.sla``::

    import torch
    from repro_torch import sla

    A = sla.SparseTensor(val, row, col, (n, n), device="cuda")
    x = sla.solve(A, b)                          # auto-dispatch + adjoint
    res = sla.solve_with_info(A, b, tol=1e-10)   # typed SolveResult

    with sla.options(fused_step="off"):          # scoped option override
        x = sla.solve(A, b)

Ported: the whole single-device surface of the reference — the iterative
route (``jnp``/``pallas``/``stencil`` backends; CG, BiCGStab, restarted
GMRES and block CG; Jacobi, block-Jacobi, Chebyshev, geometric multigrid
``mg`` on stencil operators, smoothed-aggregation ``amg`` and ILU(0)
preconditioners), the sparse-direct route (``direct``: supernodal LDLᵀ/LU,
the auto choice for mid-size systems, with ``SparseTensor.slogdet`` on the
same factors), the dense route, the nonlinear and eigen layer
(``nonlinear_solve`` with Newton / Picard / Anderson and the
``SparseNewton`` plan-engine route, ``eigsh`` by LOBPCG or Lanczos), batched
solves (stacked values and multiple right-hand sides through one plan) and
the request-batching ``SolveServer`` / ``serve``, and the distributed
``DSparseTensor`` (row-block shards over a ``torch.distributed`` group,
halo exchange with an adjoint, the ``dist`` backend; bound lazily)::

    mesh = make_mesh(8, group=None, device="cuda")  # repro_torch.core.distributed
    D = sla.DSparseTensor.from_global(val, row, col, (n, n), mesh)
    x = D.solve(D.stack_vector(b), precond="schwarz2")

Serving::

    from repro_torch.sla import SolveServer
    server = SolveServer()
    results = server.submit_batch(requests)      # grouped + batched dispatch
"""
from __future__ import annotations

from .core.adjoint import nonlinear_solve
from .core.adjoint import sparse_eigsh as eigsh
from .core.dispatch import (PLAN_STATS, SolverConfig, SolverPlan, get_plan,
                            make_config, register_backend, reset_plan_stats,
                            solve_impl)
from .core.nonlinear import SparseNewton
from .core.options import Options
from .core.options import current as get_options
from .core.options import options, set_options
from .core.solvers import SolveResult, as_solve_result
from .core.sparse import SparseTensor

__all__ = [
    "SparseTensor",
    "DSparseTensor",
    "SparseNewton",
    "nonlinear_solve",
    "eigsh",
    "SolverConfig",
    "SolverPlan",
    "SolveResult",
    "Options",
    "solve",
    "solve_with_info",
    "get_plan",
    "register_backend",
    "set_options",
    "options",
    "get_options",
    "serve",
    "SolveServer",
    "PLAN_STATS",
    "reset_plan_stats",
]

# lazily bound: the distributed layer pulls in torch.distributed and the
# serving driver the launch package, which single-solve library use should
# not pay for
_LAZY = {
    "DSparseTensor": ("repro_torch.core.distributed", "DSparseTensor"),
    "serve": ("repro_torch.launch.solve_serve", "serve"),
    "SolveServer": ("repro_torch.launch.solve_serve", "SolveServer"),
}


def __getattr__(name: str):
    target = _LAZY.get(name)
    if target is not None:
        from importlib import import_module
        return getattr(import_module(target[0]), target[1])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))


def solve(A, b, **kw):
    """Solve ``A @ x = b`` with adjoint gradients.  ``b`` may carry leading
    batch dims and ``A`` stacked values sharing one pattern: both batch
    through ONE analyzed plan and one setup.  Keyword options:
    ``backend`` ("auto", "dense", "direct", "jnp", "pallas", "stencil"),
    ``method`` ("cg", "bicgstab", "gmres", "block_cg" — a multi-rhs batch as
    one coupled block; "ldlt"/"lu" for direct;
    "lu"/"cholesky" for dense), ``precond`` ("none", "jacobi",
    "block_jacobi", "chebyshev", "mg", "amg", "ilu"), ``tol``, ``atol``,
    ``maxiter``, ``x0`` (GMRES restarts every 32 steps; ``solve_with_info``
    also takes ``restart``)."""
    return A.solve(b, **kw)


def solve_with_info(A, b, *, x0=None, **kw) -> SolveResult:
    """Like :func:`solve`, returning a typed :class:`SolveResult` (``x``,
    ``iterations``, ``residual`` and ``converged``, per right-hand side
    for batches, and ``reason``).  Un-differentiated."""
    if getattr(A, "mesh", None) is not None:      # distributed tensor
        x, info = A.solve_with_info(b, x0=x0, **kw)
    else:
        cfg = make_config(A, **kw)
        x, info = solve_impl(cfg, A, b, x0)
    return as_solve_result(x, info)
