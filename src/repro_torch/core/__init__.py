"""Plan engine of the PyTorch port: sparse tensors, options, Krylov solvers,
preconditioners (multigrid included), dispatch, the adjoint and the
nonlinear / eigen layer (mirrors ``repro.core``)::

    from repro_torch.core import SparseTensor, SparseTensorList
    x = A.solve(b)                      # auto-dispatched, adjoint gradients
    xs = A.with_values(vals).solve(b)   # stacked values (B, nnz): one plan
"""
from . import multigrid, precond, solvers
from .adjoint import nonlinear_solve, sparse_eigsh, sparse_solve
from .dispatch import (PLAN_STATS, SolverConfig, SolverPlan, get_plan,
                       make_config, register_backend, reset_plan_stats,
                       select_backend)
from .nonlinear import SparseNewton
from .sparse import SparseTensor, SparseTensorList, build_bell, coo_matvec

__all__ = [
    "SparseTensor", "SparseTensorList", "coo_matvec", "build_bell",
    "nonlinear_solve", "sparse_solve", "sparse_eigsh", "SparseNewton",
    "SolverConfig", "SolverPlan", "get_plan", "make_config",
    "select_backend", "register_backend", "PLAN_STATS", "reset_plan_stats",
    "solvers", "precond", "multigrid",
]
