"""Plan engine of the PyTorch port: sparse tensors, options, Krylov solvers,
preconditioners (multigrid included), dispatch, the adjoint and the
nonlinear / eigen layer (mirrors ``repro.core``)."""
from . import multigrid, precond, solvers
from .adjoint import nonlinear_solve, sparse_eigsh
from .nonlinear import SparseNewton

__all__ = ["solvers", "precond", "multigrid", "nonlinear_solve",
           "sparse_eigsh", "SparseNewton"]
