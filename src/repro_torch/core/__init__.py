"""Plan engine of the PyTorch port: sparse tensors, options, Krylov solvers,
preconditioners (multigrid included), dispatch and the adjoint (mirrors
``repro.core``)."""
from . import multigrid, precond, solvers

__all__ = ["solvers", "precond", "multigrid"]
