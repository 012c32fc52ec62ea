"""Plan engine of the PyTorch port: sparse tensors, options, Krylov solvers,
preconditioners (multigrid included), dispatch, the adjoint, the nonlinear
/ eigen layer and the distributed layer (mirrors ``repro.core``)::

    from repro_torch.core import SparseTensor, SparseTensorList
    x = A.solve(b)                      # auto-dispatched, adjoint gradients
    xs = A.with_values(vals).solve(b)   # stacked values (B, nnz): one plan

``DSparseTensor`` / ``DSparseTensorList`` (:mod:`.distributed`) are bound
lazily: single-device use never imports ``torch.distributed`` machinery.
"""
from . import multigrid, precond, solvers
from .adjoint import nonlinear_solve, sparse_eigsh, sparse_solve
from .dispatch import (PLAN_STATS, SolverConfig, SolverPlan, get_plan,
                       make_config, register_backend, reset_plan_stats,
                       select_backend)
from .nonlinear import SparseNewton
from .sparse import SparseTensor, SparseTensorList, build_bell, coo_matvec

__all__ = [
    "SparseTensor", "SparseTensorList", "DSparseTensor", "DSparseTensorList", "coo_matvec", "build_bell",
    "nonlinear_solve", "sparse_solve", "sparse_eigsh", "SparseNewton",
    "SolverConfig", "SolverPlan", "get_plan", "make_config",
    "select_backend", "register_backend", "PLAN_STATS", "reset_plan_stats",
    "solvers", "precond", "multigrid",
]

_LAZY = {"DSparseTensor": "distributed", "DSparseTensorList": "distributed"}


def __getattr__(name):
    """Lazy re-export of the distributed layer (PEP 562)."""
    if name in _LAZY:
        from importlib import import_module
        return getattr(import_module(f".{_LAZY[name]}", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
