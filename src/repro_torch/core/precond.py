"""Preconditioners (port of ``repro.core.precond``).

``none``, ``jacobi`` and ``ilu`` stand behind :class:`PreconditionerPlan`,
split like the reference into an eager pattern stage (``__init__``), an
arrays-only values stage (:meth:`PreconditionerPlan.refresh_state`) and a
closure assembly (:meth:`PreconditionerPlan.make_apply`).  ``ilu`` is
ILU(0)/IC(0) on the direct solver's machinery: the ``incomplete=True``
symbolic program at analyze time, its numeric factorization per values
tensor, and the factored solve as M⁻¹.  The functional :func:`chebyshev`
polynomial is ported as well (its inner step is the fused ``cheb_step``
kernel); as a plan preconditioner it arrives with slice 3.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

__all__ = ["identity", "jacobi", "chebyshev", "PreconditionerPlan"]

PRECONDITIONERS = ("none", "identity", "jacobi", "block_jacobi", "chebyshev",
                   "mg", "amg", "ilu")
# preconditioners of the reference that later slices of the port bring
_LATER_SLICE = {"block_jacobi": 3, "chebyshev": 3, "mg": 3, "amg": 3}


def identity():
    return lambda r: r


def _inv_diag(d: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    return torch.where(torch.abs(d) > eps, 1.0 / d, torch.ones_like(d))


def jacobi(diag: torch.Tensor, eps: float = 1e-30):
    """M⁻¹ = D⁻¹ — the paper's default for the PyTorch-native backend."""
    inv = _inv_diag(diag, eps)
    return lambda r: inv * r


def chebyshev(matvec: Callable, lam_min: float, lam_max: float,
              degree: int = 8, fused: bool = False):
    """Chebyshev-polynomial approximation of A⁻¹ on [lam_min, lam_max].

    With ``fused=True`` the inner d/x axpy pair runs as one
    ``fused_cheb_step`` pass per degree; the recurrence is unchanged."""
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)
    sigma = theta / delta
    if fused:
        from ..kernels import solve_step as _fk

    def apply(r):
        x = r / theta
        rk = r - matvec(x)
        rho_k = 1.0 / sigma
        dk = x
        for _ in range(degree - 1):
            rho_k1 = 1.0 / (2.0 * sigma - rho_k)
            if fused:
                x, dk = _fk.fused_cheb_step(x, dk, rk, rho_k1 * rho_k,
                                            2.0 * rho_k1 / delta)
            else:
                dk = rho_k1 * rho_k * dk + (2.0 * rho_k1 / delta) * rk
                x = x + dk
            rk = rk - matvec(dk)
            rho_k = rho_k1
        return x

    return apply


class PreconditionerPlan:
    """Pattern-level preconditioner state, reusable across values refreshes.

    ``__init__`` is the eager ``build(pattern)`` stage (validates the name);
    :meth:`refresh_state` the values stage returning arrays only; and
    :meth:`make_apply` turns that state into the apply closure."""

    def __init__(self, name: Optional[str], row, col, shape, *,
                 stencil=None):
        self.name = "none" if name in (None, "none", "identity") else name
        if self.name not in PRECONDITIONERS:
            raise ValueError(f"unknown preconditioner {name!r}")
        if self.name in _LATER_SLICE:
            raise NotImplementedError(
                f"precond={self.name!r} is not ported yet (slice "
                f"{_LATER_SLICE[self.name]} of the PyTorch port); ported so "
                f"far: 'none', 'jacobi' and 'ilu'")
        self.row, self.col = row, col
        self.shape = tuple(shape)
        self.stencil = stencil
        if self.name == "ilu":
            # eager pattern part: the direct backend's symbolic stage in
            # zero-fill (ILU(0)) mode — structures + packed level schedule,
            # placed on the pattern's device once
            from . import direct as _direct
            from ._device import to_numpy
            art = _direct.symbolic_factor(to_numpy(row), to_numpy(col),
                                          self.shape[0], incomplete=True)
            self._ilu = _direct.to_device(
                art, getattr(row, "device", torch.device("cpu")))

    def fused_diag(self, A) -> Optional[torch.Tensor]:
        """Diagonal-inverse vector for the fused step kernels, or None when
        the apply is not a diagonal scale (``ilu``) — the fused solvers then
        keep the apply outside the fused pass (partial fusion)."""
        if self.name == "none":
            return torch.ones(self.shape[0], dtype=A.dtype, device=A.device)
        if self.name == "ilu":
            return None
        return _inv_diag(A.diagonal())

    def refresh_state(self, A, matvec: Callable) -> tuple:
        """Values-dependent stage, arrays only."""
        if self.name == "none":
            return ()
        if self.name == "ilu":
            from . import direct as _direct
            return (_direct.numeric_factor(self._ilu, A.val),)
        return (_inv_diag(A.diagonal()),)

    def make_apply(self, state, matvec: Callable,
                   fused: bool = False) -> Callable:
        """Apply closure over a :meth:`refresh_state` tuple."""
        if self.name == "none":
            return identity()
        if self.name == "ilu":
            from . import direct as _direct
            art = self._ilu
            (C,) = state
            return lambda r: _direct.factored_solve(art, C, r)
        (inv,) = state
        return lambda r: inv * r
