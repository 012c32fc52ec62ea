"""Preconditioners (port of ``repro.core.precond``).

Every preconditioner of the reference's single-device plan stands behind
:class:`PreconditionerPlan`, split like the reference into an eager pattern
stage (``__init__``), an arrays-only values stage
(:meth:`PreconditionerPlan.refresh_state`, run once per values tensor by the
plan's setup) and a closure assembly (:meth:`PreconditionerPlan.make_apply`,
run per solve):

* ``jacobi`` — the paper's diagonal scaling;
* ``block_jacobi`` — dense inverses of the diagonal blocks (block 128,
  ``torch.linalg.inv_ex``, a library call as the reference's
  ``jnp.linalg.inv``), applied as one batched product;
* ``chebyshev`` — the Chebyshev polynomial on Lanczos spectrum bounds
  (:func:`estimate_spectrum`, once per setup); with ``fused`` its inner step
  is the ``fused_cheb_step`` kernel;
* ``mg`` — the geometric V-cycle on the stencil planes, every smoothing
  matvec on the ``stencil5`` kernel (:mod:`repro_torch.core.multigrid`);
* ``amg`` — smoothed-aggregation AMG: numpy coarsening and Galerkin
  programs at analyze time, the numeric hierarchy per values tensor, the
  coarsest level on the direct solver's panel kernels;
* ``ilu`` — ILU(0)/IC(0) on the direct solver's machinery: the
  ``incomplete=True`` symbolic program at analyze time, its numeric
  factorization per values tensor, the factored solve as M⁻¹.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["identity", "jacobi", "chebyshev", "estimate_spectrum",
           "PreconditionerPlan", "make_preconditioner"]

PRECONDITIONERS = ("none", "identity", "jacobi", "block_jacobi", "chebyshev",
                   "mg", "amg", "ilu")


def identity():
    return lambda r: r


def _inv_diag(d: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    return torch.where(torch.abs(d) > eps, 1.0 / d, torch.ones_like(d))


def jacobi(diag: torch.Tensor, eps: float = 1e-30):
    """M⁻¹ = D⁻¹ — the paper's default for the PyTorch-native backend."""
    inv = _inv_diag(diag, eps)
    return lambda r: inv * r


# ---------------------------------------------------------------------------
# block-Jacobi
# ---------------------------------------------------------------------------

def _bj_indices(row: np.ndarray, col: np.ndarray, block: int):
    """(scatter target, in-diagonal-block mask) of COO entries — the
    pattern half of block-Jacobi (numpy)."""
    rb = row // block
    same = rb == (col // block)
    flat = (rb * block + row % block) * block + col % block
    return np.where(same, flat, 0), same


def _bj_assemble(val: torch.Tensor, safe: torch.Tensor, same: torch.Tensor,
                 nb: int, block: int) -> torch.Tensor:
    """Scatter the diagonal-block entries into (nb, B, B); off-block
    entries add an explicit zero into slot 0, structurally empty diagonal
    slots (the padded tail rows) become 1."""
    contrib = torch.where(same, val, torch.zeros_like(val))
    blocks = val.new_zeros(nb * block * block).index_add_(0, safe, contrib)
    blocks = blocks.reshape(nb, block, block)
    ar = torch.arange(block, device=val.device)
    d = blocks[:, ar, ar]
    blocks[:, ar, ar] = torch.where(d.abs() < 1e-12, torch.ones_like(d), d)
    return blocks


def _bj_apply(inv: torch.Tensor, n: int, nb: int, block: int):
    def apply(rvec):
        rp = torch.nn.functional.pad(rvec, (0, nb * block - n))
        out = torch.bmm(inv, rp.reshape(nb, block, 1)).reshape(nb * block)
        return out[:n]
    return apply


# ---------------------------------------------------------------------------
# Chebyshev
# ---------------------------------------------------------------------------

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


def _start_vector(n: int, dtype, device, seed: int) -> torch.Tensor:
    """Lanczos start vector: standard normal from a CPU ``torch.Generator``
    seeded with ``seed``, so the CPU and the card start alike.  (The
    reference draws ``jax.random.normal(PRNGKey(seed))``, which torch cannot
    reproduce; pass ``v0`` to :func:`estimate_spectrum` for that.)"""
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(n, generator=g, dtype=dtype).to(device)


def estimate_spectrum(matvec: Callable, n: int, dtype=torch.float32,
                      steps: int = 16, seed: int = 0, *, v0=None,
                      device=None):
    """Lanczos-based extremal eigenvalue estimate for the Chebyshev bounds
    (once per setup, not per solve).  ``v0`` (tensor or numpy) replaces the
    seeded start vector.  Returns 0-dim tensors ``(λ_min, λ_max)``."""
    from .solvers import lanczos
    if v0 is None:
        v0 = _start_vector(n, dtype, device, seed)
    else:
        v0 = torch.as_tensor(np.array(v0) if isinstance(v0, np.ndarray)
                             else v0).to(device=device, dtype=dtype)
    a, b_, _ = lanczos(matvec, v0, steps)
    T = torch.diag(a) + torch.diag(b_[:-1], 1) + torch.diag(b_[:-1], -1)
    w = torch.linalg.eigvalsh(T)
    return w[0], w[-1]


# ---------------------------------------------------------------------------
# plan protocol: build(pattern) eager / refresh_state(values) / make_apply
# ---------------------------------------------------------------------------

class PreconditionerPlan:
    """Pattern-level preconditioner state, reusable across values refreshes.

    ``__init__`` is the eager ``build(pattern)`` stage: it validates the
    choice against the pattern and places every values-independent artifact
    on the pattern's device once; :meth:`refresh_state` the values stage
    returning arrays only; and :meth:`make_apply` turns that state into the
    apply closure."""

    def __init__(self, name: Optional[str], row, col, shape, *,
                 stencil=None, block: int = 128, degree: int = 8):
        from ._device import to_numpy
        self.name = "none" if name in (None, "none", "identity") else name
        if self.name not in PRECONDITIONERS:
            raise ValueError(f"unknown preconditioner {name!r}")
        self.row, self.col = row, col
        self.shape = tuple(shape)
        self.stencil = stencil
        self.block = block
        self.degree = degree
        device = getattr(row, "device", torch.device("cpu"))
        if self.name == "mg":
            if stencil is None:
                raise ValueError(
                    "precond='mg' needs a stencil-layout SparseTensor "
                    "(structured-grid operator)")
            if stencil.nx != stencil.ny:
                raise ValueError("precond='mg' requires a square grid")
        if self.name == "block_jacobi":
            # eager pattern part: diagonal-block membership + scatter targets
            self.nb = -(-self.shape[0] // block)
            safe, same = _bj_indices(to_numpy(row).astype(np.int64),
                                     to_numpy(col).astype(np.int64), block)
            self._bj_idx = (torch.as_tensor(safe, device=device),
                            torch.as_tensor(same, device=device))
        if self.name == "ilu":
            # eager pattern part: the direct backend's symbolic stage in
            # zero-fill (ILU(0)) mode — structures + packed level schedule,
            # placed on the pattern's device once
            from . import direct as _direct
            art = _direct.symbolic_factor(to_numpy(row), to_numpy(col),
                                          self.shape[0], incomplete=True)
            self._ilu = _direct.to_device(art, device)
        if self.name == "amg":
            # eager pattern part: smoothed-aggregation coarsening + the
            # Galerkin index programs + the coarsest level's LDLᵀ/LU program
            from . import multigrid as _mg
            art = _mg.amg_symbolic(to_numpy(row), to_numpy(col),
                                   self.shape[0])
            self._amg = _mg.amg_to_device(art, device)

    def fused_diag(self, A) -> Optional[torch.Tensor]:
        """Diagonal-inverse vector for the fused step kernels, or None when
        the apply is not a diagonal scale — the fused solvers then keep the
        apply outside the fused pass (partial fusion)."""
        if self.name == "none":
            return torch.ones(self.shape[0], dtype=A.dtype, device=A.device)
        if self.name == "jacobi":
            return _inv_diag(A.diagonal())
        return None

    def refresh_state(self, A, matvec: Callable) -> tuple:
        """Values-dependent stage, arrays only."""
        if self.name == "none":
            return ()
        if self.name == "jacobi":
            return (_inv_diag(A.diagonal()),)
        if self.name == "block_jacobi":
            safe, same = self._bj_idx
            blocks = _bj_assemble(A.val, safe, same, self.nb, self.block)
            return (torch.linalg.inv_ex(blocks)[0],)
        if self.name == "chebyshev":
            lmin, lmax = estimate_spectrum(matvec, self.shape[0], A.dtype,
                                           device=A.device)
            lmin = torch.maximum(lmin, lmax * 1e-4)
            return (lmin, lmax)
        if self.name == "mg":
            from .multigrid import MultigridPreconditioner
            nx, ny = self.stencil.nx, self.stencil.ny
            v5 = A.val.reshape(5, nx, ny)
            return MultigridPreconditioner.from_planes(v5).state()
        if self.name == "ilu":
            from . import direct as _direct
            return (_direct.numeric_factor(self._ilu, A.val),)
        if self.name == "amg":
            from . import multigrid as _mg
            return _mg.amg_numeric(self._amg, A.val)
        raise ValueError(f"unknown preconditioner {self.name!r}")

    def make_apply(self, state, matvec: Callable,
                   fused: bool = False) -> Callable:
        """Apply closure over a :meth:`refresh_state` tuple.  ``fused``
        routes Chebyshev's inner step through ``fused_cheb_step``; it is a
        solve-time decision, never part of the state."""
        if self.name == "none":
            return identity()
        if self.name == "jacobi":
            (inv,) = state
            return lambda r: inv * r
        if self.name == "block_jacobi":
            (inv,) = state
            return _bj_apply(inv, self.shape[0], self.nb, self.block)
        if self.name == "chebyshev":
            # the bounds as host floats: one read per solve, and the
            # recurrence's scalars launch nothing
            lmin, lmax = (float(t) for t in state)
            return chebyshev(matvec, lmin, lmax, degree=self.degree,
                             fused=fused)
        if self.name == "mg":
            from .multigrid import MultigridPreconditioner
            return MultigridPreconditioner.from_state(state)
        if self.name == "ilu":
            from . import direct as _direct
            art = self._ilu
            (C,) = state
            return lambda r: _direct.factored_solve(art, C, r)
        if self.name == "amg":
            from .multigrid import AMGPreconditioner
            return AMGPreconditioner(self._amg, state)
        raise ValueError(f"unknown preconditioner {self.name!r}")

    def refresh(self, A, matvec: Callable, fused: bool = False) -> Callable:
        """:meth:`refresh_state` + :meth:`make_apply` in one call."""
        return self.make_apply(self.refresh_state(A, matvec), matvec,
                               fused=fused)


def make_preconditioner(name: str, A, matvec: Callable) -> Callable:
    """One-shot factory: build(pattern) + refresh(values) in one call.
    Prefer going through a ``SolverPlan`` so the build stage is cached."""
    plan = PreconditionerPlan(name, A.row, A.col, A.shape,
                              stencil=A.stencil)
    return plan.refresh(A, matvec)
