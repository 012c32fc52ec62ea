"""SparseNewton — nonlinear solves through the plan engine (port of
``repro.core.nonlinear``, paper §3.2.2).

The Jacobian sparsity of a mesh-based residual is FIXED: Newton changes the
values, never the pattern.  SparseNewton uses that the way the linear plan
engine does — analyze once, refresh values every step:

* **coloring** (once, numpy): a Curtis–Powell–Reid distance-1 coloring of
  the declared pattern (:func:`repro_torch.core.sparse.color_pattern`)
  compresses the Jacobian to ``n_colors`` probe directions, counted once in
  ``PLAN_STATS["jac_color"]``.  Each Newton step recovers the exact nnz
  values with ONE probe sweep, ``torch.func.vmap`` over ``torch.func.jvp``
  (``PLAN_STATS["jac_assemble"]``): the kernel wrappers' ``vmap`` rules run
  the colors' probes as one launch of the lane-batched kernel.  A user ``assemble_jacobian``
  callback replaces the sweep when a closed form is cheaper.
* **one plan serves every step**: the inner solve dispatches through the
  pattern's cached :class:`~repro_torch.core.dispatch.SolverPlan` (direct,
  AMG, ...), so ``PLAN_STATS["analyze"] == 1`` across a Newton sweep; a
  fresh values tensor per step is one setup (``factorize`` / ``galerkin``
  count the steps).
* **IFT backward on the converged step's setup**:
  :meth:`SparseNewton.solve_adjoint` solves Jᵀλ = g through
  ``plan.transpose()`` on the SAME values tensor the last step set up — a
  setup-memo hit, zero extra factorizations or Galerkin products.

The differentiable entry point is
:func:`repro_torch.core.adjoint.nonlinear_solve` with ``jac_pattern=``.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from . import dispatch as _dispatch
from . import options as _options
from ._device import resolve_device, to_numpy
from .dispatch import PLAN_STATS, SolverConfig
from .solvers import SolveInfo
from .sparse import SparseTensor, color_pattern, detect_properties

__all__ = ["SparseNewton"]


class SparseNewton:
    """Newton's method with a mesh-fixed sparse Jacobian through the plan
    engine — analyze once, one symbolic factorization (or AMG hierarchy)
    for every step, per-step values through the setup memo.

    Parameters
    ----------
    residual
        ``residual(u, *theta) -> F`` with ``F.shape == u.shape == (n,)``;
        it must compose with ``torch.func.jvp`` and ``vmap`` (the port's
        matvecs do).
    pattern
        The Jacobian sparsity: a :class:`~repro_torch.core.sparse.
        SparseTensor` (its props and plan cache are reused) or a
        ``(row, col)`` / ``(row, col, n)`` tuple of index arrays, placed on
        ``device``.  Entries of the true Jacobian outside the pattern are
        dropped.
    linear_solver
        Inner-solve :class:`~repro_torch.core.dispatch.SolverConfig`;
        ``None`` → auto-dispatch on the first assembled values.
    assemble_jacobian
        Optional ``assemble_jacobian(u, *theta) -> values`` on the declared
        pattern, replacing the coloring and the probe sweep.
    symmetric
        Override the symmetry detection (whether the adjoint shares the
        forward plan).  Default: the tensor pattern's props, else detected
        from the first assembled values.
    device
        Device of a tuple pattern's indices (default ``"cuda"``).

    The reference's traced branch (``_solve_traced``, a ``lax.while_loop``
    under ``jit``) has no torch counterpart: the port always runs the eager
    Newton loop.
    """

    def __init__(self, residual: Callable, pattern, *,
                 linear_solver: Optional[SolverConfig] = None,
                 assemble_jacobian: Optional[Callable] = None,
                 symmetric: Optional[bool] = None, device=None):
        self.residual = residual
        self.assemble_jacobian = assemble_jacobian
        self._symmetric = symmetric
        self._cfg0 = linear_solver
        self._cfg: Optional[SolverConfig] = None
        self._plan = None

        if isinstance(pattern, SparseTensor):
            n, m = pattern.shape
            if n != m:
                raise ValueError(f"Jacobian pattern must be square, "
                                 f"got {pattern.shape}")
            self.row, self.col, self.n = pattern.row, pattern.col, n
            self._template = pattern
            if symmetric is not None and symmetric != bool(
                    pattern.props.get("symmetric", False)):
                # different props change plan selection/sharing: give the
                # override its own template so the tensor's cached plans
                # (keyed on config only, not props) are not reused unsoundly
                t = SparseTensor(pattern.val, pattern.row, pattern.col,
                                 pattern.shape, props=dict(pattern.props),
                                 validate=False, device=pattern.device)
                t.props["symmetric"] = symmetric
                if not symmetric:
                    t.props["spd_hint"] = False
                self._template = t
        else:
            dev = resolve_device(device)
            if len(pattern) == 2:
                row, col = pattern
                n = int(max(to_numpy(row).max(), to_numpy(col).max())) + 1
            else:
                row, col, n = pattern
            self.row = torch.as_tensor(to_numpy(row), dtype=torch.int64,
                                       device=dev)
            self.col = torch.as_tensor(to_numpy(col), dtype=torch.int64,
                                       device=dev)
            self.n = int(n)
            self._template = None

        if assemble_jacobian is None:
            color, n_colors = color_pattern(self.row, self.col, self.n)
            budget = _options.current().jac_coloring_budget
            if n_colors > budget:
                raise ValueError(
                    f"Jacobian pattern needs {n_colors} colors (jvp probes "
                    f"per assembly) > jac_coloring_budget ({budget}); pass "
                    f"assemble_jacobian= or raise the option "
                    f"(sla.set_options(jac_coloring_budget=...))")
            PLAN_STATS["jac_color"] += 1
            self.n_colors = n_colors
            dev = self.row.device
            probes = np.zeros((n_colors, self.n))
            probes[color, np.arange(self.n)] = 1.0
            self._probes = torch.as_tensor(probes, device=dev)
            # entry e of the pattern reads probe-sweep slot
            # (color[col[e]], row[e]):  J[r,c] == (J @ p_color[c])[r]
            self._slot = torch.as_tensor(color[to_numpy(self.col)],
                                         device=dev)
        else:
            self.n_colors = 0

    # -- Jacobian values on the pattern --------------------------------------
    def assemble(self, u, *theta):
        """Numeric Jacobian values on the declared pattern at ``u`` — one
        ``vmap``-ed jvp sweep over the color probes (or the user
        callback)."""
        PLAN_STATS["jac_assemble"] += 1
        if self.assemble_jacobian is not None:
            return self.assemble_jacobian(u, *theta)

        def F(x):
            return self.residual(x, *theta)

        Jp = torch.func.vmap(lambda p: torch.func.jvp(F, (u,), (p,))[1])(
            self._probes.to(u.dtype))                         # (colors, n)
        return Jp[self._slot, self.row]

    # -- plan resolution (once) ----------------------------------------------
    def _ensure_plan(self, vals):
        if self._plan is not None:
            return self._plan
        tmpl = self._template
        if tmpl is None:
            props = detect_properties(vals, self.row, self.col,
                                      (self.n, self.n))
            if self._symmetric is not None:
                props["symmetric"] = self._symmetric
                if not self._symmetric:
                    props["spd_hint"] = False
            tmpl = SparseTensor(vals, self.row, self.col, (self.n, self.n),
                                props=props, validate=False,
                                device=self.row.device)
            self._template = tmpl
        cfg = self._cfg0 if self._cfg0 is not None else SolverConfig()
        if cfg.backend in (None, "auto") or cfg.method in (None, "auto"):
            cfg = cfg.resolved(tmpl)
        self._cfg = cfg
        self._plan = _dispatch.get_plan(tmpl, cfg)
        return self._plan

    @property
    def plan(self):
        """The analyzed :class:`~repro_torch.core.dispatch.SolverPlan` (None
        until the first solve resolves auto-dispatch against real values)."""
        return self._plan

    # -- Newton driver -------------------------------------------------------
    def solve(self, u0, *theta, tol: float = 1e-8, maxiter: int = 50,
              damping: float = 1.0):
        """Newton sweep: assemble values → plan.solve(J, −F) → update.
        Each step's fresh values tensor is a setup-memo miss, so
        ``factorize`` / ``galerkin`` count the steps.  Returns
        ``(u, SolveInfo)``, un-differentiated; for gradients w.r.t. ``theta``
        use :func:`repro_torch.core.adjoint.nonlinear_solve`."""
        u, info, _ = self._solve_full(u0, *theta, tol=tol, maxiter=maxiter,
                                      damping=damping)
        return u, info

    def _solve_full(self, u0, *theta, tol, maxiter, damping):
        """(u, info, vals_last) — vals_last is the values tensor whose setup
        the plan memoized, handed to :meth:`solve_adjoint` by the IFT
        backward so the adjoint refactorizes nothing.  The host reads the
        residual norm once per step."""
        u = u0
        Fu = self.residual(u, *theta)
        rn = float(torch.linalg.norm(Fu))
        vals = None
        k = 0
        while k < maxiter and rn > tol:
            vals = self.assemble(u, *theta)
            plan = self._ensure_plan(vals)
            dx, _ = plan.solve(plan.matrix(vals), -Fu, cfg=self._cfg)
            u = u + damping * dx
            Fu = self.residual(u, *theta)
            rn = float(torch.linalg.norm(Fu))
            k += 1
        if vals is None:
            # converged at u0: assemble (and set up) once so the adjoint
            # still has a setup to reuse
            vals = self.assemble(u, *theta)
            self._ensure_plan(vals)
        info = SolveInfo(torch.tensor(k), torch.tensor(rn, dtype=u.dtype),
                         torch.tensor(rn <= tol))
        return u, info, vals

    # -- IFT adjoint ---------------------------------------------------------
    def solve_adjoint(self, vals, g):
        """λ from Jᵀλ = g on the transpose view of the step plan.

        Pass the IDENTICAL values tensor the last forward step set up (the
        nonlinear_solve backward does): the shared setup memo then serves
        the backward — symmetric patterns reuse the plan outright, the
        direct backend runs the transposed sweeps on the forward factors.
        A copy or a ``detach()`` is a memo miss (a second setup)."""
        plan = self._ensure_plan(vals)
        tplan = plan.transpose()
        return tplan.solve(tplan.matrix(vals), g, None,
                           cfg=tplan.adapt(self._cfg))
