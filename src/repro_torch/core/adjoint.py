"""O(1)-graph adjoints of the linear solve, the log-determinant, the
nonlinear solve and the symmetric eigensolve (port of
``repro.core.adjoint``).

The solve is ONE ``torch.autograd.Function`` — torch-sla's own form — so the
autograd graph gains a single node whatever the number of Krylov
iterations.  The forward stashes only (A's values, x*); the backward solves
Aᵀλ = g on ``plan.transpose()`` and returns

    ∂L/∂b = λ,    ∂L/∂A_ij = −λ_i x_j   (on the sparsity pattern, O(nnz)).

Batches go through the same node: stacked values (*batch, nnz) and/or
right-hand sides (*batch, n) solve as one batched ``plan.solve``, the
backward solves the batched Aᵀλ = g on the same plan (the batched setup is a
memo hit), and each gradient is summed back to its operand's shape.

``sparse_slogdet`` is one Function as well: (sign, log|det A|) from the
direct backend's cached factors, with ∂ log|det A| / ∂A_ij = (A⁻ᵀ)_ij on
the pattern from transposed solves on the same factors.

``nonlinear_solve`` (one node from θ to u: Jᵀλ = g, ∂L/∂θ = −λᵀ∂F/∂θ) and
``sparse_eigsh`` (Hellmann–Feynman eigenvalue term plus one deflated CG
per pair for the eigenvectors) follow the same pattern.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import dispatch as _dispatch
from . import options as _options
from . import solvers as _solvers
from .dispatch import SolverConfig
from .sparse import SparseTensor, sum_to_shape

__all__ = ["sparse_solve", "sparse_solve_with_info", "dist_sparse_solve",
           "sparse_slogdet", "nonlinear_solve", "sparse_eigsh"]

#: right-hand sides per transposed multi-RHS solve in the slogdet backward
SLOGDET_CHUNK = 256


class _SparseSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, val, b, plan, cfg, x0):
        x, _ = plan.solve(plan.matrix(val), b, x0, cfg=cfg)
        ctx.plan, ctx.cfg = plan, cfg
        # keep the values object itself (and its version) on the plan side:
        # the backward's setup memo keys on its identity, so the symmetric
        # adjoint reuses the forward's setup (PLAN_STATS["setup_reuse"])
        ctx.val, ctx.val_version = val, val._version
        ctx.b_shape = b.shape
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
            gval = sum_to_shape(-(lam[..., plan.row] * x[..., plan.col]),
                                val.shape)
        if ctx.needs_input_grad[1]:
            gb = sum_to_shape(lam, ctx.b_shape)
        return gval, gb, None, None, None


def sparse_solve(cfg: SolverConfig, A: SparseTensor, b: torch.Tensor,
                 x0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable ``A.solve(b)``; ``cfg`` must already be resolved.

    The forward fetches (or analyzes once) the pattern's cached plan; the
    backward solves Aᵀλ = g through ``plan.transpose()`` — the SAME plan
    for symmetric patterns, a layout-sharing or once-analyzed sibling
    otherwise.  No re-dispatch and no re-analysis per call.  Stacked values
    and right-hand sides batch through the same node."""
    plan = _dispatch.get_plan(A, cfg)
    return _SparseSolve.apply(A.val, b, plan, cfg, x0)


def sparse_solve_with_info(cfg: SolverConfig, A: SparseTensor, b, x0=None):
    """Non-differentiable variant that also returns SolveInfo."""
    return _dispatch.solve_impl(cfg, A, b, x0)


# ---------------------------------------------------------------------------
# distributed linear solve (paper §3.3) — the same plan discipline on a mesh
# ---------------------------------------------------------------------------

class _DistSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, lval, b, D, plan, cfg, x0):
        x, _ = plan.solve(D.with_values(lval), b, x0, cfg=cfg)
        ctx.D, ctx.plan, ctx.cfg = D, plan, cfg
        # the values object itself: the backward's setup memo keys on it
        ctx.lval, ctx.val_version = lval, lval._version
        ctx.save_for_backward(x)
        return x

    @staticmethod
    def backward(ctx, g):
        from . import distributed as _dist
        (x,) = ctx.saved_tensors
        D, plan, cfg, lval = ctx.D, ctx.plan, ctx.cfg, ctx.lval
        if lval._version != ctx.val_version:
            raise RuntimeError(
                "the values of a solved DSparseTensor were modified in "
                "place before the backward pass")
        tplan = plan.transpose()
        g = g.contiguous()
        if tplan is plan:
            # symmetric: same plan, same values — the setup memo makes the
            # adjoint preconditioner refresh a reuse
            lam, _ = tplan.solve(D.with_values(lval), g, None,
                                 cfg=tplan.adapt(cfg))
        else:
            At = _dist.transpose_view(tplan,
                                      _dist.transpose_values(plan, lval))
            lam, _ = tplan.solve(At, g, None, cfg=tplan.adapt(cfg))
        gval = None
        if ctx.needs_input_grad[0]:
            gval = _dist.assemble_matrix_grad(plan, lam, x)
        return gval, lam, None, None, None, None


def dist_sparse_solve(cfg: SolverConfig, D, b: torch.Tensor,
                      x0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable ``DSparseTensor.solve`` through the plan engine.

    The forward fetches (or analyzes once) the distributed plan.  The
    backward solves Aᵀλ = g through ``plan.transpose()``: the SAME plan for
    symmetric patterns (halo program, preconditioner and the per-values
    setup reused), a shared-artifact sibling on the cached Aᵀ partition
    otherwise, whose stacked Aᵀ values come from the forward values through
    the plan's gather map.  The matrix gradient is the local O(nnz)
    assembly −λ_i x_j with halo'd x; ∂L/∂b = λ."""
    plan = _dispatch.get_plan(D, cfg)
    return _DistSolve.apply(D.lval, b, D, plan, cfg, x0)


# ---------------------------------------------------------------------------
# log-determinant — sparse via the cached LDLᵀ/LU factors within the
# direct_budget option, dense fallback beyond
# ---------------------------------------------------------------------------

def _slogdet_direct_plan(A: SparseTensor):
    """The direct-backend plan for a slogdet, or None when the sparse path
    does not apply (batched values, oversize pattern, missing structural
    diagonal)."""
    n, m = A.shape
    if n != m or A.batch_shape:
        return None
    if n > _options.current().direct_budget:
        return None
    if not _dispatch.BACKENDS["direct"].applicable(A):
        return None
    cfg = SolverConfig(backend="direct", method="auto").resolved(A)
    return _dispatch.get_plan(A, cfg)


def _inv_t_on_pattern(plan, C, row, col, n, dtype):
    """(A⁻ᵀ)[row, col] from the forward factors, without forming A⁻¹.

    Column j of A⁻ᵀ solves Aᵀ x = e_j; entry e needs column ``col[e]`` at
    row ``row[e]``.  The unit right-hand sides go through the transposed
    sweeps ``SLOGDET_CHUNK`` columns at a time, as one multi-RHS solve
    each, and only the pattern's entries of each chunk are kept."""
    from . import direct as _direct
    art = plan.artifacts["direct"]
    transposed = not plan.artifacts["transposed"]
    out = torch.empty(row.shape[0], dtype=dtype, device=row.device)
    order = torch.argsort(col)
    cs = col[order]
    for c0 in range(0, n, SLOGDET_CHUNK):
        c1 = min(c0 + SLOGDET_CHUNK, n)
        lo, hi = (int(v) for v in torch.searchsorted(
            cs, torch.tensor([c0, c1], device=cs.device)))
        if lo == hi:
            continue
        E = torch.zeros(n, c1 - c0, dtype=dtype, device=row.device)
        E[torch.arange(c0, c1, device=row.device),
          torch.arange(c1 - c0, device=row.device)] = 1.0
        X = _direct.factored_solve(art, C, E, transposed=transposed)
        sel = order[lo:hi]
        out[sel] = X[row[sel], col[sel] - c0]
    return out


class _SparseSlogdet(torch.autograd.Function):
    """(sign, log|det A|) as one autograd node.  ``plan`` is the direct
    backend's plan (the factors come from its setup memo, shared with
    ``backend="direct"`` solves) or None for the dense fallback."""

    @staticmethod
    def forward(ctx, val, plan, A):
        ctx.plan, ctx.A = plan, A
        # the values object itself: the backward's setup memo keys on it
        ctx.val, ctx.val_version = val, val._version
        if plan is None:
            sign, logabs = torch.linalg.slogdet(A.with_values(val).todense())
        else:
            from . import direct as _direct
            C = plan.setup(plan.matrix(val))      # memoized numeric factors
            # pivot-block aware: 2x2 Bunch–Kaufman pairs contribute their
            # block determinant, not the raw diagonal product
            sign, logabs = _direct.factor_slogdet(plan.artifacts["direct"], C)
        ctx.mark_non_differentiable(sign)
        return sign, logabs

    @staticmethod
    def backward(ctx, gsign, glog):
        plan, A, val = ctx.plan, ctx.A, ctx.val
        if val._version != ctx.val_version:
            raise RuntimeError(
                "the values of a SparseTensor were modified in place between "
                "slogdet and its backward pass")
        if plan is None:
            dense = A.with_values(val.detach()).todense()
            inv_t = torch.linalg.inv(dense).transpose(-1, -2)
            # d log|det| / dA_ij = (A⁻ᵀ)_ij restricted to the pattern
            return glog[..., None] * inv_t[..., A.row, A.col], None, None
        C = plan.setup(plan.matrix(val))          # memo hit: no refactorize
        gval = glog * _inv_t_on_pattern(plan, C, A.row, A.col, A.shape[0],
                                        val.dtype)
        return gval, None, None


def sparse_slogdet(A: SparseTensor):
    """(sign, log|det A|) with gradients on the sparsity pattern.

    Square concrete patterns within the ``direct_budget`` option run on the
    plan engine's cached LDLᵀ/LU factors (the same numeric factorization a
    ``backend="direct"`` solve memoizes): with the symmetric fill-reducing
    permutation det(P A Pᵀ) = det(A) and unit-diagonal L, the determinant is
    the product of the stored pivots (2x2 pair blocks included) — O(nnz_L)
    work and memory, no densification.  The backward solves Aᵀ X = I on the
    SAME factors, in column chunks, keeping only X's entries on the pattern:
    never an n×n matrix.  Batched values, oversize or diagonal-deficient
    patterns take the dense fallback."""
    return _SparseSlogdet.apply(A.val, _slogdet_direct_plan(A), A)


# ---------------------------------------------------------------------------
# nonlinear solve (paper §3.2.2 "Nonlinear systems")
# ---------------------------------------------------------------------------

class _NonlinearSolve(torch.autograd.Function):
    """u(θ) with F(u, θ) = 0 as ONE autograd node.  ``forward_fn(theta)``
    returns (u, vals) — ``vals`` the SparseNewton values tensor whose setup
    the plan memoized (None on the matrix-free route); ``adjoint_fn(u, vals,
    theta, g)`` returns λ from Jᵀλ = g."""

    @staticmethod
    def forward(ctx, forward_fn, adjoint_fn, residual, *theta):
        u, vals = forward_fn(theta)
        # the values object itself, not a copy or a detach(): the backward's
        # setup memo keys on its identity (a miss is a second setup)
        ctx.vals, ctx.adjoint_fn, ctx.residual = vals, adjoint_fn, residual
        ctx.save_for_backward(u, *theta)
        return u

    @staticmethod
    def backward(ctx, g):
        u, *theta = ctx.saved_tensors
        lam = ctx.adjoint_fn(u, ctx.vals, theta, g.contiguous())
        # ∂L/∂θ = −λᵀ ∂F/∂θ
        _, vjp_th = torch.func.vjp(lambda *th: ctx.residual(u, *th), *theta)
        return (None, None, None) + tuple(-t for t in vjp_th(lam))


def nonlinear_solve(residual, x0: torch.Tensor, *theta,
                    method: str = "newton", tol: float = 1e-8,
                    maxiter: int = 50, inner_tol: float = 1e-10,
                    inner_maxiter: int = 1000, damping: float = 1.0,
                    anderson_m: int = 5, linear_solver=None,
                    jac_pattern=None, assemble_jacobian=None,
                    symmetric: Optional[bool] = None):
    """Solve F(u, θ) = 0 for u with O(1)-graph adjoint gradients w.r.t. θ.

    ``residual(u, *theta)`` is a torch function of tensors that composes
    with ``torch.func`` (``jvp``, ``vmap``, ``vjp``); ``theta`` are tensors.
    The forward may take many Newton / Picard / Anderson iterations (under
    ``no_grad``); the backward is ONE adjoint solve Jᵀλ = g plus one VJP
    into θ.

    Default (matrix-free) route: Newton's inner solves and the adjoint run
    BiCGStab on ``torch.func.jvp`` / ``vjp`` of the residual.  SparseNewton
    route: pass ``jac_pattern=`` (a SparseTensor or ``(row, col[, n])``)
    and optionally ``linear_solver=`` (a ``SolverConfig``: ``backend=
    "direct"``, ``precond="amg"``, ...); the pattern is colored once, one
    analyzed plan serves every step, and the backward solves Jᵀλ = g
    through ``plan.transpose()`` on the converged step's setup (see
    :class:`repro_torch.core.nonlinear.SparseNewton`).
    ``assemble_jacobian(u, *theta) -> values`` replaces the colored
    assembly; ``symmetric=`` overrides the pattern's symmetry detection.
    For ``method="picard"`` / ``"anderson"`` (iterating u ← u − F) the
    backward still runs through the plan: one assembly at the converged
    point."""
    theta = tuple(theta)
    if method not in ("newton", "picard", "anderson"):
        raise ValueError(f"unknown nonlinear method {method!r}")
    sn = None
    if jac_pattern is not None:
        from .nonlinear import SparseNewton
        cfg = linear_solver if linear_solver is not None else \
            SolverConfig(tol=inner_tol, maxiter=inner_maxiter)
        sn = SparseNewton(residual, jac_pattern, linear_solver=cfg,
                          assemble_jacobian=assemble_jacobian,
                          symmetric=symmetric, device=x0.device)
    elif linear_solver is not None:
        raise ValueError("linear_solver= requires jac_pattern= declaring "
                         "the Jacobian sparsity")

    def forward_fn(th):
        def F(u):
            return residual(u, *th)
        vals = None
        if method == "newton":
            if sn is not None:
                u, _, vals = sn._solve_full(x0, *th, tol=tol,
                                            maxiter=maxiter, damping=damping)
            else:
                u, _ = _solvers.newton_solve(F, x0, tol=tol, maxiter=maxiter,
                                             damping=damping,
                                             inner_tol=inner_tol,
                                             inner_maxiter=inner_maxiter)
        elif method == "picard":
            u, _ = _solvers.picard_solve(lambda u: u - F(u), x0, tol=tol,
                                         maxiter=maxiter)
        else:
            u, _ = _solvers.anderson_solve(lambda u: u - F(u), x0, tol=tol,
                                           maxiter=maxiter, m=anderson_m)
        if sn is not None and vals is None:
            # fixed-point forward, plan-engine backward: one assembly at u*
            vals = sn.assemble(u, *th)
        # a start that is already a root comes back as x0 itself: the node's
        # output must be a tensor of its own, not the caller's
        return (u.clone() if u is x0 else u), vals

    def adjoint_fn(u, vals, th, g):
        if vals is not None:
            # Jᵀλ = g on the transpose view of the step plan — the converged
            # setup reused, zero refactorization (Eq. 2)
            lam, _ = sn.solve_adjoint(vals, g)
            return lam
        # matrix-free via vjp (exact only once F(u*, θ) ≈ 0)
        _, vjp_u = torch.func.vjp(lambda uu: residual(uu, *th), u)
        lam, _ = _solvers.bicgstab(lambda v: vjp_u(v)[0], g, tol=inner_tol,
                                   maxiter=inner_maxiter)
        return lam

    return _NonlinearSolve.apply(forward_fn, adjoint_fn, residual, *theta)


# ---------------------------------------------------------------------------
# symmetric eigensolve (paper §3.2.2 "Eigenvalue problems")
# ---------------------------------------------------------------------------

class _SparseEigsh(torch.autograd.Function):
    """(w, V) of ``A.with_values(val)`` as one autograd node; ``impl(val)``
    runs the eigensolver, ``make_M(val, mv)`` builds the plan
    preconditioner (None: unpreconditioned)."""

    @staticmethod
    def forward(ctx, val, A, impl, make_M, opts):
        w, V = impl(val)
        # the values object itself: the backward's preconditioner setup is
        # a memo hit on it
        ctx.val, ctx.A, ctx.make_M, ctx.opts = val, A, make_M, opts
        ctx.save_for_backward(w, V)
        return w, V

    @staticmethod
    def backward(ctx, gw, gV):
        w, V = ctx.saved_tensors
        val, A, o = ctx.val, ctx.A, ctx.opts
        row, col = A.row, A.col
        # Hellmann–Feynman eigenvalue term: Σ_k gw_k v_ki v_kj on the pattern
        gval = torch.einsum("k,ke,ke->e", gw, V[:, row], V[:, col])
        if not o["compute_vector_grads"]:
            return gval, None, None, None, None
        # eigenvector term: y v_kᵀ with y = (λ_k I − A)⁺ (I − v_k v_kᵀ) g.
        # The other COMPUTED pairs contribute analytically (gᵀv_j/(λ_k−λ_j));
        # the uncomputed complement takes one deflated CG solve.
        mv = _dispatch.make_matvec(A.with_values(val))
        # the forward's preconditioner (setup-memo hit on ``val``); none for
        # largest=True, where the deflated operator is negative
        Mp = ctx.make_M(val, mv) if (ctx.make_M is not None
                                     and not o["largest"]) else None
        k = w.shape[0]
        ks = torch.arange(k, device=w.device)

        def proj(z):
            return z - V.T @ (V @ z)

        for i in range(k):
            lam_i, v_i, gv = w[i], V[i], gV[i]
            # analytic part over computed pairs j ≠ i (simple eigenvalues
            # assumed — paper §5)
            dif = lam_i - w
            coeff = torch.where(
                ks == i, torch.zeros_like(w),
                (V @ gv) / torch.where(dif.abs() < 1e-12,
                                       torch.full_like(dif, float("inf")),
                                       dif))
            y_comp = coeff @ V

            def op(z, lam_i=lam_i):
                pz = proj(z)
                return proj(mv(pz) - lam_i * pz)

            Mdef = _solvers._identity if Mp is None else \
                (lambda z: proj(Mp(proj(z))))
            y_rest, _ = _solvers.cg(op, -proj(gv), M=Mdef, tol=o["tol"],
                                    maxiter=o["maxiter"] * 4)
            y = y_comp + proj(y_rest)
            # the solver sees sym(A): differentiate the symmetrized map
            gval = gval + 0.5 * (y[row] * v_i[col] + v_i[row] * y[col])
        return gval, None, None, None, None


def sparse_eigsh(A: SparseTensor, k: int = 6, *, method: str = "lobpcg",
                 tol: float = 1e-6, maxiter: int = 200,
                 compute_vector_grads: bool = True, largest: bool = False,
                 precond: Optional[str] = None, seed: int = 0):
    """k extremal eigenpairs of symmetric A with Hellmann–Feynman adjoint.

    Returns ``(w (k,), V (k, n))``.  Eigenvalue cotangents cost one O(nnz)
    outer product; eigenvector cotangents one deflated CG solve per pair.
    Simple (non-degenerate) eigenvalues assumed — paper §5.  LOBPCG's start
    block and Lanczos' start vector are :func:`~repro_torch.core.solvers.
    seeded_normal` draws (a CPU generator seeded with ``seed``).

    ``precond`` (``"amg"``, ``"jacobi"``, ...; LOBPCG only) routes the
    residual preconditioner through the plan engine: the pattern's cached
    plan builds the hierarchy once, the values setup goes through the
    plan's memo (shared with linear solves on the same tensor), and the
    backward's deflated CG reuses the same apply (``largest=False`` only).
    """
    n = A.shape[0]
    if A.batch_shape:
        raise NotImplementedError(
            "eigsh does not support batched values (B, nnz), as the "
            "reference's eigsh does not; call eigsh lane by lane, on "
            "A.with_values(vals[b]) for each b")
    if method not in ("lobpcg", "lanczos"):
        raise ValueError(f"unknown eig method {method!r}")
    pplan = None
    if precond is not None:
        if method != "lobpcg":
            raise ValueError(f"precond= requires method='lobpcg', "
                             f"got method={method!r}")
        pcfg = SolverConfig(backend="jnp", method="cg", tol=tol,
                            maxiter=maxiter, precond=precond)
        pplan = _dispatch.get_plan(A, pcfg)

    def make_M(val, mv):
        """Single-vector preconditioner apply from the plan's memoized
        values setup — LOBPCG applies it to each residual row."""
        state = pplan.setup(pplan.matrix(val))
        return pplan.artifacts["precond"].make_apply(state[1], mv)

    def impl(val):
        mv = _dispatch.make_matvec(A.with_values(val))
        if method == "lobpcg":
            X0 = _solvers.seeded_normal((k, n), val.dtype, val.device, seed)
            M = make_M(val, mv) if pplan is not None else _solvers._identity
            w, V, _ = _solvers.lobpcg(mv, X0, M=M, tol=tol, maxiter=maxiter,
                                      largest=largest)
            return w, V
        mv2 = mv if not largest else (lambda v: -mv(v))
        w, V = _solvers.eigsh_lanczos(mv2, n, k,
                                      num_steps=min(max(4 * k, 32), n),
                                      dtype=val.dtype, seed=seed,
                                      device=val.device)
        return (-w.flip(0), V.flip(0)) if largest else (w, V)

    opts = dict(compute_vector_grads=compute_vector_grads, largest=largest,
                tol=tol, maxiter=maxiter)
    return _SparseEigsh.apply(A.val, A, impl,
                              make_M if pplan is not None else None, opts)
