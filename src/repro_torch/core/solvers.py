"""Krylov solvers (port of the linear part of ``repro.core.solvers``).

Every solver is *matvec-parametric* — it takes a closure ``matvec(x) -> Ax``
— so one loop serves the COO, block-ELL and stencil kernels.  Solves run
under ``torch.no_grad`` semantics (the adjoint layer differentiates them).

The reference's ``lax.while_loop`` becomes :func:`_loop`, a Python loop with
the same result: the returned ``x`` and ``iters`` are those of the first k
with ‖r_k‖ ≤ target (or k = maxiter).  On the CPU it checks the condition
every iteration.  On CUDA it carries a device-side ``active`` flag instead —
the fused kernels skip their writes and the plain loops keep their old state
once the flag drops — and reads it on the host only every
``CHECK_EVERY["cuda"]`` iterations, so the card is not stalled by a sync per
iteration.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

__all__ = [
    "SolveInfo", "SolveResult", "as_solve_result", "cg", "cg_fused",
    "bicgstab", "bicgstab_fused", "dense_solve", "CHECK_EVERY",
]

#: iterations between host reads of the convergence flag, per device type
CHECK_EVERY = {"cpu": 1, "cuda": 16}


class SolveInfo(NamedTuple):
    iters: torch.Tensor       # iterations executed
    resnorm: torch.Tensor     # final ‖r‖₂
    converged: torch.Tensor   # bool


class SolveResult(NamedTuple):
    """Typed solve payload — what :func:`repro_torch.sla.solve_with_info`
    returns.  ``reason`` is ``"converged"`` or ``"maxiter"``."""
    x: torch.Tensor
    iterations: torch.Tensor
    residual: torch.Tensor
    converged: torch.Tensor
    reason: str


def as_solve_result(x, info: SolveInfo,
                    reason: Optional[str] = None) -> SolveResult:
    """Wrap a backend's ``(x, SolveInfo)`` pair into a :class:`SolveResult`."""
    if reason is None:
        reason = "converged" if bool(torch.all(info.converged)) else "maxiter"
    return SolveResult(x=x, iterations=info.iters, residual=info.resnorm,
                       converged=info.converged, reason=reason)


def _identity(x):
    return x


def _dot(u, v):
    return torch.dot(u, v)


def _keep(on, new, old):
    """``new`` where the loop is still active, else ``old`` (no host sync)."""
    return torch.where(on, new, old)


def _loop(cond: Callable, body: Callable, state: tuple) -> tuple:
    """``lax.while_loop(cond, body, state)`` with a device-side active flag.

    ``cond(state)`` is a 0-dim bool tensor; ``body(state, active)`` returns
    the next state and must leave every quantity the caller reads after the
    loop unchanged when ``active`` (0-dim int32) is 0.  Since the flag only
    ever drops, the state after the loop is that of the first iteration
    where ``cond`` failed, however late the host notices."""
    every = CHECK_EVERY.get(state[0].device.type, 1)
    active = cond(state).to(torch.int32)
    it = 0
    while True:
        if it % every == 0 and not bool(active):
            break
        state = body(state, active)
        active = active * cond(state).to(torch.int32)
        it += 1
    return state


def _target(b, tol, atol, dot):
    bnorm = torch.sqrt(dot(b, b))
    return torch.clamp_min(tol * bnorm, atol)


# ---------------------------------------------------------------------------
# Krylov solvers
# ---------------------------------------------------------------------------

def cg(matvec: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
       *, M: Callable = _identity, tol: float = 1e-6, atol: float = 0.0,
       maxiter: int = 1000, min_iter: int = 0,
       dot: Optional[Callable] = None):
    """Preconditioned conjugate gradient (Hestenes–Stiefel), two inner
    products per iteration."""
    x0 = torch.zeros_like(b) if x0 is None else x0
    dot = dot or _dot
    target = _target(b, tol, atol, dot)
    r0 = b - matvec(x0)
    z0 = M(r0)
    k0 = torch.zeros((), dtype=torch.int64, device=b.device)

    def cond(st):
        x, r, p, rz, k = st
        return (k < maxiter) & ((torch.sqrt(dot(r, r)) > target)
                                | (k < min_iter))

    def body(st, act):
        x, r, p, rz, k = st
        on = act != 0
        Ap = matvec(p)
        alpha = rz / dot(p, Ap)
        xn = x + alpha * p
        rn = r - alpha * Ap
        z = M(rn)
        rz_new = dot(rn, z)
        pn = z + (rz_new / rz) * p
        return (_keep(on, xn, x), _keep(on, rn, r), _keep(on, pn, p),
                _keep(on, rz_new, rz), k + act)

    x, r, p, rz, k = _loop(cond, body, (x0, r0, z0, dot(r0, z0), k0))
    rn = torch.sqrt(dot(r, r))
    return x, SolveInfo(k, rn, rn <= target)


def bicgstab(matvec: Callable, b: torch.Tensor,
             x0: Optional[torch.Tensor] = None, *, M: Callable = _identity,
             tol: float = 1e-6, atol: float = 0.0, maxiter: int = 1000,
             dot: Optional[Callable] = None):
    """BiCGStab (van der Vorst 1992) with the reference's ρ-breakdown
    restart (r̂ ← r when <r̂, r> underflows)."""
    x0 = torch.zeros_like(b) if x0 is None else x0
    dot = dot or _dot
    target = _target(b, tol, atol, dot)
    eps = torch.tensor(1e-30, dtype=b.dtype, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    r0 = b - matvec(x0)

    def cond(st):
        x, r, rhat, p, v, rho, alpha, omega, k, fresh = st
        return (k < maxiter) & (torch.sqrt(dot(r, r)) > target)

    def body(st, act):
        x, r, rhat, p, v, rho_prev, alpha, omega, k, fresh = st
        on = act != 0
        rho = dot(rhat, r)
        rr = dot(r, r)
        restart = (torch.abs(rho) < 1e-12 * rr) | fresh
        rhat = torch.where(restart, r, rhat)
        rho = torch.where(restart, rr, rho)
        beta = (rho / (rho_prev + eps)) * (alpha / (omega + eps))
        beta = torch.where(restart, zero, beta)
        p = torch.where(restart, r, r + beta * (p - omega * v))
        phat = M(p)
        v = matvec(phat)
        alpha = rho / (dot(rhat, v) + eps)
        s = r - alpha * v
        shat = M(s)
        t = matvec(shat)
        omega_new = dot(t, s) / (dot(t, t) + eps)
        xn = x + alpha * phat + omega_new * shat
        rn = s - omega_new * t
        return (_keep(on, xn, x), _keep(on, rn, r), rhat, p, v, rho, alpha,
                omega_new, k + act, torch.zeros_like(fresh))

    z = torch.zeros_like(b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    k0 = torch.zeros((), dtype=torch.int64, device=b.device)
    fresh = torch.ones((), dtype=torch.bool, device=b.device)
    st0 = (x0, r0, r0, z, z, one, one, one, k0, fresh)
    x, r, *_, k, _ = _loop(cond, body, st0)
    rn = torch.sqrt(dot(r, r))
    return x, SolveInfo(k, rn, rn <= target)


def cg_fused(matvec: Callable, b: torch.Tensor,
             x0: Optional[torch.Tensor] = None, *,
             dinv: Optional[torch.Tensor] = None, M: Callable = _identity,
             tol: float = 1e-6, atol: float = 0.0, maxiter: int = 1000,
             min_iter: int = 0):
    """CG with the iteration fused into the step kernels.

    With a diagonal preconditioner (``dinv`` given) this is the merged
    Chronopoulos–Gear recurrence: α' = ρ'/(δ − βρ'/α) with δ = <Az, z>, so
    each iteration is one matvec plus exactly two fused vector sweeps
    (``fused_cg_update`` and ``fused_cg_direction``), which update x, r, p
    and s in place.  Without ``dinv`` the textbook recurrence is kept and
    only the axpy/convergence-dot passes fuse (``fused_cg_halfstep``)."""
    from ..kernels import solve_step as _fk

    dot = _dot
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    target = _target(b, tol, atol, dot)
    eps = torch.tensor(1e-30, dtype=b.dtype, device=b.device)
    r = b - matvec(x)
    rr0 = dot(r, r)
    k0 = torch.zeros((), dtype=torch.int64, device=b.device)

    def cond(st):
        rr, k = st[-2], st[-1]
        return (k < maxiter) & ((torch.sqrt(rr) > target) | (k < min_iter))

    if dinv is not None:
        p = dinv * r
        s = matvec(p)
        z = torch.empty_like(b)
        rho0 = dot(r, p)
        alpha0 = rho0 / (dot(p, s) + eps)

        def body(st, act):
            rho, alpha, rr, k = st
            on = act != 0
            _, _, _, rho_new, rr_new = _fk.fused_cg_update(
                x, r, p, s, dinv, alpha, out=(x, r, z), active=act)
            w = matvec(z)
            beta = rho_new / (rho + eps)
            _, _, delta = _fk.fused_cg_direction(z, w, p, s, beta,
                                                 out=(p, s), active=act)
            alpha_new = rho_new / (delta - beta * rho_new / (alpha + eps) + eps)
            return (_keep(on, rho_new, rho), _keep(on, alpha_new, alpha),
                    _keep(on, rr_new, rr), k + act)

        *_, rr, k = _loop(cond, body, (rho0, alpha0, rr0, k0))
    else:
        p = M(r)
        rz0 = dot(r, p)

        def body(st, act):
            p, rz, rr, k = st
            on = act != 0
            Ap = matvec(p)
            alpha = rz / (dot(p, Ap) + eps)
            _, _, rr_new = _fk.fused_cg_halfstep(x, r, p, Ap, alpha,
                                                 out=(x, r), active=act)
            z = M(r)
            rz_new = dot(r, z)
            pn = z + (rz_new / (rz + eps)) * p
            return (pn, _keep(on, rz_new, rz), _keep(on, rr_new, rr), k + act)

        *_, rr, k = _loop(cond, body, (p, rz0, rr0, k0))

    rn = torch.sqrt(rr)
    return x, SolveInfo(k, rn, rn <= target)


def bicgstab_fused(matvec: Callable, b: torch.Tensor,
                   x0: Optional[torch.Tensor] = None, *,
                   dinv: Optional[torch.Tensor] = None,
                   M: Callable = _identity, tol: float = 1e-6,
                   atol: float = 0.0, maxiter: int = 1000):
    """BiCGStab with fused step kernels: ``fused_bicg_p`` / ``fused_bicg_s``
    (diagonal preconditioner folded in), ``fused_dots2`` (ω numerator and
    denominator in one read) and ``fused_bicg_tail`` (x/r updates plus next
    iteration's <r̂,r'> and the convergence dot <r',r'>)."""
    from ..kernels import solve_step as _fk

    dot = _dot
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    target = _target(b, tol, atol, dot)
    eps = torch.tensor(1e-30, dtype=b.dtype, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    r = b - matvec(x)
    rr0 = dot(r, r)
    if dinv is not None:
        phat = torch.empty_like(b)
        s = torch.empty_like(b)
        shat = torch.empty_like(b)

    def cond(st):
        rr, k = st[-3], st[-2]
        return (k < maxiter) & (torch.sqrt(rr) > target)

    def body(st, act):
        rhat, p, v, rho_prev, rho_c, alpha, omega, rr, k, fresh = st
        on = act != 0
        # ρ = <r̂, r> was computed by last iteration's tail pass (rho_c)
        restart = (torch.abs(rho_c) < 1e-12 * rr) | fresh
        rhat = torch.where(restart, r, rhat)
        rho = torch.where(restart, rr, rho_c)
        beta = (rho / (rho_prev + eps)) * (alpha / (omega + eps))
        beta = torch.where(restart, zero, beta)
        if dinv is not None:
            p, ph = _fk.fused_bicg_p(r, p, v, dinv, beta, omega,
                                     restart.to(b.dtype), out=(p, phat),
                                     active=act)
        else:
            p = torch.where(restart, r, r + beta * (p - omega * v))
            ph = M(p)
        v = matvec(ph)
        alpha = rho / (dot(rhat, v) + eps)
        if dinv is not None:
            sv, sh = _fk.fused_bicg_s(r, v, dinv, alpha, out=(s, shat),
                                      active=act)
        else:
            sv = r - alpha * v
            sh = M(sv)
        t = matvec(sh)
        ts, tt = _fk.fused_dots2(t, sv)
        omega_new = ts / (tt + eps)
        _, _, rho_next, rr_new = _fk.fused_bicg_tail(
            x, sv, t, ph, sh, rhat, alpha, omega_new, out=(x, r), active=act)
        return (rhat, p, v, rho, rho_next, alpha, omega_new,
                _keep(on, rr_new, rr), k + act, torch.zeros_like(fresh))

    z = torch.zeros_like(b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    k0 = torch.zeros((), dtype=torch.int64, device=b.device)
    fresh = torch.ones((), dtype=torch.bool, device=b.device)
    st0 = (r.clone(), z, z, one, rr0, one, one, rr0, k0, fresh)
    *_, rr, k, _ = _loop(cond, body, st0)
    rn = torch.sqrt(rr)
    return x, SolveInfo(k, rn, rn <= target)


def dense_solve(A_dense: torch.Tensor, b: torch.Tensor, method: str = "lu"):
    """Dense direct solve (torch.linalg): Cholesky or LU."""
    if method == "cholesky":
        L = torch.linalg.cholesky(A_dense)
        x = torch.cholesky_solve(b.unsqueeze(-1), L).squeeze(-1)
    else:
        x = torch.linalg.solve(A_dense, b)
    return x, SolveInfo(torch.ones((), dtype=torch.int64, device=b.device),
                        torch.zeros((), dtype=b.dtype, device=b.device),
                        torch.ones((), dtype=torch.bool, device=b.device))
