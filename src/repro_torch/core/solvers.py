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
iteration.  Restarted GMRES reads it once per restart cycle: its inner
Arnoldi steps and the Hessenberg least squares stay on the device.

``cg_scan`` is the deliberately naive fixed-k CG that autograd unrolls (the
O(k)-graph baseline of the paper's Fig. 2); ``lanczos`` feeds the Chebyshev
bounds; ``eigh_pinv_solve`` is the pseudo-inverse small solve of the block
and Anderson solvers.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

__all__ = [
    "SolveInfo", "SolveResult", "as_solve_result", "cg", "cg_fused",
    "bicgstab", "bicgstab_fused", "gmres", "cg_scan", "eigh_pinv_solve",
    "lanczos", "dense_solve", "CHECK_EVERY",
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


def _loop(cond: Callable, body: Callable, state: tuple,
          every: Optional[int] = None) -> tuple:
    """``lax.while_loop(cond, body, state)`` with a device-side active flag.

    ``cond(state)`` is a 0-dim bool tensor; ``body(state, active)`` returns
    the next state and must leave every quantity the caller reads after the
    loop unchanged when ``active`` (0-dim int32) is 0.  Since the flag only
    ever drops, the state after the loop is that of the first iteration
    where ``cond`` failed, however late the host notices.  The host reads
    the flag every ``every`` bodies (default: ``CHECK_EVERY`` of the
    device type)."""
    if every is None:
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


def eigh_pinv_solve(G: torch.Tensor, rhs: torch.Tensor, *,
                    ridge: float = 1e-12) -> torch.Tensor:
    """Solve the (near-)singular symmetric system ``G x = rhs`` by a
    symmetric-eigendecomposition pseudo-inverse with a RELATIVE cutoff:
    eigenvalues below ``max(ridge, m·10·eps) · max|w|`` are zeroed instead
    of inverted, so rank-deficient directions stay inert.  ``rhs`` is
    ``(m,)`` or ``(m, k)``."""
    m = G.shape[0]
    cutoff = max(ridge, m * 10 * torch.finfo(G.dtype).eps)
    w, V = torch.linalg.eigh(0.5 * (G + G.T))
    cut = w.abs().max() * cutoff
    winv = torch.where(w.abs() > cut, 1.0 / w, torch.zeros_like(w))
    if rhs.dim() == 1:
        return V @ (winv * (V.T @ rhs))
    return V @ (winv[:, None] * (V.T @ rhs))


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


def _hessenberg_lstsq(H: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """argmin ‖rhs − H y‖ for the (m+1, m) Hessenberg matrix of an Arnoldi
    cycle, on the device: Householder QR, then the triangular solve.  A
    diagonal entry of R under ``(m+1)·eps`` of the largest (an exact
    breakdown) drops its direction, as the reference's ``lstsq`` cutoff
    does."""
    Q, R = torch.linalg.qr(H)
    c = Q.T @ rhs
    d = R.diagonal()
    cut = d.abs().max() * (H.shape[0] * torch.finfo(H.dtype).eps)
    R = R.clone()
    R.diagonal().copy_(torch.where(d.abs() > cut, d,
                                   torch.full_like(d, float("inf"))))
    return torch.linalg.solve_triangular(R, c.unsqueeze(1),
                                         upper=True).squeeze(1)


def gmres(matvec: Callable, b: torch.Tensor,
          x0: Optional[torch.Tensor] = None, *, M: Callable = _identity,
          tol: float = 1e-6, atol: float = 0.0, restart: int = 32,
          maxiter: int = 50):
    """Restarted GMRES(m), left-preconditioned.

    ``maxiter`` counts restart cycles; the reported iteration count is
    cycles × ``restart``, as in the reference.  The Arnoldi basis is
    orthogonalized by classical Gram–Schmidt applied twice (two
    matrix–vector products with the basis per step, where the reference's
    modified Gram–Schmidt takes j + 1 dependent passes).  The true residual
    and its norm are carried through the loop: one matvec per cycle pays
    for the convergence check and the next cycle's start vector.  Nothing
    inside a cycle reads a value on the host; the host reads the
    convergence flag once per cycle."""
    x0 = torch.zeros_like(b) if x0 is None else x0
    n = b.shape[-1]
    m = restart
    target = _target(b, tol, atol, _dot)

    def arnoldi_cycle(x, r_true):
        r = M(r_true)
        beta = torch.linalg.norm(r)
        V = b.new_zeros((m + 1, n))
        V[0] = r / (beta + 1e-30)
        H = b.new_zeros((m + 1, m))
        for j in range(m):
            w = M(matvec(V[j]))
            Vj = V[:j + 1]
            h = Vj @ w
            w = w - h @ Vj
            h2 = Vj @ w                      # second pass: re-orthogonalize
            w = w - h2 @ Vj
            hn = torch.linalg.norm(w)
            H[:j + 1, j] = h + h2
            H[j + 1, j] = hn
            V[j + 1] = w / (hn + 1e-30)
        e1 = b.new_zeros(m + 1)
        e1[0] = beta
        y = _hessenberg_lstsq(H, e1)
        return x + y @ V[:m]

    r0 = b - matvec(x0)
    k0 = torch.zeros((), dtype=torch.int64, device=b.device)

    def cond(st):
        x, r, rn, k = st
        return (k < maxiter) & (rn > target)

    def body(st, act):
        # every=1: the host has read the flag, so the body runs only while
        # active and needs no gating
        x, r, rn, k = st
        x = arnoldi_cycle(x, r)
        r = b - matvec(x)
        return (x, r, torch.linalg.norm(r), k + 1)

    x, r, rn, k = _loop(cond, body, (x0, r0, torch.linalg.norm(r0), k0),
                        every=1)
    return x, SolveInfo(k * m, rn, rn <= target)


def cg_scan(matvec: Callable, b: torch.Tensor, k: int,
            M: Callable = _identity, x0: Optional[torch.Tensor] = None):
    """Fixed-k CG as plain autograd-tracked torch ops — the naive
    O(k)-graph baseline of the paper's §4.2: reverse mode stores every
    iteration's vectors (O(k·n) memory).  Never used by the adjoint path.
    Once converged (ρ → 0) an iteration is a no-op instead of 0/0, with
    both branches of each division kept finite so the backward has no
    NaN."""
    x0 = torch.zeros_like(b) if x0 is None else x0

    def dot(u, v):
        return torch.sum(u * v)

    r0 = b - matvec(x0)
    z0 = M(r0)
    rz0 = dot(r0, z0)
    eps = torch.finfo(b.dtype).eps
    tiny = (100 * eps) ** 2 * rz0
    one = torch.ones((), dtype=b.dtype, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    x, r, p, rz = x0, r0, z0, rz0
    for _ in range(k):
        Ap = matvec(p)
        pAp = dot(p, Ap)
        live = rz > tiny
        pAp_safe = torch.where(live, pAp, one)
        rz_safe = torch.where(live, rz, one)
        alpha = torch.where(live, rz / pAp_safe, zero)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = dot(r, z)
        beta = torch.where(live, rz_new / rz_safe, zero)
        p = z + beta * p
        rz = rz_new
    return x


def lanczos(matvec: Callable, v0: torch.Tensor, num_steps: int):
    """Lanczos tridiagonalization with full reorthogonalization (small m).

    Returns ``(alphas, betas, V)``; the eigenvalues of T approximate the
    extremal eigenvalues of A (Chebyshev bounds).  A fixed number of steps,
    no host read."""
    n = v0.shape[-1]
    m = num_steps
    V = v0.new_zeros((m + 1, n))
    V[0] = v0 / torch.linalg.norm(v0)
    alphas = v0.new_zeros(m)
    betas = v0.new_zeros(m)
    for j in range(m):
        w = matvec(V[j])
        alpha = torch.sum(w * V[j])
        w = w - alpha * V[j]
        if j > 0:
            w = w - betas[j - 1] * V[j - 1]
        # full reorthogonalization against V[0..j]
        Vj = V[:j + 1]
        w = w - (Vj @ w) @ Vj
        beta = torch.linalg.norm(w)
        V[j + 1] = w / (beta + 1e-30)
        alphas[j] = alpha
        betas[j] = beta
    return alphas, betas, V


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
