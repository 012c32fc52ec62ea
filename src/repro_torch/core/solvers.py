"""Krylov, nonlinear and eigen solvers (port of ``repro.core.solvers``).

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
Arnoldi steps and the Hessenberg least squares stay on the device.  Newton
reads it once per step and LOBPCG once per iteration (its small ``eigh``
calls synchronize the host on CUDA anyway); Picard and Anderson gate their
state like the Krylov loops.

CG and BiCGStab (plain and fused) are batch-native on (B, n) lanes, with a
per-lane active mask, per-lane iteration counts on the device and one host
read of ``any(active)`` per check window — the reference's ``vmap`` of its
while_loop.  ``block_cg`` couples k right-hand sides of one matrix.

``cg_scan`` is the deliberately naive fixed-k CG that autograd unrolls (the
O(k)-graph baseline of the paper's Fig. 2); ``lanczos`` feeds the Chebyshev
bounds and ``eigsh_lanczos``; ``eigh_pinv_solve`` is the pseudo-inverse
small solve of the block and Anderson solvers.  The Jacobians of
``newton_solve`` come from ``torch.func`` (``jacfwd`` dense, ``jvp``
matrix-free), so a residual must compose with it.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

__all__ = [
    "SolveInfo", "SolveResult", "as_solve_result", "cg", "cg_fused",
    "bicgstab", "bicgstab_fused", "block_cg", "gmres", "cg_scan",
    "eigh_pinv_solve", "lanczos", "dense_solve", "CHECK_EVERY", "seeded_normal",
    "newton_solve", "picard_solve", "anderson_solve", "lobpcg_general",
    "lobpcg", "eigsh_lanczos",
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
    """<u, v> — over the last axis, one value per lane for (B, n) lanes."""
    if u.dim() == 1 and v.dim() == 1:
        return torch.dot(u, v)
    return (u * v).sum(-1)


def _kdot(u, v):
    """<u, v> through the ``fused_dots2`` kernel — the fused solvers' dot:
    lane b of a (B, n) call equals the (n,) call on lane b bit for bit
    (``torch.dot`` and a batched sum do not round alike), so each lane of a
    batched fused solve follows its single solve exactly, iteration count
    included (BiCGStab's count moves with the last bits of its dots)."""
    from ..kernels import solve_step as _fk
    return _fk.fused_dots2(u.contiguous(), v.contiguous())[0]


def _col(t):
    """A per-lane scalar (shape ``(B,)`` or 0-dim) as a column that
    broadcasts against the lanes' vectors."""
    return t[..., None]


def _keep(on, new, old):
    """``new`` where the loop (or its lane) is still active, else ``old``
    (no host sync); ``on`` is 0-dim or one flag per lane."""
    if on.dim() and new.dim() > on.dim():
        on = on.reshape(on.shape + (1,) * (new.dim() - on.dim()))
    return torch.where(on, new, old)


def _loop(cond: Callable, body: Callable, state: tuple,
          every: Optional[int] = None) -> tuple:
    """``lax.while_loop(cond, body, state)`` with a device-side active flag
    — one flag per lane for lane-batched loops (the reference's ``vmap`` of
    its while_loop).

    ``cond(state)`` is a bool tensor (0-dim, or one per lane);
    ``body(state, active)`` returns the next state and must leave every
    quantity the caller reads after the loop unchanged where ``active``
    (int32, the shape of ``cond``) is 0.  Since a flag only ever drops, the
    state after the loop is, lane by lane, that of the first iteration
    where ``cond`` failed, however late the host notices.  The host reads
    ``any(active)`` every ``every`` bodies (default: ``CHECK_EVERY`` of the
    device type) and stops when every lane is done."""
    if every is None:
        every = CHECK_EVERY.get(state[0].device.type, 1)
    active = cond(state).to(torch.int32)
    it = 0
    while True:
        if it % every == 0 and not bool(active.any()):
            break
        state = body(state, active)
        active = active * cond(state).to(torch.int32)
        it += 1
    return state


def _target(b, tol, atol, dot):
    """Per-lane convergence target ``max(tol·‖b‖, atol)``."""
    bnorm = torch.sqrt(dot(b, b))
    return torch.clamp_min(tol * bnorm, atol)


def _count0(b):
    """Per-lane iteration counters, kept on the device."""
    return torch.zeros(b.shape[:-1], dtype=torch.int64, device=b.device)


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
#
# cg, bicgstab, cg_fused and bicgstab_fused are batch-native: ``b`` is (n,)
# or (B, n) lanes, each lane its own system (``matvec`` and ``M`` map (B, n)
# to (B, n)).  Scalars, targets and iteration counts are then (B,); a lane
# whose residual meets its target stops changing while the others iterate,
# and ``SolveInfo`` carries (B,) ``iters``, ``resnorm`` and ``converged``.
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

    def cond(st):
        x, r, p, rz, k = st
        return (k < maxiter) & ((torch.sqrt(dot(r, r)) > target)
                                | (k < min_iter))

    def body(st, act):
        x, r, p, rz, k = st
        on = act != 0
        Ap = matvec(p)
        alpha = _col(rz / dot(p, Ap))
        xn = x + alpha * p
        rn = r - alpha * Ap
        z = M(rn)
        rz_new = dot(rn, z)
        pn = z + _col(rz_new / rz) * p
        return (_keep(on, xn, x), _keep(on, rn, r), _keep(on, pn, p),
                _keep(on, rz_new, rz), k + act)

    x, r, p, rz, k = _loop(cond, body,
                           (x0, r0, z0, dot(r0, z0), _count0(b)))
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
        rhat = torch.where(_col(restart), r, rhat)
        rho = torch.where(restart, rr, rho)
        beta = (rho / (rho_prev + eps)) * (alpha / (omega + eps))
        beta = torch.where(restart, zero, beta)
        p = torch.where(_col(restart), r,
                        r + _col(beta) * (p - _col(omega) * v))
        phat = M(p)
        v = matvec(phat)
        alpha = rho / (dot(rhat, v) + eps)
        s = r - _col(alpha) * v
        shat = M(s)
        t = matvec(shat)
        omega_new = dot(t, s) / (dot(t, t) + eps)
        xn = x + _col(alpha) * phat + _col(omega_new) * shat
        rn = s - _col(omega_new) * t
        return (_keep(on, xn, x), _keep(on, rn, r), rhat, p, v, rho, alpha,
                omega_new, k + act, torch.zeros_like(fresh))

    z = torch.zeros_like(b)
    one = torch.ones(b.shape[:-1], dtype=b.dtype, device=b.device)
    fresh = torch.ones(b.shape[:-1], dtype=torch.bool, device=b.device)
    st0 = (x0, r0, r0, z, z, one, one, one, _count0(b), fresh)
    x, r, *_, k, _ = _loop(cond, body, st0)
    rn = torch.sqrt(dot(r, r))
    return x, SolveInfo(k, rn, rn <= target)


def cg_fused(matvec: Callable, b: torch.Tensor,
             x0: Optional[torch.Tensor] = None, *,
             dinv: Optional[torch.Tensor] = None, M: Callable = _identity,
             tol: float = 1e-6, atol: float = 0.0, maxiter: int = 1000,
             min_iter: int = 0):
    """CG with the iteration fused into the step kernels.

    With a diagonal preconditioner (``dinv`` given: (n,), or (B, n) for
    lanes with their own values) this is the merged Chronopoulos–Gear
    recurrence: α' = ρ'/(δ − βρ'/α) with δ = <Az, z>, so each iteration is
    one matvec plus exactly two fused vector sweeps (``fused_cg_update``
    and ``fused_cg_direction``), which update x, r, p and s in place.
    Without ``dinv`` the textbook recurrence is kept and only the
    axpy/convergence-dot passes fuse (``fused_cg_halfstep``).  Every other
    dot is a ``fused_dots2`` pass (:func:`_kdot`).  On (B, n) lanes every
    pass is one lane-batched launch."""
    from ..kernels import solve_step as _fk

    dot = _kdot
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    target = _target(b, tol, atol, dot)
    eps = torch.tensor(1e-30, dtype=b.dtype, device=b.device)
    r = b - matvec(x)
    rr0 = dot(r, r)
    k0 = _count0(b)

    def cond(st):
        rr, k = st[-2], st[-1]
        go = (k < maxiter) & (torch.sqrt(rr) > target)
        return go | ((k < maxiter) & (k < min_iter)) if min_iter else go

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
            pn = z + _col(rz_new / (rz + eps)) * p
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
    iteration's <r̂,r'> and the convergence dot <r',r'>); its other dots are
    ``fused_dots2`` passes too (:func:`_kdot`).  Lane-batched on (B, n) as
    :func:`cg_fused` is."""
    from ..kernels import solve_step as _fk

    dot = _kdot
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
        rhat = torch.where(_col(restart), r, rhat)
        rho = torch.where(restart, rr, rho_c)
        beta = (rho / (rho_prev + eps)) * (alpha / (omega + eps))
        beta = torch.where(restart, zero, beta)
        if dinv is not None:
            p, ph = _fk.fused_bicg_p(r, p, v, dinv, beta, omega,
                                     restart.to(b.dtype), out=(p, phat),
                                     active=act)
        else:
            p = torch.where(_col(restart), r,
                            r + _col(beta) * (p - _col(omega) * v))
            ph = M(p)
        v = matvec(ph)
        alpha = rho / (dot(rhat, v) + eps)
        if dinv is not None:
            sv, sh = _fk.fused_bicg_s(r, v, dinv, alpha, out=(s, shat),
                                      active=act)
        else:
            sv = r - _col(alpha) * v
            sh = M(sv)
        t = matvec(sh)
        ts, tt = _fk.fused_dots2(t, sv)
        omega_new = ts / (tt + eps)
        _, _, rho_next, rr_new = _fk.fused_bicg_tail(
            x, sv, t, ph, sh, rhat, alpha, omega_new, out=(x, r), active=act)
        return (rhat, p, v, rho, rho_next, alpha, omega_new,
                _keep(on, rr_new, rr), k + act, torch.zeros_like(fresh))

    z = torch.zeros_like(b)
    one = torch.ones(b.shape[:-1], dtype=b.dtype, device=b.device)
    fresh = torch.ones(b.shape[:-1], dtype=torch.bool, device=b.device)
    st0 = (r.clone(), z, z, one, rr0, one, one, rr0, _count0(b), fresh)
    *_, rr, k, _ = _loop(cond, body, st0)
    rn = torch.sqrt(rr)
    return x, SolveInfo(k, rn, rn <= target)


def block_cg(matvec: Callable, B: torch.Tensor,
             X0: Optional[torch.Tensor] = None, *, M: Callable = _identity,
             tol: float = 1e-6, atol: float = 0.0, maxiter: int = 1000,
             ridge: float = 1e-12):
    """Block conjugate gradient (O'Leary 1980) for k right-hand sides of one
    SPD matrix: ``B`` is (k, n), and ``matvec`` / ``M`` map a (k, n) block
    (one SpMM a matvec).  The k directions are coupled through (k, k) Gram
    solves, so the block takes about the iterations of its hardest column.
    Targets are per column (``max(tol·‖bᵢ‖, atol)``); the loop runs until
    every column meets its own.  Converged or dependent columns make the
    Gram matrices singular: they are solved by :func:`eigh_pinv_solve`
    (relative cutoff), so such a column goes inert instead of amplifying
    roundoff.  The Gram products are ``torch.matmul``, as the reference
    computes them outside any kernel.  Returns ``(X, SolveInfo)`` with
    per-column ``resnorm``/``converged`` and one shared iteration count."""
    if B.dim() != 2:
        raise ValueError(f"block_cg expects B of shape (k, n), got "
                         f"{tuple(B.shape)}")
    X0 = torch.zeros_like(B) if X0 is None else X0
    target = torch.clamp_min(tol * torch.linalg.norm(B, dim=1), atol)

    def gram_solve(G, rhs):
        # PᵀAP and ZᵀR are symmetric for SPD A and symmetric M, up to
        # roundoff — symmetrize and pseudo-invert
        return eigh_pinv_solve(G, rhs, ridge=ridge)

    R0 = B - matvec(X0)
    Z0 = M(R0)
    it0 = torch.zeros((), dtype=torch.int64, device=B.device)

    def cond(st):
        X, R, P, rho, it = st
        return (it < maxiter) & torch.any(torch.linalg.norm(R, dim=1) > target)

    def body(st, act):
        X, R, P, rho, it = st
        on = act != 0
        Q = matvec(P)
        alpha = gram_solve(P @ Q.T, rho)       # (PᵀAP)⁻¹ ZᵀR, row convention
        Xn = X + alpha.T @ P
        Rn = R - alpha.T @ Q
        Z = M(Rn)
        rho_new = Z @ Rn.T
        beta = gram_solve(rho, rho_new)
        Pn = Z + beta.T @ P
        return (_keep(on, Xn, X), _keep(on, Rn, R), _keep(on, Pn, P),
                _keep(on, rho_new, rho), it + act)

    X, R, P, rho, it = _loop(cond, body, (X0, R0, Z0, Z0 @ R0.T, it0))
    rn = torch.linalg.norm(R, dim=1)
    return X, SolveInfo(it, rn, rn <= target)


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
    no host read.  Lanes: ``v0`` (B, n) with a matvec on (B, n) rows runs
    B recurrences at once (alphas, betas (B, m), V (B, m+1, n)), one
    batched matvec a step — the reference's ``jax.vmap``."""
    n = v0.shape[-1]
    m = num_steps
    lanes = v0.shape[:-1]
    V = v0.new_zeros(lanes + (m + 1, n))
    V[..., 0, :] = v0 / torch.linalg.norm(v0, dim=-1, keepdim=True)
    alphas = v0.new_zeros(lanes + (m,))
    betas = v0.new_zeros(lanes + (m,))
    for j in range(m):
        vj = V[..., j, :]
        w = matvec(vj)
        alpha = torch.sum(w * vj, dim=-1)
        w = w - alpha[..., None] * vj
        if j > 0:
            w = w - betas[..., j - 1, None] * V[..., j - 1, :]
        # full reorthogonalization against V[0..j]
        Vj = V[..., :j + 1, :]
        w = w - ((Vj @ w[..., None]).transpose(-1, -2) @ Vj)[..., 0, :]
        beta = torch.linalg.norm(w, dim=-1)
        V[..., j + 1, :] = w / (beta[..., None] + 1e-30)
        alphas[..., j] = alpha
        betas[..., j] = beta
    return alphas, betas, V


def seeded_normal(shape, dtype, device, seed: int) -> torch.Tensor:
    """Standard normal draw from a CPU ``torch.Generator`` seeded with
    ``seed``, moved to ``device``, so the CPU and the card start alike.  (The
    reference draws ``jax.random.normal(PRNGKey(seed))``, which torch cannot
    reproduce.)"""
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=dtype).to(device)


# ---------------------------------------------------------------------------
# nonlinear solvers (paper §3.2.2, "Nonlinear systems")
# ---------------------------------------------------------------------------

def newton_solve(residual: Callable, x0: torch.Tensor, *, tol: float = 1e-8,
                 maxiter: int = 50, dense_jacobian_budget: int = 2048,
                 inner_tol: float = 1e-8, inner_maxiter: int = 500,
                 damping: float = 1.0, linear_solver=None, jac_pattern=None,
                 assemble_jacobian: Optional[Callable] = None):
    """Newton's method.  Small systems use a dense Jacobian
    (``torch.func.jacfwd`` + ``torch.linalg.solve``); large systems use
    matrix-free inner solves (BiCGStab on a ``torch.func.jvp`` matvec).

    Declaring the Jacobian sparsity (``jac_pattern`` — a
    :class:`~repro_torch.core.sparse.SparseTensor` or ``(row, col, n)``
    triple) routes every inner solve through the plan engine instead: one
    symbolic analysis serves the whole sweep, values refreshed per step
    (:class:`repro_torch.core.nonlinear.SparseNewton`).  ``linear_solver``
    is the inner :class:`~repro_torch.core.dispatch.SolverConfig`;
    ``assemble_jacobian(u) -> values`` overrides the coloring-based jvp
    assembly.  The host reads the residual norm once per Newton step."""
    if linear_solver is not None or jac_pattern is not None:
        if jac_pattern is None:
            raise ValueError("linear_solver= needs jac_pattern= declaring "
                             "the Jacobian sparsity")
        from .nonlinear import SparseNewton   # lazy: avoids a module cycle
        sn = SparseNewton(lambda u: residual(u), jac_pattern,
                          linear_solver=linear_solver,
                          assemble_jacobian=(
                              None if assemble_jacobian is None
                              else lambda u: assemble_jacobian(u)),
                          device=x0.device)
        return sn.solve(x0, tol=tol, maxiter=maxiter, damping=damping)
    use_dense = x0.shape[-1] <= dense_jacobian_budget

    def cond(st):
        x, k, rn = st
        return (k < maxiter) & (rn > tol)

    def body(st, act):
        # every=1: the body runs only while active
        x, k, _ = st
        F = residual(x)
        if use_dense:
            J = torch.func.jacfwd(residual)(x)
            dx = torch.linalg.solve(J, -F)
        else:
            def mv(v):
                return torch.func.jvp(residual, (x,), (v,))[1]
            dx, _ = bicgstab(mv, -F, tol=inner_tol, maxiter=inner_maxiter)
        x = x + damping * dx
        return (x, k + 1, torch.linalg.norm(residual(x)))

    k0 = torch.zeros((), dtype=torch.int64, device=x0.device)
    x, k, rn = _loop(cond, body, (x0, k0, torch.linalg.norm(residual(x0))),
                     every=1)
    return x, SolveInfo(k, rn, rn <= tol)


def picard_solve(fixed_point: Callable, x0: torch.Tensor, *,
                 tol: float = 1e-8, maxiter: int = 500, relax: float = 1.0):
    """Damped fixed-point (Picard) iteration x ← (1−ω)x + ω G(x)."""
    def cond(st):
        x, k, rn = st
        return (k < maxiter) & (rn > tol)

    def body(st, act):
        x, k, rn = st
        on = act != 0
        x_new = (1 - relax) * x + relax * fixed_point(x)
        rn_new = torch.linalg.norm(x_new - x)
        return (_keep(on, x_new, x), k + act, _keep(on, rn_new, rn))

    k0 = torch.zeros((), dtype=torch.int64, device=x0.device)
    inf = torch.full((), float("inf"), dtype=x0.dtype, device=x0.device)
    x, k, rn = _loop(cond, body, (x0, k0, inf))
    return x, SolveInfo(k, rn, rn <= tol)


def anderson_solve(fixed_point: Callable, x0: torch.Tensor, *, m: int = 5,
                   tol: float = 1e-8, maxiter: int = 200, beta: float = 1.0,
                   ridge: float = 1e-12, gram_solver: str = "pinv"):
    """Anderson acceleration, type-II difference form (Walker & Ni 2011):

        f_k = G(x_k) − x_k
        γ   = argmin ‖f_k − ΔF γ‖²  (windowed least squares, window m)
        x⁺  = x_k + β f_k − (ΔX + β ΔF) γ

    Convergence is checked on ‖f_k‖.  The Gram matrix ΔF ΔFᵀ is
    rank-deficient whenever the window is degenerate; ``gram_solver="pinv"``
    (default) solves it through :func:`eigh_pinv_solve` (relative cutoff),
    ``"ridge"`` through ``solve(G + ridge·I)``, the reference's A/B
    baseline (it stagnates or overflows in f32)."""
    if gram_solver not in ("pinv", "ridge"):
        raise ValueError(f"gram_solver must be 'pinv'|'ridge', "
                         f"got {gram_solver!r}")
    n = x0.shape[-1]
    Xh = x0.new_zeros((m + 1, n))     # iterate history (last row = newest)
    Fh = x0.new_zeros((m + 1, n))     # residual history
    slots = torch.arange(m, device=x0.device)

    def cond(st):
        x, Xh, Fh, k, rn = st
        return (k < maxiter) & (rn > tol)

    def body(st, act):
        x, Xh, Fh, k, rn = st
        on = act != 0
        f = fixed_point(x) - x
        rn_new = torch.linalg.norm(f)
        Xn = torch.cat([Xh[1:], x[None]])
        Fn = torch.cat([Fh[1:], f[None]])
        dX = Xn[1:] - Xn[:-1]                    # (m, n) rows: Δx_i
        dF = Fn[1:] - Fn[:-1]
        valid = (slots >= (m - torch.clamp(k, max=m)))[:, None]
        dXv = torch.where(valid, dX, torch.zeros_like(dX))
        dFv = torch.where(valid, dF, torch.zeros_like(dF))
        if gram_solver == "pinv":
            gamma = eigh_pinv_solve(dFv @ dFv.T, dFv @ f, ridge=ridge)
        else:
            gram = dFv @ dFv.T + ridge * torch.eye(m, dtype=x.dtype,
                                                   device=x.device)
            gamma = torch.linalg.solve(gram, dFv @ f)
        x_new = x + beta * f - gamma @ (dXv + beta * dFv)
        return (_keep(on, x_new, x), _keep(on, Xn, Xh), _keep(on, Fn, Fh),
                k + act, _keep(on, rn_new, rn))

    k0 = torch.zeros((), dtype=torch.int64, device=x0.device)
    inf = torch.full((), float("inf"), dtype=x0.dtype, device=x0.device)
    x, _, _, k, rn = _loop(cond, body, (x0, Xh, Fh, k0, inf))
    return x, SolveInfo(k, rn, rn <= tol)


# ---------------------------------------------------------------------------
# eigensolvers (paper §3.2.2 "Eigenvalue problems")
# ---------------------------------------------------------------------------

def _rows(fn: Callable, X: torch.Tensor) -> torch.Tensor:
    """``fn`` applied to each row of X — the reference's ``jax.vmap`` over a
    block, as one single-vector call (kernel launch) per row."""
    return torch.stack([fn(x) for x in X])


def lobpcg_general(matvec: Callable, X0: torch.Tensor, *,
                   gram: Optional[Callable] = None, M: Callable = _identity,
                   tol: float = 1e-6, maxiter: int = 200,
                   largest: bool = False):
    """Locally optimal block preconditioned CG (Knyazev 2001), block form.

    ``X0``: (k, n) initial block (rows are vectors).  ``gram(S1, S2)``
    computes S1 S2ᵀ.  The [X | W | P] subspace is orthonormalized by
    pseudo-inverse whitening of its Gram matrix (rank-deficient directions
    are masked and their Ritz values pushed to 1e30), and the conjugate
    block P uses the classical coefficient split.  The small (3k × 3k)
    ``torch.linalg.eigh`` calls synchronize the host on CUDA, so the loop
    reads its convergence flag every iteration."""
    k, n = X0.shape
    sign = -1.0 if largest else 1.0

    def mv(v):
        return sign * matvec(v)

    gram = gram or (lambda S1, S2: S1 @ S2.T)
    BIG = 1e30

    def rr(S):
        """Rayleigh–Ritz on the (possibly rank-deficient) row space of S,
        whitened in the eigenbasis of its Gram matrix."""
        G = gram(S, S)
        e, V = torch.linalg.eigh(G)
        good = e > torch.clamp(e[-1], min=1e-30) * 1e-10
        isq = torch.where(good, 1.0 / torch.sqrt(torch.clamp(e, min=1e-300)),
                          torch.zeros_like(e))
        W_ = isq[:, None] * V.T                    # Λ^{-1/2} Vᵀ
        Q = W_ @ S                                  # QQᵀ = diag(good)
        T = gram(Q, _rows(mv, Q))
        T = 0.5 * (T + T.T)
        T = T + torch.diag(torch.where(good, torch.zeros_like(e),
                                       torch.full_like(e, BIG)))
        w, U = torch.linalg.eigh(T)
        C = V @ (isq[:, None] * U[:, :k])           # coefficients in S rows
        return w[:k], C.T @ S, C

    w0, X, _ = rr(X0)

    def cond(st):
        X, w, P, k_it, rn = st
        return (k_it < maxiter) & (rn > tol)

    def body(st, act):
        # every=1: the body runs only while active
        X, w, P, k_it, _ = st
        R = _rows(mv, X) - w[:, None] * X
        rn = torch.max(torch.sqrt(torch.diag(gram(R, R)))
                       / (torch.abs(w) + 1.0))
        Wp = _rows(M, R)
        # explicit inter-block orthogonalization (conditioning of S)
        Wp = Wp - gram(Wp, X) @ X
        Wn = torch.sqrt(torch.clamp(torch.diag(gram(Wp, Wp)), min=1e-300))
        Wp = Wp / Wn[:, None]
        P = P - gram(P, X) @ X
        Pn = torch.sqrt(torch.diag(gram(P, P)))
        P = torch.where(Pn[:, None] > 1e-150,
                        P / torch.clamp(Pn, min=1e-300)[:, None], P)
        S = torch.cat([X, Wp, P])
        w_new, X_new, C = rr(S)
        P_new = C[k:].T @ S[k:]                    # non-X component
        return (X_new, w_new, P_new, k_it + 1, rn)

    k0 = torch.zeros((), dtype=torch.int64, device=X0.device)
    inf = torch.full((), float("inf"), dtype=X0.dtype, device=X0.device)
    X, w, _, k_it, rn = _loop(cond, body, (X, w0, torch.zeros_like(X), k0,
                                           inf), every=1)
    X = X / torch.sqrt(torch.diag(gram(X, X)))[:, None]
    return sign * w, X, SolveInfo(k_it, rn, rn <= tol)


def lobpcg(matvec: Callable, X0: torch.Tensor, *, M: Callable = _identity,
           tol: float = 1e-6, maxiter: int = 200, largest: bool = False):
    """Single-device LOBPCG — see :func:`lobpcg_general`."""
    return lobpcg_general(matvec, X0, M=M, tol=tol, maxiter=maxiter,
                          largest=largest)


def eigsh_lanczos(matvec: Callable, n: int, k: int, *, num_steps: int = 64,
                  dtype=torch.float32, seed: int = 0, device=None):
    """k smallest eigenpairs via Lanczos + dense eigh of T, Ritz vectors.
    The start vector is :func:`seeded_normal`."""
    v0 = seeded_normal((n,), dtype, device, seed)
    alphas, betas, V = lanczos(matvec, v0, num_steps)
    T = (torch.diag(alphas) + torch.diag(betas[:-1], 1)
         + torch.diag(betas[:-1], -1))
    w, U = torch.linalg.eigh(T)
    ritz = (V[:num_steps].T @ U[:, :k]).T      # (k, n)
    ritz = ritz / torch.linalg.norm(ritz, dim=1, keepdim=True)
    return w[:k], ritz


def dense_solve(A_dense: torch.Tensor, b: torch.Tensor, method: str = "lu"):
    """Dense direct solve (torch.linalg): Cholesky or LU.  ``A_dense``
    (n, n) or (B, n, n), ``b`` (n,) or (k, n) rows broadcasting with it."""
    if method == "cholesky":
        L = torch.linalg.cholesky(A_dense)
        x = torch.cholesky_solve(b.unsqueeze(-1), L).squeeze(-1)
    else:
        x = torch.linalg.solve(A_dense, b.unsqueeze(-1)).squeeze(-1)
    lanes = x.shape[:-1]
    return x, SolveInfo(torch.ones(lanes, dtype=torch.int64, device=b.device),
                        torch.zeros(lanes, dtype=b.dtype, device=b.device),
                        torch.ones(lanes, dtype=torch.bool, device=b.device))
