"""Plain reference of the variable-coefficient Poisson solve and its gradient.

Plain PyTorch only: it imports nothing of the program.  It rebuilds the
operator from κ itself (a frozen copy of the harmonic-mean, cell-centred
assembly of paper §4.4), applies it by shifted slices, solves with a
textbook Jacobi-preconditioned CG, and gets ∂(Σu²)/∂κ from the adjoint
solve and the assembly's own autograd.  Leading dims are lanes: κ (L, ng,
ng), f (L, ng, ng) or (ng, ng).
"""
from __future__ import annotations

import torch

#: host reads of the lanes' convergence flags every so many iterations
CHECK_EVERY = 32


def planes(kappa: torch.Tensor) -> torch.Tensor:
    """κ (..., ng, ng) → signed planes (..., 5, ng, ng) in the order
    (centre, north, south, west, east).  A face's coefficient is the
    harmonic mean of its two cells; a boundary face (Dirichlet u = 0) takes
    the cell's own κ and couples to nothing."""
    k = kappa
    ng = k.shape[-1]
    zero = torch.zeros((), dtype=k.dtype, device=k.device)
    i = torch.arange(ng, device=k.device)
    has_n, has_s = (i > 0)[:, None], (i < ng - 1)[:, None]
    has_w, has_e = (i > 0)[None, :], (i < ng - 1)[None, :]

    def face(nb, inside):
        return torch.where(inside, 2.0 * k * nb / (k + nb + 1e-30), k)

    kn = face(torch.roll(k, 1, -2), has_n)
    ks = face(torch.roll(k, -1, -2), has_s)
    kw = face(torch.roll(k, 1, -1), has_w)
    ke = face(torch.roll(k, -1, -1), has_e)
    return torch.stack([kn + ks + kw + ke,
                        torch.where(has_n, -kn, zero),
                        torch.where(has_s, -ks, zero),
                        torch.where(has_w, -kw, zero),
                        torch.where(has_e, -ke, zero)], dim=-3)


def apply(p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A x for planes p (..., 5, ng, ng) and x (..., ng, ng)."""
    y = p[..., 0, :, :] * x
    y[..., 1:, :] += p[..., 1, 1:, :] * x[..., :-1, :]
    y[..., :-1, :] += p[..., 2, :-1, :] * x[..., 1:, :]
    y[..., :, 1:] += p[..., 3, :, 1:] * x[..., :, :-1]
    y[..., :, :-1] += p[..., 4, :, :-1] * x[..., :, 1:]
    return y


def _dot(u, v):
    return (u * v).sum(dim=(-2, -1))


def cg(p: torch.Tensor, b: torch.Tensor, tol: float, maxiter: int):
    """Textbook Jacobi-PCG on every lane, each lane stopped at
    ‖r‖ ≤ tol·‖b‖.  Returns (x, iterations per lane, converged per lane)."""
    b = b.expand(p.shape[:-3] + b.shape[-2:])
    dinv = 1.0 / p[..., 0, :, :]
    x = torch.zeros_like(b)
    r = b.clone()
    z = dinv * r
    d = z.clone()
    rz = _dot(r, z)
    target = tol * torch.sqrt(_dot(b, b))
    active = torch.sqrt(_dot(r, r)) > target
    iters = torch.zeros_like(rz, dtype=torch.int64)
    for k in range(maxiter):
        if k % CHECK_EVERY == 0 and not bool(active.any()):
            break
        q = apply(p, d)
        alpha = torch.where(active, rz / _dot(d, q), torch.zeros_like(rz))
        x += alpha[..., None, None] * d
        r -= alpha[..., None, None] * q
        z = dinv * r
        rz_new = _dot(r, z)
        beta = torch.where(active, rz_new / rz, torch.zeros_like(rz))
        d = torch.where(active[..., None, None], z + beta[..., None, None] * d,
                        d)
        rz = torch.where(active, rz_new, rz)
        iters += active.to(iters.dtype)
        active = active & (torch.sqrt(_dot(r, r)) > target)
    return x, iters, ~active


def solve_and_grad(kappa: torch.Tensor, f: torch.Tensor, tol: float,
                   maxiter: int):
    """u = A(κ)⁻¹ f and ∂(Σu²)/∂κ for every lane.

    The adjoint solve is Aλ = 2u (A is symmetric); the loss's derivative by
    the planes is −λ_i u_j on each coupling (i, j), which the assembly's
    autograd carries to κ.  Returns (u, dκ, converged) with u, dκ (L, ng,
    ng) and converged (L,) over both solves."""
    with torch.no_grad():
        p = planes(kappa)
        u, _, ok_u = cg(p, f, tol, maxiter)
        lam, _, ok_l = cg(p, 2.0 * u, tol, maxiter)
        dp = torch.zeros_like(p)
        dp[..., 0, :, :] = -lam * u
        dp[..., 1, 1:, :] = -lam[..., 1:, :] * u[..., :-1, :]
        dp[..., 2, :-1, :] = -lam[..., :-1, :] * u[..., 1:, :]
        dp[..., 3, :, 1:] = -lam[..., :, 1:] * u[..., :, :-1]
        dp[..., 4, :, :-1] = -lam[..., :, :-1] * u[..., :, 1:]
    k = kappa.detach().requires_grad_(True)
    with torch.enable_grad():
        (planes(k) * dp).sum().backward()
    return u, k.grad, ok_u & ok_l


def solve(kappa: torch.Tensor, b: torch.Tensor, tol: float, maxiter: int):
    """x = A(κ)⁻¹ b for every lane; returns (x, converged)."""
    with torch.no_grad():
        x, _, ok = cg(planes(kappa), b, tol, maxiter)
    return x, ok
