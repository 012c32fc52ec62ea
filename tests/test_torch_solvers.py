"""PyTorch port vs the JAX reference: the Krylov solvers (plain and fused),
the sync-free convergence loop, the preconditioners and the dense solve."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import solvers as rsol
from repro.core.sparse import SparseTensor as RTensor
from repro.data.poisson import poisson1d, poisson2d
from repro_torch.core import precond as tprec
from repro_torch.core import solvers as tsol

from _torch_parity import assert_close, port_of


def _spd():
    return poisson2d(16)


def _nonsym():
    A1 = poisson2d(10)
    val = np.asarray(A1.val).copy()
    row, col = np.asarray(A1.row), np.asarray(A1.col)
    val[col == row - 1] = -1.4
    val[col == row + 1] = -0.6
    return RTensor(val, row, col, A1.shape)


def _pair(A_ref, seed):
    A = port_of(A_ref)
    b = np.random.default_rng(seed).normal(size=A_ref.shape[0])
    dinv_r = 1.0 / A_ref.diagonal()
    dinv_t = 1.0 / A.diagonal()
    return A, jnp.asarray(b), torch.tensor(b), dinv_r, dinv_t


def _check(x_t, i_t, x_r, i_r):
    assert bool(i_t.converged) and bool(i_r.converged)
    assert abs(int(i_t.iters) - int(i_r.iters)) <= 1
    assert_close(x_t, x_r, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("solver,matrix", [("cg", "spd"), ("bicgstab", "spd"),
                                           ("bicgstab", "nonsym")])
def test_plain_krylov_matches_reference(solver, matrix):
    A_ref = _spd() if matrix == "spd" else _nonsym()
    A, b_r, b_t, dr, dt = _pair(A_ref, 1)
    x_r, i_r = getattr(rsol, solver)(lambda x: A_ref @ x, b_r,
                                     M=lambda r: dr * r, tol=1e-12)
    x_t, i_t = getattr(tsol, solver)(lambda x: A @ x, b_t,
                                     M=lambda r: dt * r, tol=1e-12)
    _check(x_t, i_t, x_r, i_r)


@pytest.mark.parametrize("solver", ["cg_fused", "bicgstab_fused"])
@pytest.mark.parametrize("diag", [True, False])
def test_fused_krylov_matches_reference(solver, diag):
    A_ref = _spd() if solver == "cg_fused" else _nonsym()
    A, b_r, b_t, dr, dt = _pair(A_ref, 2)
    kw_r = dict(dinv=dr) if diag else dict(M=lambda r: dr * r)
    kw_t = dict(dinv=dt) if diag else dict(M=lambda r: dt * r)
    x_r, i_r = getattr(rsol, solver)(lambda x: A_ref @ x, b_r, tol=1e-12,
                                     **kw_r)
    x_t, i_t = getattr(tsol, solver)(lambda x: A @ x, b_t, tol=1e-12, **kw_t)
    _check(x_t, i_t, x_r, i_r)


@pytest.mark.parametrize("solver", ["cg", "bicgstab", "cg_fused",
                                    "bicgstab_fused"])
@pytest.mark.parametrize("every", [3, 16])
def test_sparse_convergence_checks_keep_iterates(solver, every, monkeypatch):
    """Checking convergence on the host only every few iterations (the CUDA
    loop) returns exactly the x and iteration count of the per-iteration
    check: the device-side active flag freezes the state once converged."""
    A_ref = _spd() if solver.startswith("cg") else _nonsym()
    A, _, b, _, d = _pair(A_ref, 3)
    mv = lambda x: A @ x
    kw = dict(dinv=d) if solver.endswith("fused") else dict(M=lambda r: d * r)
    fn = getattr(tsol, solver)

    def run(check_every, **kw2):
        monkeypatch.setattr(tsol, "CHECK_EVERY", {"cpu": check_every})
        return fn(mv, b, **kw2, **kw)

    x1, i1 = run(1, tol=1e-10)
    x2, i2 = run(every, tol=1e-10)
    assert int(i1.iters) == int(i2.iters)
    assert torch.equal(x1, x2)
    assert float(i1.resnorm) == float(i2.resnorm)
    # maxiter stops the loop at the same place too
    x3, i3 = run(every, tol=1e-14, maxiter=5)
    x4, i4 = run(1, tol=1e-14, maxiter=5)
    assert int(i3.iters) == int(i4.iters) == 5 and not bool(i3.converged)
    assert torch.equal(x3, x4)


def test_fused_cg_matches_plain_cg():
    """Merged Chronopoulos–Gear recurrence == textbook loop (the reference's
    test_fused_cg_solver_matches_plain, on the port)."""
    A = port_of(poisson2d(20))
    b = torch.tensor(np.random.default_rng(5).normal(size=A.shape[0]))
    dinv = 1.0 / A.diagonal()
    x_p, i_p = tsol.cg(lambda x: A @ x, b, M=lambda r: dinv * r, tol=1e-11)
    x_f, i_f = tsol.cg_fused(lambda x: A @ x, b, dinv=dinv, tol=1e-11)
    assert bool(i_f.converged) and int(i_f.iters) == int(i_p.iters)
    assert_close(x_f, x_p, rtol=1e-9, atol=1e-11)


def test_bicgstab_restart_on_rho_breakdown():
    """r̂ ⟂ r at the first step (r̂ restarted to r): the breakdown restart
    keeps BiCGStab converging, like the reference."""
    n = 64
    A_ref = poisson1d(n)
    A = port_of(A_ref)
    b = np.zeros(n); b[0] = 1.0
    x_r, i_r = rsol.bicgstab(lambda x: A_ref @ x, jnp.asarray(b), tol=1e-12,
                             maxiter=500)
    x_t, i_t = tsol.bicgstab(lambda x: A @ x, torch.tensor(b), tol=1e-12,
                             maxiter=500)
    _check(x_t, i_t, x_r, i_r)


def test_chebyshev_fused_matches_plain_and_preconditions_cg():
    A = port_of(poisson2d(12))
    mv = lambda x: A @ x
    ng = 12
    lmin = 8 * np.sin(np.pi / (2 * (ng + 1))) ** 2
    lmax = 8 * np.cos(np.pi / (2 * (ng + 1))) ** 2
    r = torch.tensor(np.random.default_rng(0).normal(size=ng * ng))
    plain = tprec.chebyshev(mv, lmin, lmax, degree=6)(r)
    fused = tprec.chebyshev(mv, lmin, lmax, degree=6, fused=True)(r)
    assert_close(fused, plain, rtol=1e-12, atol=1e-13)
    M = tprec.chebyshev(mv, lmin, lmax, degree=6, fused=True)
    x, info = tsol.cg_fused(mv, r, M=M, tol=1e-10)
    x0, info0 = tsol.cg_fused(mv, r, dinv=1.0 / A.diagonal(), tol=1e-10)
    assert bool(info.converged) and int(info.iters) < int(info0.iters)
    assert_close(x, x0, rtol=1e-7, atol=1e-9)


def test_preconditioner_plan_none_jacobi_and_later_slices():
    A = port_of(poisson2d(6))
    for name in ("none", "jacobi"):
        pre = tprec.PreconditionerPlan(name, A.row, A.col, A.shape)
        M = pre.make_apply(pre.refresh_state(A, None), None)
        r = torch.ones(36, dtype=torch.float64)
        expect = r if name == "none" else r / A.diagonal()
        assert_close(M(r), expect, rtol=0, atol=0)
        assert_close(pre.fused_diag(A) * r, expect, rtol=0, atol=0)
    mv = lambda x: A @ x
    r = torch.ones(36, dtype=torch.float64)
    for name in ("block_jacobi", "chebyshev", "amg", "ilu"):
        # ported: each builds, has no diagonal form, and applies an SPD M⁻¹
        pre = tprec.PreconditionerPlan(name, A.row, A.col, A.shape)
        assert pre.fused_diag(A) is None
        z = pre.make_apply(pre.refresh_state(A, mv), mv)(r)
        assert bool(torch.isfinite(z).all())
        assert float(torch.dot(r, z)) > 0.0
    with pytest.raises(ValueError, match="mg"):   # needs the stencil view
        tprec.PreconditionerPlan("mg", A.row, A.col, A.shape)
    with pytest.raises(ValueError):
        tprec.PreconditionerPlan("bogus", A.row, A.col, A.shape)


@pytest.mark.parametrize("method", ["lu", "cholesky"])
def test_dense_solve_matches_reference(method):
    A_ref = poisson2d(7)
    b = np.random.default_rng(4).normal(size=49)
    x_r, _ = rsol.dense_solve(A_ref.todense(), jnp.asarray(b), method)
    x_t, info = tsol.dense_solve(port_of(A_ref).todense(), torch.tensor(b),
                                 method)
    assert_close(x_t, x_r, rtol=1e-12, atol=1e-13)
    assert int(info.iters) == 1 and bool(info.converged)
