"""PyTorch port vs the JAX reference: the Krylov pieces of the
preconditioned path — restarted GMRES, fixed-k ``cg_scan``, Lanczos,
``eigh_pinv_solve``, and the ``block_jacobi`` and ``chebyshev`` plan
preconditioners — on the same numpy inputs, f64, on the CPU.  The cases of
``tests/test_solvers.py`` and ``tests/test_plan.py`` that exercise them
are ported with their assertions; matvecs are counted by a wrapper instead
of a jaxpr."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PLAN_STATS as RSTATS
from repro.core import reset_plan_stats as rreset
from repro.core import precond as rprec
from repro.core import solvers as rsol
from repro.core.dispatch import make_matvec
from repro.core.sparse import SparseTensor as RTensor
from repro.data import poisson as rpoisson
from repro_torch.core import dispatch as tdisp
from repro_torch.core import options as toptions
from repro_torch.core import precond as tprec
from repro_torch.core import solvers as tsol

from _torch_parity import CPU, assert_close, np_of, port_of


def _convection_diffusion(n, c=0.3):
    """tridiag(−1−c, 2, −1+c): non-symmetric, positive spectrum."""
    A1 = rpoisson.poisson1d(n)
    val = np.asarray(A1.val).copy()
    val[np.asarray(A1.col) == np.asarray(A1.row) - 1] = -1.0 - c
    val[np.asarray(A1.col) == np.asarray(A1.row) + 1] = -1.0 + c
    return RTensor(val, A1.row, A1.col, (n, n))


def _rhs(n, seed):
    return np.random.default_rng(seed).normal(size=n)


# ---------------------------------------------------------------------------
# small dense pieces: eigh_pinv_solve, lanczos, cg_scan
# ---------------------------------------------------------------------------

def test_eigh_pinv_solve_matches_reference_and_cuts_relative():
    rng = np.random.default_rng(5)
    Q, _ = np.linalg.qr(rng.normal(size=(6, 6)))
    w = np.array([1e4, 2e3, 50.0, 1.0, 1e-12, 0.0])    # hard rank-4 @ f64
    G = (Q * w) @ Q.T
    y = rng.normal(size=6)
    rhs = G @ y
    x_r = rsol.eigh_pinv_solve(jnp.asarray(G), jnp.asarray(rhs))
    x_t = tsol.eigh_pinv_solve(torch.tensor(G), torch.tensor(rhs))
    assert_close(x_t, x_r, rtol=1e-12, atol=1e-12)
    # exact on range(G), zero on the null space
    np.testing.assert_allclose(G @ np_of(x_t), rhs, atol=1e-6)
    assert np.linalg.norm(Q[:, 4:].T @ np_of(x_t)) < 1e-8
    X_r = rsol.eigh_pinv_solve(jnp.asarray(G), jnp.stack([rhs, 2 * rhs], 1))
    X_t = tsol.eigh_pinv_solve(torch.tensor(G),
                               torch.tensor(np.stack([rhs, 2 * rhs], 1)))
    assert tuple(X_t.shape) == (6, 2)
    assert_close(X_t, X_r, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("steps", [8, 16])
def test_lanczos_matches_reference(steps):
    A_ref = rpoisson.poisson2d(10)
    A = port_of(A_ref)
    v0 = _rhs(100, 3)
    a_r, b_r, V_r = rsol.lanczos(lambda v: A_ref @ v, jnp.asarray(v0), steps)
    a_t, b_t, V_t = tsol.lanczos(lambda v: A @ v, torch.tensor(v0), steps)
    for t, r in ((a_t, a_r), (b_t, b_r), (V_t, V_r)):
        assert_close(t, r, rtol=1e-12, atol=1e-12)


def test_cg_scan_matches_reference_and_differentiates():
    A_ref = rpoisson.poisson2d(8)
    A = port_of(A_ref)
    b = _rhs(64, 1)
    k = 40                                   # runs past convergence (no-op)
    x_r = rsol.cg_scan(make_matvec(A_ref), jnp.asarray(b), k)
    x_t = tsol.cg_scan(lambda v: A @ v, torch.tensor(b), k)
    assert_close(x_t, x_r, rtol=1e-12, atol=1e-12)

    # reverse mode through the unrolled loop (the O(k)-graph baseline)
    def loss_r(val):
        Av = A_ref.with_values(val)
        return jnp.sum(rsol.cg_scan(make_matvec(Av), jnp.asarray(b), k) ** 2)

    g_r = jax.grad(loss_r)(A_ref.val)
    val = A.val.clone().requires_grad_(True)
    At = A.with_values(val)
    (tsol.cg_scan(lambda v: At @ v, torch.tensor(b), k) ** 2).sum().backward()
    assert bool(torch.isfinite(val.grad).all())
    assert_close(val.grad, g_r, rtol=1e-8, atol=1e-10)


# ---------------------------------------------------------------------------
# GMRES
# ---------------------------------------------------------------------------

def test_gmres_solve_matches_reference():
    """tests/test_solvers.py::test_gmres, both packages."""
    B_ref = _convection_diffusion(60, c=0.4)
    B = port_of(B_ref)
    b = _rhs(60, 2)
    kw = dict(backend="jnp", method="gmres", tol=1e-10, maxiter=2000)
    from repro import sla as rsla
    from repro_torch import sla as tsla
    r = rsla.solve_with_info(B_ref, jnp.asarray(b), **kw)
    t = tsla.solve_with_info(B, torch.tensor(b), **kw)
    assert int(t.iterations) == int(r.iterations) and t.reason == r.reason
    np.testing.assert_allclose(np_of(B @ t.x), b, atol=1e-6)
    assert_close(t.x, r.x, rtol=1e-9, atol=1e-9)
    # both carry the true residual: equal up to rounding of ‖b − A x‖
    assert abs(float(t.residual) - float(r.residual)) <= \
        1e-12 * np.linalg.norm(b)


@pytest.mark.parametrize("restart", [10, 20, 32])
def test_gmres_reports_true_carried_residual(restart):
    B_ref = _convection_diffusion(60, c=0.4)
    B = port_of(B_ref)
    b = _rhs(60, 2)
    x_r, i_r = rsol.gmres(lambda v: B_ref @ v, jnp.asarray(b), tol=1e-10,
                          restart=restart, maxiter=100)
    mv = lambda v: B @ v
    x, info = tsol.gmres(mv, torch.tensor(b), tol=1e-10, restart=restart,
                         maxiter=100)
    assert bool(info.converged)
    assert int(info.iters) == int(i_r.iters)
    true_rn = float(torch.linalg.norm(mv(x) - torch.tensor(b)))
    np.testing.assert_allclose(float(info.resnorm), true_rn, rtol=1e-10)


def test_gmres_matvec_count_per_cycle():
    """restart(m) Arnoldi steps + ONE residual update per cycle, plus the
    initial residual — the convergence check rides on the carried norm."""
    B = port_of(_convection_diffusion(40))
    b = torch.ones(40, dtype=torch.float64)
    calls = {"n": 0}

    def mv(v):
        calls["n"] += 1
        return B @ v

    m = 10
    _, info = tsol.gmres(mv, b, tol=1e-10, restart=m, maxiter=50)
    cycles = int(info.iters) // m
    assert cycles >= 1 and bool(info.converged)
    assert calls["n"] == 1 + cycles * (m + 1), (calls["n"], cycles)


def test_gmres_left_preconditioned_and_gradient_match_reference():
    """GMRES + block_jacobi through the plan, forward and adjoint."""
    B_ref = _convection_diffusion(48, c=0.4)
    B = port_of(B_ref)
    b = _rhs(48, 1)
    kw = dict(backend="jnp", method="gmres", tol=1e-12, maxiter=4000,
              precond="block_jacobi")

    def loss_r(val, rhs):
        return jnp.sum(B_ref.with_values(val).solve(rhs, **kw) ** 3)

    g_r = jax.grad(loss_r, (0, 1))(B_ref.val, jnp.asarray(b))
    val = B.val.clone().requires_grad_(True)
    rhs = torch.tensor(b, requires_grad=True)
    (B.with_values(val).solve(rhs, **kw) ** 3).sum().backward()
    assert_close(val.grad, g_r[0], rtol=1e-8, atol=1e-8)
    assert_close(rhs.grad, g_r[1], rtol=1e-8, atol=1e-8)


# ---------------------------------------------------------------------------
# block-Jacobi
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ng,block", [(8, 16), (12, 128), (13, 32)])
def test_block_jacobi_blocks_match_reference(ng, block):
    A_ref = rpoisson.poisson2d(ng)
    A = port_of(A_ref)
    n = A.shape[0]
    nb = -(-n // block)
    r, c = np.asarray(A_ref.row), np.asarray(A_ref.col)
    safe_r, same_r = rprec._bj_indices(r, c, block)
    blocks_r = rprec._bj_assemble(A_ref.val, safe_r, same_r, nb, block)
    pre = tprec.PreconditionerPlan("block_jacobi", A.row, A.col, A.shape,
                                   block=block)
    safe_t, same_t = pre._bj_idx
    assert np.array_equal(np_of(safe_t), np.asarray(safe_r))
    assert np.array_equal(np_of(same_t), np.asarray(same_r))
    blocks_t = tprec._bj_assemble(A.val, safe_t, same_t, nb, block)
    assert_close(blocks_t, blocks_r, rtol=1e-12, atol=1e-12)
    x = _rhs(n, 0)
    z_r = rprec.block_jacobi(A_ref.val, r, c, n, block)(jnp.asarray(x))
    M = pre.make_apply(pre.refresh_state(A, None), None)
    assert_close(M(torch.tensor(x)), z_r, rtol=1e-12, atol=1e-12)


def test_symmetric_backward_reuses_iterative_setup():
    """tests/test_plan.py: forward and backward share one refresh."""
    A_ref = rpoisson.poisson2d(8)
    A = port_of(A_ref)
    b = np.ones(64)
    kw = dict(backend="jnp", method="cg", tol=1e-13, precond="block_jacobi")
    rreset()
    jax.grad(lambda v: jnp.sum(A_ref.with_values(v).solve(
        jnp.asarray(b), **kw) ** 2))(A_ref.val)
    tdisp.reset_plan_stats()
    val = A.val.clone().requires_grad_(True)
    (A.with_values(val).solve(torch.tensor(b), **kw) ** 2).sum().backward()
    assert tdisp.PLAN_STATS["setup"] == RSTATS["setup"] == 1
    assert tdisp.PLAN_STATS["setup_reuse"] == RSTATS["setup_reuse"] >= 1


# ---------------------------------------------------------------------------
# Chebyshev as a plan preconditioner
# ---------------------------------------------------------------------------

def _reference_start_vector(monkeypatch):
    """Make the port's Lanczos start vector the reference's
    ``jax.random.normal(PRNGKey(seed))`` (torch cannot draw it)."""
    def start(shape, dtype, device, seed):
        v = jax.random.normal(jax.random.PRNGKey(seed), tuple(shape),
                              jnp.float64)
        return torch.tensor(np.asarray(v), dtype=dtype, device=device)
    monkeypatch.setattr(tsol, "seeded_normal", start)


def test_estimate_spectrum_with_reference_start_vector():
    A_ref = rpoisson.poisson2d(16)
    A = port_of(A_ref)
    v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (256,),
                                      jnp.float64))
    lo_r, hi_r = rprec.estimate_spectrum(make_matvec(A_ref), 256,
                                         jnp.float64)
    lo_t, hi_t = tprec.estimate_spectrum(lambda v: A @ v, 256, torch.float64,
                                         v0=v0, device=CPU)
    assert_close(lo_t, lo_r, rtol=1e-10, atol=0)
    assert_close(hi_t, hi_r, rtol=1e-10, atol=0)
    # the seeded start vector gives bounds of the same spectrum
    lo_s, hi_s = tprec.estimate_spectrum(lambda v: A @ v, 256, torch.float64,
                                         device=CPU)
    assert 0 < float(lo_s) < float(hi_s) <= 8.0


@pytest.mark.parametrize("fused", ["off", "on"])
def test_chebyshev_plan_matches_reference(monkeypatch, fused):
    _reference_start_vector(monkeypatch)
    A_ref = rpoisson.poisson2d(12)
    A = port_of(A_ref)
    b = _rhs(144, 4)
    kw = dict(backend="jnp", method="cg", tol=1e-12, precond="chebyshev")
    from repro import sla as rsla
    from repro_torch import sla as tsla
    r = rsla.solve_with_info(A_ref, jnp.asarray(b), **kw)
    with toptions.options(fused_step=fused):
        t = tsla.solve_with_info(A, torch.tensor(b), **kw)
    assert int(t.iterations) == int(r.iterations)
    assert_close(t.x, r.x, rtol=1e-10, atol=1e-12)


def test_chebyshev_plan_seeded_start_vector():
    """Without the reference's start vector: the solution and the
    iteration count (±1)."""
    A_ref = rpoisson.poisson2d(12)
    A = port_of(A_ref)
    b = _rhs(144, 4)
    kw = dict(backend="jnp", method="cg", tol=1e-12, precond="chebyshev")
    from repro import sla as rsla
    from repro_torch import sla as tsla
    r = rsla.solve_with_info(A_ref, jnp.asarray(b), **kw)
    t = tsla.solve_with_info(A, torch.tensor(b), **kw)
    assert abs(int(t.iterations) - int(r.iterations)) <= 1
    assert_close(t.x, r.x, rtol=1e-9, atol=1e-11)


def test_fused_chebyshev_precond_matches_plain():
    """tests/test_plan.py: the fused inner step leaves the polynomial as it
    was (pallas backend, plain vs fused)."""
    A = port_of(rpoisson.poisson2d(8))
    b = torch.ones(64, dtype=torch.float64)
    kw = dict(backend="pallas", method="cg", tol=1e-12, precond="chebyshev")
    with toptions.options(fused_step="off"):
        x_plain = A.solve(b, **kw)
    with toptions.options(fused_step="on"):
        x_fused = A.solve(b, **kw)
    assert_close(x_fused, x_plain, rtol=1e-9, atol=1e-11)


# ---------------------------------------------------------------------------
# the plan preconditioners together: iterations, acceleration, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["jacobi", "block_jacobi", "chebyshev"])
def test_preconditioners_accelerate(monkeypatch, name):
    """tests/test_solvers.py::test_preconditioners_accelerate, both
    packages, iteration counts equal."""
    _reference_start_vector(monkeypatch)
    A_ref = rpoisson.poisson2d(16)
    A = port_of(A_ref)
    b = np.ones(256)
    mv_r = make_matvec(A_ref)
    M_r = rprec.make_preconditioner(name, A_ref, mv_r)
    _, i_r = rsol.cg(mv_r, jnp.asarray(b), M=M_r, tol=1e-10, maxiter=2000)
    mv = lambda v: A @ v
    M = tprec.make_preconditioner(name, A, mv)
    x, info = tsol.cg(mv, torch.tensor(b), M=M, tol=1e-10, maxiter=2000)
    _, info0 = tsol.cg(mv, torch.tensor(b), tol=1e-10, maxiter=2000)
    assert bool(info.converged)
    assert float(torch.linalg.norm(mv(x) - torch.tensor(b))) < 1e-7
    assert int(info.iters) == int(i_r.iters)
    if name != "jacobi":   # Poisson diagonal is constant → jacobi = identity
        assert int(info.iters) <= int(info0.iters)


@pytest.mark.parametrize("precond", ["block_jacobi", "chebyshev"])
def test_preconditioned_solve_differentiable(monkeypatch, precond):
    """tests/test_plan.py: the gradient through a block-Jacobi or Chebyshev
    CG solve, against the reference's (and against dense autodiff)."""
    _reference_start_vector(monkeypatch)
    A_ref = rpoisson.poisson2d(12)
    A = port_of(A_ref)
    b = np.ones(144)
    kw = dict(backend="jnp", method="cg", tol=1e-13, precond=precond)
    g_r = jax.grad(lambda v: jnp.sum(A_ref.with_values(v).solve(
        jnp.asarray(b), **kw) ** 2))(A_ref.val)
    val = A.val.clone().requires_grad_(True)
    (A.with_values(val).solve(torch.tensor(b), **kw) ** 2).sum().backward()
    assert_close(val.grad, g_r, rtol=1e-8, atol=1e-8)
    vd = A.val.clone().requires_grad_(True)
    (torch.linalg.solve(A.with_values(vd).todense(), torch.tensor(b)) ** 2
     ).sum().backward()
    assert_close(val.grad, vd.grad, rtol=1e-6, atol=1e-8)
