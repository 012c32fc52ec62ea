"""PyTorch port vs the JAX reference: the eigen layer — LOBPCG and
Lanczos fed the reference's own start vectors, ``sparse_eigsh``'s
eigenvalue and eigenvector gradients (with and without the AMG plan
preconditioner, smallest and largest pairs) and its ``PLAN_STATS``, on the
same numpy inputs, f64, on the CPU; eigenvalues also held to
``numpy.linalg.eigvalsh``.  The cases are those of ``tests/test_solvers.py``,
``tests/test_adjoint.py`` and ``tests/test_nonlinear.py``.

The reference draws its start vectors with ``jax.random``, which torch
cannot reproduce: the parity cases hand the reference's draw to the port
(``solvers.seeded_normal`` patched), the others run the port's own seeded
CPU generator.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sla as rsla
from repro.core import solvers as rsolvers
from repro.core.adjoint import sparse_eigsh as r_eigsh
from repro.core.dispatch import PLAN_STATS as RSTATS
from repro.core.dispatch import make_matvec as r_make_matvec
from repro.core.dispatch import reset_plan_stats as rreset
from repro.core.sparse import SparseTensor as RTensor
from repro.data import poisson as rpoisson
from repro_torch import sla as tsla
from repro_torch.core import solvers as tsolvers
from repro_torch.core.adjoint import sparse_eigsh as t_eigsh
from repro_torch.core.dispatch import PLAN_STATS as TSTATS
from repro_torch.core.dispatch import make_matvec as t_make_matvec
from repro_torch.core.dispatch import reset_plan_stats as treset

from _torch_parity import CPU, assert_close, np_of, port_of


def _aniso(ng, cy=0.6):
    """2-D Poisson with anisotropic y-coupling: simple eigenvalues."""
    A = rpoisson.poisson2d(ng)
    val = np.asarray(A.val).copy()
    row, col = np.asarray(A.row), np.asarray(A.col)
    val[np.abs(row - col) == 1] *= cy
    val[row == col] = 2.0 + 2.0 * cy
    return RTensor(val, row, col, A.shape)


def _ref_normal(shape, seed):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                        jnp.float64))


@pytest.fixture
def reference_start(monkeypatch):
    """The port's start vectors replaced by the reference's draws."""
    def start(shape, dtype, device, seed):
        return torch.tensor(_ref_normal(tuple(shape), seed), dtype=dtype,
                            device=device)
    monkeypatch.setattr(tsolvers, "seeded_normal", start)


def _same_up_to_sign(V, V_ref, atol):
    V, V_ref = np_of(V), np_of(V_ref)
    s = np.sign(np.sum(V * V_ref, axis=1))[:, None]
    np.testing.assert_allclose(V * s, V_ref, atol=atol)


def _rel(a, b):
    a, b = np_of(a), np_of(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# ---------------------------------------------------------------------------
# solver level: the reference's own start vectors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("largest", [False, True])
def test_lobpcg_matches_reference_from_its_start_block(largest):
    Ar = _aniso(10)
    At = port_of(Ar)
    X0 = _ref_normal((4, Ar.shape[0]), 0)
    wr, Vr, ir = rsolvers.lobpcg(r_make_matvec(Ar), jnp.asarray(X0),
                                 tol=1e-11, maxiter=2000, largest=largest)
    wt, Vt, it = tsolvers.lobpcg(t_make_matvec(At), torch.tensor(X0),
                                 tol=1e-11, maxiter=2000, largest=largest)
    # both converge; the counts may differ (96 and 107 for the smallest
    # pairs): near convergence the whitening masks the stale P directions
    # by a relative eigenvalue cutoff, which the two LAPACK eigh calls
    # decide apart in the last bits
    assert bool(it.converged) and bool(ir.converged)
    assert_close(wt, wr, rtol=1e-10, atol=1e-10)
    _same_up_to_sign(Vt, Vr, 1e-8)
    w_np = np.linalg.eigvalsh(np.asarray(Ar.todense()))
    w_np = w_np[::-1][:4] if largest else w_np[:4]
    assert_close(wt, w_np, rtol=0, atol=1e-9)


def test_lanczos_eigsh_matches_reference_from_its_start_vector(
        reference_start):
    Ar = _aniso(10)
    At = port_of(Ar)
    n = Ar.shape[0]
    wr, Vr = rsolvers.eigsh_lanczos(r_make_matvec(Ar), n, 3, num_steps=32,
                                    dtype=jnp.float64, seed=3)
    wt, Vt = tsolvers.eigsh_lanczos(t_make_matvec(At), n, 3, num_steps=32,
                                    dtype=torch.float64, seed=3, device=CPU)
    assert_close(wt, wr, rtol=1e-10, atol=1e-10)
    _same_up_to_sign(Vt, Vr, 1e-8)


def test_lobpcg_and_lanczos_eigenvalues_vs_eigvalsh(reference_start):
    """The reference's ``test_lobpcg_and_lanczos_eigenvalues`` (marked
    ``known_failing`` there), from the reference's start vectors: 32
    Lanczos steps leave the three smallest eigenvalues at most 8.0e-7 off
    from the reference's seed-0 vector and 3.1e-6 off from the port's own
    (``seeded_normal``), so the 1e-6 bound holds for one start vector and
    not for the other (``test_lanczos_eigenvalues_from_own_start_vector``)."""
    Ar = _aniso(10)
    At = port_of(Ar)
    w_ref = np.sort(np.linalg.eigvalsh(np.asarray(Ar.todense())))
    w, V = At.eigsh(k=4, method="lobpcg", tol=1e-11, maxiter=2000)
    np.testing.assert_allclose(np_of(w), w_ref[:4], atol=1e-7)
    for i in range(4):
        assert float(torch.linalg.norm(At @ V[i] - w[i] * V[i])) < 1e-6
    w2, _ = At.eigsh(k=3, method="lanczos")
    np.testing.assert_allclose(np_of(w2), w_ref[:3], atol=1e-6)


def test_lanczos_eigenvalues_from_own_start_vector():
    """The port's own start vector: LOBPCG as tight as above; Lanczos'
    fixed 32 steps reach 1e-5 on the three smallest (its error is a
    property of the start vector, see above)."""
    Ar = _aniso(10)
    At = port_of(Ar)
    w_ref = np.sort(np.linalg.eigvalsh(np.asarray(Ar.todense())))
    w, _ = At.eigsh(k=4, method="lobpcg", tol=1e-11, maxiter=2000)
    np.testing.assert_allclose(np_of(w), w_ref[:4], atol=1e-7)
    w2, _ = At.eigsh(k=3, method="lanczos")
    np.testing.assert_allclose(np_of(w2), w_ref[:3], atol=1e-5)


def test_largest_eigenpairs_vs_eigvalsh():
    Ar = _aniso(8)
    At = port_of(Ar)
    w_ref = np.sort(np.linalg.eigvalsh(np.asarray(Ar.todense())))
    w, _ = t_eigsh(At, 2, largest=True, tol=1e-11, maxiter=1500,
                   compute_vector_grads=False)
    np.testing.assert_allclose(np.sort(np_of(w)), w_ref[-2:], atol=1e-6)


def test_eigsh_argument_checks():
    At = port_of(_aniso(5))
    with pytest.raises(ValueError, match="lobpcg"):
        t_eigsh(At, 2, method="lanczos", precond="amg")
    with pytest.raises(ValueError, match="eig method"):
        t_eigsh(At, 2, method="arnoldi")


# ---------------------------------------------------------------------------
# gradients against the reference's jax.grad
# ---------------------------------------------------------------------------

def _eig_grad_pair(Ar, loss_r, loss_t):
    g_r = jax.grad(loss_r)(Ar.val)
    At = port_of(Ar)
    val = At.val.clone().requires_grad_(True)
    loss_t(At, val).backward()
    return val.grad, g_r, At


def test_eigenvalue_gradients_match_reference(reference_start):
    """``tests/test_adjoint.py``'s eigenvalue case (Hellmann–Feynman)."""
    Ar = _aniso(7)

    def lr(val):
        w, _ = Ar.with_values(val).eigsh(k=2, tol=1e-12, maxiter=2000,
                                         compute_vector_grads=False)
        return 2.0 * w[0] + w[1]

    def lt(At, val):
        w, _ = At.with_values(val).eigsh(k=2, tol=1e-12, maxiter=2000,
                                         compute_vector_grads=False)
        return 2.0 * w[0] + w[1]

    g, g_r, _ = _eig_grad_pair(Ar, lr, lt)
    assert _rel(g, g_r) <= 1e-8


@pytest.mark.parametrize("precond", [None, "amg"])
def test_eigenvector_gradients_match_reference(reference_start, precond):
    """``tests/test_adjoint.py``'s eigenvector case and
    ``tests/test_nonlinear.py``'s AMG-preconditioned one: the analytic
    term plus one deflated CG per pair, against the reference (≤ 1e-7)
    and against the exact dense adjoint."""
    Ar = _aniso(6) if precond is None else _aniso(9)
    n = Ar.shape[0]
    a = np.random.default_rng(5).normal(size=n)
    aj, at = jnp.asarray(a), torch.tensor(a)

    def lr(val):
        w, V = rsla.eigsh(Ar.with_values(val), k=2, tol=1e-13, maxiter=3000,
                          precond=precond)
        return 1.3 * w[0] + (V[1] @ aj) ** 2

    def lt(At, val):
        w, V = tsla.eigsh(At.with_values(val), k=2, tol=1e-13, maxiter=3000,
                          precond=precond)
        return 1.3 * w[0] + (V[1] @ at) ** 2

    rreset()
    treset()
    g, g_r, At = _eig_grad_pair(Ar, lr, lt)
    assert _rel(g, g_r) <= 1e-7
    if precond is not None:
        # one analyze across the forward and the backward: the backward's
        # deflated CG reuses the forward's AMG setup through the memo
        for key in ("analyze", "coarsen", "galerkin", "setup",
                    "setup_reuse"):
            assert TSTATS[key] == RSTATS[key], key
        assert TSTATS["analyze"] == 1 and TSTATS["galerkin"] == 1
    # the exact dense-eigendecomposition adjoint (symmetrized convention)
    D = np.asarray(Ar.todense())
    w_all, V_all = np.linalg.eigh(D)
    v0, v1 = V_all[:, 0], V_all[:, 1]
    gv1 = 2 * (v1 @ a) * a
    y = sum((V_all[:, j] @ gv1) / (w_all[1] - w_all[j]) * V_all[:, j]
            for j in range(n) if j != 1)
    row, col = np.asarray(Ar.row), np.asarray(Ar.col)
    g_exact = (1.3 * v0[row] * v0[col]
               + 0.5 * (y[row] * v1[col] + v1[row] * y[col]))
    np.testing.assert_allclose(np_of(g), g_exact, rtol=1e-5, atol=1e-7)


def test_largest_pair_gradients_match_reference(reference_start):
    """``largest=True`` (``tests/test_solvers.py``): eigenvalue and
    eigenvector terms, unpreconditioned backward."""
    Ar = _aniso(8)
    a = np.random.default_rng(7).normal(size=Ar.shape[0])
    aj, at = jnp.asarray(a), torch.tensor(a)

    def lr(val):
        w, V = r_eigsh(Ar.with_values(val), 2, largest=True, tol=1e-12,
                       maxiter=1500)
        return w[0] + 0.5 * w[1] + (V[0] @ aj) ** 2

    def lt(At, val):
        w, V = t_eigsh(At.with_values(val), 2, largest=True, tol=1e-12,
                       maxiter=1500)
        return w[0] + 0.5 * w[1] + (V[0] @ at) ** 2

    g, g_r, _ = _eig_grad_pair(Ar, lr, lt)
    assert _rel(g, g_r) <= 1e-7


def test_lanczos_eigenvalue_gradients_match_reference(reference_start):
    Ar = _aniso(7)

    def lr(val):
        w, _ = r_eigsh(Ar.with_values(val), 2, method="lanczos",
                       compute_vector_grads=False)
        return w[0] + 3.0 * w[1]

    def lt(At, val):
        w, _ = t_eigsh(At.with_values(val), 2, method="lanczos",
                       compute_vector_grads=False)
        return w[0] + 3.0 * w[1]

    g, g_r, _ = _eig_grad_pair(Ar, lr, lt)
    assert _rel(g, g_r) <= 1e-8


def test_eigsh_amg_counters_and_largest_match_reference():
    """``tests/test_nonlinear.py``'s plan-engine eigen case: one analyze
    and one coarsening serve a smallest and a largest solve."""
    Ar = _aniso(9)
    At = port_of(Ar)
    w_ref = np.linalg.eigvalsh(np.asarray(Ar.todense()))
    treset()
    w, _ = tsla.eigsh(At, k=3, precond="amg", tol=1e-10, maxiter=500)
    np.testing.assert_allclose(np_of(w), w_ref[:3], rtol=1e-8)
    assert TSTATS["analyze"] == 1 and TSTATS["coarsen"] == 1
    wl, _ = tsla.eigsh(At, k=2, precond="amg", largest=True, tol=1e-9,
                       maxiter=500, compute_vector_grads=False)
    np.testing.assert_allclose(np.sort(np_of(wl)), w_ref[-2:], rtol=1e-6)
    assert TSTATS["analyze"] == 1
