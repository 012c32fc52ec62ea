"""PyTorch port vs the JAX reference: the nonlinear layer — the Jacobian
coloring (array-equal), the colored assembly through the COO, stencil and
block-ELL products (``torch.func`` rules of the kernel wrappers), Newton /
Picard / Anderson, ``SparseNewton``'s ``PLAN_STATS`` counters and the
θ-gradients of ``nonlinear_solve``, on the same numpy inputs, f64, on the
CPU.  The cases are those of ``tests/test_solvers.py``,
``tests/test_nonlinear.py`` and ``benchmarks/table5_gradcheck.py``.

The reference's kernels are ``custom_vjp`` functions with no forward-mode
rule, so its assembly is taken through the COO product of the same matrix.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sla as rsla
from repro.core import solvers as rsolvers
from repro.core.dispatch import PLAN_STATS as RSTATS
from repro.core.dispatch import SolverConfig as RConfig
from repro.core.dispatch import reset_plan_stats as rreset
from repro.core.nonlinear import SparseNewton as RSN
from repro.core.sparse import SparseTensor as RTensor
from repro.core.sparse import color_pattern as rcolor
from repro.data import graphs as rgraphs
from repro.data import poisson as rpoisson
from repro_torch import sla as tsla
from repro_torch.core import solvers as tsolvers
from repro_torch.core.dispatch import PLAN_STATS as TSTATS
from repro_torch.core.dispatch import SolverConfig as TConfig
from repro_torch.core.dispatch import reset_plan_stats as treset
from repro_torch.core.nonlinear import SparseNewton as TSN
from repro_torch.core.sparse import SparseTensor as TTensor
from repro_torch.core.sparse import color_pattern as tcolor
from repro_torch.data.poisson import poisson2d_vc as t_poisson2d_vc

from _torch_parity import CPU, assert_close, np_of, port_of

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    from _hypothesis_compat import given, settings, st


def _t(a):
    return torch.tensor(np.asarray(a))


def _th(x, grad=False):
    """θ as a 0-dim f64 tensor (a default-dtype one would round θ to f32)."""
    return torch.tensor(x, dtype=torch.float64, requires_grad=grad)


def _fresh_ref(A):
    """A reference tensor with its own plan cache (clean counters)."""
    return RTensor(A.val, A.row, A.col, A.shape, props=dict(A.props),
                   validate=False)


def _aniso(ng, cy=0.6):
    A = rpoisson.poisson2d(ng)
    val = np.asarray(A.val).copy()
    row, col = np.asarray(A.row), np.asarray(A.col)
    val[np.abs(row - col) == 1] *= cy
    val[row == col] = 2.0 + 2.0 * cy
    return RTensor(val, row, col, A.shape)


def _cubic(A, f, matvec):
    """F(u, θ) = A u + θ u³ − f (the reference's ``_cubic_problem``)."""
    def residual(u, th):
        return matvec(A, u) + th * u ** 3 - f
    return residual


def _rel(a, b):
    a, b = np_of(a), np_of(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# ---------------------------------------------------------------------------
# coloring
# ---------------------------------------------------------------------------

def _patterns():
    out = [("poisson2d(24)", rpoisson.poisson2d(24)),
           ("graph300", rgraphs.graph_laplacian(300, seed=2, shift=1e-2)),
           ("aniso9", _aniso(9))]
    out = [(lab, np.asarray(A.row), np.asarray(A.col), A.shape[0])
           for lab, A in out]
    for seed, (n, nnz) in enumerate(((40, 260), (64, 90), (30, 400))):
        rng = np.random.default_rng(seed)
        out.append((f"random{seed}", rng.integers(0, n, nnz),
                    rng.integers(0, n, nnz), n + seed))  # empty columns too
    return out


@pytest.mark.parametrize("case", range(6))
def test_color_pattern_array_equal(case):
    label, row, col, n = _patterns()[case]
    c_r, k_r = rcolor(row, col, n)
    c_t, k_t = tcolor(torch.tensor(row), torch.tensor(col), n)
    assert k_t == k_r, label
    assert np.array_equal(c_t, np.asarray(c_r)), label
    # a valid distance-1 coloring of the column-intersection graph
    for i in np.unique(row):
        cols_i = np.unique(col[row == i])
        assert len(np.unique(c_t[cols_i])) == len(cols_i)


def test_color_pattern_counts_poisson2d():
    A = rpoisson.poisson2d(24)
    _, k = tcolor(np.asarray(A.row), np.asarray(A.col), A.shape[0])
    assert k <= 8


# ---------------------------------------------------------------------------
# colored assembly through the three products
# ---------------------------------------------------------------------------

def _assembly_case(product):
    """(port tensor, reference COO tensor, port matvec) of one product."""
    if product == "stencil":
        kappa = np.random.default_rng(2).uniform(0.5, 2.0, size=(6, 6))
        At = t_poisson2d_vc(torch.tensor(kappa), use_stencil_kernel=True,
                            device=CPU)
        Ar = RTensor(np_of(At.val), np_of(At.row), np_of(At.col), At.shape)
        return At, Ar, lambda A, u: A.matvec(u)
    Ar = _aniso(6)
    At = port_of(Ar)
    if product == "bell":
        At = TTensor(At.val, At.row, At.col, At.shape, props=At.props,
                     build_kernel_layout=True, device=CPU)
        return At, Ar, lambda A, u: A.matvec(u, backend="pallas")
    return At, Ar, lambda A, u: A @ u


@pytest.mark.parametrize("product", ["coo", "stencil", "bell"])
def test_colored_assembly_matches_jacfwd_and_reference(product):
    At, Ar, mv = _assembly_case(product)
    n = At.shape[0]
    f = np.linspace(0.5, 1.5, n)
    rt = _cubic(At, _t(f), mv)
    rr = _cubic(Ar, jnp.asarray(f), lambda A, u: A @ u)
    u = np.random.default_rng(1).normal(size=n)
    th = 0.7
    treset()
    sn_t = TSN(rt, At)
    sn_r = RSN(rr, Ar)
    assert sn_t.n_colors == sn_r.n_colors <= 8
    assert TSTATS["jac_color"] == 1
    vals = sn_t.assemble(_t(u), _th(th))
    assert TSTATS["jac_assemble"] == 1
    J = torch.func.jacfwd(lambda uu: rt(uu, _th(th)))(_t(u))
    assert_close(vals, J[At.row, At.col], rtol=1e-12, atol=1e-12)
    assert_close(vals, sn_r.assemble(jnp.asarray(u), jnp.asarray(th)),
                 rtol=1e-12, atol=1e-12)


def test_coloring_budget_guard_and_callback_escape():
    n = 24
    # one dense row → every column pairwise adjacent → n colors
    row = np.concatenate([np.zeros(n, np.int64), np.arange(n)])
    col = np.concatenate([np.arange(n), np.arange(n)])

    def residual(u):
        return u + torch.zeros(n, dtype=u.dtype).index_add(
            0, torch.zeros(1, dtype=torch.int64), u.sum()[None])

    with tsla.options(jac_coloring_budget=4):
        with pytest.raises(ValueError, match="jac_coloring_budget"):
            TSN(residual, (row, col, n), device=CPU)

        def assemble(u):
            blk = torch.ones(n, dtype=u.dtype)
            blk[0] = 2.0
            return torch.cat([blk, blk])
        sn = TSN(residual, (row, col, n), assemble_jacobian=assemble,
                 device=CPU)
        vals = sn.assemble(torch.zeros(n, dtype=torch.float64))
        J = torch.func.jacfwd(residual)(torch.zeros(n, dtype=torch.float64))
        assert_close(vals, J[row, col], atol=1e-14)


# ---------------------------------------------------------------------------
# Newton / Picard / Anderson (tests/test_solvers.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["newton", "newton_matfree", "picard",
                                    "anderson"])
def test_newton_picard_anderson_match_reference(method):
    n = 32
    Ar = rpoisson.poisson1d(n)
    At = port_of(Ar)
    b = np.linspace(0.5, 1.5, n)
    Fr = lambda u: Ar @ u + 0.1 * u ** 3 - jnp.asarray(b)
    Ft = lambda u: At @ u + 0.1 * u ** 3 - _t(b)
    if method.startswith("newton"):
        kw = dict(tol=1e-12)
        if method == "newton_matfree":
            kw.update(dense_jacobian_budget=0, inner_tol=1e-12)
        ur, ir = rsolvers.newton_solve(Fr, jnp.zeros(n), **kw)
        ut, it = tsolvers.newton_solve(Ft, torch.zeros(n, dtype=torch.float64),
                                       **kw)
    elif method == "picard":
        ur, ir = rsolvers.picard_solve(lambda u: u - 0.2 * Fr(u),
                                       jnp.zeros(n), tol=1e-10, maxiter=5000)
        ut, it = tsolvers.picard_solve(lambda u: u - 0.2 * Ft(u),
                                       torch.zeros(n, dtype=torch.float64),
                                       tol=1e-10, maxiter=5000)
    else:
        ur, ir = rsolvers.anderson_solve(lambda u: u - 0.2 * Fr(u),
                                         jnp.zeros(n), tol=1e-10,
                                         maxiter=2000)
        ut, it = tsolvers.anderson_solve(lambda u: u - 0.2 * Ft(u),
                                         torch.zeros(n, dtype=torch.float64),
                                         tol=1e-10, maxiter=2000)
    assert float(torch.linalg.norm(Ft(ut))) < 1e-6, method
    assert bool(it.converged) and bool(ir.converged)
    assert int(it.iters) == int(ir.iters), method
    assert_close(ut, ur, rtol=0, atol=1e-10)


def _contraction(seed, n, L):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(n, n))
    M *= L / np.linalg.norm(M, 2)
    c = rng.normal(size=n)
    x_star = np.linalg.solve(np.eye(n) - M, c)
    Mt, ct = _t(M), _t(c)
    return (lambda x: ct + Mt @ x), x_star


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 10_000), n=st.integers(2, 24),
       L=st.floats(0.05, 0.9))
def test_picard_converges_on_random_contractions(seed, n, L):
    G, x_star = _contraction(seed, n, L)
    tol = 1e-10
    x, info = tsolvers.picard_solve(G, torch.zeros(n, dtype=torch.float64),
                                    tol=tol, maxiter=5000)
    assert bool(info.converged) == bool(float(info.resnorm) <= tol)
    assert bool(info.converged)
    np.testing.assert_allclose(np_of(x), x_star, atol=1e-8)


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 10_000), n=st.integers(2, 24),
       L=st.floats(0.05, 0.9), m=st.integers(1, 12))
def test_anderson_converges_on_random_contractions(seed, n, L, m):
    G, x_star = _contraction(seed, n, L)
    tol = 1e-10
    x, info = tsolvers.anderson_solve(G, torch.zeros(n, dtype=torch.float64),
                                      m=m, tol=tol, maxiter=2000)
    assert bool(info.converged) == bool(float(info.resnorm) <= tol)
    assert bool(info.converged), (seed, n, L, m)
    np.testing.assert_allclose(np_of(x), x_star, atol=1e-7)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000), n=st.integers(2, 12))
def test_anderson_degenerate_windows_no_nan(seed, n):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=n)
    v = rng.normal(size=n)
    M = 0.5 * np.outer(u, v) / (np.linalg.norm(u) * np.linalg.norm(v))
    c = rng.normal(size=n)
    x_star = np.linalg.solve(np.eye(n) - M, c)
    Mt, ct = _t(M), _t(c)
    x, info = tsolvers.anderson_solve(lambda x: ct + Mt @ x,
                                      torch.zeros(n, dtype=torch.float64),
                                      m=4 * n, tol=1e-11, maxiter=500)
    assert bool(torch.all(torch.isfinite(x)))
    assert bool(info.converged) == bool(float(info.resnorm) <= 1e-11)
    np.testing.assert_allclose(np_of(x), x_star, atol=1e-8)


def test_anderson_f32_pinv_held_to_fixed_point():
    """The reference's f32 case (a rank-2 map, roundoff amplified ×1e3),
    held to the numpy fixed point: the pinv Gram solve stays finite and
    converges.  The ``"ridge"`` path runs too; whether it fails in f32 is
    platform behaviour, so nothing is asserted of it."""
    rng = np.random.default_rng(0)
    n, m = 6, 8
    M = rng.normal(size=(n, n)).astype(np.float32)
    M = 0.5 * M / np.linalg.norm(M, 2)
    U, S, Vt = np.linalg.svd(M)
    S[2:] = 0.0
    M = (U * S) @ Vt
    c = (rng.normal(size=n) * 1e3).astype(np.float32)
    x_star = np.linalg.solve(np.eye(n) - M, c)
    Mt, ct = torch.tensor(M, dtype=torch.float32), torch.tensor(c)
    G = lambda x: ct + Mt @ x
    x0 = torch.zeros(n, dtype=torch.float32)
    tsolvers.anderson_solve(G, x0, m=m, tol=1e-3, maxiter=100,
                            gram_solver="ridge")
    x, info = tsolvers.anderson_solve(G, x0, m=m, tol=1e-3, maxiter=100)
    assert bool(torch.all(torch.isfinite(x)))
    assert bool(info.converged)
    np.testing.assert_allclose(np_of(x), x_star, atol=1e-2)
    with pytest.raises(ValueError, match="gram_solver"):
        tsolvers.anderson_solve(G, x0, gram_solver="qr")


# ---------------------------------------------------------------------------
# SparseNewton: solution, counters, gradients
# ---------------------------------------------------------------------------

def test_sparse_newton_matches_dense_newton_and_reference():
    Ar = rpoisson.poisson1d(48)
    At = port_of(Ar)
    n = 48
    f = np.linspace(0.5, 1.5, n)
    rt = _cubic(At, _t(f), lambda A, u: A @ u)
    th = _th(0.7)
    Ft = lambda u: rt(u, th)
    z = torch.zeros(n, dtype=torch.float64)
    u_dense, info_d = tsolvers.newton_solve(Ft, z, tol=1e-12)
    sn = TSN(rt, At, linear_solver=TConfig(backend="direct"))
    u_sparse, info_s = sn.solve(z, th, tol=1e-12)
    assert bool(info_d.converged) and bool(info_s.converged)
    assert_close(u_sparse, u_dense, atol=1e-8)
    u_api, info_api = tsolvers.newton_solve(
        Ft, z, tol=1e-12, jac_pattern=At,
        linear_solver=TConfig(backend="direct"))
    assert bool(info_api.converged)
    assert_close(u_api, u_dense, atol=1e-8)
    rr = _cubic(Ar, jnp.asarray(f), lambda A, u: A @ u)
    u_ref, _ = RSN(rr, Ar, linear_solver=RConfig(backend="direct")).solve(
        jnp.zeros(n), jnp.asarray(0.7), tol=1e-12)
    assert_close(u_sparse, u_ref, atol=1e-12)
    with pytest.raises(ValueError, match="jac_pattern"):
        tsolvers.newton_solve(Ft, z, linear_solver=TConfig(backend="direct"))
    with pytest.raises(ValueError, match="jac_pattern"):
        tsla.nonlinear_solve(rt, z, th, linear_solver=TConfig())
    with pytest.raises(ValueError, match="nonlinear method"):
        tsla.nonlinear_solve(rt, z, th, method="secant")


_COUNTER_CFGS = {
    "direct": dict(backend="direct"),
    "amg": dict(backend="jnp", method="cg", precond="amg", tol=1e-12,
                maxiter=500),
}


@pytest.mark.parametrize("route", sorted(_COUNTER_CFGS))
def test_sparse_newton_counters_and_gradient_match_reference(route):
    """One analyze serves the sweep and its IFT backward; factorize /
    galerkin count the steps; the backward reuses the converged setup
    (``tests/test_nonlinear.py``).  Every counter equals the reference's,
    and the θ-gradient too (≤ 1e-8)."""
    kw = _COUNTER_CFGS[route]
    Ar = _fresh_ref(rpoisson.poisson2d(8))
    At = port_of(Ar)
    n = At.shape[0]
    f = np.linspace(0.5, 1.5, n)
    rr = _cubic(Ar, jnp.asarray(f), lambda A, u: A @ u)
    rt = _cubic(At, _t(f), lambda A, u: A @ u)

    rreset()
    g_r = jax.grad(lambda t: jnp.sum(rsla.nonlinear_solve(
        rr, jnp.zeros(n), t, jac_pattern=Ar,
        linear_solver=RConfig(**kw)) ** 2))(jnp.asarray(0.7))
    stats_r = dict(RSTATS)

    treset()
    th = _th(0.7, grad=True)
    u = tsla.nonlinear_solve(rt, torch.zeros(n, dtype=torch.float64), th,
                             jac_pattern=At, linear_solver=TConfig(**kw))
    (u ** 2).sum().backward()
    assert TSTATS["analyze"] == 1 and TSTATS["jac_color"] == 1
    assert TSTATS["transpose_shared"] == 1 and TSTATS["setup_reuse"] >= 1
    refresh = "factorize" if route == "direct" else "galerkin"
    assert TSTATS[refresh] == TSTATS["jac_assemble"] >= 2
    for key in TSTATS:
        assert TSTATS[key] == stats_r.get(key, 0), key
    assert _rel(th.grad, g_r) <= 1e-8


def test_graph_is_one_node():
    """θ → u is ONE autograd node, whatever the Newton steps."""
    Ar = rpoisson.poisson1d(16)
    At = port_of(Ar)
    rt = _cubic(At, _t(np.linspace(0.5, 1.5, 16)), lambda A, u: A @ u)
    th = _th(0.7, grad=True)
    u = tsla.nonlinear_solve(rt, torch.zeros(16, dtype=torch.float64), th,
                             tol=1e-12)
    node = u.grad_fn
    assert type(node).__name__ == "_NonlinearSolveBackward"
    nxt = [fn for fn, _ in node.next_functions if fn is not None]
    assert len(nxt) == 1 and type(nxt[0]).__name__ == "AccumulateGrad"
    assert nxt[0].variable is th


def test_matrix_free_newton_gradients_match_reference():
    """``benchmarks/table5_gradcheck.py``'s nonlinear row at n = 96:
    F(u; val, f) = A(val) u + u³ − f, matrix-free Newton, gradients in val
    and f against the reference's ``jax.grad`` (≤ 1e-8)."""
    n = 96
    Ar = rpoisson.poisson1d(n)
    At = port_of(Ar)
    f = np.linspace(0.5, 1.5, n)

    def rres(u, val, ff):
        return Ar.with_values(val) @ u + u ** 3 - ff

    def tres(u, val, ff):
        return At.with_values(val) @ u + u ** 3 - ff

    gv_r, gf_r = jax.grad(lambda v, ff: jnp.sum(rsla.nonlinear_solve(
        rres, jnp.zeros(n), v, ff, method="newton", tol=1e-13) ** 2),
        (0, 1))(Ar.val, jnp.asarray(f))
    val = At.val.clone().requires_grad_(True)
    ff = _t(f).requires_grad_(True)
    u = tsla.nonlinear_solve(tres, torch.zeros(n, dtype=torch.float64), val,
                             ff, method="newton", tol=1e-13)
    (u ** 2).sum().backward()
    assert _rel(val.grad, gv_r) <= 1e-8
    assert _rel(ff.grad, gf_r) <= 1e-8


@pytest.mark.parametrize("route", ["direct", "amg"])
def test_sparse_newton_table5_gradients_match_reference(route):
    """``table5_gradcheck.py``'s SparseNewton rows at ng = 12 (aniso
    Poisson): θ-gradient and counters against the reference."""
    cfg = dict(backend="direct") if route == "direct" else dict(
        backend="jnp", method="cg", precond="amg", tol=1e-13, maxiter=800)
    Ar = _fresh_ref(_aniso(12))
    At = port_of(Ar)
    n = At.shape[0]
    f = np.linspace(0.5, 1.5, n)
    fr, ft = jnp.asarray(f), _t(f)
    rreset()
    g_r = jax.grad(lambda t: jnp.sum(rsla.nonlinear_solve(
        lambda u, tt: Ar @ u + tt * u ** 3 - fr, jnp.zeros(n), t,
        jac_pattern=Ar, linear_solver=RConfig(**cfg), tol=1e-13) ** 2))(
        jnp.asarray(0.7))
    stats_r = dict(RSTATS)
    treset()
    th = _th(0.7, grad=True)
    u = tsla.nonlinear_solve(lambda u, tt: At @ u + tt * u ** 3 - ft,
                             torch.zeros(n, dtype=torch.float64), th,
                             jac_pattern=At, linear_solver=TConfig(**cfg),
                             tol=1e-13)
    (u ** 2).sum().backward()
    assert _rel(th.grad, g_r) <= 1e-8
    for key in ("analyze", "jac_color", "jac_assemble", "factorize",
                "galerkin", "transpose_shared", "setup", "setup_reuse"):
        assert TSTATS[key] == stats_r[key], key


@pytest.mark.parametrize("method", ["picard", "anderson"])
def test_fixed_point_forward_plan_backward_matches_reference(method):
    """Picard / Anderson forward + SparseNewton IFT backward
    (``tests/test_nonlinear.py``): the θ-gradient equals the reference's."""
    A0 = rpoisson.poisson1d(40)
    val = np.asarray(A0.val).copy()
    val[np.asarray(A0.row) == np.asarray(A0.col)] += 1.0
    Ar = RTensor(jnp.asarray(val), A0.row, A0.col, A0.shape)
    At = port_of(Ar)
    n = 40
    f = np.linspace(0.5, 1.5, n)
    rr = _cubic(Ar, jnp.asarray(f), lambda A, u: A @ u)
    rt = _cubic(At, _t(f), lambda A, u: A @ u)
    kw = dict(maxiter=8000) if method == "picard" else dict(maxiter=2000)
    g_r = jax.grad(lambda t: jnp.sum(rsla.nonlinear_solve(
        lambda u, tt: 0.3 * rr(u, tt), jnp.zeros(n), t, method=method,
        tol=1e-13, jac_pattern=Ar, linear_solver=RConfig(backend="direct"),
        **kw) ** 2))(jnp.asarray(0.3))
    th = _th(0.3, grad=True)
    u = tsla.nonlinear_solve(lambda u, tt: 0.3 * rt(u, tt),
                             torch.zeros(n, dtype=torch.float64), th,
                             method=method, tol=1e-13, jac_pattern=At,
                             linear_solver=TConfig(backend="direct"), **kw)
    (u ** 2).sum().backward()
    assert _rel(th.grad, g_r) <= 1e-8


def test_p_laplacian_graph_one_analyze_grad_vs_fd():
    """The reference's acceptance case on a smaller graph (n = 2000):
    one analyze across every Newton step, the IFT backward and the FD
    evaluations; the θ-gradient against a central difference to 1e-5."""
    n = 2000
    At = port_of(rgraphs.graph_laplacian(n, seed=7))
    f = _t(np.random.default_rng(11).normal(size=n)) * 1e-2
    p, eps_reg = 3.0, 1e-3

    def residual(u, th):
        return At @ u + th * ((u ** 2 + eps_reg) ** ((p - 2) / 2)) * u - f

    cfg = TConfig(backend="jnp", method="cg", precond="amg", tol=1e-12,
                  maxiter=600)

    def loss(t):
        u = tsla.nonlinear_solve(residual, torch.zeros(n, dtype=torch.float64),
                                 t, jac_pattern=At, linear_solver=cfg,
                                 tol=1e-11, maxiter=30)
        return (u ** 2).sum()

    treset()
    th = _th(0.8, grad=True)
    loss(th).backward()
    assert TSTATS["analyze"] == 1 and TSTATS["jac_color"] == 1
    assert TSTATS["transpose_shared"] == 1
    assert TSTATS["galerkin"] == TSTATS["jac_assemble"]
    eps = 1e-4
    with torch.no_grad():
        fd = (loss(_th(0.8 + eps)) - loss(_th(0.8 - eps))) \
            / (2 * eps)
    assert TSTATS["analyze"] == 1
    assert abs(float(th.grad - fd)) / abs(float(fd)) < 1e-5


@pytest.mark.parametrize("arity", [2, 3])
def test_tuple_pattern_nonlinear_solve_matches_reference(arity):
    """``jac_pattern=(row, col[, n])`` through ``nonlinear_solve`` and
    ``newton_solve``: the pattern lands on x0's device, and u and the
    θ-gradient equal the reference's."""
    Ar = _fresh_ref(_aniso(8))
    At = port_of(Ar)
    n = At.shape[0]
    row, col = np.asarray(Ar.row), np.asarray(Ar.col)
    pat = (row, col, n)[:arity]
    f = np.linspace(0.5, 1.5, n)
    fr, ft = jnp.asarray(f), _t(f)
    cfg = dict(backend="direct")
    g_r = jax.grad(lambda t: jnp.sum(rsla.nonlinear_solve(
        lambda u, tt: Ar @ u + tt * u ** 3 - fr, jnp.zeros(n), t,
        jac_pattern=pat, linear_solver=RConfig(**cfg), tol=1e-13) ** 2))(
        jnp.asarray(0.7))
    th = _th(0.7, grad=True)
    u = tsla.nonlinear_solve(lambda u, tt: At @ u + tt * u ** 3 - ft,
                             torch.zeros(n, dtype=torch.float64), th,
                             jac_pattern=pat, linear_solver=TConfig(**cfg),
                             tol=1e-13)
    (u ** 2).sum().backward()
    assert u.device.type == "cpu"
    assert _rel(th.grad, g_r) <= 1e-8
    x_r, _ = rsolvers.newton_solve(lambda u: Ar @ u + 0.7 * u ** 3 - fr,
                                   jnp.zeros(n), tol=1e-13, jac_pattern=pat,
                                   linear_solver=RConfig(**cfg))
    x_t, _ = tsolvers.newton_solve(lambda u: At @ u + 0.7 * u ** 3 - ft,
                                   torch.zeros(n, dtype=torch.float64),
                                   tol=1e-13, jac_pattern=pat,
                                   linear_solver=TConfig(**cfg))
    assert_close(x_t, x_r, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("route", ["newton_matfree", "newton_direct",
                                   "picard", "anderson"])
@pytest.mark.parametrize("x0_grad", [False, True])
def test_start_at_root_returns_own_tensor(route, x0_grad):
    """A start that already solves F = 0 takes no step: the solve still
    returns a tensor of its own (x0 gains no autograd history, a leaf x0
    that requires grad is accepted) and the θ-gradient equals the
    reference's from the same start."""
    Ar = _fresh_ref(rpoisson.poisson1d(24))
    At = port_of(Ar)
    n = 24
    u0 = np.linspace(0.1, 0.4, n)
    f = np.asarray(Ar @ jnp.asarray(u0)) + 0.7 * u0 ** 3
    fr, ft = jnp.asarray(f), _t(f)
    method = "newton" if route.startswith("newton") else route
    kw = dict(method=method, tol=1e-10)
    kw_r, kw_t = dict(kw), dict(kw)
    if route != "newton_matfree":
        kw_r.update(jac_pattern=Ar, linear_solver=RConfig(backend="direct"))
        kw_t.update(jac_pattern=At, linear_solver=TConfig(backend="direct"))
    g_r = jax.grad(lambda t: jnp.sum(rsla.nonlinear_solve(
        lambda u, tt: Ar @ u + tt * u ** 3 - fr, jnp.asarray(u0), t,
        **kw_r) ** 2))(jnp.asarray(0.7))
    x0 = _t(u0).requires_grad_(x0_grad)
    th = _th(0.7, grad=True)
    u = tsla.nonlinear_solve(lambda u, tt: At @ u + tt * u ** 3 - ft, x0, th,
                             **kw_t)
    assert u is not x0 and x0.grad_fn is None
    (u ** 2).sum().backward()
    assert x0.grad is None
    assert_close(u, u0, rtol=0, atol=1e-12)
    assert _rel(th.grad, g_r) <= 1e-8
