"""PyTorch port vs the JAX reference: smoothed-aggregation AMG
(``precond="amg"``) — the numpy pattern passes (``aggregate_pattern``,
``spgemm_program``, ``tentative_coarse_pattern``), the random geometric
graph generator, every integer array of ``amg_symbolic``'s artifacts
(array-equal), the numeric state and one V-cycle (1e-12), CG iteration
counts, ``PLAN_STATS`` and gradients, on the same numpy inputs, f64, on the
CPU.  The cases of ``tests/test_amg.py`` are ported with their
assertions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PLAN_STATS as RSTATS
from repro.core import reset_plan_stats as rreset
from repro.core import multigrid as rmg
from repro.core import sparse as rsparse
from repro.core.sparse import SparseTensor as RTensor
from repro.data import graphs as rgraphs
from repro.data import poisson as rpoisson
from repro_torch.core import dispatch as tdisp
from repro_torch.core import multigrid as tmg
from repro_torch.core import sparse as tsparse
from repro_torch.core.adjoint import sparse_solve_with_info
from repro_torch.core.dispatch import make_config
from repro_torch.data import graphs as tgraphs

from _torch_parity import CPU, assert_close, np_of, port_of


def _convection_diffusion(n, c=0.3):
    A1 = rpoisson.poisson1d(n)
    val = np.asarray(A1.val).copy()
    val[np.asarray(A1.col) == np.asarray(A1.row) - 1] = -1.0 - c
    val[np.asarray(A1.col) == np.asarray(A1.row) + 1] = -1.0 + c
    return RTensor(val, A1.row, A1.col, (n, n))


def _operators():
    """(label, reference tensor) of the symbolic cases: unstructured graph
    Laplacians, a grid operator, a non-symmetric tridiagonal."""
    return [("graph300", rgraphs.graph_laplacian(300, seed=2, shift=1e-2)),
            ("graph2000", rgraphs.graph_laplacian(2000, seed=1)),
            ("poisson12", rpoisson.poisson2d(12)),
            ("convdiff200", _convection_diffusion(200, c=0.4))]


def _pattern(A_ref):
    return np.asarray(A_ref.row), np.asarray(A_ref.col), A_ref.shape[0]


# ---------------------------------------------------------------------------
# numpy pattern passes and the graph generator: array-equal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", range(4))
def test_pattern_passes_array_equal(case):
    label, A_ref = _operators()[case]
    r, c, n = _pattern(A_ref)
    agg_r, na_r = rsparse.aggregate_pattern(r, c, n)
    agg_t, na_t = tsparse.aggregate_pattern(r, c, n)
    assert na_t == na_r and np.array_equal(agg_t, agg_r)
    # P's tentative pattern × A, as the AMG symbolic stage builds it
    prog_r = rsparse.spgemm_program(r, c, np.arange(n), agg_r, (n, na_r))
    prog_t = tsparse.spgemm_program(r, c, np.arange(n), agg_t, (n, na_t))
    for a, b in zip(prog_t, prog_r):
        assert np.array_equal(a, b)
    for coarsest in (48, 8):
        tc_r = rsparse.tentative_coarse_pattern(r, c, n, coarsest=coarsest)
        tc_t = tsparse.tentative_coarse_pattern(r, c, n, coarsest=coarsest)
        assert tc_t[1] == tc_r[1]
        for i in (0, 2, 3, 4):
            assert np.array_equal(tc_t[i], tc_r[i]), (label, coarsest, i)


@pytest.mark.parametrize("n,seed,dim", [(300, 0, 2), (2000, 1, 2),
                                        (3000, 0, 2), (500, 3, 3)])
def test_geometric_graph_and_laplacian_array_equal(n, seed, dim):
    g_r = rgraphs.geometric_graph(n, seed=seed, dim=dim)
    g_t = tgraphs.geometric_graph(n, seed=seed, dim=dim)
    for a, b in zip(g_t, g_r):
        assert np.array_equal(a, b)
    if dim == 2:
        L_r = rgraphs.graph_laplacian(n, seed=seed, shift=1e-3)
        L_t = tgraphs.graph_laplacian(n, seed=seed, shift=1e-3, device=CPU)
        for f in ("val", "row", "col"):
            assert np.array_equal(np_of(getattr(L_t, f)),
                                  np.asarray(getattr(L_r, f))), f
        assert L_t.props == L_r.props and L_t.stencil is None


# ---------------------------------------------------------------------------
# amg_symbolic: every integer array equal; amg_numeric + one V-cycle 1e-12
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", range(4))
def test_amg_symbolic_artifacts_array_equal(case):
    label, A_ref = _operators()[case]
    r, c, n = _pattern(A_ref)
    art_r = rmg.amg_symbolic(r, c, n)
    art_t = tmg.amg_symbolic(r, c, n)
    assert art_t.stats == art_r.stats and art_t.n_coarse == art_r.n_coarse
    assert len(art_t.levels) == len(art_r.levels) >= 1
    for lt, lr in zip(art_t.levels, art_r.levels):
        for f in rmg.AMGLevelSymbolic._fields:
            a, b = np.asarray(getattr(lt, f)), np.asarray(getattr(lr, f))
            assert a.shape == b.shape and np.array_equal(a, b), (label, f)
    for f in ("perm", "ipos", "a2f"):
        assert np.array_equal(np.asarray(getattr(art_t.coarse, f)),
                              np.asarray(getattr(art_r.coarse, f))), f
    # on the device: int32 programs, the same values
    dev = tmg.amg_to_device(art_t, CPU)
    for lt, ld in zip(art_t.levels, dev.levels):
        assert ld.g1_a.dtype == torch.int32 and ld.diag_mask.dtype == torch.bool
        assert np.array_equal(np_of(ld.g2_dst), lt.g2_dst)


@pytest.mark.parametrize("case", range(4))
def test_amg_numeric_state_and_vcycle_match_reference(case):
    label, A_ref = _operators()[case]
    r, c, n = _pattern(A_ref)
    art_r = rmg.amg_symbolic(r, c, n)
    st_r = rmg.amg_numeric(art_r, A_ref.val)
    art_t = tmg.amg_to_device(tmg.amg_symbolic(r, c, n), CPU)
    st_t = tmg.amg_numeric(art_t, torch.tensor(np.asarray(A_ref.val)))
    for lt, lr in zip(st_t[0], st_r[0]):
        for a, b in zip(lt, lr):             # (aval, dinv, p_val) per level
            assert_close(a, b, rtol=1e-12, atol=1e-12)
    assert_close(st_t[1], st_r[1], rtol=1e-12, atol=1e-12)  # coarse factors
    x = np.random.default_rng(case).normal(size=n)
    z_r = rmg.AMGPreconditioner(art_r, st_r)(jnp.asarray(x))
    z_t = tmg.AMGPreconditioner(art_t, st_t)(torch.tensor(x))
    assert_close(z_t, z_r, rtol=1e-12, atol=1e-12)


def test_galerkin_program_matches_dense_triple_product():
    L = tgraphs.graph_laplacian(2000, seed=2, shift=1e-2, device=CPU)
    n = L.shape[0]
    art = tmg.amg_to_device(tmg.amg_symbolic(L.row, L.col, n), CPU)
    assert len(art.levels) >= 2
    state, C = tmg.amg_numeric(art, L.val)
    lev, nxt = art.levels[0], art.levels[1]
    aval, dinv, p_val = state[0]
    P = np.zeros((n, lev.n_c))
    np.add.at(P, (np_of(lev.p_row), np_of(lev.p_col)), np_of(p_val))
    Ac_ref = P.T @ np_of(L.todense()) @ P
    Ac = np.zeros((lev.n_c, lev.n_c))
    np.add.at(Ac, (np_of(nxt.arow), np_of(nxt.acol)), np_of(state[1][0]))
    np.testing.assert_allclose(Ac, Ac_ref, rtol=1e-10, atol=1e-12)


def test_amg_hierarchy_coarsens_geometrically():
    L = tgraphs.graph_laplacian(2000, seed=1, device=CPU)
    art = tmg.amg_symbolic(L.row, L.col, L.shape[0])
    sizes = art.stats["sizes"]
    assert sizes[0] == 2000
    assert sizes[1] <= sizes[0] // 2          # real coarsening, level 1
    assert art.n_coarse <= 256                 # bottomed out in direct range


# ---------------------------------------------------------------------------
# the preconditioned solve: iterations, PLAN_STATS, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["poisson32", "graph1000"])
def test_amg_cg_iterations_match_reference(which):
    """tests/test_amg.py::test_amg_on_structured_poisson_too, and an
    unstructured graph: iteration counts equal to the reference's."""
    A_ref = rpoisson.poisson2d(32) if which == "poisson32" else \
        rgraphs.graph_laplacian(1000, seed=0, shift=1e-3)
    A = port_of(A_ref)
    n = A.shape[0]
    b = np.random.default_rng(0).normal(size=n)
    from repro import sla as rsla
    from repro_torch import sla as tsla
    kw = dict(backend="jnp", method="cg", tol=1e-10, maxiter=2000,
              precond="amg")
    r = rsla.solve_with_info(A_ref, jnp.asarray(b), **kw)
    t = tsla.solve_with_info(A, torch.tensor(b), **kw)
    assert t.reason == "converged" and int(t.iterations) == int(r.iterations)
    assert float(torch.linalg.norm(A @ t.x - torch.tensor(b))) < 1e-7
    assert_close(t.x, r.x, rtol=1e-9, atol=1e-10)


def test_amg_beats_jacobi_4x_on_unstructured_graph():
    G = tgraphs.graph_laplacian(3000, seed=0, shift=1e-3, device=CPU)
    assert G.stencil is None          # no grid structure — mg inapplicable
    with pytest.raises(ValueError, match="mg"):
        G.solve(torch.ones(G.shape[0], dtype=torch.float64), backend="jnp",
                precond="mg")
    b = torch.tensor(np.random.default_rng(0).normal(size=G.shape[0]))
    cfg_j = make_config(G, backend="jnp", method="cg", tol=1e-8,
                        maxiter=40000)
    xj, ij = sparse_solve_with_info(cfg_j, G, b)
    cfg_a = make_config(G, backend="jnp", method="cg", tol=1e-8,
                        maxiter=40000, precond="amg")
    xa, ia = sparse_solve_with_info(cfg_a, G, b)
    assert bool(ia.converged) and bool(ij.converged)
    assert float(torch.linalg.norm(G @ xa - b)) < 1e-6
    assert int(ia.iters) * 4 <= int(ij.iters), (int(ia.iters), int(ij.iters))


def test_amg_one_coarsen_one_galerkin_across_sweep_and_backward():
    """tests/test_amg.py: one coarsening and one Galerkin product across a
    tolerance sweep and the backward; new values refresh the numeric half
    only.  The PLAN_STATS deltas equal the reference's."""
    A_ref = rpoisson.poisson2d(12)
    A = port_of(A_ref)
    b = np.ones(144)
    kw = dict(backend="jnp", method="cg", precond="amg")
    stats = []
    for pkg in ("ref", "port"):
        if pkg == "ref":
            rreset()
            for tol in (1e-4, 1e-8, 1e-12):
                A_ref.solve(jnp.asarray(b), tol=tol, **kw)
            jax.grad(lambda v: jnp.sum(A_ref.with_values(v).solve(
                jnp.asarray(b), tol=1e-12, **kw) ** 2))(A_ref.val)
            mid = dict(RSTATS)
            A_ref.with_values(A_ref.val * 2.0).solve(jnp.asarray(b),
                                                     tol=1e-8, **kw)
            stats.append((mid, dict(RSTATS)))
        else:
            tdisp.reset_plan_stats()
            for tol in (1e-4, 1e-8, 1e-12):
                A.solve(torch.tensor(b), tol=tol, **kw)
            # differentiate at A's own values tensor, as jax.grad does at
            # A.val: the setup memo keys on the values (identity, version)
            val = A.val.requires_grad_(True)
            (A.with_values(val).solve(torch.tensor(b), tol=1e-12, **kw) ** 2
             ).sum().backward()
            mid = dict(tdisp.PLAN_STATS)
            A.with_values(A.val.detach() * 2.0).solve(torch.tensor(b),
                                                      tol=1e-8, **kw)
            stats.append((mid, dict(tdisp.PLAN_STATS)))
    (mid_r, end_r), (mid_t, end_t) = stats
    for k in ("coarsen", "galerkin", "analyze", "transpose_shared"):
        assert mid_t[k] == mid_r[k], (k, mid_t, mid_r)
        assert end_t[k] == end_r[k], (k, end_t, end_r)
    assert (mid_t["coarsen"], mid_t["galerkin"], mid_t["analyze"],
            mid_t["transpose_shared"]) == (1, 1, 1, 1)
    assert (end_t["coarsen"], end_t["galerkin"]) == (1, 2)


def _grad_pair(A_ref, b, method, power, **kw):
    A = port_of(A_ref)
    kw = dict(backend="jnp", method=method, tol=1e-13, precond="amg", **kw)
    g_r = jax.grad(lambda v, rhs: jnp.sum(A_ref.with_values(v).solve(
        rhs, **kw) ** power), (0, 1))(A_ref.val, jnp.asarray(b))
    val = A.val.clone().requires_grad_(True)
    rhs = torch.tensor(b, requires_grad=True)
    (A.with_values(val).solve(rhs, **kw) ** power).sum().backward()
    gd_v = A.val.clone().requires_grad_(True)
    gd_b = torch.tensor(b, requires_grad=True)
    (torch.linalg.solve(A.with_values(gd_v).todense(), gd_b) ** power
     ).sum().backward()
    return (val.grad, rhs.grad), g_r, (gd_v.grad, gd_b.grad)


def test_amg_gradcheck_symmetric_matches_reference_and_dense():
    A_ref = rpoisson.poisson2d(12)
    b = np.random.default_rng(0).normal(size=144)
    g, g_r, g_d = _grad_pair(A_ref, b, "cg", 2)
    for i in range(2):
        assert_close(g[i], g_r[i], rtol=1e-8, atol=1e-8)
        assert_close(g[i], g_d[i], rtol=1e-6, atol=1e-8)


def test_amg_gradcheck_nonsymmetric_matches_reference_and_dense():
    B_ref = _convection_diffusion(48, c=0.4)
    assert not B_ref.props["symmetric"]
    b = np.random.default_rng(1).normal(size=48)
    g, g_r, g_d = _grad_pair(B_ref, b, "bicgstab", 3, maxiter=8000)
    for i in range(2):
        assert_close(g[i], g_r[i], rtol=1e-8, atol=1e-8)
        assert_close(g[i], g_d[i], rtol=1e-6, atol=1e-8)


def test_amg_on_a_graph_of_many_components():
    """A sparse geometric graph (radius 0.02: hundreds of components)
    stalls the aggregation above ``coarsest`` with a coarsest pattern that
    is (almost) diagonal.  The reference's direct analysis of it raises
    IndexError (``direct._emit_snode`` indexes the empty fill list); the
    port analyzes it, and CG + amg converges with the reference's level
    sizes above the coarsest."""
    r_G = rgraphs.graph_laplacian(2000, radius=0.02, shift=1e-3)
    r, c, n = _pattern(r_G)
    with pytest.raises(IndexError):
        rmg.amg_symbolic(r, c, n)
    G = tgraphs.graph_laplacian(2000, radius=0.02, shift=1e-3, device=CPU)
    art = tmg.amg_symbolic(G.row, G.col, n)
    assert art.stats["sizes"][:2] == [2000, 908] and art.n_coarse > 64
    b = torch.tensor(np.random.default_rng(0).normal(size=n))
    x, info = sparse_solve_with_info(make_config(
        G, backend="jnp", method="cg", tol=1e-10, maxiter=2000,
        precond="amg"), G, b)
    assert bool(info.converged)
    assert float(torch.linalg.norm(G @ x - b)) < 1e-8 * float(b.norm())


def test_direct_analysis_of_a_diagonal_pattern():
    """No off-diagonal fill (an empty L): the supernodal program has no
    sub-rows, and the factored solve divides by the diagonal."""
    from repro_torch.core import direct as td
    n = 700
    i = np.arange(n)
    art = td.to_device(td.symbolic_factor(i, i, n, supernodal="on"), CPU)
    assert art.snode is not None
    d = torch.tensor(np.random.default_rng(1).uniform(1, 2, n))
    C = td.numeric_factor(art, d)
    b = torch.ones(n, dtype=torch.float64)
    assert_close(td.factored_solve(art, C, b), 1.0 / d, rtol=1e-15, atol=0)
