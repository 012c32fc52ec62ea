"""PyTorch port vs the JAX reference: batched solves and the solve server
(the cases of tests/test_serve.py inside the port's slice 5).

The same numpy inputs go through both packages: the reference batches by
``jax.vmap``, the port through its lane-batched kernels and batch-native
Krylov loops.  Solutions, gradients, per-lane iteration counts and
``PLAN_STATS`` are held to the reference at its own tolerances.  Slice 5b's
routes (batched values through the direct route, MG, AMG, the plan
Chebyshev and ILU) are held to the reference here in one case each
(``tests/test_torch_batch_direct.py`` has the rest); batched values in
eigsh raise ``NotImplementedError``, as the reference does not take them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sla as rsla
from repro.core import dispatch as rdisp
from repro.core.sparse import build_bell as r_build_bell
from repro.data import poisson as rpoisson
from repro.kernels import ops as rops
from repro.kernels import solve_step as rfk
from repro.kernels.stencil5 import Stencil5Meta as RMeta
from repro_torch import sla as tsla
from repro_torch.core import dispatch as tdisp
from repro_torch.core import solvers as tsol
from repro_torch.core.sparse import bell_to_device, build_bell
from repro_torch.data import poisson as tpoisson
from repro_torch.kernels import ops as tops
from repro_torch.kernels import solve_step as tfk
from repro_torch.kernels.stencil5 import Stencil5Meta

from _torch_parity import (CPU, FUSED_SIGS, assert_close, bell_case, np_of,
                           port_of, stencil_case, tol)

SCALES = (1.0, 1.7, 0.6)


def _kappa(ng, seed=0):
    return 1.0 + 0.5 * np.random.default_rng(seed).random((ng, ng))


def _ref_matrix(backend, ng=8):
    if backend == "stencil":
        return rpoisson.poisson2d_vc(jnp.asarray(_kappa(ng)),
                                     use_stencil_kernel=True)
    return rpoisson.poisson2d(ng)


def _stack(val):
    return np.stack([np.asarray(val) * s for s in SCALES])


def _stats(stats):
    return {k: v for k, v in stats.items() if v}


# ---------------------------------------------------------------------------
# the lane-batched kernels' plain versions against the reference's vmapped
# kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("lanes", ["values", "shared_x", "rhs"])
def test_lane_batched_bell_matches_reference_vmap(lanes, dtype):
    n, m = 120, 90
    row, col, val, x = bell_case(n, m, 0.08, dtype, 1)
    rng = np.random.default_rng(4)
    V = (val[None] * rng.uniform(0.5, 1.5, (3, 1))).astype(dtype)
    X = rng.normal(size=(3, m)).astype(dtype)
    rmeta, rcols, rperm = r_build_bell(row, col, (n, m))
    mv = lambda v, xx: rops.bell_matvec(rmeta, rcols, rperm, v, xx, n)
    bell = bell_to_device(build_bell(row, col, (n, m)), CPU)
    if lanes == "values":
        y_r = jax.vmap(mv)(jnp.asarray(V), jnp.asarray(X))
        y_t = tops.bell_matvec(bell, torch.tensor(V), torch.tensor(X), n)
    elif lanes == "shared_x":
        y_r = jax.vmap(lambda v: mv(v, jnp.asarray(x)))(jnp.asarray(V))
        y_t = tops.bell_matvec(bell, torch.tensor(V), torch.tensor(x), n)
    else:
        y_r = jax.vmap(lambda xx: mv(jnp.asarray(val), xx))(jnp.asarray(X))
        y_t = tops.bell_matvec(bell, torch.tensor(val), torch.tensor(X), n)
    assert tuple(y_t.shape) == (3, n)
    assert_close(y_t, y_r, **tol(dtype))


@pytest.mark.parametrize("shared_planes", [False, True])
def test_lane_batched_stencil_matches_reference_vmap(shared_planes):
    nx, ny = 21, 37
    v, _ = stencil_case(nx, ny, np.float64, 2)
    rng = np.random.default_rng(5)
    V = v[None] * rng.uniform(0.5, 1.5, (4, 1))
    X = rng.normal(size=(4, nx * ny))
    mv = lambda vv, xx: rops.stencil5_matvec(RMeta(nx=nx, ny=ny), vv, xx)
    meta = Stencil5Meta(nx=nx, ny=ny)
    if shared_planes:
        y_r = jax.vmap(lambda xx: mv(jnp.asarray(v), xx))(jnp.asarray(X))
        y_t = tops.stencil5_matvec(meta, torch.tensor(v), torch.tensor(X))
    else:
        y_r = jax.vmap(mv)(jnp.asarray(V), jnp.asarray(X))
        y_t = tops.stencil5_matvec(meta, torch.tensor(V), torch.tensor(X))
    assert_close(y_t, y_r, **tol(np.float64))


@pytest.mark.parametrize("name", sorted(FUSED_SIGS))
def test_lane_batched_fused_matches_reference_vmap(name):
    """(B, n) vectors, one shared (n,) vector (the last), per-lane scalars:
    the port's lane-batched plain version against ``jax.vmap`` of the
    reference's kernel."""
    n_vec, n_sc = FUSED_SIGS[name]
    rng = np.random.default_rng(11)
    B, n = 3, 517
    vecs = [rng.normal(size=(B, n)) for _ in range(n_vec - 1)]
    shared = rng.normal(size=n)
    scal = [rng.normal(size=B) for _ in range(n_sc)]
    if name == "fused_bicg_p":
        scal[2] = np.array([0.0, 1.0, 0.0])
    fn_r = getattr(rfk, name)
    out_r = jax.vmap(lambda *a: fn_r(*a[:n_vec - 1], jnp.asarray(shared),
                                     *a[n_vec - 1:]))(
        *[jnp.asarray(v) for v in vecs], *[jnp.asarray(s) for s in scal])
    out_t = getattr(tfk, name)(*[torch.tensor(v) for v in vecs],
                               torch.tensor(shared),
                               *[torch.tensor(s) for s in scal])
    assert len(out_t) == len(out_r)
    for a, b in zip(out_t, out_r):
        assert tuple(a.shape) == tuple(b.shape)
        assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_lane_batched_fused_active_mask_keeps_inactive_lanes():
    rng = np.random.default_rng(12)
    x, r, p, s = (torch.tensor(rng.normal(size=(3, 40))) for _ in range(4))
    d = torch.tensor(rng.normal(size=40))
    x0, r0 = x.clone(), r.clone()
    z = torch.empty_like(x)
    alpha = torch.tensor([0.5, -0.25, 2.0])
    act = torch.tensor([1, 0, 1], dtype=torch.int32)
    _, _, _, rho, rr = tfk.fused_cg_update(x, r, p, s, d, alpha,
                                           out=(x, r, z), active=act)
    assert torch.equal(x[1], x0[1]) and torch.equal(r[1], r0[1])
    for lane in (0, 2):
        want = tfk.fused_cg_update(x0[lane], r0[lane], p[lane], s[lane], d,
                                   alpha[lane])
        assert_close(x[lane], want[0], rtol=1e-15, atol=0)
        assert_close(rho[lane], want[3], rtol=1e-15, atol=0)
        assert_close(rr[lane], want[4], rtol=1e-15, atol=0)


def test_lane_batched_bell_backward_matches_reference_vjp():
    n, m = 60, 60
    row, col, val, _ = bell_case(n, m, 0.1, np.float64, 3)
    rng = np.random.default_rng(6)
    V = val[None] * rng.uniform(0.5, 1.5, (3, 1))
    X = rng.normal(size=(3, m))
    W = rng.normal(size=(3, n))
    rmeta, rcols, rperm = r_build_bell(row, col, (n, m))
    mv = lambda v, xx: rops.bell_matvec(rmeta, rcols, rperm, v, xx, n)
    gr = jax.grad(lambda vv, xx: jnp.sum(jnp.asarray(W) * jax.vmap(mv)(
        vv, xx)), (0, 1))(jnp.asarray(V), jnp.asarray(X))
    bell = bell_to_device(build_bell(row, col, (n, m)), CPU)
    vt = torch.tensor(V, requires_grad=True)
    xt = torch.tensor(X, requires_grad=True)
    (torch.tensor(W) * tops.bell_matvec(bell, vt, xt, n)).sum().backward()
    assert_close(vt.grad, gr[0], rtol=1e-10, atol=1e-12)
    assert_close(xt.grad, gr[1], rtol=1e-10, atol=1e-12)


def test_lane_batched_kernels_under_torch_vmap():
    """``torch.func.vmap`` over the wrappers reaches the lane-batched kernel
    (one call for the batch) and agrees with the per-lane products."""
    nx = ny = 9
    v, _ = stencil_case(nx, ny, np.float64, 7)
    X = torch.tensor(np.random.default_rng(8).normal(size=(4, nx * ny)))
    meta = Stencil5Meta(nx=nx, ny=ny)
    vt = torch.tensor(v)
    y = torch.func.vmap(lambda xx: tops.stencil5_matvec(meta, vt, xx))(X)
    want = torch.stack([tops.stencil5_matvec(meta, vt, xx) for xx in X])
    assert_close(y, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# batched values through the plan engine, per backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,fused", [
    ("jnp", "off"), ("jnp", "on"), ("pallas", "off"), ("pallas", "on"),
    ("stencil", "off"), ("stencil", "on")])
def test_batched_values_parity_iterations_and_counters(backend, fused):
    """One analyze and ONE batched setup for the stack; solutions and the
    per-lane iteration counts equal the reference's vmapped solve."""
    A_ref = _ref_matrix(backend)
    n = A_ref.shape[0]
    b = np.ones(n)
    vals = _stack(A_ref.val)
    kw = dict(backend=backend, method="cg", precond="jacobi", tol=1e-11)
    with rsla.options(fused_step=fused):
        rdisp.reset_plan_stats()
        res_r = rsla.solve_with_info(A_ref.with_values(jnp.asarray(vals)),
                                     jnp.asarray(b), **kw)
        stats_r = _stats(rdisp.PLAN_STATS)
    A = port_of(A_ref)
    with tsla.options(fused_step=fused):
        tdisp.reset_plan_stats()
        res_t = tsla.solve_with_info(A.with_values(torch.tensor(vals)),
                                     torch.tensor(b), **kw)
        stats_t = _stats(tdisp.PLAN_STATS)
    assert stats_t == stats_r
    assert stats_t["analyze"] == 1 and stats_t["setup"] == 1
    assert np_of(res_t.iterations).tolist() == \
        np.asarray(res_r.iterations).tolist()
    assert_close(res_t.x, res_r.x, rtol=1e-8, atol=1e-10)
    assert res_t.reason == res_r.reason == "converged"
    # each lane equals its own single solve
    for lane, s in enumerate(SCALES):
        x1 = A.with_values(A.val * s).solve(torch.tensor(b), **kw)
        assert_close(res_t.x[lane], x1, rtol=1e-8, atol=1e-10)


def test_batched_setup_memo_reused_across_solves():
    """Same stacked values tensor → one batched setup (a tolerance sweep over
    a batch costs one setup, as for a single tensor), as in the reference."""
    def run(pkg, A, to):
        Ab = A.with_values(to(_stack(np_of(A.val))))
        disp = rdisp if pkg == "ref" else tdisp
        cfg = disp.make_config(Ab, backend="jnp", method="cg", tol=1e-8)
        plan = disp.get_plan(Ab, cfg)
        disp.reset_plan_stats()
        plan.solve(Ab, to(np.ones(A.shape[0])), cfg=cfg)
        plan.solve(Ab, to(np.ones(A.shape[0])), cfg=disp.SolverConfig(
            backend="jnp", method="cg", tol=1e-10, precond="jacobi"))
        return _stats(disp.PLAN_STATS)

    A_ref = rpoisson.poisson2d(8)
    s_r = run("ref", A_ref, jnp.asarray)
    s_t = run("port", port_of(A_ref), torch.tensor)
    assert s_t == s_r
    assert s_t["setup"] == 1 and s_t["setup_reuse"] == 1


@pytest.mark.parametrize("backend", ["jnp", "pallas", "stencil"])
def test_batched_gradient_matches_dense_and_reference(backend):
    """∂Σx²/∂(vals, b) through the batched adjoint, against a dense solve
    per lane and against the reference's gradient (b shared by the lanes:
    its gradient sums over them)."""
    A_ref = _ref_matrix(backend, ng=6)
    n = A_ref.shape[0]
    b = np.random.default_rng(1).normal(size=n)
    vals = _stack(A_ref.val)
    kw = dict(backend=backend, method="cg", tol=1e-12)

    def loss_r(v, bb):
        return jnp.sum(A_ref.with_values(v).solve(bb, **kw) ** 2)
    g_r = jax.grad(loss_r, (0, 1))(jnp.asarray(vals), jnp.asarray(b))

    A = port_of(A_ref)
    vt = torch.tensor(vals, requires_grad=True)
    bt = torch.tensor(b, requires_grad=True)
    tdisp.reset_plan_stats()
    (A.with_values(vt).solve(bt, **kw) ** 2).sum().backward()
    stats = _stats(tdisp.PLAN_STATS)
    assert stats["analyze"] == 1 and stats["setup"] == stats["setup_reuse"] == 1

    vd = torch.tensor(vals, requires_grad=True)
    bd = torch.tensor(b, requires_grad=True)
    X = torch.stack([torch.linalg.solve(A.with_values(v).todense(), bd)
                     for v in vd])
    (X ** 2).sum().backward()
    for got, dense, ref in ((vt.grad, vd.grad, g_r[0]),
                            (bt.grad, bd.grad, g_r[1])):
        assert_close(got, dense, rtol=1e-6, atol=1e-8)
        assert_close(got, ref, rtol=1e-6, atol=1e-8)


def test_multi_rhs_gradient_matches_reference():
    """k right-hand sides on ONE matrix: one setup, gradients in val (summed
    over the right-hand sides) and in each b."""
    A_ref = rpoisson.poisson2d(6)
    n = A_ref.shape[0]
    B = np.random.default_rng(2).normal(size=(4, n))
    kw = dict(backend="pallas", method="cg", tol=1e-12)
    g_r = jax.grad(lambda v, bb: jnp.sum(A_ref.with_values(v).solve(
        bb, **kw) ** 2), (0, 1))(A_ref.val, jnp.asarray(B))
    A = port_of(A_ref)
    vt = A.val.clone().requires_grad_(True)
    bt = torch.tensor(B, requires_grad=True)
    tdisp.reset_plan_stats()
    (A.with_values(vt).solve(bt, **kw) ** 2).sum().backward()
    assert tdisp.PLAN_STATS["setup"] == 1
    assert_close(vt.grad, g_r[0], rtol=1e-6, atol=1e-8)
    assert_close(bt.grad, g_r[1], rtol=1e-6, atol=1e-8)


# ---------------------------------------------------------------------------
# multi-rhs: block-CG, the direct route and the fused block-Jacobi path
# ---------------------------------------------------------------------------

def test_block_cg_multi_rhs_matches_per_rhs_cg():
    A_ref = rpoisson.poisson2d(8)
    n = A_ref.shape[0]
    rng = np.random.default_rng(3)
    B = np.vstack([np.ones(n), rng.normal(size=n), rng.normal(size=n)])
    dense = np.asarray(A_ref.todense())
    ref = np.linalg.solve(dense, B.T).T
    A = port_of(A_ref)
    X = A.solve(torch.tensor(B), backend="jnp", method="block_cg", tol=1e-11)
    assert_close(X, ref, rtol=1e-8, atol=1e-10)
    cfg_b = tdisp.make_config(A, backend="jnp", method="block_cg", tol=1e-11)
    plan = tdisp.get_plan(A, cfg_b)
    _, info_b = plan.solve(A, torch.tensor(B), cfg=cfg_b)
    cfg_c = tdisp.make_config(A, backend="jnp", method="cg", tol=1e-11)
    _, info_c = plan.solve(A, torch.tensor(B), cfg=cfg_c)
    assert int(info_b.iters) <= int(info_c.iters.max())
    assert bool(info_b.converged.all())
    assert tuple(info_b.resnorm.shape) == (3,)
    # the reference's counts: block CG's, and per-rhs CG's (vmapped)
    rcfg = rdisp.make_config(A_ref, backend="jnp", method="block_cg",
                             tol=1e-11)
    rplan = rdisp.get_plan(A_ref, rcfg)
    _, rinfo_b = rplan.solve(A_ref, jnp.asarray(B), cfg=rcfg)
    rcfg_c = rdisp.make_config(A_ref, backend="jnp", method="cg", tol=1e-11)
    _, rinfo_c = rplan.solve(A_ref, jnp.asarray(B), cfg=rcfg_c)
    assert int(info_b.iters) == int(rinfo_b.iters)
    assert np_of(info_c.iters).tolist() == np.asarray(rinfo_c.iters).tolist()


def test_block_cg_duplicate_rhs_is_breakdown_free():
    A_ref = rpoisson.poisson2d(8)
    n = A_ref.shape[0]
    B = np.stack([np.ones(n), 2.0 * np.ones(n), np.ones(n)])   # rank 1
    X = port_of(A_ref).solve(torch.tensor(B), backend="jnp",
                             method="block_cg", tol=1e-10)
    ref = np.linalg.solve(np.asarray(A_ref.todense()), B.T).T
    assert_close(X, ref, rtol=1e-8, atol=1e-10)


def test_block_cg_single_rhs_degenerates_to_vector():
    A_ref = rpoisson.poisson2d(8)
    b = np.ones(A_ref.shape[0])
    x = port_of(A_ref).solve(torch.tensor(b), backend="jnp",
                             method="block_cg", tol=1e-11)
    assert tuple(x.shape) == b.shape
    assert_close(x, np.linalg.solve(np.asarray(A_ref.todense()), b),
                 rtol=1e-8, atol=1e-10)


def test_multi_rhs_block_jacobi_through_fused_step():
    """Multi-rhs + block-Jacobi through the fused (lane-batched) step
    kernels matches the plain path and the reference."""
    A_ref = rpoisson.poisson2d(8)
    n = A_ref.shape[0]
    B = np.random.default_rng(5).normal(size=(4, n))
    kw = dict(backend="pallas", method="cg", precond="block_jacobi",
              tol=1e-11)
    with rsla.options(fused_step="on"):
        X_r = A_ref.solve(jnp.asarray(B), **kw)
    A = port_of(A_ref)
    with tsla.options(fused_step="off"):
        X_plain = A.solve(torch.tensor(B), **kw)
    with tsla.options(fused_step="on"):
        X_fused = A.solve(torch.tensor(B), **kw)
    assert_close(X_fused, X_plain, rtol=1e-8, atol=1e-10)
    assert_close(X_fused, X_r, rtol=1e-8, atol=1e-10)
    with tsla.options(fused_step="on"):
        X_blk = A.solve(torch.tensor(B), method="block_cg", backend="jnp",
                        precond="block_jacobi", tol=1e-11)
    ref = np.linalg.solve(np.asarray(A_ref.todense()), B.T).T
    assert_close(X_blk, ref, rtol=1e-8, atol=1e-10)


def test_direct_multi_rhs_one_factorization_per_column_residuals():
    """k right-hand sides through the direct route: one factorization, one
    multi-column solve, a residual and a converged flag per column (the
    reference's vmapped solve reports them so)."""
    A_ref = rpoisson.poisson2d(10)
    n = A_ref.shape[0]
    B = np.random.default_rng(6).normal(size=(5, n))
    B[2] *= 1e3
    res_r = rsla.solve_with_info(A_ref, jnp.asarray(B), backend="direct")
    A = port_of(A_ref)
    tdisp.reset_plan_stats()
    res_t = tsla.solve_with_info(A, torch.tensor(B), backend="direct")
    assert tdisp.PLAN_STATS["factorize"] == 1
    assert tuple(res_t.residual.shape) == (5,)
    assert_close(res_t.x, res_r.x, rtol=1e-10, atol=1e-12)
    assert bool(res_t.converged.all()) and res_t.reason == "converged"
    assert tuple(np.asarray(res_r.residual).shape) == (5,)
    dense = np.asarray(A_ref.todense())
    for j in range(5):
        rn = np.linalg.norm(B[j] - dense @ np_of(res_t.x[j]))
        assert float(res_t.residual[j]) <= 1e-10 * np.linalg.norm(B[j])
        assert abs(float(res_t.residual[j]) - rn) <= \
            1e-12 * np.linalg.norm(B[j])
    vt = A.val.clone().requires_grad_(True)
    bt = torch.tensor(B, requires_grad=True)
    (A.with_values(vt).solve(bt, backend="direct") ** 2).sum().backward()
    g_r = jax.grad(lambda v, bb: jnp.sum(A_ref.with_values(v).solve(
        bb, backend="direct") ** 2), (0, 1))(A_ref.val, jnp.asarray(B))
    assert_close(vt.grad, g_r[0], rtol=1e-8, atol=1e-6)
    assert_close(bt.grad, g_r[1], rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("method,stacked", [
    ("gmres", False), ("gmres", True), ("block_cg", True)])
def test_lane_by_lane_methods_match_reference(method, stacked):
    """The methods with no batch-native loop (GMRES; block CG over stacked
    values) solve lane by lane on the batched setup, as the reference's
    vmap does."""
    A_ref = rpoisson.poisson2d(6)
    n = A_ref.shape[0]
    B = np.random.default_rng(8).normal(size=(3, n))
    vals = _stack(A_ref.val)
    kw = dict(backend="jnp", method=method, tol=1e-11)
    Ar = A_ref.with_values(jnp.asarray(vals)) if stacked else A_ref
    res_r = rsla.solve_with_info(Ar, jnp.asarray(B), **kw)
    A = port_of(A_ref)
    At = A.with_values(torch.tensor(vals)) if stacked else A
    tdisp.reset_plan_stats()
    res_t = tsla.solve_with_info(At, torch.tensor(B), **kw)
    assert tdisp.PLAN_STATS["setup"] == 1
    assert_close(res_t.x, res_r.x, rtol=1e-8, atol=1e-10)
    assert np_of(res_t.iterations).tolist() == \
        np.asarray(res_r.iterations).tolist()
    dense = torch.stack([At.with_values(v).todense() for v in At.val]) \
        if stacked else A.todense()
    want = torch.linalg.solve(dense, torch.tensor(B).unsqueeze(-1))[..., 0]
    assert_close(res_t.x, want, rtol=1e-8, atol=1e-10)


# ---------------------------------------------------------------------------
# slice 5b: batched values through the direct route, MG, AMG, Chebyshev and
# ILU match the reference; batched eigsh raises, as in the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["direct", "amg", "mg", "chebyshev", "ilu",
                                  "eigsh"])
def test_slice_5b_combinations_raise(case, monkeypatch):
    """Two value lanes through each slice-5b route: the reference's batched
    solve (its ``jax.vmap``) at its tolerances, the same PLAN_STATS (one
    setup for the stack).  eigsh takes no batched values in either package:
    the port raises, naming no slice."""
    if case == "mg":
        A_ref = rpoisson.poisson2d_vc(jnp.asarray(_kappa(8)),
                                      use_stencil_kernel=True)
    else:
        A_ref = rpoisson.poisson2d(8)
    A = port_of(A_ref)
    vals = np.stack([np.asarray(A_ref.val), 1.5 * np.asarray(A_ref.val)])
    Ab = A.with_values(torch.tensor(vals))
    b = np.ones(A.shape[0])
    if case == "eigsh":
        with pytest.raises(NotImplementedError,
                           match="does not support batched values") as exc:
            Ab.eigsh(k=2)
        assert "slice" not in str(exc.value)
        return
    if case == "chebyshev":              # the reference's Lanczos start
        def start(shape, dtype, device, seed):
            v = jax.random.normal(jax.random.PRNGKey(seed), tuple(shape),
                                  jnp.float64)
            return torch.tensor(np.asarray(v), dtype=dtype, device=device)
        monkeypatch.setattr(tsol, "seeded_normal", start)
    kw = dict(backend="direct") if case == "direct" else dict(
        backend="stencil" if case == "mg" else "jnp", method="cg",
        precond=case, tol=1e-11)
    rdisp.reset_plan_stats()
    res_r = rsla.solve_with_info(A_ref.with_values(jnp.asarray(vals)),
                                 jnp.asarray(b), **kw)
    stats_r = _stats(rdisp.PLAN_STATS)
    tdisp.reset_plan_stats()
    res_t = tsla.solve_with_info(Ab, torch.tensor(b), **kw)
    stats_t = _stats(tdisp.PLAN_STATS)
    assert stats_t == stats_r and stats_t["setup"] == 1
    assert np_of(res_t.iterations).tolist() == \
        np.asarray(res_r.iterations).tolist()
    assert_close(res_t.x, res_r.x, rtol=1e-9 if case == "direct" else 1e-8,
                 atol=1e-11 if case == "direct" else 1e-10)


# ---------------------------------------------------------------------------
# the serving driver
# ---------------------------------------------------------------------------

def _server_stream(pkg):
    """The reference test's interleaved two-pattern stream, in ``pkg``."""
    rng = np.random.default_rng(0)
    A1, A2 = rpoisson.poisson2d(6), rpoisson.poisson2d(7)
    P1, P2 = (port_of(A1), port_of(A2)) if pkg == "port" else (A1, A2)
    out = []
    for i in range(10):
        A0 = P1 if i % 2 == 0 else P2
        s = float(rng.uniform(0.8, 1.2))
        bi = rng.normal(size=A0.shape[0])
        if pkg == "port":
            out.append((A0.with_values(A0.val * s), torch.tensor(bi)))
        else:
            out.append((A0.with_values(A0.val * s), jnp.asarray(bi)))
    return out


def test_solve_server_groups_and_orders():
    from repro.launch.solve_serve import SolveRequest as RReq
    from repro.launch.solve_serve import SolveServer as RServer
    from repro_torch.launch.solve_serve import SolveRequest, SolveServer
    opts = {"backend": "jnp", "method": "cg", "tol": 1e-10}
    out_r = RServer(max_batch=8).submit_batch(
        [RReq(A, b, dict(opts)) for A, b in _server_stream("ref")])
    stream = _server_stream("port")
    server = SolveServer(max_batch=8)
    tdisp.reset_plan_stats()
    out = server.submit_batch([SolveRequest(A, b, dict(opts))
                               for A, b in stream])
    assert server.stats["dispatches"] == 2, server.stats
    assert tdisp.PLAN_STATS["analyze"] == 2, tdisp.PLAN_STATS
    assert server.stats["padded_slots"] == 16
    assert server.occupancy == pytest.approx(10 / 16)
    for res, res_r, (A, b) in zip(out, out_r, stream):
        assert res.reason == "converged"
        ref = torch.linalg.solve(A.todense(), b)
        assert_close(res.x, ref, rtol=1e-7, atol=1e-9)
        assert_close(res.x, res_r.x, rtol=1e-7, atol=1e-9)
        assert int(res.iterations) == int(res_r.iterations)


def test_serve_smoke_report():
    from repro.launch.solve_serve import serve as rserve
    from repro_torch.launch.solve_serve import serve
    rep = serve(n_requests=8, grid=6, n_patterns=1, max_batch=8,
                check=True, device=CPU)   # parity asserted inside
    rep_r = rserve(n_requests=8, grid=6, n_patterns=1, max_batch=8,
                   check=True)
    assert rep["plan_stats"]["analyze"] == rep_r["plan_stats"]["analyze"] \
        == 1
    assert rep["converged"] and rep_r["converged"]
    for side in ("batched", "sequential"):
        assert rep[side]["solves_per_sec"] > 0
        assert rep[side]["p99_ms"] >= rep[side]["p50_ms"]
    assert rep["occupancy"] == rep_r["occupancy"] == 1.0
    assert rep["device"] == "cpu"


def test_solve_serve_cli_smoke_on_cpu(capsys):
    from repro_torch.launch import solve_serve
    rep = solve_serve.main(["--smoke", "--device", "cpu"])
    assert rep["converged"] and rep["n_requests"] == 64
    assert "speedup=" in capsys.readouterr().out


def test_solve_serve_defaults_to_the_card():
    from repro_torch.launch.solve_serve import serve
    if torch.cuda.is_available():
        from repro_torch.core._device import resolve_device
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(n_requests=2, grid=4)
