"""PyTorch port vs the JAX reference: stacked values (B, nnz) through the
direct route and the heavy preconditioners (MG, AMG, Chebyshev, ILU) — the
cases of tests/test_serve.py that the reference runs under ``jax.vmap``.

The same numpy inputs go through both packages.  The reference vmaps its
setup and its per-lane solve; the port factorizes the whole stack at once
(the panel kernels' lane-strided forms; their plain versions here, on the
CPU) and applies one lane-stacked preconditioner.  Solutions, gradients,
per-lane iteration counts and ``PLAN_STATS`` are held to the reference at
its own tolerances, and every lane to its own single solve.
"""
import re
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sla as rsla
from repro.core import direct as rd
from repro.core import dispatch as rdisp
from repro.core.sparse import SparseTensor as RTensor
from repro.data import poisson as rpoisson
from repro_torch import sla as tsla
from repro_torch.core import direct as td
from repro_torch.core import dispatch as tdisp
from repro_torch.core import solvers as tsol
from repro_torch.data import poisson as tpoisson

from _torch_parity import (CPU, assert_close, jittered_lanes, not_proportional,
                           np_of, port_of)

SCALES = (1.0, 1.7, 0.6)


def _stats(stats):
    return {k: v for k, v in stats.items() if v}


def _stack(val, scales=SCALES):
    return np.stack([np.asarray(val) * s for s in scales])


def _drift(ng=10):
    """The non-symmetric drift operator: variable-coefficient Poisson with
    unequal N/S couplings (symmetric pattern, non-symmetric values)."""
    rng = np.random.default_rng(0)
    kap = np.exp(0.3 * rng.normal(size=(ng, ng)))
    drift = np.array([1.0, 1.3, 0.7, 1.0, 1.0]).reshape(5, 1)
    rows, cols, _ = tpoisson.vc_pattern(ng)
    v = (np.asarray(rpoisson.vc_coefficients(jnp.asarray(kap))).reshape(5, -1)
         * drift).reshape(-1)
    n = ng * ng
    props = {"symmetric": False, "spd_hint": False, "sorted_rows": False}
    return RTensor(v, rows, cols, (n, n), props=props, validate=False)


def _both(A_ref, vals, b, **kw):
    """The reference's and the port's batched solve of ``vals`` (B, nnz)
    on A_ref's pattern, each with its PLAN_STATS."""
    rdisp.reset_plan_stats()
    res_r = rsla.solve_with_info(A_ref.with_values(jnp.asarray(vals)),
                                 jnp.asarray(b), **kw)
    stats_r = _stats(rdisp.PLAN_STATS)
    A = port_of(A_ref)
    tdisp.reset_plan_stats()
    res_t = tsla.solve_with_info(A.with_values(torch.tensor(vals)),
                                 torch.tensor(b), **kw)
    stats_t = _stats(tdisp.PLAN_STATS)
    return A, res_r, stats_r, res_t, stats_t


def _lanes_are_single_solves(A, vals, b, res_t, rtol, atol, **kw):
    for lane, v in enumerate(vals):
        one = tsla.solve_with_info(A.with_values(torch.tensor(v)),
                                   torch.tensor(b), **kw)
        assert_close(res_t.x[lane], one.x, rtol=rtol, atol=atol)
        assert int(res_t.iterations[lane]) == int(one.iterations)


# ---------------------------------------------------------------------------
# the direct route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["ldlt", "lu", "supernodal"])
def test_batched_direct_parity_single_factorize(case):
    """Stacked values through ``backend="direct"``: ONE setup and ONE
    factorization for the stack (tests/test_serve.py:51), the reference's
    solutions at its tolerances, every lane its own single solve."""
    if case == "lu":
        A_ref, method = _drift(), "lu"
    else:
        A_ref, method = rpoisson.poisson2d(8 if case == "ldlt" else 24), "ldlt"
    n = A_ref.shape[0]
    b = np.random.default_rng(3).normal(size=n)
    vals = _stack(A_ref.val)
    kw = dict(backend="direct", method=method)
    A, res_r, stats_r, res_t, stats_t = _both(A_ref, vals, b, **kw)
    assert stats_t == stats_r
    assert stats_t["setup"] == stats_t["factorize"] == 1
    assert stats_t["analyze"] == 1
    art = tdisp.get_plan(A, tdisp.make_config(A, **kw)).artifacts["direct"]
    assert (art.snode is not None) == (case == "supernodal")
    assert_close(res_t.x, res_r.x, rtol=1e-9, atol=1e-11)
    assert tuple(res_t.residual.shape) == (len(SCALES),)
    assert bool(res_t.converged.all()) and res_t.reason == "converged"
    _lanes_are_single_solves(A, vals, b, res_t, 1e-12, 1e-14, **kw)


def test_batched_factors_with_pairs_and_per_lane_tau():
    """The indefinite-hint program (static 2x2 pairs) on a stack whose lanes
    differ in scale by 10⁶: one factorization of the stack equals the
    reference's vmapped ``numeric_factor`` (τ = √eps·max|A_b| per lane), and
    its forward and transposed solves the reference's vmapped solves."""
    rng = np.random.default_rng(1)
    m, k = 18, 8
    H = rng.standard_normal((m, m))
    H = H @ H.T + m * np.eye(m)
    Bm = rng.standard_normal((k, m))
    Ad = np.block([[H, Bm.T], [Bm, np.zeros((k, k))]])
    n = m + k
    row, col = np.nonzero((np.abs(Ad) > 1e-12) | np.eye(n, dtype=bool))
    vals = _stack(Ad[row, col], (1.0, 1e3, 1e-3))
    rhs = rng.standard_normal((3, n))
    ra = rd.symbolic_factor(row, col, n, pivot_blocks="auto")
    ta = td.to_device(td.symbolic_factor(row, col, n, pivot_blocks="auto"),
                      CPU)
    assert ta.snode.stats["n_pair_pivots"] > 0
    Cr = np.asarray(jax.vmap(lambda v: rd.numeric_factor(ra, v))(
        jnp.asarray(vals)))
    with warnings.catch_warnings():
        warnings.simplefilter("error")       # any perturbation warning fails
        C = td.numeric_factor(ta, torch.tensor(vals))
    assert tuple(C.shape) == (3, ta.nnzF + 2)
    tau = td._pivot_tau(torch.tensor(vals), None)
    assert_close(tau, np.sqrt(np.finfo(np.float64).eps)
                 * np.abs(vals).max(axis=1), rtol=1e-15, atol=0)
    for lane in range(3):
        scale = np.abs(Cr[lane, :-2]).max()
        assert np.abs(np_of(C)[lane, :-2] - Cr[lane, :-2]).max() \
            <= 1e-12 * scale
    for transposed in (False, True):
        xr = jax.vmap(lambda c, bb: rd.factored_solve(
            ra, c, bb, transposed=transposed))(jnp.asarray(Cr),
                                               jnp.asarray(rhs))
        x = td.factored_solve(ta, C, torch.tensor(rhs), transposed=transposed)
        assert_close(x, xr, rtol=1e-9, atol=1e-11)
        Ab = np.stack([Ad * s for s in (1.0, 1e3, 1e-3)])
        want = np.linalg.solve(np.swapaxes(Ab, 1, 2) if transposed else Ab,
                               rhs[..., None])[..., 0]
        assert_close(x, want, rtol=1e-8, atol=1e-10)
    # (B, n, m): several right-hand sides per lane
    R = torch.tensor(rng.standard_normal((3, n, 4)))
    X = td.factored_solve(ta, C, R)
    for j in range(4):
        assert_close(X[..., j], td.factored_solve(ta, C, R[..., j]),
                     rtol=1e-13, atol=1e-15)


def test_batched_perturbation_counts_per_lane():
    """A sparse saddle point the static pairs do not cover (the reference
    clamps its pivots): the stack warns ONCE with each lane's clamp count,
    equal to that lane's single factorization, and every lane solves as its
    single factorization does."""
    H = rpoisson.poisson2d(8)
    m, k = 64, 16
    rng = np.random.default_rng(0)
    br = np.repeat(np.arange(k), 3)
    bc = rng.integers(0, m, br.size)
    bv = rng.standard_normal(br.size)
    hr, hc, hv = np.asarray(H.row), np.asarray(H.col), np.asarray(H.val)
    row = np.concatenate([hr, m + br, bc, m + np.arange(k)])
    col = np.concatenate([hc, bc, m + br, m + np.arange(k)])
    val = np.concatenate([hv, bv, bv, np.zeros(k)])
    n = m + k
    vals = _stack(val, (1.0, 3.0))
    b = torch.tensor(rng.standard_normal(n))
    ta = td.to_device(td.symbolic_factor(row, col, n, pivot_blocks="auto"),
                      CPU)
    counts, singles = [], []
    for v in vals:
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            Cs = td.numeric_factor(ta, torch.tensor(v))
        (msg,) = [str(w.message) for w in rec]
        counts.append(int(re.search(r"hit (\d+) ", msg).group(1)))
        singles.append(td.factored_solve(ta, Cs, b))
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        C = td.numeric_factor(ta, torch.tensor(vals))
    (msg,) = [str(w.message) for w in rec]
    got = [int(c) for _, c in re.findall(r"(\d+) \((\d+), \|d\|", msg)]
    assert got == counts and all(c > 0 for c in counts), (msg, counts)
    x = td.factored_solve(ta, C, b.expand(2, n))
    for lane in range(2):
        assert torch.equal(x[lane], singles[lane])


@pytest.mark.parametrize("sym", [True, False], ids=["ldlt", "lu"])
def test_batched_direct_gradient_matches_reference(sym):
    """∂Σx²/∂(vals, b) through the batched direct route against ``jax.grad``
    of the reference's batched solve; the backward runs the transposed
    sweeps on the SAME lane factors: one factorization over forward and
    backward, PLAN_STATS equal to the reference's."""
    A_ref = rpoisson.poisson2d(8) if sym else _drift(8)
    n = A_ref.shape[0]
    b = np.random.default_rng(1).normal(size=n)
    vals = _stack(A_ref.val)
    kw = dict(backend="direct")

    def loss_r(v, bb):
        return jnp.sum(A_ref.with_values(v).solve(bb, **kw) ** 2)
    rdisp.reset_plan_stats()
    g_r = jax.grad(loss_r, (0, 1))(jnp.asarray(vals), jnp.asarray(b))
    stats_r = _stats(rdisp.PLAN_STATS)

    A = port_of(A_ref)
    vt = torch.tensor(vals, requires_grad=True)
    bt = torch.tensor(b, requires_grad=True)
    tdisp.reset_plan_stats()
    (A.with_values(vt).solve(bt, **kw) ** 2).sum().backward()
    stats_t = _stats(tdisp.PLAN_STATS)
    assert stats_t == stats_r
    assert stats_t["factorize"] == stats_t["setup"] == 1
    assert stats_t["transpose_shared"] == 1
    assert_close(vt.grad, g_r[0], rtol=1e-9, atol=1e-11)
    assert_close(bt.grad, g_r[1], rtol=1e-9, atol=1e-11)


# ---------------------------------------------------------------------------
# the heavy preconditioners
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["cg", "bicgstab"])
def test_batched_amg_parity_single_galerkin(method):
    """CG / BiCGStab + AMG on stacked values: ONE Galerkin product for the
    stack (tests/test_serve.py:67), the reference's solutions and per-lane
    iterations, each lane its single solve."""
    A_ref = rpoisson.poisson2d(10)
    b = np.ones(A_ref.shape[0])
    vals = _stack(A_ref.val)
    kw = dict(backend="jnp", method=method, precond="amg", tol=1e-11)
    A, res_r, stats_r, res_t, stats_t = _both(A_ref, vals, b, **kw)
    assert stats_t == stats_r
    assert stats_t["setup"] == stats_t["galerkin"] == 1
    assert np_of(res_t.iterations).tolist() == \
        np.asarray(res_r.iterations).tolist()
    assert_close(res_t.x, res_r.x, rtol=1e-8, atol=1e-10)
    _lanes_are_single_solves(A, vals, b, res_t, 1e-12, 1e-14, **kw)


@pytest.mark.parametrize("ng", [8, 32])
def test_batched_stencil_mg_parity(ng):
    """CG + geometric MG on stacked stencil values (tests/test_serve.py:83
    at ng 8; a random κ at ng 32, where the hierarchy has levels): one
    lane-stacked hierarchy, the reference's solutions and iterations."""
    kappa = np.ones((ng, ng)) if ng == 8 else \
        1.0 + 0.5 * np.random.default_rng(0).random((ng, ng))
    A_ref = rpoisson.poisson2d_vc(jnp.asarray(kappa), use_stencil_kernel=True)
    b = np.ones(A_ref.shape[0])
    vals = _stack(A_ref.val)
    kw = dict(backend="stencil", method="cg", precond="mg", tol=1e-11)
    A, res_r, stats_r, res_t, stats_t = _both(A_ref, vals, b, **kw)
    assert stats_t == stats_r
    assert stats_t["analyze"] == stats_t["setup"] == 1
    assert np_of(res_t.iterations).tolist() == \
        np.asarray(res_r.iterations).tolist()
    assert_close(res_t.x, res_r.x, rtol=1e-8, atol=1e-10)
    _lanes_are_single_solves(A, vals, b, res_t, 1e-12, 1e-14, **kw)


def _reference_start_vector(monkeypatch):
    """The port's Lanczos start vector made the reference's
    ``jax.random.normal(PRNGKey(seed))`` (torch cannot draw it)."""
    def start(shape, dtype, device, seed):
        v = jax.random.normal(jax.random.PRNGKey(seed), tuple(shape),
                              jnp.float64)
        return torch.tensor(np.asarray(v), dtype=dtype, device=device)
    monkeypatch.setattr(tsol, "seeded_normal", start)


@pytest.mark.parametrize("method", ["cg", "bicgstab"])
@pytest.mark.parametrize("precond", ["chebyshev", "ilu"])
def test_batched_chebyshev_and_ilu_parity(monkeypatch, precond, method):
    """Chebyshev (one Lanczos estimate per lane, (B,) bounds) and ILU(0)
    (the scalar program with a lane axis) on stacked values, CG and
    BiCGStab: the reference's solutions and iterations, one setup."""
    _reference_start_vector(monkeypatch)
    A_ref = rpoisson.poisson2d(10)
    b = np.random.default_rng(4).normal(size=A_ref.shape[0])
    vals = _stack(A_ref.val)
    kw = dict(backend="jnp", method=method, precond=precond, tol=1e-11)
    A, res_r, stats_r, res_t, stats_t = _both(A_ref, vals, b, **kw)
    assert stats_t == stats_r
    assert stats_t["setup"] == 1
    assert np_of(res_t.iterations).tolist() == \
        np.asarray(res_r.iterations).tolist()
    assert_close(res_t.x, res_r.x, rtol=1e-8, atol=1e-10)
    _lanes_are_single_solves(A, vals, b, res_t, 1e-10, 1e-12, **kw)


@pytest.mark.parametrize("route", [
    "ldlt", "lu", "supernodal", "amg-cg", "amg-bicgstab", "mg-cg",
    "chebyshev-cg", "ilu-cg", "ilu-bicgstab"])
def test_batched_lanes_not_proportional(monkeypatch, route):
    """Lanes that are not multiples of one another: every entry jittered
    on its own (``jittered_lanes``), or a random κ per lane for MG.  AMG,
    MG and ILU(0) are homogeneous in the values and a Krylov iterate does
    not see a preconditioner's scale, so scaled copies of one matrix cannot
    show a lane applied on another lane's state; these lanes do.  Each
    route against the reference's vmapped solve and each lane's single
    solve."""
    _reference_start_vector(monkeypatch)
    precond, _, method = route.partition("-")
    rng = np.random.default_rng(11)
    if precond == "mg":
        ng = 32
        refs = [rpoisson.poisson2d_vc(jnp.asarray(1.0 + rng.random((ng, ng))),
                                      use_stencil_kernel=True)
                for _ in range(3)]
        A_ref = refs[0]
        vals = np.stack([np.asarray(a.val) for a in refs])
        kw = dict(backend="stencil", method=method, precond="mg", tol=1e-11)
    else:
        A_ref = _drift() if precond == "lu" else rpoisson.poisson2d(
            {"ldlt": 8, "supernodal": 24}.get(precond, 10))
        vals = jittered_lanes(A_ref.row, A_ref.col, A_ref.val, 3, seed=7)
        kw = dict(backend="direct", method="lu" if precond == "lu" else
                  "ldlt") if not method else \
            dict(backend="jnp", method=method, precond=precond, tol=1e-11)
    b = rng.normal(size=A_ref.shape[0])
    A, res_r, stats_r, res_t, stats_t = _both(A_ref, vals, b, **kw)
    assert not_proportional(res_t.x) > 1e-3
    assert stats_t == stats_r and stats_t["setup"] == 1
    if method:
        assert np_of(res_t.iterations).tolist() == \
            np.asarray(res_r.iterations).tolist()
        assert_close(res_t.x, res_r.x, rtol=1e-8, atol=1e-10)
        tight = precond in ("amg", "mg")
        _lanes_are_single_solves(A, vals, b, res_t, 1e-12 if tight else 1e-10,
                                 1e-14 if tight else 1e-12, **kw)
    else:
        assert stats_t["factorize"] == 1
        assert_close(res_t.x, res_r.x, rtol=1e-9, atol=1e-11)
        _lanes_are_single_solves(A, vals, b, res_t, 1e-12, 1e-14, **kw)


@pytest.mark.parametrize("fused", ["off", "on"])
def test_batched_chebyshev_fused_step_per_lane_scalars(fused):
    """The lane Chebyshev on block-ELL with and without the fused step: the
    per-lane recurrence scalars give each lane its single solve."""
    A = tpoisson.poisson2d(12, device=CPU)
    b = torch.ones(A.shape[0], dtype=torch.float64)
    vals = torch.tensor(_stack(np_of(A.val), (1.0, 1e2, 0.3)))
    kw = dict(backend="pallas", method="cg", precond="chebyshev", tol=1e-11)
    with tsla.options(fused_step=fused):
        res = tsla.solve_with_info(A.with_values(vals), b, **kw)
        _lanes_are_single_solves(A, np_of(vals), np_of(b), res, 1e-10,
                                 1e-12, **kw)


@pytest.mark.parametrize("precond", ["mg", "amg", "chebyshev", "ilu"])
def test_lane_states_slice_for_lane_by_lane_methods(precond):
    """GMRES on stacked values solves lane by lane on slices of the ONE
    lane-stacked setup (``PreconditionerPlan.lane_state``): one setup, each
    lane its single solve."""
    A = tpoisson.poisson2d_vc(torch.ones(16, 16, dtype=torch.float64),
                              use_stencil_kernel=True, device=CPU) \
        if precond == "mg" else tpoisson.poisson2d(10, device=CPU)
    kw = dict(backend="jnp", method="gmres", precond=precond, tol=1e-11)
    b = torch.ones(A.shape[0], dtype=torch.float64)
    vals = torch.tensor(_stack(np_of(A.val)))
    tdisp.reset_plan_stats()
    X = A.with_values(vals).solve(b, **kw)
    assert tdisp.PLAN_STATS["setup"] == 1
    for lane in range(3):
        one = A.with_values(vals[lane]).solve(b, **kw)
        assert_close(X[lane], one, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("precond", ["mg", "amg", "ilu"])
def test_one_lane_state_takes_k_rows_at_once(precond):
    """A one-lane state's apply on (k, n) rows treats them as k right-hand
    sides of its one matrix, all in one V-cycle (one factored solve for
    ILU): each row equals the apply on that row alone."""
    from repro_torch.core.precond import PreconditionerPlan
    rng = np.random.default_rng(5)
    A = tpoisson.poisson2d_vc(torch.tensor(1.0 + rng.random((32, 32))),
                              use_stencil_kernel=True, device=CPU) \
        if precond == "mg" else tpoisson.poisson2d(10, device=CPU)
    pre = PreconditionerPlan(precond, A.row, A.col, A.shape,
                             stencil=A.stencil)
    M = pre.make_apply(pre.refresh_state(A, None), None)
    R = torch.tensor(rng.normal(size=(3, A.shape[0])))
    Z = M(R)
    assert tuple(Z.shape) == tuple(R.shape)
    for row in range(3):
        assert_close(Z[row], M(R[row]), rtol=1e-13, atol=1e-15)


# ---------------------------------------------------------------------------
# the solve server on the new routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["direct", "amg"])
def test_solve_server_direct_and_amg_groups_set_up_once(route):
    """Per-request options reach ``plan.solve``: a stream of requests with
    ``backend="direct"`` or ``precond="amg"`` on two patterns is served as
    one dispatch per pattern group, each with ONE factorization / Galerkin
    product, and each request gets its single solve."""
    from repro_torch.launch.solve_serve import SolveRequest, SolveServer, serve
    opts = {"direct": {"backend": "direct", "method": "ldlt"},
            "amg": {"backend": "jnp", "method": "cg", "precond": "amg",
                    "tol": 1e-11}}[route]
    counter = "factorize" if route == "direct" else "galerkin"
    rng = np.random.default_rng(0)
    bases = [tpoisson.poisson2d(9, device=CPU),
             tpoisson.poisson2d(10, device=CPU)]
    reqs = []
    for i in range(7):
        A0 = bases[i % 2]
        reqs.append(SolveRequest(A0.with_values(A0.val * rng.uniform(0.7, 1.4)),
                                 torch.tensor(rng.normal(size=A0.shape[0])),
                                 dict(opts)))
    server = SolveServer(max_batch=8)
    tdisp.reset_plan_stats()
    out = server.submit_batch(reqs)
    assert server.stats["dispatches"] == 2
    assert tdisp.PLAN_STATS[counter] == 2
    assert tdisp.PLAN_STATS["setup"] == 2
    for res, req in zip(out, reqs):
        assert res.reason == "converged"
        one = req.A.solve(req.b, **opts)
        assert_close(res.x, one, rtol=1e-12, atol=1e-14)
        want = torch.linalg.solve(req.A.todense(), req.b)
        assert_close(res.x, want, rtol=1e-9, atol=1e-11)
    # the serving workload end to end on the route (parity checked inside)
    n_req, mb = 8, 4
    rep = serve(n_requests=n_req, grid=6, n_patterns=1, max_batch=mb,
                check=True, device=CPU, **opts)
    assert rep["converged"] and rep["occupancy"] == 1.0
    # the warm-up wave, the timed waves (one setup per batched dispatch)
    # and one per request of the one-at-a-time loop, whose first request's
    # setup is the memoized one of its warm-up solve
    assert rep["plan_stats"][counter] == 1 + n_req // mb + n_req
