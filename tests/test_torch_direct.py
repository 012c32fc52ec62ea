"""PyTorch port vs the JAX reference: the sparse-direct route.

Same numpy inputs through both packages (x64), on the CPU, where the port's
panel kernels run their plain versions:

- the symbolic artifacts array-equal for every ordering, ``incomplete``,
  ``supernodal`` off/on and ``pivot_blocks="auto"`` (the port leaves the
  scalar program out where the supernodal one runs; its counts still agree);
- the factor vector C (to 1e-12 of its scale), forward and transposed
  solves, multi-RHS solves and ``factor_slogdet``;
- ``DirectBackend`` solves and values-gradients, PLAN_STATS over a
  solve + backward + ``with_values`` sweep, symmetric and not;
- the zero-pivot guard's warning and clamp count;
- ILU(0)-preconditioned CG (iterations within one) and its gradient;
- ``SparseTensor.slogdet`` and its chunked gradient;
- the exact LU κ-gradient of the non-symmetric drift operator.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dispatch as rdisp
from repro.core import direct as rd
from repro.core.sparse import SparseTensor as RTensor
from repro.data import poisson as rpoisson
from repro_torch import sla as tsla
from repro_torch.core import adjoint as tadj
from repro_torch.core import direct as td
from repro_torch.core import dispatch as tdisp
from repro_torch.data import poisson as tpoisson

from _torch_parity import CPU, assert_close, np_of, port_of

ORDERINGS = [dict(), dict(supernodal="off"), dict(supernodal="on"),
             dict(ordering="md"), dict(ordering="rcm"),
             dict(ordering="natural"), dict(incomplete=True)]


def _random_pattern(n=200, per_row=4, seed=7):
    """Unsymmetric random pattern with a dominant full diagonal."""
    rng = np.random.default_rng(seed)
    row = np.concatenate([np.repeat(np.arange(n), per_row), np.arange(n)])
    col = np.concatenate([rng.integers(0, n, n * per_row), np.arange(n)])
    val = rng.standard_normal(row.size)
    val[-n:] = 4.0 * per_row
    return row, col, val, n


def _saddle(m, k, seed=1):
    """Indefinite KKT matrix [[H, Bᵀ], [B, 0]], zero block kept."""
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((m, m))
    H = H @ H.T + m * np.eye(m)
    B = rng.standard_normal((k, m))
    A = np.block([[H, B.T], [B, np.zeros((k, k))]])
    n = m + k
    row, col = np.nonzero((np.abs(A) > 1e-12) | np.eye(n, dtype=bool))
    return row, col, A[row, col], A, n


def _poisson(ng=16):
    A = rpoisson.poisson2d(ng)
    return (np.asarray(A.row), np.asarray(A.col), np.asarray(A.val),
            A.shape[0])


def _case(name):
    if name == "poisson2d":
        return _poisson() + ({},)
    if name == "random":
        return _random_pattern() + ({},)
    row, col, val, _, n = _saddle(18, 8)
    return row, col, val, n, {"pivot_blocks": "auto"}


def _assert_same_artifacts(ra, ta):
    assert (ta.n, ta.nnzF) == (ra.n, ra.nnzF)
    assert ta.stats == ra.stats
    for f in ("perm", "ipos", "a2f"):
        np.testing.assert_array_equal(getattr(ta, f), np.asarray(getattr(ra, f)))
    if ta.snode is None:
        assert ra.snode is None
        for prog in ("factor", "row_sweep", "col_sweep"):
            for x, y in zip(getattr(ta, prog), getattr(ra, prog)):
                np.testing.assert_array_equal(x, np.asarray(y))
        return
    assert ta.factor is ta.row_sweep is ta.col_sweep is None
    assert len(ta.snode.schedule) == len(ra.snode.schedule)
    for lt, lr in zip(ta.snode.schedule, ra.snode.schedule):
        assert len(lt) == len(lr)
        for bt, br in zip(lt, lr):
            assert (bt.wb, bt.rb, bt.pairs) == (br.wb, br.rb, br.pairs)
            for f in ("pidx", "qidx", "uidx", "rows", "wvec", "rvec", "bkm"):
                np.testing.assert_array_equal(getattr(bt, f),
                                              np.asarray(getattr(br, f)))
    for f in ("pair_cols", "pair_off", "unpaired"):
        np.testing.assert_array_equal(getattr(ta.snode, f),
                                      np.asarray(getattr(ra.snode, f)))


@pytest.mark.parametrize("opts", ORDERINGS, ids=lambda o: str(o) or "amd")
@pytest.mark.parametrize("case", ["poisson2d", "random", "saddle"])
def test_symbolic_artifacts_match_reference(case, opts):
    row, col, val, n, kw = _case(case)
    if kw and (opts.get("incomplete") or opts.get("supernodal") == "off"):
        with pytest.raises(ValueError, match="pivot_blocks"):
            td.symbolic_factor(row, col, n, **kw, **opts)
        return
    ra = rd.symbolic_factor(row, col, n, **kw, **opts)
    ta = td.symbolic_factor(row, col, n, **kw, **opts)
    _assert_same_artifacts(ra, ta)


def test_scalar_program_only_where_it_runs():
    row, col, val, n = _poisson(24)
    on = td.symbolic_factor(row, col, n, supernodal="on")
    off = td.symbolic_factor(row, col, n, supernodal="off")
    ilu = td.symbolic_factor(row, col, n, incomplete=True)
    assert on.snode is not None and on.factor is None
    assert on.row_sweep is None and on.col_sweep is None
    assert off.snode is None and off.factor is not None
    assert ilu.snode is None and ilu.factor is not None
    # the step and update counts of the program left out still agree
    assert on.stats["n_steps"] == off.stats["n_steps"]
    assert on.stats["flops"] == off.stats["flops"]


@pytest.mark.parametrize("opts", [dict(), dict(supernodal="off"),
                                  dict(incomplete=True)],
                         ids=["auto", "scalar", "ilu0"])
@pytest.mark.parametrize("case", ["poisson2d", "random", "saddle"])
def test_factor_solves_and_slogdet_match_reference(case, opts):
    row, col, val, n, kw = _case(case)
    if kw and opts:
        return                      # pairs need the supernodal program
    ra = rd.symbolic_factor(row, col, n, **kw, **opts)
    ta = td.to_device(td.symbolic_factor(row, col, n, **kw, **opts), CPU)
    Cr = np.asarray(rd.numeric_factor(ra, jnp.asarray(val)))
    Ct = td.numeric_factor(ta, torch.tensor(val))
    scale = np.abs(Cr[:-2]).max()
    assert np.abs(np_of(Ct)[:-2] - Cr[:-2]).max() <= 1e-12 * scale
    b = np.random.default_rng(3).standard_normal(n)
    for tr in (False, True):
        xr = np.asarray(rd.factored_solve(ra, jnp.asarray(Cr), jnp.asarray(b),
                                          transposed=tr))
        xt = td.factored_solve(ta, Ct, torch.tensor(b), transposed=tr)
        assert np.abs(np_of(xt) - xr).max() <= 1e-10 * np.abs(xr).max()
        B = np.random.default_rng(4).standard_normal((n, 3))
        X = td.factored_solve(ta, Ct, torch.tensor(B), transposed=tr)
        for j in range(3):
            assert_close(X[:, j], td.factored_solve(
                ta, Ct, torch.tensor(B[:, j]), transposed=tr),
                rtol=1e-13, atol=1e-14)
    if not opts.get("incomplete"):
        sr, lr = rd.factor_slogdet(ra, jnp.asarray(Cr))
        st, lt = td.factor_slogdet(ta, Ct)
        assert float(st) == float(sr)
        assert_close(lt, lr, rtol=1e-12)


def _drift_pattern(ng=24):
    rows, cols, _ = tpoisson.vc_pattern(ng)
    v = (rpoisson.vc_coefficients(np.ones((ng, ng))).reshape(5, -1)
         * np.array([1.0, 1.3, 0.7, 1.0, 1.0])[:, None]).reshape(-1)
    return np.asarray(rows), np.asarray(cols), np.asarray(v), ng * ng


@pytest.mark.parametrize("case", ["poisson2d", "drift"])
def test_live_target_table_matches_reference_uidx(case):
    """to_device's int32 live-only extend-add targets are the reference's
    uidx with its pad entries (all on the scratch sink) dropped, lane by
    lane."""
    row, col, _, n = _poisson(40) if case == "poisson2d" else _drift_pattern()
    ra = rd.symbolic_factor(row, col, n, supernodal="on")
    ta = td.to_device(td.symbolic_factor(row, col, n, supernodal="on"), CPU)
    n_live = 0
    for lr, lt in zip(ra.snode.schedule, ta.snode.schedule):
        for br, bt in zip(lr, lt):
            uidx, r = np.asarray(br.uidx), np.asarray(br.rvec)
            assert bt.uidx.dtype == torch.int32 and bt.pidx.dtype == torch.int32
            off = np_of(bt.uoff)
            assert off[0] == 0 and off[-1] == bt.uidx.numel()
            for l, rl in enumerate(r):
                np.testing.assert_array_equal(
                    np_of(bt.uidx[off[l]:off[l + 1]]),
                    uidx[l, :rl, :rl].reshape(-1))
                pads = np.ones(uidx.shape[1:], bool)
                pads[:rl, :rl] = False
                assert (uidx[l][pads] == ra.nnzF).all()
            n_live += int((r.astype(np.int64) ** 2).sum())
    assert n_live == sum(bt.uidx.numel() for lt in ta.snode.schedule
                         for bt in lt) > 0


@pytest.mark.parametrize("case", ["poisson2d", "poisson2d-pairs", "saddle",
                                  "drift"])
def test_inplace_factorization_matches_reference_and_spares_the_sink(case):
    """The port's supernodal factorization on the CPU — gather, plain
    factor, scatter, plain Schur, live-only extend-add, in place in C —
    gives the reference's numeric_factor output (f64, 1e-12 of its scale),
    pairs off and on, and never writes the scratch sink."""
    if case == "saddle":
        row, col, val, _, n = _saddle(18, 8)
    elif case == "drift":
        row, col, val, n = _drift_pattern()
    else:
        row, col, val, n = _poisson(24)
    kw = {"supernodal": "on"}
    if case in ("poisson2d-pairs", "saddle"):
        kw["pivot_blocks"] = "auto"
    ra = rd.symbolic_factor(row, col, n, **kw)
    ta = td.to_device(td.symbolic_factor(row, col, n, **kw), CPU)
    assert any(bk.pairs for lvl in ta.snode.schedule for bk in lvl) \
        == ("pivot_blocks" in kw)
    Cr = np.asarray(rd.numeric_factor(ra, jnp.asarray(val)))
    v = torch.tensor(val)
    C = torch.zeros(ta.nnzF + 2, dtype=torch.float64)
    C.index_add_(0, ta.a2f, v)
    C[ta.nnzF + 1] = 1.0
    C[ta.nnzF] = 7.25                       # sentinel in the scratch sink
    C, nbad = td._snode_numeric(ta, C, td._pivot_tau(v, None), True)
    assert float(C[ta.nnzF]) == 7.25
    assert float(nbad) == 0.0
    scale = np.abs(Cr[:-2]).max()
    assert np.abs(np_of(C)[:-2] - Cr[:-2]).max() <= 1e-12 * scale


def test_indefinite_pairs_solve_without_perturbation():
    row, col, val, A, n = _saddle(18, 8)
    b = np.random.default_rng(2).standard_normal(n)
    ta = td.to_device(td.symbolic_factor(row, col, n, pivot_blocks="auto"),
                      CPU)
    assert ta.snode.stats["n_pair_pivots"] > 0
    with warnings.catch_warnings():
        warnings.simplefilter("error")       # any perturbation warning fails
        C = td.numeric_factor(ta, torch.tensor(val))
    x = td.factored_solve(ta, C, torch.tensor(b))
    xt = td.factored_solve(ta, C, torch.tensor(b), transposed=True)
    assert_close(x, np.linalg.solve(A, b), rtol=1e-8, atol=1e-8)
    assert_close(xt, np.linalg.solve(A.T, b), rtol=1e-8, atol=1e-8)
    s, logabs = td.factor_slogdet(ta, C)
    sd, ld = np.linalg.slogdet(A)
    assert float(s) == sd
    assert_close(logabs, ld, rtol=1e-10)


def _convection(n=56, c=0.3):
    """1-D convection–diffusion: symmetric pattern, non-symmetric values."""
    A1 = rpoisson.poisson1d(n)
    val = np.asarray(A1.val).copy()
    r, cc = np.asarray(A1.row), np.asarray(A1.col)
    val[cc == r - 1] = -1.0 - c
    val[cc == r + 1] = -1.0 + c
    return RTensor(val, A1.row, A1.col, (n, n))


@pytest.mark.parametrize("sym", [True, False], ids=["ldlt", "lu"])
def test_direct_backend_solve_grad_and_plan_stats_match_reference(sym):
    A_ref = rpoisson.poisson2d(10) if sym else _convection()
    A = port_of(A_ref)
    n = A.shape[0]
    b = np.random.default_rng(5).standard_normal(n)

    def loss_ref(v):
        acc = 0.0
        for tol in (1e-4, 1e-8, 1e-12):
            x = A_ref.with_values(v).solve(jnp.asarray(b), backend="direct",
                                           tol=tol)
            acc = acc + jnp.sum(x ** 2)
        return acc

    rdisp.reset_plan_stats()
    g_ref = jax.grad(loss_ref)(A_ref.val)
    rdisp.solve_impl(rdisp.make_config(A_ref.with_values(1.5 * A_ref.val),
                                       backend="direct"),
                     A_ref.with_values(1.5 * A_ref.val), jnp.asarray(b))
    tdisp.reset_plan_stats()
    v = A.val.clone().requires_grad_(True)
    acc = 0.0
    for tol in (1e-4, 1e-8, 1e-12):
        x = A.with_values(v).solve(torch.tensor(b), backend="direct", tol=tol)
        acc = acc + (x ** 2).sum()
    acc.backward()
    B = A.with_values(1.5 * A.val)
    x2, info = tdisp.solve_impl(tdisp.make_config(B, backend="direct"), B,
                                torch.tensor(b))
    assert tdisp.PLAN_STATS == rdisp.PLAN_STATS
    assert tdisp.PLAN_STATS["analyze"] == 1
    assert tdisp.PLAN_STATS["factorize"] == 2
    assert tdisp.PLAN_STATS["transpose_shared"] == 1
    assert_close(v.grad, g_ref, rtol=1e-9, atol=1e-12)
    assert bool(info.converged) and int(info.iters) == 1
    assert_close(x2, np.linalg.solve(1.5 * np.asarray(A_ref.todense()), b),
                 rtol=1e-10, atol=1e-12)
    plan = A.plan(backend="direct")
    assert plan.cfg.method == ("ldlt" if sym else "lu")
    assert plan.nbytes() > 0


def test_adjoint_gradient_of_pair_factors_matches_dense():
    """The reference differentiates through its pair factorization; the port
    gets the same gradient from the adjoint on the forward factors."""
    row, col, val, A, n = _saddle(12, 5, seed=9)
    b = np.random.default_rng(3).standard_normal(n)
    T = tsla.SparseTensor(val, row, col, (n, n),
                          props={"indefinite_hint": True}, device=CPU)
    v = torch.tensor(val, requires_grad=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        (T.with_values(v).solve(torch.tensor(b), backend="direct",
                                method="lu") ** 2).sum().backward()
    vd = torch.tensor(val, requires_grad=True)
    Ad = torch.zeros(n, n, dtype=torch.float64).index_put(
        (torch.tensor(row), torch.tensor(col)), vd, accumulate=True)
    (torch.linalg.solve(Ad, torch.tensor(b)) ** 2).sum().backward()
    assert_close(v.grad, vd.grad, rtol=1e-6, atol=1e-8)
    assert T.plan(backend="direct", method="lu").artifacts[
        "direct"].snode.stats["n_pair_pivots"] > 0


def test_convert_carries_routing_hints():
    big = rpoisson.poisson2d(320)              # n > direct_budget
    big.props["illcond_hint"] = True
    assert rdisp.select_backend(big, "auto", "auto") == ("direct", "ldlt")
    assert tdisp.select_backend(port_of(big), "auto", "auto") == \
        ("direct", "ldlt")
    row, col, val, A, n = _saddle(6, 3)
    R = RTensor(val, row, col, (n, n), props={"indefinite_hint": True})
    T = port_of(R)
    assert T.props == {"indefinite_hint": True}
    assert T.plan(backend="direct", method="lu").artifacts[
        "direct"].snode.stats["n_pair_pivots"] > 0


def test_pivot_guard_warning_and_clamp_count_match_reference():
    Z = (np.array([0.0, 1.0, 1.0, 0.0]), np.array([0, 0, 1, 1]),
         np.array([0, 1, 0, 1]))
    ra = rd.symbolic_factor(Z[1], Z[2], 2)
    ta = td.to_device(td.symbolic_factor(Z[1], Z[2], 2), CPU)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        Cr = rd.numeric_factor(ra, jnp.asarray(Z[0]))
        Ct = td.numeric_factor(ta, torch.tensor(Z[0]))
    msgs = [str(w.message) for w in rec if "pivot" in str(w.message)]
    assert len(msgs) == 2 and msgs[0] == msgs[1]
    assert_close(Ct[:-2], np.asarray(Cr)[:-2], rtol=1e-15, atol=0)
    x = td.factored_solve(ta, Ct, torch.tensor([1.0, 2.0], dtype=torch.float64))
    assert_close(x, [2.0, 1.0], rtol=1e-6)
    C_bad = td.numeric_factor(ta, torch.tensor(Z[0]), pivot_guard=False)
    assert not bool(torch.isfinite(td.factored_solve(
        ta, C_bad, torch.tensor([1.0, 2.0], dtype=torch.float64))).all())
    # supernodal path: a saddle without pairs clamps the same pivots
    row, col, val, A, n = _saddle(18, 8)
    ra = rd.symbolic_factor(row, col, n, supernodal="on")
    ta = td.to_device(td.symbolic_factor(row, col, n, supernodal="on"), CPU)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        rd.numeric_factor(ra, jnp.asarray(val))
        td.numeric_factor(ta, torch.tensor(val))
    msgs = [str(w.message) for w in rec if "pivot" in str(w.message)]
    assert len(msgs) == 2 and msgs[0] == msgs[1], msgs


def test_ilu_preconditioned_cg_matches_reference():
    A_ref = rpoisson.poisson2d(24)
    A = port_of(A_ref)
    b = np.ones(A.shape[0])
    it = {}
    for pre in ("jacobi", "ilu"):
        r = rdisp.solve_impl(rdisp.make_config(A_ref, backend="jnp",
                                               method="cg", tol=1e-10,
                                               precond=pre),
                             A_ref, jnp.asarray(b))
        t = tdisp.solve_impl(tdisp.make_config(A, backend="jnp", method="cg",
                                               tol=1e-10, precond=pre),
                             A, torch.tensor(b))
        assert abs(int(t[1].iters) - int(r[1].iters)) <= 1
        assert_close(t[0], r[0], rtol=1e-8, atol=1e-10)
        it[pre] = int(t[1].iters)
    assert it["ilu"] < it["jacobi"]
    # the ILU-preconditioned solve's gradient against the dense one
    A10 = tpoisson.poisson2d(10, device=CPU)
    b10 = torch.ones(100, dtype=torch.float64)
    v = A10.val.clone().requires_grad_(True)
    (A10.with_values(v).solve(b10, backend="jnp", method="cg", tol=1e-13,
                              precond="ilu") ** 2).sum().backward()
    vd = A10.val.clone().requires_grad_(True)
    (torch.linalg.solve(A10.with_values(vd).todense(), b10) ** 2).sum() \
        .backward()
    assert_close(v.grad, vd.grad, rtol=1e-6, atol=1e-8)


def test_ilu_is_exact_on_a_tridiagonal():
    A = tpoisson.poisson1d(32, device=CPU)
    b = torch.tensor(np.random.default_rng(7).normal(size=32))
    plan = A.plan(backend="jnp", method="cg", tol=1e-12, precond="ilu")
    pre = plan.artifacts["precond"]
    M = pre.make_apply(pre.refresh_state(A, None), None)
    assert_close(M(b), torch.linalg.solve(A.todense(), b), rtol=1e-10,
                 atol=1e-10)


@pytest.mark.parametrize("case", ["poisson2d", "convection", "saddle"])
def test_slogdet_and_chunked_gradient_match_reference(case, monkeypatch):
    if case == "poisson2d":
        A_ref = rpoisson.poisson2d(9)
    elif case == "convection":
        A_ref = _convection(40)
    else:
        row, col, val, _, n = _saddle(14, 6, seed=5)
        A_ref = RTensor(val, row, col, (n, n),
                        props={"indefinite_hint": True})
    A = port_of(A_ref)
    monkeypatch.setattr(tadj, "SLOGDET_CHUNK", 7)   # many column chunks
    tdisp.reset_plan_stats()
    v = A.val.clone().requires_grad_(True)
    s, logabs = A.with_values(v).slogdet()
    logabs.backward()
    sr, lr = A_ref.slogdet()
    g_ref = jax.grad(lambda vv: A_ref.with_values(vv).slogdet()[1])(
        A_ref.val)
    assert float(s) == float(sr)
    # static pair pivots grow the saddle's factors (no pivot search): both
    # packages lose digits there, so the reference's own tolerances of its
    # pair tests apply (slogdet 1e-10, gradient 1e-6)
    saddle = case == "saddle"
    assert_close(logabs, lr, rtol=1e-10 if saddle else 1e-12)
    assert_close(v.grad, g_ref, rtol=1e-6 if saddle else 1e-9,
                 atol=1e-8 if saddle else 1e-12)
    assert tdisp.PLAN_STATS["factorize"] == 1
    assert tdisp.PLAN_STATS["analyze"] == 1


def test_slogdet_shares_factors_and_falls_back_dense_for_batches():
    A = tpoisson.poisson2d(8, device=CPU)
    tdisp.reset_plan_stats()
    A.solve(torch.ones(64, dtype=torch.float64), backend="direct")
    A.slogdet()
    assert tdisp.PLAN_STATS["factorize"] == 1
    assert tdisp.PLAN_STATS["analyze"] == 1
    V = torch.stack([A.val, 2.0 * A.val]).requires_grad_(True)
    s, logabs = A.with_values(V).slogdet()
    logabs.sum().backward()
    for i, sc in enumerate((1.0, 2.0)):
        sd, ld = np.linalg.slogdet(sc * np_of(A.todense()))
        assert float(s[i]) == sd
        assert_close(logabs[i], ld, rtol=1e-10)
    dense = A.todense()
    gd = torch.linalg.inv(dense).T[A.row, A.col]
    assert_close(V.grad[0], gd, rtol=1e-10, atol=1e-12)
    assert_close(V.grad[1], gd / 2.0, rtol=1e-10, atol=1e-12)


def test_drift_kappa_gradient_exact_by_lu():
    """The κ-gradient of the non-symmetric drift operator, by direct LU, is
    the reference's to 1e-12 and the dense answer's to 1e-10 — the exact
    yardstick the BiCGStab gradients of that operator are held against."""
    ng = 12
    rng = np.random.default_rng(0)
    kap = np.exp(0.3 * rng.normal(size=(ng, ng)))
    drift = np.array([1.0, 1.3, 0.7, 1.0, 1.0]).reshape(5, 1)
    rows, cols, _ = tpoisson.vc_pattern(ng)
    n = ng * ng
    props = {"symmetric": False, "spd_hint": False, "sorted_rows": False}
    f = np.ones(n)

    def loss_ref(k):
        v = (rpoisson.vc_coefficients(k).reshape(5, -1) * drift).reshape(-1)
        A = RTensor(v, rows, cols, (n, n), props=props, validate=False)
        return jnp.sum(A.solve(jnp.asarray(f), backend="direct") ** 2)

    g_ref = np.asarray(jax.grad(loss_ref)(jnp.asarray(kap)))
    grads = {}
    for backend in ("direct", "dense"):
        k = torch.tensor(kap, requires_grad=True)
        v = (tpoisson.vc_coefficients(k).reshape(5, -1)
             * torch.tensor(drift)).reshape(-1)
        A = tsla.SparseTensor(v, rows, cols, (n, n), props=props,
                              validate=False, device=CPU)
        (A.solve(torch.tensor(f), backend=backend) ** 2).sum().backward()
        grads[backend] = np_of(k.grad)
    assert_close(grads["direct"], g_ref, rtol=1e-12, atol=1e-14)
    assert_close(grads["direct"], grads["dense"], rtol=1e-10, atol=1e-13)


def test_sparse_saddle_perturbs_like_the_reference():
    """Static pairs do not cover a SPARSE saddle point: both packages clamp
    the same pivots (same warning) and solve a nearby matrix."""
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
    b = rng.standard_normal(n)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        ra = rd.symbolic_factor(row, col, n, pivot_blocks="auto")
        xr = rd.factored_solve(ra, rd.numeric_factor(ra, jnp.asarray(val)),
                               jnp.asarray(b))
        ta = td.to_device(td.symbolic_factor(row, col, n,
                                             pivot_blocks="auto"), CPU)
        xt = td.factored_solve(ta, td.numeric_factor(ta, torch.tensor(val)),
                               torch.tensor(b))
    msgs = [str(w.message) for w in rec if "pivot" in str(w.message)]
    assert len(msgs) == 2 and msgs[0] == msgs[1], msgs
    Ad = np.zeros((n, n))
    np.add.at(Ad, (row, col), val)
    res_r = np.linalg.norm(Ad @ np.asarray(xr) - b) / np.linalg.norm(b)
    res_t = np.linalg.norm(Ad @ np_of(xt) - b) / np.linalg.norm(b)
    assert res_t < 1e-3 and res_r < 1e-3
    assert res_t > 1e-12 and res_r > 1e-12     # a nearby matrix, not A
