"""PyTorch port vs the JAX reference, end to end: ``sla.solve`` and its
gradient through the plan engine (jnp / pallas / stencil / dense backends),
PLAN_STATS parity, kernel-plan decisions, the linear-adjoint cases of
tests/test_adjoint.py, and the O(1)-graph property."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sla as rsla
from repro.core import dispatch as rdisp
from repro.core.sparse import SparseTensor as RTensor
from repro.data import poisson as rpoisson
from repro.kernels.stencil5 import Stencil5Meta as RMeta
from repro_torch import sla as tsla
from repro_torch.core import dispatch as tdisp
from repro_torch.core.convert import kappa_from_array
from repro_torch.data import poisson as tpoisson

from _torch_parity import CPU, assert_close, np_of, port_of


def _kappa(ng, seed=0):
    return 1.0 + 0.5 * np.random.default_rng(seed).random((ng, ng))


def _stencil_ref(ng, symmetric, seed=0):
    """Reference stencil-layout operator; the non-symmetric variant scales
    the N/S couplings unequally (an upwinded drift term)."""
    A = rpoisson.poisson2d_vc(jnp.asarray(_kappa(ng, seed)),
                              use_stencil_kernel=True)
    if symmetric:
        return A
    v5 = np.asarray(A.val).reshape(5, ng, ng).copy()
    v5[1] *= 1.3
    v5[2] *= 0.7
    props = {"symmetric": False, "spd_hint": False, "sorted_rows": False}
    return RTensor(v5.reshape(-1), A.row, A.col, A.shape, props=props,
                   stencil=RMeta(nx=ng, ny=ng), validate=False)


def _coo_ref(ng, symmetric):
    A = rpoisson.poisson2d(ng)
    if symmetric:
        return A
    val = np.asarray(A.val).copy()
    row, col = np.asarray(A.row), np.asarray(A.col)
    val[col == row - 1] = -1.4
    val[col == row + 1] = -0.6
    return RTensor(val, row, col, A.shape)


def _sweep(A_ref, backend, method, fused):
    """solve + backward for two values arrays, then a tolerance sweep on the
    second — in both packages; returns PLAN_STATS and the gradients."""
    n = A_ref.shape[0]
    b = np.random.default_rng(7).normal(size=n)
    vals = [np.asarray(A_ref.val), 1.5 * np.asarray(A_ref.val)]
    kw = dict(backend=backend, method=method, tol=1e-11)

    rdisp.reset_plan_stats()
    grads_r = []
    with rsla.options(fused_step=fused):
        for v in vals:
            loss = lambda vv: jnp.sum(A_ref.with_values(vv).solve(
                jnp.asarray(b), **kw) ** 2)
            grads_r.append(np.asarray(jax.grad(loss)(jnp.asarray(v))))
        rsla.solve_with_info(A_ref.with_values(jnp.asarray(vals[1])),
                             jnp.asarray(b), **dict(kw, tol=1e-6))
    stats_r = dict(rdisp.PLAN_STATS)

    A = port_of(A_ref)
    tdisp.reset_plan_stats()
    grads_t = []
    with tsla.options(fused_step=fused):
        for v in vals:
            vt = torch.tensor(v, requires_grad=True)
            (A.with_values(vt).solve(torch.tensor(b), **kw) ** 2).sum().backward()
            grads_t.append(np_of(vt.grad))
        tsla.solve_with_info(A.with_values(torch.tensor(vals[1])),
                             torch.tensor(b), **dict(kw, tol=1e-6))
    stats_t = dict(tdisp.PLAN_STATS)
    return stats_r, stats_t, grads_r, grads_t


@pytest.mark.parametrize("backend,symmetric", [
    ("jnp", True), ("jnp", False), ("pallas", True), ("pallas", False),
    ("stencil", True), ("stencil", False)])
def test_plan_stats_and_gradients_match_reference(backend, symmetric):
    A_ref = _stencil_ref(10, symmetric) if backend == "stencil" \
        else _coo_ref(10, symmetric)
    method = "cg" if symmetric else "bicgstab"
    stats_r, stats_t, g_r, g_t = _sweep(A_ref, backend, method, "off")
    assert stats_t == stats_r
    assert stats_t["analyze"] == (2 if backend == "jnp" and not symmetric
                                  else 1)
    for a, b in zip(g_t, g_r):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("backend,method", [("stencil", "cg"),
                                            ("pallas", "bicgstab")])
def test_fused_solve_matches_reference_fused(backend, method):
    """fused_step="on" forced on both sides: same solution and gradient."""
    symmetric = method == "cg"
    A_ref = _stencil_ref(8, symmetric) if backend == "stencil" \
        else _coo_ref(8, symmetric)
    stats_r, stats_t, g_r, g_t = _sweep(A_ref, backend, method, "on")
    assert stats_t == stats_r
    for a, b in zip(g_t, g_r):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("backend", ["stencil", "jnp"])
def test_kappa_gradient_matches_reference(backend):
    """The slice end to end: ∂Σu²/∂κ through poisson2d_vc and the solve."""
    ng = 16
    kappa = _kappa(ng, 3)
    f = np.ones(ng * ng)
    stencil = backend == "stencil"

    def loss_r(k):
        A = rpoisson.poisson2d_vc(k, use_stencil_kernel=stencil)
        return jnp.sum(A.solve(jnp.asarray(f), backend=backend, method="cg",
                               tol=1e-12) ** 2)

    with rsla.options(fused_step="on"):
        g_r = jax.grad(loss_r)(jnp.asarray(kappa))
    kt = kappa_from_array(kappa, device=CPU, requires_grad=True)
    with tsla.options(fused_step="on"):
        A = tpoisson.poisson2d_vc(kt, use_stencil_kernel=stencil, device=CPU)
        u = tsla.solve(A, torch.tensor(f), backend=backend, method="cg",
                       tol=1e-12)
        (u ** 2).sum().backward()
    assert_close(kt.grad, g_r, rtol=1e-6, atol=1e-10)


def test_kernel_plan_and_fuse_decisions_match_reference():
    A_ref = rpoisson.poisson2d(9)
    A = port_of(A_ref)
    rdisp.reset_plan_stats()
    tdisp.reset_plan_stats()
    for backend in ("jnp", "pallas"):
        kr = A_ref.plan(backend=backend, method="cg").artifacts["kernel"]
        kt = A.plan(backend=backend, method="cg").artifacts["kernel"]
        assert (kt.choice, kt.reason, kt.interpret) == \
            (kr.choice, kr.reason, kr.interpret)
        for mode in ("auto", "on", "off"):
            with rsla.options(fused_step=mode), tsla.options(fused_step=mode):
                assert tdisp._fuse_enabled(kt) == rdisp._fuse_enabled(kr)
    assert tdisp.PLAN_STATS == rdisp.PLAN_STATS
    Ak_ref = _stencil_ref(6, True)
    kr = Ak_ref.plan().artifacts["kernel"]
    kt = port_of(Ak_ref).plan().artifacts["kernel"]
    assert (kt.choice, kt.reason) == (kr.choice, kr.reason) == \
        ("stencil", "stencil layout present")


def test_backend_selection_matches_reference():
    for A_ref in (rpoisson.poisson2d(8), _stencil_ref(6, True),
                  _coo_ref(9, False)):
        r = rdisp.select_backend(A_ref, "auto", "auto")
        t = tdisp.select_backend(port_of(A_ref), "auto", "auto")
        assert t == r
    big = rpoisson.poisson2d(70)               # 4900 > dense_budget
    assert rdisp.select_backend(big, "auto", "auto") == ("direct", "ldlt")
    A = port_of(big)
    assert tdisp.select_backend(A, "auto", "auto") == ("direct", "ldlt")
    b = np.random.default_rng(2).normal(size=4900)
    x = A.solve(torch.tensor(b))               # auto → direct, and it solves
    x_ref = big.solve(jnp.asarray(b))
    assert_close(x, x_ref, rtol=1e-10, atol=1e-12)
    assert A.plan().cfg.backend == "direct"


@pytest.mark.parametrize("method", ["cholesky", "lu"])
def test_dense_backend_solve_and_gradient_match_reference(method):
    A_ref = rpoisson.poisson2d(6)
    b = np.random.default_rng(1).normal(size=36)
    g_r = jax.grad(lambda v: jnp.sum(A_ref.with_values(v).solve(
        jnp.asarray(b), backend="dense", method=method) ** 3))(A_ref.val)
    vt = torch.tensor(np.asarray(A_ref.val), requires_grad=True)
    A = port_of(A_ref)
    (A.with_values(vt).solve(torch.tensor(b), backend="dense",
                             method=method) ** 3).sum().backward()
    assert_close(vt.grad, g_r, rtol=1e-9, atol=1e-12)


def test_solve_with_info_matches_reference():
    A_ref = rpoisson.poisson2d(12)
    b = np.ones(144)
    r = rsla.solve_with_info(A_ref, jnp.asarray(b), backend="jnp",
                             method="cg", tol=1e-10)
    t = tsla.solve_with_info(port_of(A_ref), torch.tensor(b), backend="jnp",
                             method="cg", tol=1e-10)
    assert t.reason == r.reason == "converged"
    assert int(t.iterations) == int(r.iterations)
    assert_close(t.x, r.x, rtol=1e-10)
    r = rsla.solve_with_info(A_ref, jnp.asarray(b), backend="jnp",
                             method="cg", tol=1e-14, maxiter=3)
    t = tsla.solve_with_info(port_of(A_ref), torch.tensor(b), backend="jnp",
                             method="cg", tol=1e-14, maxiter=3)
    assert t.reason == r.reason == "maxiter" and int(t.iterations) == 3


def test_later_slices_raise_with_their_slice():
    A = tpoisson.poisson2d(5, device=CPU)
    b = torch.ones(25, dtype=torch.float64)
    x_ref = torch.linalg.solve(A.todense(), b)
    # slice 5: multi-rhs, batched values and block_cg are ported
    X = A.solve(torch.ones(2, 25, dtype=torch.float64), backend="jnp",
                tol=1e-12)
    assert_close(X, torch.stack([x_ref, x_ref]), rtol=1e-10, atol=1e-11)
    X = A.with_values(torch.stack([A.val, A.val])).solve(b, backend="jnp",
                                                          tol=1e-12)
    assert_close(X, torch.stack([x_ref, x_ref]), rtol=1e-10, atol=1e-11)
    x = A.solve(b, backend="jnp", method="block_cg", tol=1e-12)
    assert_close(x, x_ref, rtol=1e-10, atol=1e-11)
    # slice 5b: batched values through the direct route are ported
    X = A.with_values(torch.stack([A.val, 2.0 * A.val])).solve(
        b, backend="direct")
    assert_close(X, torch.stack([x_ref, x_ref / 2.0]), rtol=1e-12,
                 atol=1e-13)
    x = A.solve(b, backend="direct")           # slice 2: ported
    assert_close(x, x_ref, rtol=1e-12, atol=1e-13)
    x = A.solve(b, backend="jnp", method="gmres", tol=1e-12)  # ported
    assert_close(x, x_ref, rtol=1e-10, atol=1e-11)
    with pytest.raises(ValueError):
        A.solve(b, backend="nope")


def test_setup_memo_keys_on_identity_and_version():
    A = tpoisson.poisson2d(6, device=CPU)
    b = torch.ones(36, dtype=torch.float64)
    tdisp.reset_plan_stats()
    v = A.val.clone()
    B = A.with_values(v)
    B.solve(b, backend="jnp", method="cg")
    B.solve(b, backend="jnp", method="cg", tol=1e-9)
    assert tdisp.PLAN_STATS["setup"] == 1
    assert tdisp.PLAN_STATS["setup_reuse"] == 1
    v.mul_(2.0)                          # in place: a new setup, new answer
    x2 = B.solve(b, backend="jnp", method="cg", tol=1e-10)
    assert tdisp.PLAN_STATS["setup"] == 2
    x_ref = torch.linalg.solve(B.todense(), b)
    assert_close(x2, x_ref, rtol=1e-8)


# ---------------------------------------------------------------------------
# the linear-adjoint cases of tests/test_adjoint.py, on the port
# ---------------------------------------------------------------------------

def _loss(A, maxiter=4000, tol=1e-13):
    def loss(val, b):
        x = A.with_values(val).solve(b, backend="jnp", method="cg", tol=tol,
                                     maxiter=maxiter)
        return torch.sum(x ** 2)
    return loss


def test_linear_adjoint_matches_dense_autodiff():
    A = tpoisson.poisson2d(8, device=CPU)
    b0 = torch.tensor(np.random.default_rng(0).normal(size=64))
    v = A.val.clone().requires_grad_(True)
    b = b0.clone().requires_grad_(True)
    _loss(A)(v, b).backward()
    vd = A.val.clone().requires_grad_(True)
    bd = b0.clone().requires_grad_(True)
    xd = torch.linalg.solve(A.with_values(vd).todense(), bd)
    (xd ** 2).sum().backward()
    assert_close(v.grad, vd.grad, rtol=1e-6, atol=1e-8)
    assert_close(b.grad, bd.grad, rtol=1e-6, atol=1e-8)


def test_linear_adjoint_vs_finite_differences():
    A = tpoisson.poisson2d(8, device=CPU)
    b = torch.ones(64, dtype=torch.float64)
    loss = _loss(A)
    v = A.val.clone().requires_grad_(True)
    loss(v, b).backward()
    eps = 1e-6
    for e in np.random.default_rng(1).choice(A.nnz, 5, replace=False):
        vp, vm = A.val.clone(), A.val.clone()
        vp[e] += eps
        vm[e] -= eps
        with torch.no_grad():
            fd = (loss(vp, b) - loss(vm, b)) / (2 * eps)
        assert abs(float(v.grad[e]) - float(fd)) / max(abs(float(fd)), 1e-9) \
            < 1e-4


def test_kernel_backend_adjoint():
    """Gradients flow through the stencil-kernel solve path identically."""
    ng = 12
    f = torch.ones(ng * ng, dtype=torch.float64)
    grads = []
    for use_kernel in (True, False):
        kappa = torch.full((ng, ng), 1.3, dtype=torch.float64,
                           requires_grad=True)
        A = tpoisson.poisson2d_vc(kappa, use_stencil_kernel=use_kernel,
                                  device=CPU)
        x = A.solve(f, backend="stencil" if use_kernel else "jnp",
                    method="cg", tol=1e-12)
        (x ** 2).sum().backward()
        grads.append(kappa.grad)
    assert_close(grads[0], grads[1], rtol=1e-6, atol=1e-8)


def _graph_nodes(t):
    seen, stack = set(), [t.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        stack.extend(nxt for nxt, _ in fn.next_functions)
    return seen


def test_o1_graph_independent_of_iterations():
    """The solve adds exactly ONE autograd node, whatever maxiter is."""
    A = tpoisson.poisson2d(8, device=CPU)
    b = torch.ones(64, dtype=torch.float64)
    counts = []
    for maxiter in (10, 1000):
        v = A.val.clone().requires_grad_(True)
        x = A.with_values(v).solve(b, backend="jnp", method="cg",
                                   maxiter=maxiter, tol=1e-13)
        nodes = _graph_nodes(x)
        assert type(x.grad_fn).__name__ == "_SparseSolveBackward"
        counts.append(len(nodes))
    assert counts[0] == counts[1] == 2      # the solve + v's AccumulateGrad
