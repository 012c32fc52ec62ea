"""PyTorch port vs the JAX reference: the geometric multigrid preconditioner
(``precond="mg"``) — its level hierarchy, one V-cycle, CG iteration counts
and the gradients through MG-preconditioned solves, on the same numpy κ,
f64, on the CPU (where the smoother's ``stencil5`` calls run the kernel's
plain version).  The cases of ``tests/test_multigrid.py`` and the mg cases
of ``tests/test_plan.py`` are ported with their assertions."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import multigrid as rmg
from repro.core import solvers as rsol
from repro.core.dispatch import make_matvec
from repro.core.sparse import SparseTensor as RTensor
from repro.data import poisson as rpoisson
from repro_torch.core import multigrid as tmg
from repro_torch.core import solvers as tsol
from repro_torch.core.convert import kappa_from_array
from repro_torch.data import poisson as tpoisson
from repro_torch.kernels import stencil5 as tks

from _torch_parity import CPU, assert_close, port_of


def _kappa(ng, amp=0.5):
    """The reference tests' smooth κ = 1 + a·sin(2πx)·sin(2πy)."""
    xs = np.linspace(0, 1, ng)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    return 1.0 + amp * np.sin(2 * np.pi * X) * np.sin(2 * np.pi * Y)


def _both(ng, stencil=False):
    """(κ, reference operator, port operator, port matvec)."""
    kap = _kappa(ng)
    A_ref = rpoisson.poisson2d_vc(jnp.asarray(kap), use_stencil_kernel=stencil)
    A = tpoisson.poisson2d_vc(kappa_from_array(kap, CPU),
                              use_stencil_kernel=stencil, device=CPU)
    return kap, A_ref, A, (lambda v: A @ v)


@pytest.mark.parametrize("ng", [16, 32, 64])
def test_mg_hierarchy_and_vcycle_match_reference(ng):
    kap = _kappa(ng)
    M_r = rmg.MultigridPreconditioner(jnp.asarray(kap))
    M_t = tmg.MultigridPreconditioner(torch.tensor(kap))
    assert M_t.sizes == M_r.sizes
    for lt, lr in zip(M_t.levels, M_r.levels):
        assert_close(lt, lr, rtol=1e-12, atol=1e-12)
    assert_close(M_t.A_coarse, M_r.A_coarse, rtol=1e-12, atol=1e-12)
    r = np.random.default_rng(ng).normal(size=ng * ng)
    z_r = M_r(jnp.asarray(r))
    assert_close(M_t(torch.tensor(r)), z_r, rtol=1e-12, atol=1e-12)
    # from_planes (the plan's entry) and from_state rebuild the same cycle
    v5 = rpoisson.vc_coefficients(jnp.asarray(kap)).reshape(5, ng, ng)
    P_r = rmg.MultigridPreconditioner.from_planes(v5)
    P_t = tmg.MultigridPreconditioner.from_planes(
        torch.tensor(np.asarray(v5)))
    Q_t = tmg.MultigridPreconditioner.from_state(P_t.state())
    z_r = P_r(jnp.asarray(r))
    assert_close(P_t(torch.tensor(r)), z_r, rtol=1e-12, atol=1e-12)
    assert_close(Q_t(torch.tensor(r)), z_r, rtol=1e-12, atol=1e-12)


def test_mg_smoother_runs_the_stencil_kernel_wrapper(monkeypatch):
    """Every smoothing and residual matvec of the V-cycle goes through
    ``kernels.stencil5.stencil5`` (the kernel on a CUDA tensor): per
    non-coarsest level pre (2) + residual (1) + post (2) calls."""
    calls = {"n": 0}
    orig = tks.stencil5

    def counting(*a, **kw):
        calls["n"] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(tks, "stencil5", counting)
    M = tmg.MultigridPreconditioner(torch.tensor(_kappa(64)))
    M(torch.ones(64 * 64, dtype=torch.float64))
    assert calls["n"] == 5 * (len(M.sizes) - 1), (calls["n"], M.sizes)


def test_mg_beats_jacobi_and_converges():
    kap, A_ref, A, mv = _both(64)
    b = np.ones(64 * 64)
    mv_r = make_matvec(A_ref)
    _, ij_r = rsol.cg(mv_r, jnp.asarray(b), M=lambda r: r / A_ref.diagonal(),
                      tol=1e-10, maxiter=20000)
    _, im_r = rsol.cg(mv_r, jnp.asarray(b),
                      M=rmg.make_mg_preconditioner(jnp.asarray(kap)),
                      tol=1e-10, maxiter=500)
    bt = torch.tensor(b)
    d = A.diagonal()
    _, ij = tsol.cg(mv, bt, M=lambda r: r / d, tol=1e-10, maxiter=20000)
    x, im = tsol.cg(mv, bt, M=tmg.make_mg_preconditioner(torch.tensor(kap)),
                    tol=1e-10, maxiter=500)
    assert bool(im.converged)
    assert float(torch.linalg.norm(mv(x) - bt)) < 1e-7
    assert int(im.iters) < int(ij.iters) / 5
    assert (int(im.iters), int(ij.iters)) == (int(im_r.iters), int(ij_r.iters))


def test_mg_iterations_h_independent():
    """The multigrid property: iterations ~constant as the grid refines;
    each count equal to the reference's."""
    iters = {}
    for ng in (32, 64, 128):
        kap, A_ref, A, mv = _both(ng)
        _, info_r = rsol.cg(make_matvec(A_ref), jnp.ones(ng * ng),
                            M=rmg.make_mg_preconditioner(jnp.asarray(kap)),
                            tol=1e-9, maxiter=500)
        _, info = tsol.cg(mv, torch.ones(ng * ng, dtype=torch.float64),
                          M=tmg.make_mg_preconditioner(torch.tensor(kap)),
                          tol=1e-9, maxiter=500)
        iters[ng] = int(info.iters)
        assert bool(info.converged)
        assert iters[ng] == int(info_r.iters), (ng, iters[ng], info_r.iters)
    assert iters[128] <= 2 * iters[32] + 4, iters


def test_mg_inside_adjoint_solve():
    """tests/test_multigrid.py::test_mg_inside_adjoint_solve (its solve is
    the plan's CG + Jacobi on the MG test operator), then the same loss
    with ``precond="mg"`` on the stencil layout: gradients against the
    reference's."""
    kap, A_ref, A, _ = _both(32)
    b = np.ones(32 * 32)
    from repro.core.adjoint import sparse_solve as rsolve
    from repro.core.dispatch import make_config as rconfig
    from repro_torch.core.adjoint import sparse_solve as tsolve
    from repro_torch.core.dispatch import make_config as tconfig

    def loss_r(val):
        A2 = A_ref.with_values(val)
        x = rsolve(rconfig(A2, backend="jnp", method="cg", tol=1e-12), A2,
                   jnp.asarray(b))
        return jnp.sum(x ** 2)

    g_r = jax.grad(loss_r)(A_ref.val)
    val = A.val.detach().clone().requires_grad_(True)
    A2 = A.with_values(val)
    x = tsolve(tconfig(A2, backend="jnp", method="cg", tol=1e-12), A2,
               torch.tensor(b))
    (x ** 2).sum().backward()
    assert bool(torch.isfinite(val.grad).all())
    assert_close(val.grad, g_r, rtol=1e-8, atol=1e-8)

    _, S_ref, S, _ = _both(32, stencil=True)
    kw = dict(method="cg", tol=1e-12, precond="mg", maxiter=500)
    g_r = jax.grad(lambda v: jnp.sum(S_ref.with_values(v).solve(
        jnp.asarray(b), **kw) ** 2))(S_ref.val)
    val = S.val.detach().clone().requires_grad_(True)
    (S.with_values(val).solve(torch.tensor(b), **kw) ** 2).sum().backward()
    assert S.plan(**kw).cfg.backend == "stencil"
    assert_close(val.grad, g_r, rtol=1e-8, atol=1e-8)


def test_mg_first_class_precond_option():
    """precond='mg' builds the V-cycle from the stencil planes inside setup;
    auto-dispatch keeps the stencil kernel; iterations as the reference."""
    kap, A_ref, A, mv = _both(32, stencil=True)
    b = np.ones(32 * 32)
    kw = dict(method="cg", tol=1e-10, precond="mg", maxiter=200)
    from repro import sla as rsla
    from repro_torch import sla as tsla
    r = rsla.solve_with_info(A_ref, jnp.asarray(b), **kw)
    t = tsla.solve_with_info(A, torch.tensor(b), **kw)
    assert float(torch.linalg.norm(mv(t.x) - torch.tensor(b))) < 1e-7
    assert int(t.iterations) == int(r.iterations)
    assert_close(t.x, r.x, rtol=1e-9, atol=1e-11)
    assert A.plan(**kw).cfg.backend == "stencil"


def test_mg_precond_requires_stencil():
    A = tpoisson.poisson2d(8, device=CPU)
    with pytest.raises(ValueError, match="mg"):
        A.solve(torch.ones(64, dtype=torch.float64), backend="jnp",
                precond="mg")


def _nonsym_stencil_ref(ng=8):
    rows, cols, meta = rpoisson.vc_pattern(ng)
    val = rpoisson.vc_coefficients(jnp.ones((ng, ng))).reshape(5, ng, ng)
    val = val.at[1].mul(1.3).at[2].mul(0.7).reshape(-1)   # break symmetry
    return RTensor(val, rows, cols, (ng * ng, ng * ng),
                   props={"symmetric": False, "spd_hint": False},
                   stencil=meta, validate=False)


def test_grad_nonsymmetric_stencil_mg_stays_on_stencil():
    """tests/test_plan.py: the backward of a non-symmetric stencil solve
    with precond='mg' keeps the stencil kernel (transposed planes, mg
    included); gradients as the reference's and as dense autodiff."""
    B_ref = _nonsym_stencil_ref(8)
    B = port_of(B_ref)
    b = np.ones(64)
    kw = dict(method="bicgstab", tol=1e-13, maxiter=8000, precond="mg")
    g_r = jax.grad(lambda v: jnp.sum(B_ref.with_values(v).solve(
        jnp.asarray(b), **kw) ** 2))(B_ref.val)
    val = B.val.clone().requires_grad_(True)
    (B.with_values(val).solve(torch.tensor(b), **kw) ** 2).sum().backward()
    assert_close(val.grad, g_r, rtol=1e-8, atol=1e-8)
    tp = B.plan(**kw).transpose()
    assert tp.cfg.backend == "stencil" and tp.cfg.precond == "mg"
    vd = B.val.clone().requires_grad_(True)
    (torch.linalg.solve(B.with_values(vd).todense(), torch.tensor(b)) ** 2
     ).sum().backward()
    assert_close(val.grad, vd.grad, rtol=1e-6, atol=1e-8)


def test_shared_vcycle_routine_used_by_geometric_mg():
    pre = tmg.MultigridPreconditioner(torch.tensor(_kappa(16, 0.3)))
    assert isinstance(pre._hier[0], tmg.Level)
    assert pre._hier[-1].coarse_solve is not None
    r = torch.ones(16 * 16, dtype=torch.float64)
    z = pre(r)
    assert z.shape == r.shape and bool(torch.isfinite(z).all())
