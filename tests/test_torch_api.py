"""The port's public surface (``repro_torch.sla``) against the reference's
(``repro.sla``, tests/test_api.py): the same 20 names, the distributed
``DSparseTensor`` among them (bound lazily), each resolvable and
documented;
``register_backend`` in both of its forms; ``SparseTensorList`` with one
adjoint per pattern."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sla as rsla
from repro.core.sparse import SparseTensorList as RList
from repro.data import poisson as rpoisson
import repro_torch
from repro_torch import sla as tsla
from repro_torch.core import dispatch as tdisp
from repro_torch.core import solvers as tsolvers
from repro_torch.core.sparse import SparseTensorList

from _torch_parity import assert_close, np_of, port_of


def test_api_surface_is_the_reference_less_dsparse():
    # the name is historical: since the distributed slice the surface is
    # the reference's whole, DSparseTensor included
    assert sorted(tsla.__all__) == sorted(rsla.__all__)
    assert len(tsla.__all__) == 20


def test_api_surface_resolvable_and_documented():
    for name in tsla.__all__:
        obj = getattr(tsla, name)          # lazy names must resolve too
        assert obj is not None
        if callable(obj) and not isinstance(obj, dict):
            assert getattr(obj, "__doc__", None), f"{name} lacks a docstring"
    assert repro_torch.sla is tsla
    from repro_torch.core.distributed import DSparseTensor
    assert tsla.DSparseTensor is DSparseTensor


@pytest.fixture
def _registry():
    saved = dict(tdisp.BACKENDS)
    yield
    tdisp.BACKENDS.clear()
    tdisp.BACKENDS.update(saved)


def _dense_fn(cfg, A, b, x0):
    x = torch.linalg.solve(A.todense(), b.unsqueeze(-1)).squeeze(-1)
    lanes = x.shape[:-1]
    return x, tsolvers.SolveInfo(torch.ones(lanes, dtype=torch.int64),
                                 torch.zeros(lanes, dtype=x.dtype),
                                 torch.ones(lanes, dtype=torch.bool))


def test_register_backend_function_form(_registry):
    calls = []

    def solve_fn(cfg, A, b, x0):
        calls.append(tuple(b.shape))
        return _dense_fn(cfg, A, b, x0)

    tsla.register_backend("dense_fn", solve_fn,
                          applicable=lambda A: A.shape[0] == A.shape[1])
    A = port_of(rpoisson.poisson2d(5))
    b = torch.tensor(np.random.default_rng(0).normal(size=25))
    v = A.val.clone().requires_grad_(True)
    x = tsla.solve(A.with_values(v), b, backend="dense_fn")
    (x ** 2).sum().backward()
    vd = A.val.clone().requires_grad_(True)
    xd = torch.linalg.solve(A.with_values(vd).todense(), b)
    (xd ** 2).sum().backward()
    assert_close(x, xd, rtol=1e-12, atol=1e-13)
    assert_close(v.grad, vd.grad, rtol=1e-10, atol=1e-12)
    assert calls == [(25,), (25,)]          # forward + adjoint, same plan
    res = tsla.solve_with_info(A, torch.stack([b, 2 * b]),
                               backend="dense_fn")   # batches as they come
    assert res.reason == "converged" and tuple(res.x.shape) == (2, 25)
    assert tdisp.BACKENDS["dense_fn"].applicable(A)


def test_register_backend_instance_form(_registry):
    class Recording(tdisp.DenseBackend):
        """The dense backend, counting its setups."""
        setups = 0

        def setup(self, plan, A):
            Recording.setups += 1
            return super().setup(plan, A)

    tsla.register_backend("recording", backend=Recording())
    assert tdisp.BACKENDS["recording"].name == "recording"
    A = port_of(rpoisson.poisson2d(5))
    b = torch.ones(25, dtype=torch.float64)
    x = tsla.solve(A, b, backend="recording", method="lu")
    x2 = tsla.solve(A, b, backend="recording", method="lu")
    assert_close(x, torch.linalg.solve(A.todense(), b), rtol=1e-12,
                 atol=1e-13)
    assert torch.equal(x, x2) and Recording.setups == 1   # memoized setup
    with pytest.raises(TypeError):
        tsla.register_backend("nothing")


def test_sparse_tensor_list_solve_and_matvec_own_adjoints():
    """Distinct patterns, each on its own plan with its own adjoint: the
    list's gradients equal the separate solves' and the reference's."""
    A_refs = [rpoisson.poisson2d(5), rpoisson.poisson2d(6)]
    rng = np.random.default_rng(1)
    bs = [rng.normal(size=A.shape[0]) for A in A_refs]
    xs_np = [rng.normal(size=A.shape[0]) for A in A_refs]
    kw = dict(backend="jnp", method="cg", tol=1e-12)

    def loss_r(v1, v2):
        L = RList([A_refs[0].with_values(v1), A_refs[1].with_values(v2)])
        xs = L.solve([jnp.asarray(b) for b in bs], **kw)
        ys = L.matvec([jnp.asarray(x) for x in xs_np])
        return sum(jnp.sum(x ** 2) + jnp.sum(y ** 3) for x, y in zip(xs, ys))
    g_r = jax.grad(loss_r, (0, 1))(A_refs[0].val, A_refs[1].val)

    As = [port_of(A) for A in A_refs]
    vs = [A.val.clone().requires_grad_(True) for A in As]
    L = SparseTensorList([A.with_values(v) for A, v in zip(As, vs)])
    assert len(L) == 2 and L[1].shape == (36, 36)
    tdisp.reset_plan_stats()
    xs = L.solve([torch.tensor(b) for b in bs], **kw)
    ys = L.matvec([torch.tensor(x) for x in xs_np])
    sum(((x ** 2).sum() + (y ** 3).sum()) for x, y in zip(xs, ys)).backward()
    assert tdisp.PLAN_STATS["analyze"] == 2       # one plan per pattern
    for v, g in zip(vs, g_r):
        assert_close(v.grad, g, rtol=1e-6, atol=1e-8)
    # each element's gradient is its own: solving one alone gives the same
    v0 = As[0].val.clone().requires_grad_(True)
    x0 = As[0].with_values(v0).solve(torch.tensor(bs[0]), **kw)
    y0 = As[0].with_values(v0).matvec(torch.tensor(xs_np[0]))
    ((x0 ** 2).sum() + (y0 ** 3).sum()).backward()
    assert_close(vs[0].grad, v0.grad, rtol=1e-12, atol=1e-14)
    with pytest.raises(ValueError):
        L.solve([torch.tensor(bs[0])])
    assert np_of(xs[1]).shape == (36,)
