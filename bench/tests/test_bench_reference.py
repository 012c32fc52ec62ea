"""The plain reference against a dense solve and a finite difference."""
import pytest
import torch

import _helpers  # noqa: F401
from bench.harness import inputs
from bench.reference import poisson_vc as ref

NG = 16
FAMILY = {"modes": 8, "max_wavenumber": 5}


def _kappa(lanes=2, seed=1):
    g = inputs.generator("cpu", seed)
    return inputs.kappa(g, lanes, NG, FAMILY, 0.9, torch.float64, "cpu")


def _dense(p):
    n = NG * NG
    cols = [ref.apply(p, torch.eye(n, dtype=p.dtype)[j].reshape(NG, NG))
            .reshape(-1) for j in range(n)]
    return torch.stack(cols, dim=1)


def test_operator_is_spd():
    M = _dense(ref.planes(_kappa(1)[0]))
    assert torch.allclose(M, M.T, atol=0, rtol=0)
    assert float(torch.linalg.eigvalsh(M).min()) > 0


def test_cg_matches_dense_solve():
    kap = _kappa()
    b = torch.randn(2, NG, NG, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(3))
    x, ok = ref.solve(kap, b, 1e-12, 10_000)
    assert bool(ok.all())
    for lane in range(2):
        M = _dense(ref.planes(kap[lane]))
        xd = torch.linalg.solve(M, b[lane].reshape(-1)).reshape(NG, NG)
        assert float((x[lane] - xd).norm() / xd.norm()) < 1e-10


def test_adjoint_gradient_matches_finite_difference():
    kap = _kappa()
    f = torch.ones(2, NG, NG, dtype=torch.float64)
    u, g, ok = ref.solve_and_grad(kap, f, 1e-13, 10_000)
    assert bool(ok.all())

    def loss(k):
        x, _ = ref.solve(k, f[:1], 1e-13, 10_000)
        return float((x * x).sum())

    for (i, j) in [(0, 0), (5, 7), (15, 3), (8, 8)]:
        h = 1e-4
        kp, km = kap[:1].clone(), kap[:1].clone()
        kp[0, i, j] += h
        km[0, i, j] -= h
        fd = (loss(kp) - loss(km)) / (2 * h)
        assert abs(fd - float(g[0, i, j])) <= 1e-6 * abs(fd) + 1e-9, (i, j)


def test_adjoint_gradient_matches_dense_autograd():
    kap = _kappa(1)[0]
    f = torch.ones(NG * NG, dtype=torch.float64)
    k = kap.clone().requires_grad_(True)
    M = _dense_autograd(k)
    u = torch.linalg.solve(M, f)
    (u * u).sum().backward()
    _, g, _ = ref.solve_and_grad(kap[None], f.reshape(1, NG, NG), 1e-13,
                                 10_000)
    assert float((g[0] - k.grad).norm() / k.grad.norm()) < 1e-9


def _dense_autograd(k):
    p = ref.planes(k)
    n = NG * NG
    eye = torch.eye(n, dtype=k.dtype).reshape(n, NG, NG)
    return ref.apply(p.expand(n, 5, NG, NG), eye).reshape(n, n).T


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lanes_are_independent(dtype):
    kap = _kappa(3).to(dtype)
    b = torch.ones(NG, NG, dtype=dtype)
    x, _ = ref.solve(kap, b, 1e-6, 10_000)
    x1, _ = ref.solve(kap[1:2], b, 1e-6, 10_000)
    assert torch.equal(x[1], x1[0])
