"""PyTorch port vs the JAX reference: sparse tensors, layouts, generators,
options, and the port's import/device guards (all on the CPU)."""
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sparse as rsparse
from repro.core import options as roptions
from repro.data import poisson as rpoisson
from repro_torch.core import options as toptions
from repro_torch.core import sparse as tsparse
from repro_torch.data import poisson as tpoisson

from _torch_parity import CPU, assert_close, np_of, port_of


def _random_pattern(rng, n, m, nnz):
    row = rng.integers(0, n, nnz)
    col = rng.integers(0, m, nnz)
    keys = np.unique(row.astype(np.int64) * m + col)
    return (keys // m).astype(np.int32), (keys % m).astype(np.int32)


@pytest.mark.parametrize("n,m,nnz,max_k,seed", [
    (37, 300, 900, None, 0),        # ragged bands and column blocks
    (200, 150, 400, None, 4),       # empty rows / cols
    (64, 64, 300, None, 2),
    (300, 517, 2500, 2, 7),         # max_k cap drops entries (perm == -1)
    (1, 1, 1, None, 3),
])
def test_build_bell_matches_reference(n, m, nnz, max_k, seed):
    row, col = _random_pattern(np.random.default_rng(seed), n, m, nnz)
    rm, rb, rp = rsparse.build_bell(row, col, (n, m), max_k=max_k)
    tm, tb, tp = tsparse.build_bell(row, col, (n, m), max_k=max_k)
    assert tm == tsparse.BellMeta(**rm.__dict__)
    np.testing.assert_array_equal(tb, np.asarray(rb))
    np.testing.assert_array_equal(tp, np.asarray(rp))
    assert tb.dtype == np.int32


@pytest.mark.parametrize("ng", [8, 33])
def test_build_bell_poisson_matches_reference(ng):
    A = rpoisson.poisson2d(ng)
    rm, rb, rp = rsparse.build_bell(A.row, A.col, A.shape)
    tm, tb, tp = tsparse.build_bell(np.asarray(A.row), np.asarray(A.col),
                                    A.shape)
    assert tm.fill == rm.fill and tm.k == rm.k
    np.testing.assert_array_equal(tb, np.asarray(rb))
    np.testing.assert_array_equal(tp, np.asarray(rp))


def test_poisson_generators_match_reference():
    for ref, port in ((rpoisson.poisson1d(17), tpoisson.poisson1d(17, device=CPU)),
                      (rpoisson.poisson2d(9), tpoisson.poisson2d(9, device=CPU))):
        for f in ("val", "row", "col"):
            np.testing.assert_array_equal(np_of(getattr(port, f)),
                                          np.asarray(getattr(ref, f)))
        assert port.props == ref.props
        assert port.shape == ref.shape
    r, c, meta = rpoisson.vc_pattern(11)
    tr, tc, tmeta = tpoisson.vc_pattern(11)
    np.testing.assert_array_equal(tr, r)
    np.testing.assert_array_equal(tc, c)
    assert (tmeta.nx, tmeta.ny) == (meta.nx, meta.ny)


def test_vc_coefficients_and_gradient_match_reference():
    import jax
    rng = np.random.default_rng(0)
    kappa = 1.0 + rng.random((13, 13))
    w = rng.normal(size=5 * 13 * 13)
    v_ref = rpoisson.vc_coefficients(jnp.asarray(kappa))
    kt = torch.tensor(kappa, requires_grad=True)
    v_t = tpoisson.vc_coefficients(kt)
    assert_close(v_t, v_ref, rtol=1e-14, atol=1e-14)
    g_ref = jax.grad(lambda k: jnp.sum(jnp.asarray(w) *
                                       rpoisson.vc_coefficients(k)))(
        jnp.asarray(kappa))
    (torch.tensor(w) * v_t).sum().backward()
    assert_close(kt.grad, g_ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("symmetric", [True, False])
def test_detect_properties_matches_reference(symmetric):
    A = rpoisson.poisson2d(6)
    val = np.asarray(A.val).copy()
    if not symmetric:
        val[np.asarray(A.col) == np.asarray(A.row) + 1] = -0.5
    ref = rsparse.detect_properties(jnp.asarray(val), A.row, A.col, A.shape)
    port = tsparse.detect_properties(torch.tensor(val), np.asarray(A.row),
                                     np.asarray(A.col), A.shape)
    assert port == ref
    assert tsparse.has_full_diagonal(np.asarray(A.row), np.asarray(A.col),
                                     A.shape[0])


def test_coo_products_match_reference():
    rng = np.random.default_rng(5)
    n, m = 40, 70
    row, col = _random_pattern(rng, n, m, 500)
    val = rng.normal(size=len(row))
    x, y = rng.normal(size=m), rng.normal(size=n)
    Ar = rsparse.SparseTensor(val, row, col, (n, m))
    At = tsparse.SparseTensor(val, row, col, (n, m), device=CPU)
    assert_close(At @ torch.tensor(x), Ar @ jnp.asarray(x), rtol=1e-12)
    assert_close(At.rmatvec(torch.tensor(y)), Ar.rmatvec(jnp.asarray(y)),
                 rtol=1e-12)
    assert_close(At.todense(), Ar.todense(), rtol=1e-14)
    assert_close(At.T.todense(), Ar.T.todense(), rtol=1e-14)
    Asq = rpoisson.poisson2d(5)
    assert_close(port_of(Asq).diagonal(), Asq.diagonal(), rtol=1e-14)
    # batched values broadcast through the same index_add_ segment sum
    vals = np.stack([val, 2 * val])
    yb = tsparse.coo_matvec(torch.tensor(vals), At.row, At.col,
                            torch.tensor(x), n)
    yr = rsparse.coo_matvec(jnp.asarray(vals), jnp.asarray(row),
                            jnp.asarray(col), jnp.asarray(x), n)
    assert_close(yb, yr, rtol=1e-12)


def test_with_values_shares_plan_cache_and_T():
    A = tpoisson.poisson2d(4, device=CPU)
    B = A.with_values(A.val * 2)
    assert B._plans is A._plans and B.shape == A.shape
    assert A.T.shape == (A.shape[1], A.shape[0])
    assert A.T._plans is not A._plans


def test_options_match_reference():
    rf = {f.name: f.default for f in __import__("dataclasses").fields(
        roptions.Options)}
    tf = {f.name: f.default for f in __import__("dataclasses").fields(
        toptions.Options)}
    assert rf == tf
    env = {"REPRO_SLA_FUSED_STEP": "ON", "REPRO_SLA_PLAN_CACHE_BYTES": "1e8",
           "REPRO_SLA_BELL_MIN_FILL": "0.25", "OTHER": "x"}
    assert toptions._parse_env(env) == roptions._parse_env(env)
    with pytest.raises(ValueError):
        toptions._parse_env({"REPRO_SLA_TYPO": "1"})
    for bad in (dict(fused_step="maybe"), dict(dense_budget=-1),
                dict(bell_min_fill=2.0), dict(plan_cache_cap=0),
                dict(plan_cache_bytes=-5)):
        with pytest.raises(ValueError):
            toptions.set_options(**bad)
    before = toptions.current()
    with toptions.options(fused_step="off", dense_budget=7) as o:
        assert toptions.current() is o and o.dense_budget == 7
        with pytest.raises(RuntimeError):
            with toptions.options(fused_step="on"):
                raise RuntimeError("body raises")
        assert toptions.current().fused_step == "off"
    assert toptions.current() == before


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def test_port_imports_without_jax_or_reference():
    """The port imports with ``jax`` and ``repro`` refused by the importer."""
    code = textwrap.dedent("""
        import sys
        class Refuse:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    raise ImportError("refused: " + name)
                return None
        sys.meta_path.insert(0, Refuse())
        import repro_torch
        from repro_torch import sla
        from repro_torch.core import (adjoint, convert, direct, dispatch,
                                      options, precond, solvers, sparse)
        from repro_torch.data import poisson
        from repro_torch.kernels import (_build, ops, ref, solve_step,
                                         supernode)
        A = poisson.poisson2d(6, device="cpu")
        import torch
        x = sla.solve(A, torch.ones(36, dtype=torch.float64), backend="jnp")
        sla.solve(A, x, backend="direct")
        sla.solve(A, x, backend="jnp", precond="ilu")
        A.slogdet()
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "repro")]
        assert not bad, bad
        print("ok", x.shape[0])
    """)
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env["PYTHONPATH"] = src
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok 36"


def test_constructors_need_a_card_or_an_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    kappa = np.ones((4, 4))
    for make in (lambda: tpoisson.poisson2d(4),
                 lambda: tpoisson.poisson1d(4),
                 lambda: tpoisson.poisson2d_vc(kappa),
                 lambda: tsparse.SparseTensor([1.0], [0], [0], (1, 1))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    A = tsparse.SparseTensor([2.0], [0], [0], (1, 1), device=CPU)
    assert A.device.type == "cpu"
