"""PyTorch port vs the JAX reference: the kernels' plain versions against
the reference Pallas kernels (interpret mode on the CPU) and the
differentiable operator wrappers' backward against the reference
``custom_vjp``.  The hand-written kernels are held to these plain versions
on a card by ``test_torch_on_card.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparse import build_bell as r_build_bell
from repro.kernels import ops as rops
from repro.kernels import solve_step as rfk
from repro.kernels.stencil5 import Stencil5Meta as RMeta
from repro_torch.core.direct import SnodeBucket
from repro_torch.core.sparse import bell_to_device, build_bell
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import solve_step as tfk
from repro_torch.kernels.stencil5 import Stencil5Meta

from _torch_parity import (FUSED_SIGS, assert_close, bell_case,
                           fused_inputs, stencil_case, tol)

@pytest.mark.parametrize("nx,ny,dtype,seed", [
    (3, 3, np.float64, 0), (37, 300, np.float64, 1), (37, 300, np.float32, 2),
    (70, 5, np.float32, 3), (16, 128, np.float64, 4)])
def test_stencil5_plain_matches_reference_kernel(nx, ny, dtype, seed):
    v, x = stencil_case(nx, ny, dtype, seed)
    y_r = rops.stencil5_matvec(RMeta(nx=nx, ny=ny), jnp.asarray(v),
                               jnp.asarray(x))
    y_t = tops.stencil5_matvec(Stencil5Meta(nx=nx, ny=ny), torch.tensor(v),
                               torch.tensor(x))
    assert_close(y_t, y_r, **tol(dtype))


@pytest.mark.parametrize("n,m,density,dtype,seed", [
    (4, 4, 0.3, np.float64, 0), (200, 150, 0.05, np.float64, 1),
    (120, 90, 0.08, np.float32, 2), (37, 300, 0.01, np.float64, 3)])
def test_bell_plain_matches_reference_kernel(n, m, density, dtype, seed):
    row, col, val, x = bell_case(n, m, density, dtype, seed)
    rmeta, rcols, rperm = r_build_bell(row, col, (n, m))
    y_r = rops.bell_matvec(rmeta, rcols, rperm, jnp.asarray(val),
                           jnp.asarray(x), n)
    bell = bell_to_device(build_bell(row, col, (n, m)), "cpu")
    y_t = tops.bell_matvec(bell, torch.tensor(val), torch.tensor(x), n)
    assert_close(y_t, y_r, **tol(dtype))
    assert_close(tops.bell_matvec_ref(bell, torch.tensor(val),
                                      torch.tensor(x), n), y_r, **tol(dtype))


@pytest.mark.parametrize("name", sorted(FUSED_SIGS))
@pytest.mark.parametrize("n,dtype", [(5, np.float64), (1029, np.float64),
                                     (1029, np.float32), (2048, np.float32)])
def test_fused_plain_matches_reference_kernel(name, n, dtype):
    vecs, scalars = fused_inputs(name, n, dtype, seed=n)
    out_r = getattr(rfk, name)(*[jnp.asarray(v) for v in vecs],
                               *[jnp.asarray(s) for s in scalars])
    out_t = getattr(tfk, name)(*[torch.tensor(v) for v in vecs],
                               *[torch.tensor(s) for s in scalars])
    assert len(out_t) == len(out_r)
    for a, b in zip(out_t, out_r):
        assert_close(a, b, **tol(dtype))


def test_fused_restart_flag_and_in_place_gating():
    """bicg_p honours the restart flag; ``out=`` aliases inputs in place and
    ``active=0`` leaves them untouched (the solver loops rely on both)."""
    rng = np.random.default_rng(9)
    r, p, v, d = (torch.tensor(rng.normal(size=50)) for _ in range(4))
    pn, ph = tfk.fused_bicg_p(r, p, v, d, 0.3, 0.7, 1.0)
    assert_close(pn, r, rtol=0, atol=0)
    x, rr = r.clone(), p.clone()
    x0, r0 = x.clone(), rr.clone()
    z = torch.empty_like(x)
    off = torch.zeros((), dtype=torch.int32)
    tfk.fused_cg_update(x, rr, v, d, d, 0.5, out=(x, rr, z), active=off)
    assert torch.equal(x, x0) and torch.equal(rr, r0)
    ref = tref.fused_cg_update_ref(x0, r0, v, d, d, 0.5)
    outs = tfk.fused_cg_update(x, rr, v, d, d, 0.5, out=(x, rr, z),
                               active=torch.ones((), dtype=torch.int32))
    assert outs[0] is x and outs[2] is z
    for a, b in zip(outs, ref):
        assert_close(a, b, rtol=1e-15, atol=0)


def test_fused_dots_exclude_padding():
    """Dots over a size-5 vector equal the plain length-5 dots (the
    reference's padding test; the CUDA kernel masks the tail instead)."""
    u = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0], dtype=torch.float64)
    v = torch.tensor([1.0, -1.0, 1.0, -1.0, 1.0], dtype=torch.float64)
    uv, uu = tfk.fused_dots2(u, v)
    uv_r, uu_r = rfk.fused_dots2(jnp.asarray(np.asarray(u)),
                                 jnp.asarray(np.asarray(v)))
    assert float(uv) == float(uv_r) == 3.0
    assert float(uu) == float(uu_r) == 55.0


def test_stencil5_backward_matches_reference_vjp():
    rng = np.random.default_rng(0)
    nx, ny = 21, 83
    v, x = stencil_case(nx, ny, np.float64, 0)
    w = rng.normal(size=nx * ny)
    gr = jax.grad(lambda vv, xx: jnp.sum(jnp.asarray(w) * rops.stencil5_matvec(
        RMeta(nx=nx, ny=ny), vv, xx)), (0, 1))(jnp.asarray(v), jnp.asarray(x))
    vt = torch.tensor(v, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    (torch.tensor(w) * tops.stencil5_matvec(Stencil5Meta(nx=nx, ny=ny), vt,
                                            xt)).sum().backward()
    assert_close(vt.grad, gr[0], rtol=1e-10, atol=1e-12)
    assert_close(xt.grad, gr[1], rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("with_t_bell", [False, True])
def test_bell_backward_matches_reference_vjp(with_t_bell):
    n, m = 120, 90
    row, col, val, x = bell_case(n, m, 0.08, np.float64, 1)
    w = np.random.default_rng(2).normal(size=n)
    rmeta, rcols, rperm = r_build_bell(row, col, (n, m))
    gr = jax.grad(lambda vv, xx: jnp.sum(jnp.asarray(w) * rops.bell_matvec(
        rmeta, rcols, rperm, vv, xx, n)), (0, 1))(jnp.asarray(val),
                                                  jnp.asarray(x))
    bell = bell_to_device(build_bell(row, col, (n, m)), "cpu")
    t_bell = bell_to_device(build_bell(col, row, (m, n)), "cpu") \
        if with_t_bell else None
    vt = torch.tensor(val, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    (torch.tensor(w) * tops.bell_matvec(bell, vt, xt, n,
                                        t_bell=t_bell)).sum().backward()
    assert_close(vt.grad, gr[0], rtol=1e-10, atol=1e-12)
    assert_close(xt.grad, gr[1], rtol=1e-10, atol=1e-12)


def test_bell_assemble_and_its_gradient_match_reference():
    n, m = 300, 517
    row, col, val, _ = bell_case(n, m, 0.02, np.float64, 6)
    rmeta, rcols, rperm = r_build_bell(row, col, (n, m), max_k=2)
    bell = bell_to_device(build_bell(row, col, (n, m), max_k=2), "cpu")
    tiles_r = rops.bell_assemble(rmeta, rperm, jnp.asarray(val))
    vt = torch.tensor(val, requires_grad=True)
    tiles_t = tops.bell_assemble(bell.meta, bell.perm, vt)
    assert_close(tiles_t, tiles_r, rtol=0, atol=0)
    w = np.random.default_rng(7).normal(size=tiles_r.shape)
    g_r = jax.grad(lambda v: jnp.sum(jnp.asarray(w) * rops.bell_assemble(
        rmeta, rperm, v)))(jnp.asarray(val))
    (torch.tensor(w) * tiles_t).sum().backward()
    assert_close(vt.grad, g_r, rtol=0, atol=0)


def test_transposed_planes_match_reference():
    v, _ = stencil_case(9, 14, np.float64, 5)
    v5 = v.reshape(5, 9, 14)
    assert_close(tops.stencil_transpose_planes(torch.tensor(v5)),
                 rops._stencil_transpose_planes(jnp.asarray(v5)),
                 rtol=0, atol=0)


def test_kernel_wrappers_count_no_cpu_launches():
    """On CPU tensors the wrappers run the plain versions and count no
    kernel launch."""
    from repro_torch import kernels
    kernels.reset_launch_counts()
    v, x = stencil_case(8, 8, np.float64, 0)
    tops.stencil5_matvec(Stencil5Meta(nx=8, ny=8), torch.tensor(v),
                         torch.tensor(x))
    tfk.fused_dots2(torch.tensor(x), torch.tensor(x))
    from repro_torch.kernels import supernode as tsn
    P = torch.eye(6, 2, dtype=torch.float64).repeat(3, 1, 1)
    Q = torch.ones(3, 2, 4, dtype=torch.float64)
    w = torch.full((3,), 2, dtype=torch.int32)
    r = torch.full((3,), 4, dtype=torch.int32)
    bk = torch.zeros(3, 2, dtype=torch.bool)
    C = torch.cat([P.reshape(-1), Q.reshape(-1), torch.zeros(48)]).double()
    pidx = torch.arange(36, dtype=torch.int32).view(3, 6, 2)
    qidx = torch.arange(36, 60, dtype=torch.int32).view(3, 2, 4)
    tsn.panel_factor_inplace(C, pidx, qidx, w, r, 1e-8, bk)
    tsn.schur_update_inplace(C, pidx, qidx, w, r,
                             torch.arange(60, 108, dtype=torch.int32),
                             torch.arange(0, 64, 16))
    tsn.block_trsv(C[:36].view(3, 6, 2)[:, :2, :],
                   torch.ones(3, 2, dtype=torch.float64), w, bk, mode="u")
    rows = torch.arange(18, dtype=torch.int32).view(3, 6)
    sweep = SnodeBucket(wb=2, rb=4, pairs=False, pidx=pidx, qidx=qidx,
                        uidx=None, rows=rows, wvec=w, rvec=r, bkm=bk)
    for mode in ("l", "u"):
        tsn.sn_sweep_inplace(C, torch.zeros(19, 2, dtype=torch.float64),
                             sweep, mode)
    from repro_torch.kernels.flash_attention import flash_attention
    qkv = torch.ones(2, 5, 16)
    flash_attention(qkv, qkv, qkv, causal=True)
    # the lane-batched entry points (slice 5)
    meta = Stencil5Meta(nx=8, ny=8)
    tops.stencil5_matvec(meta, torch.tensor(v).repeat(2, 1),
                         torch.tensor(x).repeat(2, 1))
    X = torch.tensor(x).repeat(3, 1)
    tfk.fused_dots2(X, X)
    # the lane-stacked panel kernels (slice 5b): two value lanes of C
    C2 = torch.stack([C, 2.0 * C])
    tsn.panel_factor_inplace(C2, pidx, qidx, w, r,
                             torch.tensor([1e-8, 2e-8], dtype=torch.float64),
                             bk)
    tsn.schur_update_inplace(C2, pidx, qidx, w, r,
                             torch.arange(60, 108, dtype=torch.int32),
                             torch.arange(0, 64, 16))
    tsn.sn_sweep_inplace(C2, torch.zeros(2, 19, 2, dtype=torch.float64),
                         sweep, "lt")
    assert set(kernels.launch_counts().values()) == {0}
    assert set(tsn.SWEEP_MODE_LAUNCHES.values()) == {0}
    # 15 single-vector kernels + 11 lane-batched entry points + the 3
    # lane-stacked panel kernels
    assert len(kernels.launch_counts()) == 29
