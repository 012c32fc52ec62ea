"""The PyTorch port's hand-written CUDA kernels on the card, each against
its plain PyTorch version (``repro_torch.kernels.ref``) on the same inputs.

The plain versions are held to the JAX reference on the CPU by the other
``test_torch_*.py`` files; this file imports neither ``jax`` nor the
reference, so it runs on a card machine without them:

    PYTHONPATH=src python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_on_card.py

(``chip_smoke.py`` runs exactly that and fails on any failure or skip).
Every test is marked ``cuda`` and skips where ``torch.cuda.is_available()``
is false.  Tolerances: the reference tests' kernel tolerances (1e-12 f64,
1e-5 f32, of the output's scale for the supernodal kernels); bf16 flash
elementwise |o − plain| ≤ 8e-3·|plain| + 1e-3 against the f32-p plain
version.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import direct as td
from repro_torch.core.sparse import bell_to_device, build_bell
from repro_torch.data.poisson import poisson2d_arrays
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import solve_step as tfk
from repro_torch.kernels import supernode as tsn
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_gqa)
from repro_torch.kernels.stencil5 import Stencil5Meta

from _torch_parity import (FUSED_SIGS, assert_close, bell_case,  # noqa: F401
                           cuda_device, fused_inputs, inplace_bucket,
                           panel_bucket, port_inplace, port_panel, rel,
                           stencil_case, sweep_bucket, sweep_bucket_on, tol)

TOL = {np.float64: 1e-12, np.float32: 1e-5}
SHAPES = [(3, 8, 16), (5, 4, 8), (4, 2, 4), (2, 8, 32)]   # (k, wb, rb)
MODES = ("l", "lt", "u", "ut")
#: bf16 flash, elementwise |o − plain| <= rtol·|plain| + atol: 4 half-ulps
#: of the output's rounding and an atol for outputs near 0
BF16_TOL = (8e-3, 1e-3)
#: sweep buckets: ragged lanes with an all-pad last lane; (3, 32, 1024) and
#: (2, 32, 200) split every live lane over several blocks (8 and 2)
SWEEP_SHAPES = [(5, 8, 16), (4, 2, 4), (7, 3, 5), (3, 32, 1024), (2, 32, 200)]


# ---------------------------------------------------------------------------
# slice 1: stencil5, block-ELL SpMV, the fused solve steps
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_stencil5_matches_plain(cuda_device, dtype):
    from repro_torch.kernels.stencil5 import stencil5
    for nx, ny in ((37, 300), (1, 1), (256, 257)):
        v, x = stencil_case(nx, ny, np.float64, 1)
        v5 = torch.tensor(v, dtype=dtype, device=cuda_device).reshape(5, nx, ny)
        x2 = torch.tensor(x, dtype=dtype, device=cuda_device).reshape(nx, ny)
        y = stencil5(Stencil5Meta(nx=nx, ny=ny), v5, x2)
        torch.cuda.synchronize()
        assert_close(y, tref.stencil5_ref(v5, x2),
                     **tol(np.float32 if dtype == torch.float32 else np.float64))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_bell_matches_plain(cuda_device, dtype):
    n, m = 200, 150
    row, col, val, x = bell_case(n, m, 0.05, np.float64, 1)
    bell = bell_to_device(build_bell(row, col, (n, m)), cuda_device)
    vt = torch.tensor(val, dtype=dtype, device=cuda_device)
    xt = torch.tensor(x, dtype=dtype, device=cuda_device)
    y = tops.bell_matvec(bell, vt, xt, n)
    torch.cuda.synchronize()
    assert_close(y, tops.bell_matvec_ref(bell, vt, xt, n),
                 **tol(np.float32 if dtype == torch.float32 else np.float64))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FUSED_SIGS))
def test_cuda_fused_matches_plain(cuda_device, name):
    for n, dtype in ((5, np.float64), (1029, np.float32), (300_001, np.float64)):
        vecs, scalars = fused_inputs(name, n, dtype, seed=3)
        vt = [torch.tensor(v, device=cuda_device) for v in vecs]
        st = [torch.tensor(s, device=cuda_device) for s in scalars]
        out = getattr(tfk, name)(*vt, *st)
        torch.cuda.synchronize()
        ref = getattr(tref, name + "_ref")(*vt, *st)
        for a, b in zip(out, ref):
            assert_close(a, b, rtol=1e-4 if dtype == np.float32 else 1e-10,
                         atol=1e-3 if dtype == np.float32 else 1e-9)


# ---------------------------------------------------------------------------
# slice 2: the supernodal panel kernels and the sweep
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("pairs", [False, True])
def test_cuda_panel_factor_and_schur_match_plain(cuda_device, pairs, dtype):
    """Both kernels in place on ragged buckets (garbage in the pad slots,
    sibling lanes sharing targets; (3, 32, 1024) splits each lane over 16
    blocks) against the plain in-place versions."""
    for shape in SHAPES + [(3, 32, 1024), (7, 3, 5)]:
        k, wb, rb = shape
        b = inplace_bucket(k, wb, rb, dtype, 3, pairs)
        Cf_k, nbk, Cs_k = port_inplace(b, 0.5, pairs, cuda_device)
        torch.cuda.synchronize()
        Cf_p, nbp, Cs_p = port_inplace(b, 0.5, pairs)
        assert rel(Cf_k, Cf_p) <= TOL[dtype] and nbk == nbp
        assert rel(Cs_k, Cs_p) <= TOL[dtype]
        assert float(Cf_k[b["sink"]]) == float(Cs_k[b["sink"]]) == 7.25


@pytest.mark.cuda
@pytest.mark.parametrize("pairs", [False, True])
def test_cuda_split_lanes_repeat_with_one_work_vector(cuda_device, pairs):
    """Lanes split over several blocks ((3, 32, 1024): 16 blocks a lane;
    (2, 32, 100): 2), factored again and again with one ``work`` vector: the
    plain version's C and clamp count every time, the counters back at 0."""
    work = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    for shape in [(3, 32, 1024), (2, 32, 100)]:
        b = inplace_bucket(*shape, np.float64, 4, pairs)
        Cf_p, nbp, _ = port_inplace(b, 0.5, pairs)
        t = lambda a: torch.tensor(a, device=cuda_device)
        args = (t(b["pidx"]), t(b["qidx"]), t(b["w"]), t(b["r"]), 0.5,
                t(b["bkm"]))
        for _ in range(8):
            C = t(b["C"])
            nb = tsn.panel_factor_inplace(C, *args, pairs=pairs, work=work)
            torch.cuda.synchronize()
            assert rel(C, Cf_p) <= TOL[np.float64] and float(nb) == nbp
            assert int(work.abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("pairs", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_cuda_block_trsv_matches_plain(cuda_device, mode, pairs):
    for dtype in (np.float64, np.float32):
        k, wb, rb = 5, 32, 64
        P, Q, w, r, bkm = panel_bucket(k, wb, rb, dtype, 2, pairs)
        Pf = port_panel(P, Q, w, r, 0.5, bkm, pairs, True)[0].to(cuda_device)
        wt = torch.tensor(w, device=cuda_device)
        bt = torch.tensor(bkm, device=cuda_device)
        for m in (1, 5):
            y = torch.tensor(np.random.default_rng(m).normal(
                size=(k, wb, m)).astype(dtype), device=cuda_device)
            D = Pf[:, :wb, :]                      # strided view: no copy
            x = tsn.block_trsv(D, y, wt, bt, mode=mode, pairs=pairs)
            torch.cuda.synchronize()
            want = tref.sn_trsv_ref(D, y, wt, bt, mode=mode, pairs=pairs)
            assert rel(x, want) <= TOL[dtype]


def _untouched(tb, n):
    """(n+1,) bool: the rows of y that no live entry of the bucket names —
    the scratch row, the pool rows no lane draws and the spare rows."""
    wb, rb = tb["wb"], tb["rb"]
    live = np.concatenate([np.arange(wb)[None, :] < tb["w"][:, None],
                           np.arange(rb)[None, :] < tb["r"][:, None]], 1)
    named = np.zeros(n + 1, bool)
    named[tb["rows"][live]] = True
    return ~named


@pytest.mark.cuda
@pytest.mark.parametrize("pairs", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_cuda_sweep_matches_plain(cuda_device, mode, pairs):
    """One launch of the in-place sweep step against its plain version: f64
    and f32, 1 and 64 right-hand sides, ragged lanes, an all-pad lane, lanes
    split over several blocks, sibling lanes sharing sub-rows.  Every row
    that no live entry names (the scratch row among them) keeps its value
    bit for bit, and the counters are back at zero."""
    for dtype in (np.float64, np.float32):
        for shape in SWEEP_SHAPES:
            for m in (1, 64):
                C, y, tb = sweep_bucket(*shape, dtype, 5 + m, pairs, m=m)
                n = y.shape[0] - 1
                bk = sweep_bucket_on(tb, cuda_device)
                Ck = torch.tensor(C, device=cuda_device)
                y0 = torch.tensor(y, device=cuda_device)
                work, part = tsn.sweep_buffers([bk], m, Ck.dtype, cuda_device)
                launches = tsn.SWEEP_MODE_LAUNCHES[mode]
                yk = tsn.sn_sweep_inplace(Ck, y0.clone(), bk, mode,
                                          work=work, part=part)
                torch.cuda.synchronize()
                assert tsn.SWEEP_MODE_LAUNCHES[mode] == launches + 1
                yp = tref.sn_sweep_inplace_ref(
                    Ck, y0.clone(), bk.pidx, bk.qidx, bk.rows, bk.wvec,
                    bk.rvec, bk.bkm, mode=mode, pairs=pairs)
                what = f"{shape} m={m} {np.dtype(dtype).name}"
                assert rel(yk, yp) <= TOL[dtype], what
                keep = torch.tensor(_untouched(tb, n), device=cuda_device)
                assert bool(keep[n]) and torch.equal(yk[keep], y0[keep]), what
                assert int(work.abs().sum()) == 0, what


@pytest.mark.cuda
@pytest.mark.parametrize("pairs", [False, True])
def test_cuda_sweep_repeats_with_one_work_buffer(cuda_device, pairs):
    """Lanes split over several blocks ((3, 32, 1024): 8 a lane; (2, 32,
    200): 2) swept again and again in all four modes with one ``work`` /
    ``part`` pair: the plain version's y every time, the counters back at
    zero after every launch, and the gathering modes (u, lt: partial sums
    added in a fixed order) bit-equal from one repeat to the next."""
    for shape in [(3, 32, 1024), (2, 32, 200)]:
        for m in (1, 64):
            C, y, tb = sweep_bucket(*shape, np.float64, 9, pairs, m=m)
            bk = sweep_bucket_on(tb, cuda_device)
            Ck = torch.tensor(C, device=cuda_device)
            y0 = torch.tensor(y, device=cuda_device)
            work, part = tsn.sweep_buffers([bk], m, Ck.dtype, cuda_device)
            assert part is not None
            for mode in MODES:
                yp = tref.sn_sweep_inplace_ref(
                    Ck, y0.clone(), bk.pidx, bk.qidx, bk.rows, bk.wvec,
                    bk.rvec, bk.bkm, mode=mode, pairs=pairs)
                first = None
                for _ in range(4):
                    yk = tsn.sn_sweep_inplace(Ck, y0.clone(), bk, mode,
                                              work=work, part=part)
                    torch.cuda.synchronize()
                    assert rel(yk, yp) <= TOL[np.float64]
                    assert int(work.abs().sum()) == 0
                    if mode in ("u", "lt"):
                        first = yk if first is None else first
                        assert torch.equal(yk, first)


@pytest.mark.cuda
@pytest.mark.parametrize("pairs", [False, True])
def test_cuda_direct_solve_matches_plain(cuda_device, pairs):
    """The whole supernodal route on the kernels — ``numeric_factor`` and
    ``factored_solve`` forward and transposed, 1 and 3 right-hand sides —
    against the same calls on the CPU (the plain versions), with one
    ``sn_sweep`` launch per bucket and sweep."""
    val, row, col = poisson2d_arrays(24)
    n = 24 * 24
    kw = {"supernodal": "on", "pivot_blocks": "auto" if pairs else None}
    art = td.symbolic_factor(row, col, n, **kw)
    nb = sum(len(lvl) for lvl in art.snode.schedule)
    on_card = td.to_device(art, cuda_device)
    on_cpu = td.to_device(art, "cpu")
    Ck = td.numeric_factor(on_card, torch.tensor(val, device=cuda_device))
    Cp = td.numeric_factor(on_cpu, torch.tensor(val))
    assert rel(Ck[:-2], Cp[:-2]) <= 1e-12
    B = np.random.default_rng(1).standard_normal((n, 3))
    for transposed in (False, True):
        for b in (B[:, 0], B):
            launches = tsn.LAUNCHES["sn_sweep"]
            xk = td.factored_solve(on_card, Ck, torch.tensor(
                b, device=cuda_device), transposed=transposed)
            torch.cuda.synchronize()
            assert tsn.LAUNCHES["sn_sweep"] == launches + 2 * nb
            xp = td.factored_solve(on_cpu, Cp, torch.tensor(b),
                                   transposed=transposed)
            assert rel(xk, xp) <= 1e-12


# ---------------------------------------------------------------------------
# slice 3: flash attention
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d,causal,S,T", [
    (torch.float32, 64, True, 256, 256), (torch.float32, 64, False, 128, 256),
    (torch.bfloat16, 128, True, 1000, 1000), (torch.float32, 16, True, 77, 77),
    (torch.bfloat16, 32, False, 65, 130)])
def test_flash_kernel_matches_plain_on_card(cuda_device, dtype, d, causal, S,
                                            T):
    from repro_torch import kernels
    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(rng.normal(size=(3, n, d)), dtype=dtype,
                            device=cuda_device) for n in (S, T, T))
    kernels.reset_launch_counts()
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    assert kernels.launch_counts()[
        "flash_attention" if bf16 else "flash_attention_f32"] == 1
    want = tref.flash_attention_ref(q.float(), k.float(), v.float(),
                                    causal=causal)
    diff = (out.float() - want).abs()
    rtol, atol = BF16_TOL if bf16 else (2e-5, 2e-5)
    assert bool((diff <= rtol * want.abs() + atol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [1, 2, 8])
def test_gqa_kernel_matches_plain_on_card(cuda_device, dtype, K):
    """The kernel reads strided (B, S, H, d) / (B, T, K, d) views in place:
    q sliced out of a fused projection, S ≠ T ragged."""
    B, S, T, H, d = 2, 300, 333, 8, 64
    rng = np.random.default_rng(K)
    qkv = torch.tensor(rng.normal(size=(B, S, H + 2 * K, d)), dtype=dtype,
                       device=cuda_device)
    q = qkv[:, :, :H]
    k, v = (torch.tensor(rng.normal(size=(B, T, K, d)), dtype=dtype,
                         device=cuda_device) for _ in range(2))
    out = flash_attention_gqa(q, k, v, causal=True)
    torch.cuda.synchronize()

    def heads(t):
        t = t.float().repeat_interleave(H // t.shape[2], dim=2)
        return t.permute(0, 2, 1, 3).reshape(B * H, t.shape[1], d)

    want = tref.flash_attention_ref(heads(q), heads(k), heads(v),
                                    causal=True).reshape(B, H, S, d)
    want = want.transpose(1, 2)
    rtol, atol = BF16_TOL if dtype == torch.bfloat16 else (2e-5, 2e-5)
    assert bool(((out.float() - want).abs() <= rtol * want.abs() + atol).all())


# ---------------------------------------------------------------------------
# the preconditioned Krylov path: the MG smoother on the stencil kernel, the
# AMG V-cycle, GMRES — each on the card against the CPU port (plain
# versions).  AMG sums with index_add_ (atomics on the card): its V-cycle is
# held to 1e-10 of its scale, and its iteration count must not move.
# ---------------------------------------------------------------------------

#: a whole V-cycle, card against CPU, relative to its output's scale
TOL_CYCLE = {torch.float64: 1e-10, torch.float32: 1e-4}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_mg_smoother_and_vcycle_match_plain(cuda_device, dtype):
    from repro_torch.core import multigrid as tmg
    from repro_torch.kernels import stencil5 as tks
    ng = 256
    rng = np.random.default_rng(3)
    kap = 1.0 + 0.5 * rng.random((ng, ng))
    M = tmg.MultigridPreconditioner(torch.tensor(kap, dtype=dtype,
                                                 device=cuda_device))
    tol_k = TOL[np.float64 if dtype == torch.float64 else np.float32]
    for v5 in M.levels[:-1]:
        n = v5.shape[1]
        inv = tmg._jacobi_weights(v5, M.omega)
        x, b = (torch.tensor(rng.normal(size=(n, n)), dtype=dtype,
                             device=cuda_device) for _ in range(2))
        before = tks.LAUNCHES["stencil5"]
        got = tmg._smooth(tmg._stencil_fn(v5), inv, x, b, 2)
        assert tks.LAUNCHES["stencil5"] == before + 2
        want = tmg._smooth(lambda y: tref.stencil5_ref(v5, y), inv, x, b, 2)
        assert rel(got, want) <= tol_k, (n, rel(got, want))
    r = torch.tensor(rng.normal(size=ng * ng), dtype=dtype)
    before = tks.LAUNCHES["stencil5"]
    z = M(r.to(cuda_device))
    torch.cuda.synchronize()
    assert tks.LAUNCHES["stencil5"] - before == 5 * (len(M.sizes) - 1)
    zc = tmg.MultigridPreconditioner(torch.tensor(kap, dtype=dtype))(r)
    assert rel(z, zc) <= TOL_CYCLE[dtype], rel(z, zc)


@pytest.mark.cuda
def test_cuda_mg_solve_iterations_match_cpu(cuda_device):
    from repro_torch import sla
    from repro_torch.data.poisson import poisson2d_vc
    ng = 128
    kap = 1.0 + 0.5 * np.random.default_rng(4).random((ng, ng))
    res = []
    for dev in (cuda_device, torch.device("cpu")):
        A = poisson2d_vc(torch.tensor(kap, device=dev),
                         use_stencil_kernel=True, device=dev)
        res.append(sla.solve_with_info(A, torch.ones(ng * ng,
                                                      dtype=torch.float64,
                                                      device=dev),
                                       tol=1e-10, precond="mg"))
    assert res[0].reason == res[1].reason == "converged"
    assert int(res[0].iterations) == int(res[1].iterations)
    assert rel(res[0].x, res[1].x) <= 1e-8


def _amg_graph(dev):
    from repro_torch.data.graphs import graph_laplacian
    return graph_laplacian(3000, seed=0, shift=1e-3, device=dev)


@pytest.mark.cuda
def test_cuda_amg_vcycle_matches_cpu(cuda_device):
    from repro_torch.core.precond import PreconditionerPlan
    from repro_torch.kernels import launch_counts, reset_launch_counts
    r = torch.tensor(np.random.default_rng(5).normal(size=3000))
    z = []
    for dev in (cuda_device, torch.device("cpu")):
        G = _amg_graph(dev)
        pre = PreconditionerPlan("amg", G.row, G.col, G.shape)
        reset_launch_counts()
        M = pre.make_apply(pre.refresh_state(G, None), None)
        z.append(M(r.to(dev)))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            n = launch_counts()
            # the coarsest level factorizes and solves on the panel kernels
            assert n["panel_factor"] > 0 and n["sn_sweep"] > 0
    assert rel(z[0], z[1]) <= TOL_CYCLE[torch.float64], rel(z[0], z[1])


@pytest.mark.cuda
def test_cuda_amg_iterations_stable_over_runs(cuda_device):
    """Three card solves, each with a fresh values tensor (a fresh Galerkin
    product, summed in a fresh atomic order), and the CPU's: one
    iteration count."""
    from repro_torch import sla
    iters = []
    for dev in (cuda_device,) * 3 + (torch.device("cpu"),):
        G = _amg_graph(dev)
        b = torch.ones(3000, dtype=torch.float64, device=dev)
        res = sla.solve_with_info(G.with_values(G.val.clone()), b,
                                  backend="jnp", method="cg", tol=1e-10,
                                  maxiter=2000, precond="amg")
        assert res.reason == "converged"
        iters.append(int(res.iterations))
    assert len(set(iters)) == 1, iters


@pytest.mark.cuda
def test_cuda_gmres_iterations_match_cpu(cuda_device):
    """GMRES(16) + block-Jacobi on a non-symmetric drift operator, through
    the block-ELL kernel on the card: the CPU port's cycle count."""
    from repro_torch import sla
    from repro_torch.core.sparse import SparseTensor
    ng = 32
    val, row, col = poisson2d_arrays(ng)
    val = val.copy()
    val[col == row - 1] = -1.4
    val[col == row + 1] = -0.6
    b = np.random.default_rng(6).normal(size=ng * ng)
    res = []
    for dev in (cuda_device, torch.device("cpu")):
        B = SparseTensor(val, row, col, (ng * ng, ng * ng), device=dev)
        res.append(sla.solve_with_info(
            B, torch.tensor(b, device=dev), backend="pallas", method="gmres",
            restart=16, tol=1e-10, maxiter=4000, precond="block_jacobi"))
    assert res[0].reason == res[1].reason == "converged"
    assert int(res[0].iterations) == int(res[1].iterations)
    assert rel(res[0].x, res[1].x) <= 1e-8
