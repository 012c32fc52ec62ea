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
                           jittered_lanes, not_proportional, np_of,
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


#: (B, S, T, H, K, d, causal) for the f32 kernel: G = H/K in {1, 2, 4, 8},
#: S from 1 to past the large tile, S < T and S > T; ``f32_tile`` picks the
#: 32-row tile for the first six and the 128-row tile for the last four
F32_CASES = [(1, 1, 1, 8, 8, 64, True), (2, 37, 37, 8, 4, 16, True),
             (1, 130, 70, 8, 1, 32, True), (2, 45, 300, 4, 1, 128, False),
             (1, 129, 129, 16, 2, 64, False), (3, 64, 200, 6, 3, 32, True),
             (4, 300, 300, 32, 8, 64, True), (24, 200, 333, 8, 8, 16, True),
             (8, 257, 129, 16, 2, 32, True), (90, 140, 140, 2, 1, 128, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(F32_CASES)))
def test_f32_flash_tiles_match_plain_on_card(cuda_device, case):
    """The f32 kernel at both of its tiles, q sliced out of a fused
    projection (k and v too where S = T), against the plain version on the
    expanded heads: |o − plain| <= 2e-5·(1 + |plain|) elementwise."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import f32_tile
    B, S, T, H, K, d, causal = F32_CASES[case]
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert f32_tile(B, H, K, S, sms)[0] == (32 if case < 6 else 128)
    rng = np.random.default_rng(case)
    f = lambda *shape: torch.tensor(rng.normal(size=shape),
                                    dtype=torch.float32, device=cuda_device)
    qkv = f(B, S, H + 2 * K, d)
    q = qkv[:, :, :H]
    k, v = ((qkv[:, :, H:H + K], qkv[:, :, H + K:]) if S == T else
            (f(B, T, K, d), f(B, T, K, d)))
    kernels.reset_launch_counts()
    out = flash_attention_gqa(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention_f32"] == 1

    def heads(t):
        t = t.repeat_interleave(H // t.shape[2], dim=2)
        return t.permute(0, 2, 1, 3).reshape(B * H, t.shape[1], d)

    want = tref.flash_attention_ref(heads(q), heads(k), heads(v),
                                    causal=causal)
    want = want.reshape(B, H, S, d).transpose(1, 2)
    assert bool(((out - want).abs() <= 2e-5 * (1 + want.abs())).all())


def _expanded(t, H):
    """(B, n, K, d) → (B·H, n, d) f32, KV head h // (H/K) for query head h."""
    B, n, K, d = t.shape
    t = t.float().repeat_interleave(H // K, dim=2)
    return t.permute(0, 2, 1, 3).reshape(B * H, n, d)


def _gqa_plain(q, k, v, causal, window=0):
    B, S, H, d = q.shape
    o = tref.flash_attention_ref(_expanded(q, H), _expanded(k, H),
                                 _expanded(v, H), causal=causal,
                                 window=window)
    return o.reshape(B, H, S, d).transpose(1, 2)


def _within(out, want, dtype):
    rtol, atol = BF16_TOL if dtype == torch.bfloat16 else (2e-5, 2e-5)
    return bool(((out.float() - want).abs() <= rtol * want.abs() + atol).all())


#: sliding windows: one key, a ragged band, a tile-sized band and
#: recurrentgemma's 2048, at S not a multiple of any tile (2600 for 2048, so
#: that the last blocks' bands start past tile 0)
WINDOWS = (1, 17, 128, 2048)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("window", WINDOWS)
def test_windowed_flash_matches_plain_on_card(cuda_device, dtype, d, window):
    """The band i − window < j ≤ i on both kernels (strided GQA views; at
    d 256 one KV head, as recurrentgemma's local layers) against the plain
    version on the expanded heads."""
    from repro_torch import kernels
    B, H, K = (1, 4, 2) if d == 64 else (1, 2, 1)
    S = 2600 if window == 2048 else 333
    rng = np.random.default_rng(window + d)
    qkv = torch.tensor(rng.normal(size=(B, S, H + 2 * K, d)), dtype=dtype,
                       device=cuda_device)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + K], qkv[:, :, H + K:]
    kernels.reset_launch_counts()
    out = flash_attention_gqa(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention" if dtype == torch.bfloat16
                                   else "flash_attention_f32"] == 1
    assert _within(out, _gqa_plain(q, k, v, True, window), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 256])
def test_window_zero_and_wide_window_are_bit_equal_on_card(cuda_device, dtype,
                                                           d):
    """window 0 is the call without the argument, and a window wider than
    every query's reach (S) takes the windowed branch to the same bits."""
    B, S, H, K = 2, 400, 4, 2
    rng = np.random.default_rng(d)
    q, k, v = (torch.tensor(rng.normal(size=(B, S, n, d)), dtype=dtype,
                            device=cuda_device) for n in (H, K, K))
    plain = flash_attention_gqa(q, k, v, causal=True)
    zero = flash_attention_gqa(q, k, v, causal=True, window=0)
    wide = flash_attention_gqa(q, k, v, causal=True, window=S)
    torch.cuda.synchronize()
    assert torch.equal(plain, zero)
    assert torch.equal(plain, wide)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_gqa_one_kv_head_d256_matches_plain_on_card(cuda_device, dtype,
                                                    causal):
    """K = 1 at head dim 256 (recurrentgemma's attention: H 10, K 1),
    causal with S = T and bidirectional with T ≠ S."""
    B, S, H = 2, 300, 10
    T = S if causal else 333
    rng = np.random.default_rng(int(causal))
    q = torch.tensor(rng.normal(size=(B, S, H, 256)), dtype=dtype,
                     device=cuda_device)
    k, v = (torch.tensor(rng.normal(size=(B, T, 1, 256)), dtype=dtype,
                         device=cuda_device) for _ in range(2))
    out = flash_attention_gqa(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert _within(out, _gqa_plain(q, k, v, causal), dtype)


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
@pytest.mark.parametrize("precond", ["mg", "amg"])
def test_cuda_one_lane_vcycle_on_k_rows(cuda_device, precond):
    """k right-hand sides of one matrix in ONE V-cycle on the card (MG: the
    levels on ``stencil5_batched`` with shared planes; AMG: one coarse
    factored solve with k columns): each row equals the V-cycle on that row
    alone, and the launches are one cycle's, whatever k."""
    from repro_torch.core.precond import PreconditionerPlan
    from repro_torch.data.poisson import poisson2d_vc
    from repro_torch.kernels import launch_counts, reset_launch_counts
    rng = np.random.default_rng(6)
    A = poisson2d_vc(torch.tensor(1.0 + 0.5 * rng.random((128, 128)),
                                  device=cuda_device),
                     use_stencil_kernel=True, device=cuda_device) \
        if precond == "mg" else _amg_graph(cuda_device)
    pre = PreconditionerPlan(precond, A.row, A.col, A.shape,
                             stencil=A.stencil)
    M = pre.make_apply(pre.refresh_state(A, None), None)
    R = torch.tensor(rng.normal(size=(5, A.shape[0])), device=cuda_device)

    def counted(r):
        reset_launch_counts()
        z = M(r)
        torch.cuda.synchronize()
        return z, {k: v for k, v in launch_counts().items() if v}
    _, one = counted(R[0])
    Z, many = counted(R)
    assert many == ({"stencil5_batched": one["stencil5"]} if precond == "mg"
                    else one), (one, many)
    for row in range(5):
        assert rel(Z[row], M(R[row])) <= TOL_CYCLE[torch.float64]


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


# ---------------------------------------------------------------------------
# slice 4: the kernels under torch.func, SparseNewton's assembly, LOBPCG
# ---------------------------------------------------------------------------

def _func_rules(product, dev):
    """(y, jvp tangent, vmap(jvp) over 3 probes, vjp in x and val) of one
    kernel product on ``dev``, on fixed seeded inputs."""
    if product == "bell":
        n = m = 300
        row, col, val, x = bell_case(n, m, 0.03, np.float64, 4)
        bell = bell_to_device(build_bell(row, col, (n, m)), dev)

        def f(v, xx):
            return tops.bell_matvec(bell, v, xx, n)
    else:
        nx, ny = 37, 41
        val, x = stencil_case(nx, ny, np.float64, 4)
        meta = Stencil5Meta(nx=nx, ny=ny)

        def f(v, xx):
            return tops.stencil5_matvec(meta, v, xx)
    rng = np.random.default_rng(9)
    t = lambda a: torch.tensor(a, device=dev)
    v, xx = t(val), t(x)
    dv, dx = t(rng.normal(size=val.shape)), t(rng.normal(size=x.shape))
    P = t(rng.normal(size=(3,) + x.shape))
    y, yd = torch.func.jvp(f, (v, xx), (dv, dx))
    Y = torch.func.vmap(lambda p: torch.func.jvp(
        lambda z: f(v, z), (xx,), (p,))[1])(P)
    _, pull = torch.func.vjp(f, v, xx)
    gv, gx = pull(t(rng.normal(size=y.shape)))
    return y, yd, Y, gv, gx


@pytest.mark.cuda
@pytest.mark.parametrize("product", ["bell", "stencil"])
def test_cuda_kernel_func_rules_match_plain(cuda_device, product):
    """``torch.func.jvp`` (both tangents), ``vmap`` over ``jvp`` and
    ``vjp`` through the kernel wrappers on the card, against the same
    rules on the plain versions (CPU)."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    card = _func_rules(product, cuda_device)
    torch.cuda.synchronize()
    name = "bell_spmv" if product == "bell" else "stencil5"
    lanes = "bell_spmm" if product == "bell" else "stencil5_batched"
    # y, two jvp terms, y under vmap, y under vjp (the stencil's Aᵀg
    # launches once more, on the transposed planes); the three probes
    # under vmap are one launch of the lane-batched kernel
    assert launch_counts()[name] == (5 if product == "bell" else 6)
    assert launch_counts()[lanes] == 1
    for a, b in zip(card, _func_rules(product, torch.device("cpu"))):
        assert rel(a, b) <= TOL[np.float64]


def _newton_problem(dev, ng=24):
    from repro_torch.core.sparse import SparseTensor
    val, row, col = poisson2d_arrays(ng)
    A = SparseTensor(val, row, col, (ng * ng, ng * ng),
                     build_kernel_layout=True, device=dev)
    f = torch.tensor(np.random.default_rng(2).normal(size=ng * ng),
                     device=dev)

    def F(u, th):
        return A.matvec(u, backend="pallas") + th * u ** 3 - f
    return A, F


@pytest.mark.cuda
def test_cuda_sparse_newton_assembly_matches_cpu(cuda_device):
    """One colored Jacobian assembly on the card (one ``bell_spmv`` launch
    for F, and the probe sweep's colors as ONE ``bell_spmm`` launch)
    against the CPU port's."""
    from repro_torch.core.nonlinear import SparseNewton
    from repro_torch.kernels import launch_counts, reset_launch_counts
    u = np.random.default_rng(3).normal(size=24 * 24)
    vals = []
    for dev in (cuda_device, torch.device("cpu")):
        A, F = _newton_problem(dev)
        sn = SparseNewton(F, A)
        reset_launch_counts()
        vals.append(sn.assemble(torch.tensor(u, device=dev),
                                torch.tensor(0.8, dtype=torch.float64,
                                             device=dev)))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert launch_counts()["bell_spmv"] == 1
            assert launch_counts()["bell_spmm"] == 1 and sn.n_colors > 1
    assert rel(vals[0], vals[1]) <= TOL[np.float64]


@pytest.mark.cuda
@pytest.mark.parametrize("precond", [None, "amg"])
def test_cuda_lobpcg_matches_cpu(cuda_device, precond):
    """LOBPCG ``eigsh`` on the card (block matvec on ``bell_spmv``) against
    the CPU port from the same seeded start block: eigenvalues, and
    eigenvectors up to sign."""
    from repro_torch.core.sparse import SparseTensor
    ng, cy = 16, 0.6
    val, row, col = poisson2d_arrays(ng)
    val = val.copy()
    val[np.abs(row - col) == 1] *= cy
    val[row == col] = 2.0 + 2.0 * cy
    res = []
    for dev in (cuda_device, torch.device("cpu")):
        A = SparseTensor(val, row, col, (ng * ng, ng * ng),
                         build_kernel_layout=True, device=dev)
        res.append(A.eigsh(k=4, tol=1e-10, maxiter=500, precond=precond))
    (w_c, V_c), (w, V) = res
    assert rel(w_c, w) <= 1e-10
    sign = torch.sign((V_c.cpu() * V).sum(1, keepdim=True))
    assert rel(V_c.cpu() * sign, V) <= 1e-6


# ---------------------------------------------------------------------------
# slice 5: the lane-batched kernels and the batched solve path
# ---------------------------------------------------------------------------

def _bitwise(a, b):
    return torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_bell_lanes_match_plain_and_single(cuda_device, dtype):
    """Batched values (x batched or shared) and SpMM: each against the
    lane-by-lane plain version, each lane bit-equal to ``bell_spmv`` on
    that lane, one lane equal to the single-vector entry point.  20 and 17
    lanes cross the kernel's 8-lane chunks."""
    from repro_torch.kernels.spmv_bell import (bell_spmm, bell_spmv,
                                               bell_spmv_batched)
    n, m = 300, 250
    row, col, val, _ = bell_case(n, m, 0.04, np.float64, 3)
    bell = bell_to_device(build_bell(row, col, (n, m)), cuda_device)
    sell = bell.sell
    rng = np.random.default_rng(4)
    t = lambda a: torch.tensor(a, dtype=dtype, device=cuda_device)
    V = t(val[None] * rng.uniform(0.5, 1.5, (20, 1)))
    X = t(rng.normal(size=(20, m)))
    packed = tops.sell_assemble(sell, V)
    p0 = tops.sell_assemble(sell, t(val))
    cases = [("values", bell_spmv_batched(sell, packed, X, n),
              lambda b: bell_spmv(sell, packed[b], X[b], n)),
             ("shared x", bell_spmv_batched(sell, packed, X[0], n),
              lambda b: bell_spmv(sell, packed[b], X[0], n)),
             ("spmm", bell_spmm(sell, p0, X[:17], n),
              lambda b: bell_spmv(sell, p0, X[b], n))]
    torch.cuda.synchronize()
    tl = tol(np.float32 if dtype == torch.float32 else np.float64)
    for label, Y, single in cases:
        assert Y.shape[1] == n, label
        for b in range(Y.shape[0]):
            assert _bitwise(Y[b], single(b)), (label, b)
        vv = packed if label != "spmm" else p0
        xx = X[0] if label == "shared x" else X[:Y.shape[0]]
        plain = tref.sell_matvec_lanes_ref(sell.slice_ptr, sell.cols, vv,
                                           xx, n)
        assert_close(Y, plain, **tl)
    Y1 = bell_spmv_batched(sell, packed[:1], X[:1], n)
    assert _bitwise(Y1[0], bell_spmv(sell, packed[0], X[0], n))


def _ragged_pattern(n=997, m=1013, seed=7):
    """(row, col) of n rows (not a multiple of 32) of very different
    widths: mostly 1–3 entries, every 37th row 10–39, row 5 300 entries,
    rows 17 and n − 1 empty."""
    rng = np.random.default_rng(seed)
    widths = rng.integers(1, 4, n)
    widths[::37] = rng.integers(10, 40, len(widths[::37]))
    widths[5], widths[17], widths[-1] = 300, 0, 0
    row = np.repeat(np.arange(n), widths).astype(np.int32)
    col = np.concatenate([rng.choice(m, w, replace=False)
                          for w in widths]).astype(np.int32)
    return row, col


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["values", "shared x", "spmm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_lane_kernel_every_chunk_split(cuda_device, dtype, layout):
    """B = 1 .. 33 lanes: every split into 8-, 4-, 2- and 1-lane chunks and
    both sides of each chunk edge, on a ragged pattern.  Each
    lane equals ``bell_spmv`` on that lane bit for bit; all lanes are
    within the kernel tolerance of the plain version, elementwise against
    the scale of |values|·|x|.  Every split is ONE launch."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.spmv_bell import (bell_spmm, bell_spmv,
                                               bell_spmv_batched, lane_chunks)
    n, m = 997, 1013
    row, col = _ragged_pattern(n, m)
    sell = bell_to_device(build_bell(row, col, (n, m)), cuda_device).sell
    rng = np.random.default_rng(11)
    t = lambda a: torch.tensor(a, dtype=dtype, device=cuda_device)
    V = tops.sell_assemble(sell, t(rng.normal(size=(33, len(row)))))
    X = t(rng.normal(size=(33, m)))
    tl = tol(np.float32 if dtype == torch.float32 else np.float64)
    sizes = set()
    for B in range(1, 34):
        if layout == "values":
            vv, xx, fn = V[:B], X[:B], bell_spmv_batched
        elif layout == "shared x":
            vv, xx, fn = V[:B], X[0], bell_spmv_batched
        else:
            vv, xx, fn = V[0], X[:B], bell_spmm
        reset_launch_counts()
        Y = fn(sell, vv, xx, n)
        assert Y.shape == (B, n)
        assert sum(launch_counts().values()) == 1, B
        for b in range(B):
            single = bell_spmv(sell, vv[b] if vv.dim() == 2 else vv,
                               xx[b] if xx.dim() == 2 else xx, n)
            assert _bitwise(Y[b], single), (B, b)
        plain = tref.sell_matvec_lanes_ref(sell.slice_ptr, sell.cols, vv,
                                           xx, n)
        scale = tref.sell_matvec_lanes_ref(sell.slice_ptr, sell.cols,
                                           vv.abs(), xx.abs(), n)
        assert bool(((Y - plain).abs()
                     <= tl["rtol"] * scale + tl["atol"]).all()), B
        sizes.update(c for c, _ in lane_chunks(B))
    assert sizes == {1, 2, 4, 8}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_stencil_lanes_match_plain_and_single(cuda_device, dtype):
    from repro_torch.kernels.stencil5 import stencil5, stencil5_batched
    nx, ny = 37, 300
    v, _ = stencil_case(nx, ny, np.float64, 1)
    rng = np.random.default_rng(2)
    t = lambda a: torch.tensor(a, dtype=dtype, device=cuda_device)
    V = t(v.reshape(5, nx, ny)[None] * rng.uniform(0.5, 1.5, (3, 1, 1, 1)))
    X = t(rng.normal(size=(4, nx, ny)))
    meta = Stencil5Meta(nx=nx, ny=ny)
    tl = tol(np.float32 if dtype == torch.float32 else np.float64)
    Y = stencil5_batched(meta, V, X[:3])
    Ys = stencil5_batched(meta, V[0], X)          # one operator, 4 rhs
    torch.cuda.synchronize()
    for b in range(3):
        assert _bitwise(Y[b], stencil5(meta, V[b], X[b]))
    for b in range(4):
        assert _bitwise(Ys[b], stencil5(meta, V[0], X[b]))
    assert_close(Y, tref.stencil5_lanes_ref(V, X[:3]), **tl)
    assert_close(Ys, tref.stencil5_lanes_ref(V[0], X), **tl)
    assert _bitwise(stencil5_batched(meta, V[:1], X[:1])[0],
                    stencil5(meta, V[0], X[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FUSED_SIGS))
def test_cuda_fused_lanes_match_plain_and_single(cuda_device, name):
    """(B, n) lanes with the last vector shared and per-lane scalars: the
    plain version, each lane bit-equal to the single-vector kernel on that
    lane (outputs and dots), one lane equal to the unbatched call, and the
    active mask leaving the inactive lanes' outputs untouched."""
    n_vec, n_sc = FUSED_SIGS[name]
    fn = getattr(tfk, name)
    _, _, _, n_out, _ = tfk.BODIES[name]
    for B, n in ((4, 300_001), (3, 1029)):
        rng = np.random.default_rng(n)
        t = lambda a: torch.tensor(a, device=cuda_device)
        vecs = [t(rng.normal(size=(B, n))) for _ in range(n_vec - 1)]
        vecs.append(t(rng.normal(size=n)))
        sc = [t(rng.normal(size=B)) for _ in range(n_sc)]
        if name == "fused_bicg_p":
            sc[2] = t(np.array([0.0, 1.0, 0.0, 0.0][:B]))
        out = fn(*vecs, *sc)
        torch.cuda.synchronize()
        for b in range(B):
            one = fn(*[v[b] if v.dim() == 2 else v for v in vecs],
                     *[s[b] for s in sc])
            for got, want in zip(out, one):
                assert _bitwise(got[b], want), (name, b)
        plain = tref.fused_step_lanes_ref(name, vecs, sc, B)
        for got, want in zip(out, plain):
            assert_close(got, want, rtol=1e-10, atol=1e-9)
        first = fn(*[v[:1] if v.dim() == 2 else v for v in vecs],
                   *[s[:1] for s in sc])
        single = fn(*[v[0] if v.dim() == 2 else v for v in vecs],
                    *[s[0] for s in sc])
        for got, want in zip(first, single):
            assert _bitwise(got[0], want)
        if n_out:
            dst = [torch.full((B, n), 7.25, dtype=torch.float64,
                              device=cuda_device) for _ in range(n_out)]
            act = torch.tensor([1, 0] * B, dtype=torch.int32,
                               device=cuda_device)[:B]
            fn(*vecs, *sc, out=dst, active=act)
            torch.cuda.synchronize()
            for o, want in zip(dst, out):
                assert bool((o[1] == 7.25).all())
                assert _bitwise(o[0], want[0])


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["pallas", "stencil"])
def test_cuda_batched_solve_matches_single_solves(cuda_device, backend):
    """Batched values through ``solve_with_info`` on the lane-batched
    kernels: per-lane iteration counts equal the single solves', the
    solutions agree, and the single-vector kernels are not launched."""
    from repro_torch import kernels, sla
    from repro_torch.data.poisson import poisson2d, poisson2d_vc
    ng = 40
    if backend == "stencil":
        kap = torch.tensor(1.0 + 0.5 * np.random.default_rng(0).random(
            (ng, ng)), device=cuda_device)
        A = poisson2d_vc(kap, use_stencil_kernel=True, device=cuda_device)
    else:
        A = poisson2d(ng, device=cuda_device)
    scales = (1.0, 1.3, 0.7, 0.9)
    vals = torch.stack([A.val * s for s in scales])
    b = torch.ones(ng * ng, dtype=torch.float64, device=cuda_device)
    kw = dict(backend=backend, method="cg", tol=1e-10)
    kernels.reset_launch_counts()
    res = sla.solve_with_info(A.with_values(vals), b, **kw)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    spmv = "stencil5" if backend == "stencil" else "bell_spmv"
    assert counts[spmv + "_batched"] > 0
    assert counts["fused_cg_update_batched"] > 0
    assert counts[spmv] == counts["fused_cg_update"] == 0
    for lane, s in enumerate(scales):
        one = sla.solve_with_info(A.with_values(A.val * s), b, **kw)
        assert int(res.iterations[lane]) == int(one.iterations)
        assert_close(res.x[lane], one.x, rtol=1e-9, atol=1e-11)


@pytest.mark.cuda
def test_cuda_multi_rhs_block_cg_and_direct(cuda_device):
    """k right-hand sides on one matrix: block CG on ``bell_spmm`` and one
    direct factorization with ``sn_sweep`` carrying the k columns, both
    against the CPU port."""
    from repro_torch import kernels, sla
    from repro_torch.core import dispatch as D
    from repro_torch.data.poisson import poisson2d
    B = np.random.default_rng(3).normal(size=(8, 576))
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        A = poisson2d(24, device=dev)           # n > 512: supernodal
        Bt = torch.tensor(B, device=dev)
        kernels.reset_launch_counts()
        D.reset_plan_stats()
        X = sla.solve(A, Bt, backend="pallas", method="block_cg", tol=1e-11)
        Xd = sla.solve(A, Bt, backend="direct")
        out[dev.type] = (X.cpu(), Xd.cpu(), kernels.launch_counts(),
                         dict(D.PLAN_STATS))
    X, Xd, counts, stats = out["cuda"]
    assert counts["bell_spmm"] > 0 and counts["sn_sweep"] > 0
    assert stats["factorize"] == 1
    assert_close(X, out["cpu"][0], rtol=1e-8, atol=1e-10)
    assert_close(Xd, out["cpu"][1], rtol=1e-10, atol=1e-12)


@pytest.mark.cuda
def test_cuda_solve_server_smoke(cuda_device):
    from repro_torch.launch.solve_serve import serve
    rep = serve(n_requests=16, grid=12, n_patterns=2, max_batch=8,
                backend="pallas", check=True, device=cuda_device)
    assert rep["converged"] and rep["occupancy"] == 1.0
    assert rep["plan_stats"]["analyze"] == 2


# ---------------------------------------------------------------------------
# slice 5b: the lane-stacked panel kernels (B value lanes of one pattern in
# one launch) and the batched direct route and preconditioners
# ---------------------------------------------------------------------------

LANES = (1, 3, 8)


def _lane_scales(B):
    return np.random.default_rng(B).uniform(0.7, 1.4, B)


@pytest.mark.cuda
@pytest.mark.parametrize("pairs", [False, True])
@pytest.mark.parametrize("B", LANES)
def test_cuda_lane_panel_factor_and_schur_match_plain(cuda_device, B, pairs):
    """``panel_factor`` and ``schur_update`` on a (B, nnzF+2) stack with a
    per-lane τ in ONE launch each: the plain version lane by lane (1e-12 of
    the scale), the single-lane launch on lane b's values (panel_factor bit
    for bit; schur_update, which scatters with atomics, to 1e-13), per-lane
    clamp counts, the sink untouched."""
    for shape in SHAPES + [(3, 32, 1024), (7, 3, 5)]:
        b = inplace_bucket(*shape, np.float64, 3, pairs)
        s = _lane_scales(B)
        C = np.stack([b["C"] * sc for sc in s])
        C[:, b["sink"]] = 7.25
        tau = 0.5 * s
        t = lambda a, dev=cuda_device: torch.tensor(a, device=dev)
        args = lambda dev: (t(b["pidx"], dev), t(b["qidx"], dev),
                            t(b["w"], dev), t(b["r"], dev))
        Ck, Cp = t(C), t(C, "cpu")
        n0 = tsn.LAUNCHES["panel_factor_lanes"]
        nbk = tsn.panel_factor_inplace(Ck, *args(cuda_device), t(tau),
                                       t(b["bkm"]), pairs=pairs)
        torch.cuda.synchronize()
        assert tsn.LAUNCHES["panel_factor_lanes"] == n0 + 1
        nbp = tsn.panel_factor_inplace(Cp, *args("cpu"), t(tau, "cpu"),
                                       t(b["bkm"], "cpu"), pairs=pairs)
        assert nbk.tolist() == nbp.tolist()
        Sk, Sp = Ck.clone(), Cp.clone()
        n0 = tsn.LAUNCHES["schur_update_lanes"]
        tsn.schur_update_inplace(Sk, *args(cuda_device), t(b["tgt"]),
                                 t(b["toff"]))
        torch.cuda.synchronize()
        assert tsn.LAUNCHES["schur_update_lanes"] == n0 + 1
        tsn.schur_update_inplace(Sp, *args("cpu"), t(b["tgt"], "cpu"),
                                 t(b["toff"], "cpu"))
        for lane in range(B):
            assert rel(Ck[lane], Cp[lane]) <= TOL[np.float64], (shape, lane)
            assert rel(Sk[lane], Sp[lane]) <= TOL[np.float64], (shape, lane)
            assert float(Sk[lane, b["sink"]]) == 7.25
            C1 = t(C[lane])
            nb1 = tsn.panel_factor_inplace(C1, *args(cuda_device),
                                           float(tau[lane]), t(b["bkm"]),
                                           pairs=pairs)
            assert torch.equal(C1, Ck[lane]) and float(nb1) == nbp[lane]
            tsn.schur_update_inplace(C1, *args(cuda_device), t(b["tgt"]),
                                     t(b["toff"]))
            torch.cuda.synchronize()
            assert rel(C1, Sk[lane]) <= 1e-13


@pytest.mark.cuda
@pytest.mark.parametrize("pairs", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_cuda_lane_sweep_matches_plain(cuda_device, mode, pairs):
    """One ``sn_sweep`` launch on B value lanes ((B, nnzF+2) factors,
    (B, n+1, m) y), B in 1, 3, 8 and m in 1, 5, lanes split over several
    blocks: the plain version lane by lane, the single-lane launch on lane
    b (bit for bit in the gathering modes u / lt; the scattering modes l /
    ut add with atomics: 1e-13), the rows no live entry names kept, the
    counters back at zero, one launch whatever B."""
    for shape in [(5, 8, 16), (7, 3, 5), (3, 32, 1024), (2, 32, 200)]:
        for m in (1, 5):
            C, y, tb = sweep_bucket(*shape, np.float64, 5 + m, pairs, m=m)
            n = y.shape[0] - 1
            bk = sweep_bucket_on(tb, cuda_device)
            keep = torch.tensor(_untouched(tb, n), device=cuda_device)
            for B in LANES:
                s = _lane_scales(B)
                Cs = torch.tensor(np.stack([C * sc for sc in s]),
                                  device=cuda_device)
                rng = np.random.default_rng(B + m)
                Y = rng.normal(size=(B, n + 1, m))
                Y[:, n] = 7.25
                Y0 = torch.tensor(Y, device=cuda_device)
                work, part = tsn.sweep_buffers([bk], m, Cs.dtype,
                                               cuda_device, B)
                n0 = tsn.LAUNCHES["sn_sweep_lanes"]
                Yk = tsn.sn_sweep_inplace(Cs, Y0.clone(), bk, mode,
                                          work=work, part=part)
                torch.cuda.synchronize()
                assert tsn.LAUNCHES["sn_sweep_lanes"] == n0 + 1
                assert int(work.abs().sum()) == 0
                Yp = tref.sn_sweep_inplace_ref(
                    Cs, Y0.clone(), bk.pidx, bk.qidx, bk.rows, bk.wvec,
                    bk.rvec, bk.bkm, mode=mode, pairs=pairs)
                what = f"{shape} m={m} B={B}"
                for lane in range(B):
                    assert rel(Yk[lane], Yp[lane]) <= TOL[np.float64], what
                    assert torch.equal(Yk[lane][keep], Y0[lane][keep]), what
                    y1 = tsn.sn_sweep_inplace(Cs[lane].clone(),
                                              Y0[lane].clone(), bk, mode)
                    torch.cuda.synchronize()
                    if mode in ("u", "lt"):
                        assert torch.equal(y1, Yk[lane]), what
                    else:
                        assert rel(y1, Yk[lane]) <= 1e-13, what


@pytest.mark.cuda
@pytest.mark.parametrize("pairs", [False, True])
def test_cuda_lane_direct_route_matches_plain(cuda_device, pairs):
    """``numeric_factor`` on (B, nnz) values and ``factored_solve`` on the
    (B, nnzF+2) stack, forward and transposed, with (B, n) and (B, n, 3)
    right-hand sides: the CPU port lane by lane (1e-12), each lane's single
    factorization on the card (1e-13: schur_update's atomics), and ONE
    launch per bucket and kernel for the stack."""
    val, row, col = poisson2d_arrays(24)
    n = 24 * 24
    kw = {"supernodal": "on", "pivot_blocks": "auto" if pairs else None}
    art = td.symbolic_factor(row, col, n, **kw)
    nb = sum(len(lvl) for lvl in art.snode.schedule)
    on_card, on_cpu = td.to_device(art, cuda_device), td.to_device(art, "cpu")
    B = 3
    V = np.stack([val * sc for sc in _lane_scales(B)])
    before = dict(tsn.LAUNCHES)
    Ck = td.numeric_factor(on_card, torch.tensor(V, device=cuda_device))
    torch.cuda.synchronize()
    for name in ("panel_factor_lanes", "schur_update_lanes"):
        assert tsn.LAUNCHES[name] == before[name] + nb
    Cp = td.numeric_factor(on_cpu, torch.tensor(V))
    for lane in range(B):
        assert rel(Ck[lane, :-2], Cp[lane, :-2]) <= 1e-12
        C1 = td.numeric_factor(on_card, torch.tensor(V[lane],
                                                     device=cuda_device))
        assert rel(C1[:-2], Ck[lane, :-2]) <= 1e-13
    R = np.random.default_rng(1).standard_normal((B, n, 3))
    for transposed in (False, True):
        for rhs in (R[..., 0], R):
            n0 = tsn.LAUNCHES["sn_sweep_lanes"]
            xk = td.factored_solve(on_card, Ck, torch.tensor(
                rhs, device=cuda_device), transposed=transposed)
            torch.cuda.synchronize()
            assert tsn.LAUNCHES["sn_sweep_lanes"] == n0 + 2 * nb
            xp = td.factored_solve(on_cpu, Cp, torch.tensor(rhs),
                                   transposed=transposed)
            assert rel(xk, xp) <= 1e-12


def _slice_5b_route(dev, precond, proportional):
    """Stacked values through ``precond`` (or the direct route) on the
    card: one setup for the stack, each lane its single solve on the card
    (iterations equal), the lane-stacked kernels launched.  Lanes are
    scaled copies of one matrix, or (``proportional=False``) each entry
    jittered on its own (a random κ per lane for MG)."""
    from repro_torch import kernels, sla
    from repro_torch.core import dispatch as D
    from repro_torch.data.poisson import poisson2d, poisson2d_vc
    B = 4
    rng = np.random.default_rng(0)
    if precond == "mg":
        kaps = [torch.tensor(1.0 + 0.5 * rng.random((64, 64)), device=dev)
                for _ in range(B if not proportional else 1)]
        ops = [poisson2d_vc(k, use_stencil_kernel=True, device=dev)
               for k in kaps]
        A = ops[0]
        kw = dict(backend="stencil", method="cg", precond="mg", tol=1e-10)
    else:
        A = poisson2d(24, device=dev)
        kw = dict(backend="direct") if precond == "direct" else \
            dict(backend="pallas", method="cg", precond=precond, tol=1e-10)
    if proportional:
        vals = torch.stack([A.val * float(sc) for sc in _lane_scales(B)])
    elif precond == "mg":
        vals = torch.stack([op.val for op in ops])
    else:
        vals = torch.tensor(jittered_lanes(np_of(A.row), np_of(A.col),
                                           np_of(A.val), B, seed=7),
                            device=dev)
    b = torch.ones(A.shape[0], dtype=torch.float64, device=dev)
    kernels.reset_launch_counts()
    D.reset_plan_stats()
    res = sla.solve_with_info(A.with_values(vals), b, **kw)
    counts = kernels.launch_counts()
    assert D.PLAN_STATS["setup"] == 1
    want = {"direct": "sn_sweep_lanes", "amg": "sn_sweep_lanes",
            "mg": "stencil5_batched", "chebyshev": "bell_spmv_batched",
            "ilu": "bell_spmv_batched"}[precond]
    assert counts[want] > 0, counts
    if not proportional:
        assert not_proportional(res.x) > 1e-3
    for lane in range(B):
        one = sla.solve_with_info(A.with_values(vals[lane].clone()), b, **kw)
        assert int(res.iterations[lane]) == int(one.iterations)
        assert_close(res.x[lane], one.x, rtol=1e-9, atol=1e-11)


@pytest.mark.cuda
@pytest.mark.parametrize("precond", ["direct", "amg", "mg", "chebyshev",
                                     "ilu"])
def test_cuda_batched_values_slice_5b_routes(cuda_device, precond):
    """Stacked values, lanes scaled copies of one matrix, through the direct
    route and CG + MG / AMG / Chebyshev / ILU on the card."""
    _slice_5b_route(cuda_device, precond, proportional=True)


@pytest.mark.cuda
@pytest.mark.parametrize("precond", ["direct", "amg", "mg", "chebyshev",
                                     "ilu"])
def test_cuda_batched_values_lanes_not_proportional(cuda_device, precond):
    """The same routes on lanes that are not multiples of one another (AMG,
    MG and ILU(0) are homogeneous in the values, so scaled lanes cannot
    show a lane applied on another lane's state)."""
    _slice_5b_route(cuda_device, precond, proportional=False)


# ---------------------------------------------------------------------------
# slice 6: the distributed layer's local product, shard dots and halo
# ---------------------------------------------------------------------------

def _dist_tensor(device, p, nonsym=False, ng=48):
    from repro_torch.core.distributed import DSparseTensor, make_mesh
    v, r, c = poisson2d_arrays(ng)
    if nonsym:
        v = v.copy()
        v[c == r - 1] = -1.4
        v[c == r + 1] = -0.6
    n = ng * ng
    return DSparseTensor.from_global(v, r, c, (n, n),
                                     make_mesh(p, device=device),
                                     symmetric=not nonsym)


@pytest.mark.cuda
@pytest.mark.parametrize("nonsym", [False, True])
def test_cuda_dist_stack_spmv_matches_coo(cuda_device, nonsym):
    """The rank's block-diagonal stack SpMV (P = 4 shards, pads left out
    of the layout) on ``bell_spmv``, forward and transpose, against
    ``coo_matvec`` on the same stack."""
    from repro_torch.core.sparse import coo_matvec
    from repro_torch.kernels import spmv_bell
    D = _dist_tensor(cuda_device, 4, nonsym)
    op = D._local_op()
    assert op.sell is not None and op.sell.n_rows == op.n_rows
    assert int((op.sell.spos >= 0).sum()) == sum(D.meta.shard_nnz)
    rng = np.random.default_rng(6)
    x_ext = torch.tensor(rng.normal(size=(4, op.n_ext)), device=cuda_device)
    g = torch.tensor(rng.normal(size=(4, op.n_loc)), device=cuda_device)
    vals = D.lval.reshape(-1)[op.vidx]
    before = spmv_bell.LAUNCHES["bell_spmv"]
    y = op.apply(D.lval, op.pack(D.lval), x_ext)
    assert spmv_bell.LAUNCHES["bell_spmv"] == before + 1
    y_plain = coo_matvec(vals, op.row, op.col, x_ext.reshape(-1), op.n_rows)
    assert rel(y.reshape(-1), y_plain) <= 1e-12
    yt = op.apply_t(D.lval, g)
    yt_plain = coo_matvec(vals, op.col, op.row, g.reshape(-1), op.n_cols)
    assert rel(yt.reshape(-1), yt_plain) <= 1e-12
    with pytest.raises(TypeError):
        op.apply(D.lval, op.pack(D.lval), x_ext.float())


@pytest.mark.cuda
def test_cuda_dist_shard_dots_match_plain(cuda_device):
    """The per-shard partials from one lane-batched ``fused_dots2`` launch
    (shards as lanes) against the plain sums, and lane by lane equal to a
    one-shard launch bit for bit (a shard's partial does not depend on the
    shards beside it)."""
    from repro_torch.core import distributed as tdist
    rng = np.random.default_rng(7)
    U = torch.tensor(rng.normal(size=(2, 4, 100_003)), device=cuda_device)
    v = torch.tensor(rng.normal(size=(4, 100_003)), device=cuda_device)
    before = tfk.LAUNCHES["fused_dots2_batched"]
    d1, d2 = tdist._stack_dots2(U, v)
    assert tfk.LAUNCHES["fused_dots2_batched"] == before + 1
    assert rel(d1, (U * v).sum(-1)) <= 1e-12
    assert rel(d2, (U * U).sum(-1)) <= 1e-12
    for j in range(2):
        for q in range(4):
            one = tdist._stack_dots2(U[j:j + 1, q:q + 1].contiguous(),
                                     v[q:q + 1].contiguous())[0]
            assert torch.equal(one.reshape(()), d1[j, q])


@pytest.mark.cuda
def test_cuda_dist_halo_adjoint(cuda_device):
    """⟨Hx, y⟩ = ⟨x, Hᵀy⟩ on CUDA tensors, and H, Hᵀ equal to the CPU's
    bit for bit (they only move values and add pairs)."""
    from repro_torch.core import distributed as tdist
    mesh = tdist.make_mesh(8, device=cuda_device)
    prog = tdist.halo_program(2, 3, mesh)
    rng = np.random.default_rng(8)
    x = torch.tensor(rng.normal(size=(8, 24)), device=cuda_device)
    y = torch.tensor(rng.normal(size=(8, 29)), device=cuda_device)
    hx = tdist._halo_run(prog, x)
    hty = tdist._halo_run_t(prog, y)
    lhs = float((hx * y).sum())
    assert abs(lhs - float((x * hty).sum())) <= 1e-12 * abs(lhs)
    cpu = tdist.halo_program(2, 3, tdist.make_mesh(8, device="cpu"))
    assert torch.equal(hx.cpu(), tdist._halo_run(cpu, x.cpu()))
    assert torch.equal(hty.cpu(), tdist._halo_run_t(cpu, y.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("precond", ["jacobi", "schwarz2"])
def test_cuda_dist_solve_and_grad_match_cpu(cuda_device, precond):
    """A P = 4 solve with its values gradient on the card's kernels
    against the same solve on the CPU's plain versions."""
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        D = _dist_tensor(dev, 4, ng=32)
        lv = D.lval.clone().requires_grad_(True)
        b = D.stack_vector(torch.ones(32 * 32, dtype=torch.float64,
                                      device=dev))
        x = D.with_values(lv).solve(b, tol=1e-12, maxiter=4000,
                                    precond=precond)
        (x * x).sum().backward()
        out[dev.type] = (x.detach().cpu(), lv.grad.cpu())
    assert rel(out["cuda"][0], out["cpu"][0]) <= 1e-10
    assert rel(out["cuda"][1], out["cpu"][1]) <= 1e-8


# ---------------------------------------------------------------------------
# slice 8: training — the differentiable flash kernel, a train step, AdamW
# ---------------------------------------------------------------------------

#: dq/dk/dv of the autograd Function (the kernel's forward, the blocked
#: plain backward) against autograd through the plain version on f32 copies
#: of the same inputs, max |Δ| over max |g_plain|: f32 at the forward's
#: 1e-5; bf16 at 1e-2 (the kernel's o, which the backward reads, and each
#: gradient are rounded to bf16: 2^-9 relative each)
GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("mode", ["causal", "bidir", "window"])
def test_flash_autograd_matches_plain_on_card(cuda_device, dtype, d, mode):
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import _plain
    B, S, H, K = 2, 300, 4, 2              # S not a multiple of any tile
    causal, window = mode != "bidir", 100 if mode == "window" else 0
    rng = np.random.default_rng(d)
    q, k, v, w = (torch.tensor(rng.normal(size=(B, S, h, d)), dtype=dtype,
                               device=cuda_device)
                  for h in (H, K, K, H))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    kernels.reset_launch_counts()
    o = flash_attention_gqa(*leaves, causal=causal, window=window)
    # the flash op's own registered backward, not autograd through plain ops
    assert "repro_torch_flash_attention_gqa" in type(o.grad_fn).__name__
    (o.float() * w.float()).sum().backward()
    torch.cuda.synchronize()
    assert kernels.launch_counts()[
        "flash_attention" if dtype == torch.bfloat16
        else "flash_attention_f32"] == 1
    plain = [t.float().requires_grad_(True) for t in (q, k, v)]
    (_plain(*plain, causal, window) * w.float()).sum().backward()
    for got, want in zip(leaves, plain):
        assert got.grad.dtype == dtype
        scale = float(want.grad.abs().max())
        assert float((got.grad.float() - want.grad).abs().max()) \
            <= GRAD_TOL[dtype] * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_gradients_on_card(cuda_device, dtype):
    """One smoke llama train step's loss and gradients on the card: every
    parameter's gradient present, finite and nonzero, the flash kernel in
    the forward; the loss within 1e-4 (f32) / 2e-2 (bf16) of the CPU's."""
    import dataclasses
    from repro_torch import kernels
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.launch.train import loss_fn
    from repro_torch.models.transformer import Transformer
    cfg = dataclasses.replace(smoke_variant(get_config("llama3.2-1b")),
                              dtype=dtype, remat="full")
    batch = synthetic_batch(0, 0, 4, 129, cfg.vocab)
    weights = Transformer(cfg, seed=0, device="cpu").state_dict()
    losses = {}
    for dev in (cuda_device, torch.device("cpu")):
        model = Transformer(cfg, seed=0, device=dev)
        model.load_state_dict(weights)        # the same numbers on both
        kernels.reset_launch_counts()
        total, m = loss_fn(model, {k: t.to(dev) for k, t in batch.items()}, 2)
        total.backward()
        losses[dev.type] = float(m["loss"])
        if dev.type == "cuda":
            torch.cuda.synchronize()
            name = ("flash_attention" if dtype == "bfloat16"
                    else "flash_attention_f32")
            # the forward and the remat recompute, per layer
            assert kernels.launch_counts()[name] == 2 * cfg.n_layers
            for n, p in model.named_parameters():
                assert p.grad is not None, n
                assert bool(torch.isfinite(p.grad).all()), n
                assert float(p.grad.abs().max()) > 0, n
    tol = 1e-4 if dtype == "float32" else 2e-2
    assert abs(losses["cuda"] - losses["cpu"]) <= tol * losses["cpu"]


@pytest.mark.cuda
def test_adamw_on_card_matches_cpu(cuda_device):
    from repro_torch.optim.adamw import AdamWConfig, adamw_update
    rng = np.random.default_rng(2)
    shapes = {"w": (64, 48), "b": (48,), "e": (4, 8, 16)}
    mk = lambda f: {k: f(s).astype(np.float32)  # noqa: E731
                    for k, s in shapes.items()}
    p, g = mk(lambda s: rng.normal(size=s)), mk(
        lambda s: 3 * rng.normal(size=s))
    m, v = mk(lambda s: 0.1 * rng.normal(size=s)), mk(
        lambda s: 0.01 * rng.uniform(size=s))
    cfg = AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=20)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        T = lambda d: {k: torch.tensor(a, device=dev)  # noqa: E731
                       for k, a in d.items()}
        out[dev.type] = adamw_update(cfg, T(p), T(g), {
            "m": T(m), "v": T(v),
            "step": torch.tensor(5, dtype=torch.int32, device=dev)})
    (cp, cs, cm), (hp, hs, hm) = out["cuda"], out["cpu"]
    assert abs(float(cm["lr"]) - float(hm["lr"])) <= 1e-6 * cfg.lr
    for k in shapes:
        for a, b in ((cp[k], hp[k]), (cs["m"][k], hs["m"][k]),
                     (cs["v"][k], hs["v"][k])):
            assert a.device.type == "cuda"
            assert float((a.cpu() - b).abs().max()) \
                <= 1e-6 * float(b.abs().max())


# ---------------------------------------------------------------------------
# slice 9: the flash kernel under sharding (``local_map`` on a 1-rank mesh)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """A (pod, data, model) = (1, 1, 1) mesh over a one-rank NCCL group (a
    file store, no port), or a skip without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the NCCL mesh and the kernel run "
                    "only on the card")
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    store = tmp_path_factory.mktemp("nccl") / "store"
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    try:
        yield init_device_mesh("cuda", (1, 1, 1),
                               mesh_dim_names=("pod", "data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("S,T,H,K,d,causal", [
    (1000, 1000, 4, 4, 128, True), (65, 130, 2, 2, 32, False),
    (300, 333, 8, 1, 64, True), (300, 333, 8, 2, 64, True),
    (300, 333, 8, 8, 64, True)])
def test_sharded_flash_matches_plain_on_card(nccl_mesh, S, T, H, K, d,
                                             causal):
    """Row 7's bf16 sweep through ``models.attention._sharded_flash``: q, k,
    v as ``DTensor``\\ s sharded by batch and heads, the kernel launched
    once under ``local_map`` on the local shards, the output against the
    plain version."""
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch import kernels
    from repro_torch.models.attention import _sharded_flash
    B = 2
    rng = np.random.default_rng(S + H + K)
    q, k, v = (torch.tensor(rng.normal(size=(B, n, h, d)),
                            dtype=torch.bfloat16, device="cuda")
               for n, h in ((S, H), (T, K), (T, K)))
    pl = [Shard(0), Shard(0), Shard(2)]
    dq, dk, dv = (distribute_tensor(t, nccl_mesh, pl, src_data_rank=None)
                  for t in (q, k, v))
    kernels.reset_launch_counts()
    out = _sharded_flash(dq, dk, dv, causal=causal, window=0)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention"] == 1
    assert tuple(out.placements) == tuple(pl)
    want = _gqa_plain(q, k, v, causal)
    assert _within(out.full_tensor(), want, torch.bfloat16)
