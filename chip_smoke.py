#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

    python3 chip_smoke.py            # one NVIDIA GPU; builds the kernels

What it does, in order:

1. prints the card (``nvidia-smi`` name and power limit) and builds the
   hand-written CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc;
2. kernel phase: every kernel (stencil5, block-ELL SpMV, the 8 fused
   solve-step bodies) against its plain PyTorch version on the card, in f32
   and f64, at the main-path shapes and one ragged small shape, with its
   time, the plain version's time, its bound and — where one PyTorch call
   computes the same function — that call's time (``library_ms``); the
   block-ELL SpMV reads the sliced-ELL layout of its block-ELL plan and is
   also held to the product on the reference's dense tiles, its bound
   counts the nonzeros (CSR bytes), and the segment-sum ``coo_matvec`` is
   timed beside the CSR call;
   before the phases, nvcc's ``-Xptxas -v`` registers, shared memory and
   spills of the SpMV and flash kernels;
3. stencil path: ``poisson2d_vc(κ)`` at ng=2048 (4.19M unknowns, f64),
   ``sla.solve`` (auto → stencil backend, CG, Jacobi, fused steps) and
   ∂Σu²/∂κ, checked against the same run on the plain COO path;
4. block-ELL path: ``poisson2d(1024)`` with ``backend="pallas"``, solve and
   ∂/∂val, checked the same way; peak device memory (at most 1.25 GB: no
   dense tiles) and ms per iteration;
5. default general path: ``poisson2d(1024)`` with ``backend="jnp"``, CG and
   BiCGStab (the kernel plan keeps COO: block-ELL fill is below the gate);
6. solver-level path: ``cg_fused`` with a fused Chebyshev preconditioner,
   the caller of the halfstep and cheb_step bodies;
7. transposed paths: non-symmetric operators at ng=256 (a drift term
   scales the N/S couplings unequally), BiCGStab, whose adjoint solves run
   the stencil kernel on transposed planes and block-ELL on Aᵀ's layout
   (``t_bell``); solved to tol 1e-10, ∂Σu²/∂(κ, val) checked against the
   plain COO path;
8. direct path (the slice's main path): ``poisson2d(316)`` (99,856
   unknowns, f64), ``sla.solve`` auto-routed to the supernodal LDLᵀ, ∂Σu²/∂val
   against a CG run at tol 1e-12, then a ``with_values`` refactorization,
   whose profiler trace must hold ``panel_factor`` and ``schur_update`` once
   per bucket and no per-bucket gather, scatter or ``index_add_``; the
   solve + backward launch ``sn_sweep`` 4 × buckets times, and a solve's
   trace holds at most 2 × buckets sweep launches and 16 other device ops;
9. LU path: the non-symmetric drift ``poisson2d(128)``, auto → direct/LU,
   solution and ∂/∂val against the dense backend (adjoint on ut/lt sweeps);
10. indefinite path: a dense-block saddle point (n = 512) with static 2x2
    pivot pairs, solve, transposed solve, ``slogdet`` and its gradient
    against torch.linalg;
11. ILU path: ``poisson2d(100)``, CG with ``precond="ilu"`` against Jacobi;
11a. MG path: the stencil path's operator (ng=2048) with CG +
    ``precond="mg"`` (every smoothing matvec on stencil5), ∂Σu²/∂κ against
    the same path on the plain versions of its kernels (``plain_kernels``),
    iterations against the stencil path's Jacobi count (fewer than 1/5),
    stencil5 launches and time of one V-cycle;
11b. AMG path: ``poisson2d(1024)`` with ``backend="pallas"`` and CG +
    ``precond="amg"`` (coarsest level on the panel kernels): analyze time
    (the AMG symbolic part apart), setup, level sizes, one coarsening and
    one Galerkin product across the solve and its backward, iterations
    over three fresh setups (one count), at most 1/4 of the block-ELL
    path's Jacobi count, ∂/∂val against the plain run; then the same on
    ``graph_laplacian(2^20)`` (an unstructured random geometric graph)
    against its own CG + Jacobi run;
11c. GMRES / Chebyshev path: GMRES(32) + ``block_jacobi`` on the
    transposed path's drift operator (ng=256, block-ELL kernel, tol 1e-10)
    with its backward against the plain run, beside BiCGStab +
    block_jacobi; CG + the plan ``chebyshev`` (Lanczos bounds, fused
    ``fused_cheb_step``) at ``poisson2d(1024)`` with its backward;
12. panel kernels: panel_factor and schur_update (fused with the
    extend-add; both in place in the factor vector) and sn_sweep (one
    bucket of a sweep in place in y) against their plain versions on
    copies of the direct path's own C for ``poisson2d(316)`` (its widest
    bucket, the bucket with the most lanes, a ragged bucket; garbage in the
    scratch sink and the scratch row of y, which must stay as they were),
    every slot of C and every row of y compared, f32 and f64, pairs off and
    on, sn_sweep and the standalone block_trsv (the same kernel with no
    sub-rows) in their four modes with 1 and 64 right-hand sides; then
    their summed time over one factorization (one mode-l sweep for
    sn_sweep, y restored before every pass) against the bound, with
    ``torch.bmm`` and bmm + ``index_add_`` beside schur_update,
    ``lu_factor_ex`` (no pivoting) beside panel_factor, and
    ``solve_triangular`` and solve_triangular + bmm + ``index_add_``
    beside sn_sweep;
13. flash kernels: flash_attention against its plain version (f32, on the
    same inputs, over chunks of bh; elementwise, |o − plain| ≤
    2e-5·|plain| + 2e-5 in f32 and ≤ 8e-3·|plain| + 1e-3 in bf16, with the
    bf16 kernel's distance from the plain version that rounds p to bf16
    printed beside it)
    at the LM path's layer shape (BH 128, S 4096, d 64, bf16, causal), f32
    causal and bidirectional (64, 2048, 64), a ragged bf16 (24, 1000, 128)
    and an uneven f32 bidirectional (2, 128 | 256, 64), then the model's
    GQA form (B 4, S 4096, H 32, K 8, d 64, q a strided slice) against the
    plain version on expanded heads — in bf16, in f32 at the decode ≡
    forward check's shape (B 2, S 128) and in f32 at the full prefill
    shape (row 7b's SIMT kernel beside SDPA); their time, the plain version's,
    SDPA's and the bound (the bf16 tensor-core kernel and the f32 SIMT
    kernel are two rows of the kernels line);
14. LM serving path: llama3.2-1b at full width (16 layers, d 2048, vocab
    128,256; seed-made weights, params f32, activations bf16): ``prefill``
    of 4 prompts × 4096 tokens (the flash kernel once per layer, on the
    projections' own (B, S, H, hd) / (B, S, K, hd) layout), its wall time,
    tokens/s, peak memory and profiler breakdown; the serving CLI
    (``serve.main``, batch 4, prompt 32, 32 generated) and ms per token step
    with the device busy share over 8 traced steps; decode ≡ forward (B 2,
    S 128; decode runs no kernel): f32 logits within 2e-4 of max |logits|,
    bf16 greedy tokens agreeing on ≥ 95% of the positions (the bf16
    forward on the tensor-core kernel, the f32 one on the SIMT kernel);
15. on-card tests: ``python -m pytest --noconftest -p no:cacheprovider -q
    tests/test_torch_on_card.py`` (``PYTHONPATH=src``), every hand-written
    kernel against its plain version over the tests' shape sweeps; fails
    on any failure or skip, or on no pass;

then a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
...}``.  Every failed check raises (exit code 1).  Without a CUDA device it
exits with code 2 and prints no result.  Details (build log, all numbers)
go to ``chiprun_out/chip_smoke/``.  It takes no arguments: the sizes,
tolerance and seed below are those of the main path.
"""
from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12            # H100 SXM HBM3 (NVIDIA data sheet)
# H100 SXM peak rates (NVIDIA data sheet): f32 and f64 outside the tensor
# cores; bf16 at the dense tensor-core rate, the least time any kernel could
# take for bf16 attention
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 989e12}
TOL_KERNEL = {"float32": 1e-5, "float64": 1e-12}
REPEATS = 4                          # whole factorizations on the kernels
TOL_GRAD = 1e-6                      # gradient vs the plain path, relative

NG_STENCIL = 2048                    # stencil path: 4.19M unknowns
NG_BELL = 1024                       # block-ELL / general paths: 1.05M
# block-ELL path: the sliced layout holds the nonzeros once (~0.1 GB at
# ng=1024); the dense (bm, bn) tiles it replaced took 4.29 GB
BELL_PEAK_GB = 1.25
NG_TRANSPOSE = 256                   # non-symmetric (transposed) paths
# 1e-8: at ng=2048 (cond(A) ~ 1e7) the f64 recurrences' residual gap
# reaches ~3e-9, so 1e-10 is below what f64 CG attains in true residual
TOL = 1e-8
# On the drift operator of the transposed paths, the κ-gradients of two
# BiCGStab runs that differ only in arithmetic order part by an amount that
# grows with the grid and not with the tolerance: 7e-11 at ng=256 and
# 1.6e-7 at ng=512 with the plain versions on both sides (CPU, tol 1e-10),
# 4.3e-6 at ng=1024 at tol 1e-8 and 1e-10 alike (H100).  So these paths
# run at ng=256, where TOL_GRAD has room.
TOL_TRANSPOSE = 1e-10
NG_DIRECT = 316                      # direct path: 99,856 unknowns
NG_LU = 128                          # non-symmetric LU path: 16,384
SADDLE = (384, 128)                  # indefinite path: H 384², B 128×384
NG_ILU = 100                         # ILU path: 10,000 unknowns
TOL_DIRECT_RES = 1e-10               # direct solve: true relative residual
TOL_CG_REF = 1e-12                   # the CG run the direct gradient meets
TOL_DENSE = 1e-8                     # LU / saddle vs torch.linalg, relative
MAXITER = 30000
SEED = 0
# phases 11a–11c, the preconditioned Krylov path: MG on the stencil path's
# operator (NG_STENCIL), AMG on the block-ELL path's (NG_BELL) and on an
# unstructured graph Laplacian of the same order of n, GMRES on the
# transposed path's drift operator (NG_TRANSPOSE) at TOL_TRANSPOSE, the plan
# Chebyshev at NG_BELL.  The iteration ratios against Jacobi on the same
# operator are the reference's own test assertions (tests/test_multigrid.py:
# 30, tests/test_amg.py:52).
MG_RATIO = 5                         # MG: fewer than 1/5 of Jacobi's
AMG_RATIO = 4                        # AMG: at most 1/4 of Jacobi's
N_GRAPH = 1 << 20                    # unstructured AMG case: 1,048,576 nodes
AMG_REPEATS = 3                      # solves, each with a fresh setup
# phase 13: (label, BH, S, T, d, dtype, causal); the first is the main
# path's layer shape (B 4 × 32 heads, S 4096, head dim 64)
FLASH_SHAPES = (("prefill layer", 128, 4096, 4096, 64, "bfloat16", True),
                ("f32 causal", 64, 2048, 2048, 64, "float32", True),
                ("f32 bidir", 64, 2048, 2048, 64, "float32", False),
                ("ragged bf16", 24, 1000, 1000, 128, "bfloat16", True),
                ("uneven f32", 2, 128, 256, 64, "float32", False))
# the model's GQA form at the shapes the main path gives it: (label, B, S, H,
# K, d, dtype) — the bf16 prefill layer and the f32 decode ≡ forward check's
# forward (the only f32 launches of the path; row 7b is read here)
FLASH_GQA = (("prefill GQA", 4, 4096, 32, 8, 64, "bfloat16"),
             ("f32 check GQA", 2, 128, 32, 8, 64, "float32"),
             # row 7b at the prefill's full layer shape (timed, not on the
             # path): the f32 SIMT kernel beside SDPA
             ("f32 prefill GQA", 4, 4096, 32, 8, 64, "float32"))
# elementwise |o − plain| <= rtol·|plain| + atol, the plain version run in
# f32 (p in f32) on the same inputs.  f32: the reference test's
# 2e-5·(1 + |plain|); bf16: the output's rounding is 2^-9 relative, held at
# 8e-3 (4 half-ulps) with an atol of 1e-3 for outputs near 0.  The bf16
# kernel's distance from the version that rounds p to bf16 is printed too.
TOL_FLASH = {"float32": (2e-5, 2e-5), "bfloat16": (8e-3, 1e-3)}
# phase 14: llama3.2-1b at full width (16 layers), seed-made weights
LM_ARCH = "llama3.2-1b"
LM_PREFILL = (4, 4096)               # prefill: B prompts × S tokens
LM_SERVE = (4, 32, 32)               # serving: batch, prompt, generated
LM_CHECK = (2, 128)                  # decode ≡ forward: B × S
TOL_LM_F32 = 2e-4                    # f32 max |Δlogits| / max |logits|
LM_AGREE = 0.95                      # bf16: greedy tokens that must agree
OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke")

KERNEL_SOURCES = {
    "stencil5": ("src/repro_torch/kernels/csrc/stencil5.cu",
                 "src/repro/kernels/stencil5.py:77"),
    "bell_spmv": ("src/repro_torch/kernels/csrc/spmv_bell.cu",
                  "src/repro/kernels/spmv_bell.py:66"),
}
FUSED = ("fused_cg_update", "fused_cg_direction", "fused_cg_halfstep",
         "fused_cheb_step", "fused_dots2", "fused_bicg_p", "fused_bicg_s",
         "fused_bicg_tail")
# flops per element of each fused body (for the operations bound)
FUSED_FLOPS = {"fused_cg_update": 9, "fused_cg_direction": 6,
               "fused_cg_halfstep": 6, "fused_cheb_step": 4,
               "fused_dots2": 4, "fused_bicg_p": 5, "fused_bicg_s": 3,
               "fused_bicg_tail": 10}
for _f in FUSED:
    KERNEL_SOURCES[_f] = ("src/repro_torch/kernels/csrc/solve_step.cu",
                          "src/repro/kernels/solve_step.py:92")
for _f, _line in (("panel_factor", 73), ("schur_update", 123),
                  ("sn_sweep", 158)):
    KERNEL_SOURCES[_f] = ("src/repro_torch/kernels/csrc/supernode.cu",
                          f"src/repro/kernels/supernode.py:{_line}")
PANEL_KERNELS = ("panel_factor", "schur_update", "sn_sweep")
ON_CARD_TESTS = "tests/test_torch_on_card.py"
SOLVE_OTHER_OPS = 16                 # a direct solve's device ops besides
                                     # its sweep launches (set-up, residual)
for _f in ("flash_attention", "flash_attention_f32"):
    KERNEL_SOURCES[_f] = ("src/repro_torch/kernels/csrc/flash_attention.cu",
                          "src/repro/kernels/flash_attention.py:84")


class CheckFailed(AssertionError):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)
    print(f"  ok: {what}", flush=True)


def say(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps, warmup=2, spin_ms=1.0, reset=None):
    """Mean device time of ``fn`` over ``reps`` back-to-back launches.

    The launches are queued behind a spin kernel (``torch.cuda._sleep``), so
    the host's time to enqueue them stays off the clock: the events measure
    the device work alone, not Python overhead between launches.
    ``spin_ms`` is the spin per rep; it must exceed one call's enqueue
    time (``fn`` may launch many kernels).  ``reset``, when given, runs
    before each call off the clock (it restores the inputs ``fn`` changes
    in place), and each call is timed on its own."""
    import torch
    for _ in range(warmup):
        if reset is not None:
            reset()
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    if reset is not None:
        tot = 0.0
        for _ in range(reps):
            reset()
            torch.cuda._sleep(int(spin_ms * 2_000_000))
            t0.record()
            fn()
            t1.record()
            t1.synchronize()
            tot += t0.elapsed_time(t1)
        return tot / reps
    torch.cuda._sleep(int(reps * spin_ms * 2_000_000))   # ≈1 ms per 2M
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def wall_ms(fn, reps, reset=None):
    """Mean host wall time per call, synchronized (enqueue + device).  With
    ``reset`` (as in :func:`cuda_ms`) each call is timed on its own."""
    import torch
    if reset is not None:
        times = []
        for _ in range(reps + 1):            # the first call warms up
            reset()
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return sum(times[1:]) / reps * 1e3
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps * 1e3


def bound_ms(nbytes, flops, dtype_name):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def rel_err(outs, refs, scales):
    """max |kernel − plain| over max of the plain version on |inputs| (the
    floating-point error scale of a sum of products)."""
    worst, worst_abs = 0.0, 0.0
    for a, b, s in zip(outs, refs, scales):
        d = float((a.double() - b.double()).abs().max())
        sc = max(float(s.double().abs().max()), 1e-300)
        worst_abs = max(worst_abs, d)
        worst = max(worst, d / sc)
    return worst, worst_abs


def smooth_kappa(ng, seed):
    """Smooth random conductivity in roughly [0.4, 2.5] (numpy seed)."""
    rng = np.random.default_rng(seed)
    t = (np.arange(ng) + 0.5) / ng
    X, Y = np.meshgrid(t, t, indexing="ij")
    field = np.zeros((ng, ng))
    for _ in range(8):
        kx, ky = rng.integers(1, 6, 2)
        a = rng.normal() / (kx + ky)
        px, py = rng.uniform(0, 2 * np.pi, 2)
        field += a * np.sin(np.pi * kx * X + px) * np.sin(np.pi * ky * Y + py)
    return np.exp(field / max(np.abs(field).max(), 1e-12) * 0.9)


def csr_of(A):
    """torch.sparse CSR of a port SparseTensor (the library yardstick)."""
    import warnings
    import torch
    idx = torch.stack([A.row, A.col])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # "beta" notices
        coo = torch.sparse_coo_tensor(idx, A.val.detach(), A.shape,
                                      check_invariants=False).coalesce()
        return coo.to_sparse_csr()


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def kernel_phase(dev, ng_stencil, ng_bell, seed, out):
    import torch
    from repro_torch.core.sparse import bell_to_device, build_bell
    from repro_torch.data.poisson import (poisson2d_arrays, vc_coefficients,
                                          vc_pattern)
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import solve_step as fk
    from repro_torch.kernels.stencil5 import Stencil5Meta, stencil5
    from repro_torch.kernels.spmv_bell import bell_spmv

    rng = np.random.default_rng(seed)
    res = {}

    # -- stencil5: the main path's planes (poisson2d_vc(κ) at ng) ----------
    ng = ng_stencil
    kap = torch.tensor(smooth_kappa(ng, seed), device=dev)
    v5 = vc_coefficients(kap).reshape(5, ng, ng)
    x = torch.tensor(rng.normal(size=(ng, ng)), device=dev)
    meta = Stencil5Meta(nx=ng, ny=ng)
    errs = []
    for dt in (torch.float64, torch.float32):
        cases = [(meta, v5.to(dt), x.to(dt))]
        nx, ny = 37, 300
        vr = torch.tensor(rng.normal(size=(5, nx, ny)), device=dev, dtype=dt)
        vr[1, 0] = 0; vr[2, -1] = 0; vr[3, :, 0] = 0; vr[4, :, -1] = 0
        cases.append((Stencil5Meta(nx=nx, ny=ny), vr,
                      torch.tensor(rng.normal(size=(nx, ny)), device=dev,
                                   dtype=dt)))
        for m_, vv, xx in cases:
            y = stencil5(m_, vv, xx)
            torch.cuda.synchronize()
            e, ea = rel_err([y], [ref.stencil5_ref(vv, xx)],
                            [ref.stencil5_ref(vv.abs(), xx.abs())])
            errs.append((str(dt)[6:], m_.nx, m_.ny, e, ea))
    n = ng * ng
    ms = cuda_ms(lambda: stencil5(meta, v5, x), 50)
    wall = wall_ms(lambda: stencil5(meta, v5, x), 20)
    plain = cuda_ms(lambda: ref.stencil5_ref(v5, x), 20)
    rows, cols, _ = vc_pattern(ng)
    from repro_torch.core.sparse import SparseTensor
    A = SparseTensor(v5.reshape(-1), rows, cols, (n, n), props={},
                     validate=False, device=dev)
    csr = csr_of(A)
    xf = x.reshape(-1)
    lib = cuda_ms(lambda: csr @ xf, 20)
    del A, csr
    res["stencil5"] = dict(errs=errs, ms=ms, wall_ms=wall, plain_ms=plain,
                           library_ms=lib,
                           bytes=7 * n * 8, flops=9 * n, dtype="float64",
                           shape=f"(5,{ng},{ng})")

    # -- bell_spmv: poisson2d(ng_bell), sliced-ELL layout of its block-ELL
    #    plan; held to the plain version and to the old dense tiles ---------
    ngb = ng_bell
    val, row, col = poisson2d_arrays(ngb)
    nb = ngb * ngb
    bell = bell_to_device(build_bell(row, col, (nb, nb)), dev)
    sell = bell.sell
    vt = torch.tensor(val, device=dev)
    packed = ops.sell_assemble(sell, vt)
    xb = torch.tensor(rng.normal(size=nb), device=dev)

    def sell_plain(sl, pk, xx, n_):
        return ref.sell_matvec_ref(sl.slice_ptr, sl.cols, pk, xx, n_)

    errs, tile_errs = [], []
    for dt in (torch.float64, torch.float32):
        cases = [(bell, vt.to(dt), xb.to(dt), nb)]
        # ragged small case: 1000 × 700 random pattern
        n_s, m_s = 1000, 700
        keys = np.unique(rng.integers(0, n_s * m_s, 9000))
        r_s, c_s = keys // m_s, keys % m_s
        cases.append((bell_to_device(build_bell(r_s, c_s, (n_s, m_s)), dev),
                      torch.tensor(rng.normal(size=len(keys)), device=dev,
                                   dtype=dt),
                      torch.tensor(rng.normal(size=m_s), device=dev,
                                   dtype=dt), n_s))
        for bl, vv, xx, n_ in cases:
            pk = ops.sell_assemble(bl.sell, vv)
            y = bell_spmv(bl.sell, pk, xx, n_)
            torch.cuda.synchronize()
            scale = [sell_plain(bl.sell, pk.abs(), xx.abs(), n_)]
            e, ea = rel_err([y], [sell_plain(bl.sell, pk, xx, n_)], scale)
            errs.append((str(dt)[6:], n_, xx.shape[0], e, ea))
            # the same product on the reference's dense (bm, bn) tiles
            et, _ = rel_err([y], [ops.bell_matvec_ref(bl, vv, xx, n_)],
                            scale)
            tile_errs.append((str(dt)[6:], n_, xx.shape[0], et))
            torch.cuda.empty_cache()
    for dt, n_, m_, et in tile_errs:
        check(et <= TOL_KERNEL[dt], f"bell_spmv {dt} ({n_} x {m_}) matches "
              f"the product on the old dense tiles ({et:.2e} <= "
              f"{TOL_KERNEL[dt]:.0e})")
    ms = cuda_ms(lambda: bell_spmv(sell, packed, xb, nb), 50)
    wall = wall_ms(lambda: bell_spmv(sell, packed, xb, nb), 20)
    plain = cuda_ms(lambda: sell_plain(sell, packed, xb, nb), 5)
    from repro_torch.core.sparse import SparseTensor, coo_matvec
    A = SparseTensor(vt, row, col, (nb, nb), props={}, device=dev)
    csr = csr_of(A)
    lib = cuda_ms(lambda: csr @ xb, 50)
    coo = cuda_ms(lambda: coo_matvec(A.val, A.row, A.col, xb, nb), 20)
    nnz = len(val)
    # what the product needs: values, int32 columns and x read once, y
    # written once, with CSR's row pointers or the sliced layout's padded
    # slots and slice pointers — the bound takes the smaller
    csr_bytes = nnz * (8 + 4) + (nb + 1) * 4 + 2 * nb * 8
    layout_bytes = sell.n_slots * (8 + 4) + sell.slice_ptr.numel() * 8 \
        + 2 * nb * 8
    say(f"  bell_spmv poisson2d({ngb}) f64: {ms:.4f} ms; sliced layout "
        f"{sell.n_slots} slots for {nnz} nonzeros, {layout_bytes / 1e6:.1f} "
        f"MB ({layout_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s); "
        f"CSR {csr_bytes / 1e6:.1f} MB "
        f"({csr_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms); CSR call {lib:.4f} "
        f"ms; coo_matvec (index_add_) {coo:.4f} ms; plain {plain:.4f} ms")
    res["bell_spmv"] = dict(
        errs=errs, ms=ms, wall_ms=wall, plain_ms=plain, library_ms=lib,
        coo_matvec_ms=coo, bytes=min(csr_bytes, layout_bytes),
        csr_bytes=csr_bytes, layout_bytes=layout_bytes,
        flops=2 * nnz, dtype="float64", nnz=nnz, slots=sell.n_slots,
        shape=f"poisson2d({ngb}) n={nb} nnz={nnz} (sliced ELL, "
              f"{sell.n_slots} slots)",
        fill=bell.meta.fill, tile_errs=tile_errs)
    del A, csr, packed, bell, sell
    torch.cuda.empty_cache()

    # -- the 8 fused bodies: n = ng_stencil² (the stencil path's vectors) ---
    n = ng_stencil * ng_stencil
    for name in FUSED:
        bid, n_in, n_sc, n_out, n_dot = fk.BODIES[name]
        errs = []
        for dt in (torch.float64, torch.float32):
            for nn in (n, 1000):
                vecs = [torch.tensor(rng.normal(size=nn), device=dev, dtype=dt)
                        for _ in range(n_in)]
                scs = [torch.tensor(rng.normal(), device=dev, dtype=dt)
                       for _ in range(n_sc)]
                if name == "fused_bicg_p":
                    scs[2] = torch.zeros((), device=dev, dtype=dt)
                got = getattr(fk, name)(*vecs, *scs)
                torch.cuda.synchronize()
                plain_f = getattr(ref, name + "_ref")
                want = plain_f(*vecs, *scs)
                scale = plain_f(*[v.abs() for v in vecs],
                                *[s.abs() for s in scs])
                e, ea = rel_err(got, want, scale)
                errs.append((str(dt)[6:], nn, 0, e, ea))
        vecs = [torch.tensor(rng.normal(size=n), device=dev)
                for _ in range(n_in)]
        scs = [torch.tensor(rng.normal(), device=dev) for _ in range(n_sc)]
        if name == "fused_bicg_p":
            # restart = 0, the loop's common case: p' needs r, p, v and dinv
            # (with restart set the kernel reads only r and dinv)
            scs[2] = torch.zeros((), device=dev)
        outs = [torch.empty_like(vecs[0]) for _ in range(n_out)]
        fn = getattr(fk, name)
        if name == "fused_dots2":
            call = lambda: fn(*vecs)
        else:
            call = lambda: fn(*vecs, *scs, out=outs)
        ms = cuda_ms(call, 50)
        wall = wall_ms(call, 20)
        plain = cuda_ms(lambda: getattr(ref, name + "_ref")(*vecs, *scs), 20)
        reads, writes = fn.passes
        res[name] = dict(errs=errs, ms=ms, wall_ms=wall, plain_ms=plain,
                         library_ms=None,
                         bytes=(reads + writes) * n * 8,
                         flops=FUSED_FLOPS[name] * n, dtype="float64",
                         shape=f"({n},)")
        del vecs, outs
    torch.cuda.empty_cache()

    for name, r in res.items():
        worst = max(e for (_, _, _, e, _) in r["errs"])
        worst_by_dtype = {}
        for (dt, _, _, e, _) in r["errs"]:
            worst_by_dtype[dt] = max(worst_by_dtype.get(dt, 0.0), e)
        r["max_rel_err"] = worst
        r["max_abs_err"] = max(ea for (dt, _, _, _, ea) in r["errs"]
                               if dt == "float64")
        b_ms, b_by = bound_ms(r["bytes"], r["flops"], r["dtype"])
        r["bound_ms"], r["bound_by"] = b_ms, b_by
        say(f"  {name:20s} {r['shape']:>22s} f64: {r['ms']:.4f} ms "
            f"(host wall {r['wall_ms']:.4f} ms/call, plain {r['plain_ms']:.4f} ms, bound {b_ms:.4f} ms by {b_by}, "
            f"library {'-' if r['library_ms'] is None else '%.4f ms' % r['library_ms']}); "
            + "; ".join(f"{dt} rel err {e:.2e} (limit {TOL_KERNEL[dt]:.0e})"
                        for dt, e in worst_by_dtype.items()))
        for dt, e in worst_by_dtype.items():
            check(e <= TOL_KERNEL[dt],
                  f"{name} {dt} matches its plain version "
                  f"({e:.2e} <= {TOL_KERNEL[dt]:.0e})")
    out["kernel_phase"] = res
    return res


# ---------------------------------------------------------------------------
# phases 3–6: the port's paths through its entry points
# ---------------------------------------------------------------------------

def _counts_reset():
    from repro_torch import kernels
    from repro_torch.core.dispatch import reset_plan_stats
    kernels.reset_launch_counts()
    reset_plan_stats()


def _counts():
    from repro_torch import kernels
    from repro_torch.core.dispatch import PLAN_STATS
    return kernels.launch_counts(), dict(PLAN_STATS)


def _sync(dev):
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _peak_reset(dev):
    import torch
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _peak(dev):
    import torch
    if torch.device(dev).type == "cuda":
        return torch.cuda.max_memory_allocated() / 1e9
    return 0.0


def _grad_rel(g, g_plain):
    return float((g - g_plain).abs().max()) / max(
        float(g_plain.abs().max()), 1e-300)


def stencil_path(dev, ng, tol, maxiter, seed, out):
    import torch
    from repro_torch import sla
    from repro_torch.data.poisson import poisson2d_vc
    from repro_torch.kernels import ref

    kap_np = smooth_kappa(ng, seed)
    n = ng * ng
    f = torch.ones(n, dtype=torch.float64, device=dev)
    kappa = torch.tensor(kap_np, device=dev, requires_grad=True)
    _sync(dev)
    _peak_reset(dev)
    _counts_reset()
    t0 = time.perf_counter()
    A = poisson2d_vc(kappa, use_stencil_kernel=True, device=dev)
    u = sla.solve(A, f, tol=tol, maxiter=maxiter)
    _sync(dev)
    t1 = time.perf_counter()
    (u * u).sum().backward()
    _sync(dev)
    t2 = time.perf_counter()
    launches, stats = _counts()
    peak = _peak(dev)
    plan = A.plan(tol=tol, maxiter=maxiter)
    say(f"  stencil path ng={ng} (n={n}): backend={plan.cfg.backend} "
        f"method={plan.cfg.method} precond={plan.cfg.precond} kernel="
        f"{plan.artifacts['kernel'].choice}; forward {t1 - t0:.3f} s, "
        f"backward {t2 - t1:.3f} s")
    t3 = time.perf_counter()
    info = sla.solve_with_info(A, f, tol=tol, maxiter=maxiter)
    _sync(dev)
    t4 = time.perf_counter()
    with torch.no_grad():
        v5 = A.val.detach().reshape(5, ng, ng)
        r = f - ref.stencil5_ref(v5, info.x.reshape(ng, ng)).reshape(-1)
        relres = float(r.norm() / f.norm())
    say(f"  iterations {int(info.iterations)}, true residual {relres:.3e} "
        f"(solve_with_info {t4 - t3:.3f} s)")
    say(f"  launches {json.dumps({k: v for k, v in launches.items() if v})}")
    say(f"  PLAN_STATS {json.dumps({k: v for k, v in stats.items() if v})}")
    g = kappa.grad.detach().clone()

    # the same run on the plain path: COO segment-sum, plain CG loop
    kappa2 = torch.tensor(kap_np, device=dev, requires_grad=True)
    t5 = time.perf_counter()
    with sla.options(fused_step="off"):
        A2 = poisson2d_vc(kappa2, device=dev)
        u2 = sla.solve(A2, f, backend="jnp", method="cg", tol=tol,
                       maxiter=maxiter)
        (u2 * u2).sum().backward()
    _sync(dev)
    t6 = time.perf_counter()
    gerr = _grad_rel(g, kappa2.grad)
    say(f"  plain path (COO, fused_step=off): {t6 - t5:.3f} s; "
        f"κ-gradient max rel diff {gerr:.3e}")
    check(bool(torch.isfinite(u).all()) and u.shape == (n,),
          "stencil path: finite solution of shape (n,)")
    check(relres <= 10 * tol, f"stencil path: true residual {relres:.2e} "
          f"<= 10·tol")
    check(bool(torch.isfinite(g).all()) and gerr <= TOL_GRAD,
          f"stencil path: κ.grad matches the plain run ({gerr:.2e} <= "
          f"{TOL_GRAD:.0e})")
    check(stats["analyze"] == 1 and stats["transpose_shared"] == 1,
          "stencil path: analyze == 1, transpose_shared == 1")
    for k in ("stencil5", "fused_cg_update", "fused_cg_direction"):
        check(launches[k] > 0, f"stencil path launched {k} "
              f"({launches[k]} times)")
    out["stencil_path"] = dict(
        ng=ng, n=n, tol=tol, iterations=int(info.iterations),
        forward_s=t1 - t0, backward_s=t2 - t1, info_solve_s=t4 - t3,
        plain_run_s=t6 - t5, true_residual=relres, grad_rel_diff=gerr,
        peak_gb=peak, launches=launches, plan_stats=stats)
    say(f"  peak device memory {peak:.2f} GB; forward "
        f"{(t1 - t0) / max(int(info.iterations), 1) * 1e3:.3f} ms/iteration")
    del A, A2, u, u2, info, kappa, kappa2
    return launches


def bell_path(dev, ng, tol, maxiter, out):
    import torch
    from repro_torch import sla
    from repro_torch.core.sparse import coo_matvec
    from repro_torch.data.poisson import poisson2d

    A0 = poisson2d(ng, device=dev)
    n = ng * ng
    b = torch.ones(n, dtype=torch.float64, device=dev)
    val = A0.val.clone().requires_grad_(True)
    _sync(dev)
    _peak_reset(dev)
    _counts_reset()
    t0 = time.perf_counter()
    A = A0.with_values(val)
    u = sla.solve(A, b, backend="pallas", tol=tol, maxiter=maxiter)
    _sync(dev)
    t1 = time.perf_counter()
    (u * u).sum().backward()
    _sync(dev)
    t2 = time.perf_counter()
    launches, stats = _counts()
    peak = _peak(dev)
    kp = A.plan(backend="pallas", tol=tol).artifacts["kernel"]
    say(f"  block-ELL path poisson2d({ng}) (n={n}): KernelPlan choice="
        f"{kp.choice} reason='{kp.reason}' fill={kp.bell[0].fill:.5f} "
        f"k={kp.bell[0].k}; forward {t1 - t0:.3f} s, backward {t2 - t1:.3f} s")
    t3 = time.perf_counter()
    info = sla.solve_with_info(A, b, backend="pallas", tol=tol,
                               maxiter=maxiter)
    _sync(dev)
    t4 = time.perf_counter()
    with torch.no_grad():
        r = b - coo_matvec(A0.val, A0.row, A0.col, info.x, n)
        relres = float(r.norm() / b.norm())
    say(f"  iterations {int(info.iterations)}, true residual {relres:.3e} "
        f"(solve_with_info {t4 - t3:.3f} s)")
    say(f"  launches {json.dumps({k: v for k, v in launches.items() if v})}")
    say(f"  PLAN_STATS {json.dumps({k: v for k, v in stats.items() if v})}")
    g = val.grad.detach().clone()
    val2 = A0.val.clone().requires_grad_(True)
    t5 = time.perf_counter()
    with sla.options(fused_step="off"):
        u2 = sla.solve(A0.with_values(val2), b, backend="jnp", method="cg",
                       tol=tol, maxiter=maxiter)
        (u2 * u2).sum().backward()
    _sync(dev)
    t6 = time.perf_counter()
    gerr = _grad_rel(g, val2.grad)
    say(f"  plain path (COO, fused_step=off): {t6 - t5:.3f} s; "
        f"val-gradient max rel diff {gerr:.3e}")
    check(kp.choice == "bell", "block-ELL path: kernel plan adopted BELL")
    check(bool(torch.isfinite(u).all()) and u.shape == (n,),
          "block-ELL path: finite solution of shape (n,)")
    check(relres <= 10 * tol,
          f"block-ELL path: true residual {relres:.2e} <= 10·tol")
    check(bool(torch.isfinite(g).all()) and gerr <= TOL_GRAD,
          f"block-ELL path: val.grad matches the plain run ({gerr:.2e} <= "
          f"{TOL_GRAD:.0e})")
    check(stats["analyze"] == 1 and stats["transpose_shared"] == 1,
          "block-ELL path: analyze == 1, transpose_shared == 1")
    for k in ("bell_spmv", "fused_cg_update", "fused_cg_direction"):
        check(launches[k] > 0, f"block-ELL path launched {k} "
              f"({launches[k]} times)")
    iters = max(int(info.iterations), 1)
    out["bell_path"] = dict(
        ng=ng, n=n, tol=tol, iterations=int(info.iterations),
        forward_s=t1 - t0, backward_s=t2 - t1, info_solve_s=t4 - t3,
        plain_run_s=t6 - t5, true_residual=relres, grad_rel_diff=gerr,
        fill=kp.bell[0].fill, reason=kp.reason, peak_gb=peak,
        forward_ms_per_iteration=(t1 - t0) / iters * 1e3,
        info_ms_per_iteration=(t4 - t3) / iters * 1e3,
        launches=launches, plan_stats=stats)
    say(f"  peak device memory {peak:.3f} GB; forward "
        f"{(t1 - t0) / iters * 1e3:.3f} ms/iteration (solve_with_info "
        f"{(t4 - t3) / iters * 1e3:.3f} ms/iteration)")
    check(peak <= BELL_PEAK_GB, f"block-ELL path: peak device memory "
          f"{peak:.3f} GB <= {BELL_PEAK_GB} GB (no dense tiles)")
    del A, A0, u, u2, info, val, val2
    return launches


def general_path(dev, ng, tol, maxiter, out):
    import torch
    from repro_torch import sla
    from repro_torch.core.sparse import coo_matvec
    from repro_torch.data.poisson import poisson2d

    A = poisson2d(ng, device=dev)
    n = ng * ng
    b = torch.ones(n, dtype=torch.float64, device=dev)
    total = {}
    res = {}
    for method, bodies in (("cg", ("fused_cg_update", "fused_cg_direction")),
                           ("bicgstab", ("fused_bicg_p", "fused_bicg_s",
                                         "fused_dots2", "fused_bicg_tail"))):
        _sync(dev)
        _counts_reset()
        t0 = time.perf_counter()
        info = sla.solve_with_info(A, b, backend="jnp", method=method,
                                   tol=tol, maxiter=maxiter)
        _sync(dev)
        t1 = time.perf_counter()
        launches, stats = _counts()
        kp = A.plan(backend="jnp", method=method).artifacts["kernel"]
        with torch.no_grad():
            relres = float((b - coo_matvec(A.val, A.row, A.col, info.x, n))
                           .norm() / b.norm())
        say(f"  general path poisson2d({ng}) jnp/{method}: KernelPlan "
            f"choice={kp.choice} reason='{kp.reason}'; {t1 - t0:.3f} s, "
            f"iterations {int(info.iterations)}, true residual {relres:.3e}")
        say(f"  launches {json.dumps({k: v for k, v in launches.items() if v})}")
        check(kp.choice == "coo" and kp.reason.startswith("bell fill"),
              f"general path ({method}): kernel plan kept COO below the "
              f"fill gate")
        check(info.reason == "converged" and relres <= 10 * tol,
              f"general path ({method}): converged, true residual "
              f"{relres:.2e} <= 10·tol")
        check(stats["analyze"] == 1, f"general path ({method}): analyze == 1")
        for k in bodies:
            check(launches[k] > 0, f"general path ({method}) launched "
                  f"{k} ({launches[k]} times)")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        res[method] = dict(seconds=t1 - t0, iterations=int(info.iterations),
                           true_residual=relres, reason=kp.reason,
                           launches=launches, plan_stats=stats)
    out["general_path"] = dict(ng=ng, n=n, tol=tol, **res)
    del A
    return total


def chebyshev_path(dev, ng, tol, maxiter, out):
    import torch
    from repro_torch.core import precond, solvers
    from repro_torch.data.poisson import poisson2d

    A = poisson2d(ng, device=dev)
    n = ng * ng
    b = torch.ones(n, dtype=torch.float64, device=dev)
    mv = lambda x: A @ x
    lmin = 8 * math.sin(math.pi / (2 * (ng + 1))) ** 2
    lmax = 8 * math.cos(math.pi / (2 * (ng + 1))) ** 2
    _sync(dev)
    _counts_reset()
    t0 = time.perf_counter()
    M = precond.chebyshev(mv, lmin, lmax, degree=8, fused=True)
    x, info = solvers.cg_fused(mv, b, M=M, tol=tol, maxiter=maxiter)
    _sync(dev)
    t1 = time.perf_counter()
    launches, _ = _counts()
    with torch.no_grad():
        relres = float((b - mv(x)).norm() / b.norm())
    say(f"  solver-level path poisson2d({ng}): cg_fused + fused Chebyshev "
        f"(degree 8): {t1 - t0:.3f} s, iterations {int(info.iters)}, "
        f"true residual {relres:.3e}")
    say(f"  launches {json.dumps({k: v for k, v in launches.items() if v})}")
    check(bool(info.converged) and relres <= 10 * tol,
          f"solver-level path: converged, true residual {relres:.2e} <= 10·tol")
    for k in ("fused_cg_halfstep", "fused_cheb_step"):
        check(launches[k] > 0, f"solver-level path launched {k} "
              f"({launches[k]} times)")
    out["chebyshev_path"] = dict(ng=ng, n=n, tol=tol, seconds=t1 - t0,
                                 iterations=int(info.iters),
                                 true_residual=relres, launches=launches)
    del A, x
    return launches


def transpose_path(dev, ng, tol, maxiter, seed, out):
    """Non-symmetric operators: the backward's adjoint solve runs on the
    backend's own transpose plan (``transpose_shared`` with ``analyze ==
    1``), launching the stencil kernel on transposed planes and the
    block-ELL kernel on Aᵀ's layout."""
    import torch
    from repro_torch import sla
    from repro_torch.core.sparse import SparseTensor
    from repro_torch.data.poisson import poisson2d, vc_coefficients, vc_pattern
    from repro_torch.kernels import launch_counts

    n = ng * ng
    b = torch.ones(n, dtype=torch.float64, device=dev)
    props = {"symmetric": False, "spd_hint": False, "sorted_rows": False}
    rows, cols, meta = vc_pattern(ng)
    drift = torch.tensor([1.0, 1.3, 0.7, 1.0, 1.0], dtype=torch.float64,
                         device=dev).reshape(5, 1)

    def stencil_op(kappa, stencil):
        v = (vc_coefficients(kappa).reshape(5, -1) * drift).reshape(-1)
        return SparseTensor(v, rows, cols, (n, n), props=props,
                            stencil=meta if stencil else None,
                            validate=False, device=dev)

    A0 = poisson2d(ng, device=dev)
    v0 = A0.val.clone()
    v0[A0.col == A0.row - 1] = -1.4
    v0[A0.col == A0.row + 1] = -0.6
    B = SparseTensor(v0, A0.row, A0.col, A0.shape, props=props, device=dev)
    kap_np = smooth_kappa(ng, seed)
    kernel_of = {"stencil": "stencil5", "pallas": "bell_spmv"}
    res = {}
    total = {}
    for backend in ("stencil", "pallas"):
        if backend == "stencil":
            leaf = torch.tensor(kap_np, device=dev, requires_grad=True)
            make = lambda w: stencil_op(w, True)
            make_plain = lambda w: stencil_op(w, False)
        else:
            leaf = v0.clone().requires_grad_(True)
            make = make_plain = B.with_values
        kern = kernel_of[backend]
        _sync(dev)
        _counts_reset()
        t0 = time.perf_counter()
        A = make(leaf)
        u = sla.solve(A, b, backend=backend, tol=tol, maxiter=maxiter)
        _sync(dev)
        fwd = launch_counts()[kern]
        t1 = time.perf_counter()
        (u * u).sum().backward()
        _sync(dev)
        t2 = time.perf_counter()
        launches, stats = _counts()
        plan = A.plan(backend=backend, tol=tol, maxiter=maxiter)
        info = sla.solve_with_info(A, b, backend=backend, tol=tol,
                                   maxiter=maxiter)
        g = leaf.grad.detach().clone()
        leaf2 = leaf.detach().clone().requires_grad_(True)
        t3 = time.perf_counter()
        with sla.options(fused_step="off"):
            u2 = sla.solve(make_plain(leaf2), b, backend="jnp",
                           method="bicgstab", tol=tol, maxiter=maxiter)
            (u2 * u2).sum().backward()
        _sync(dev)
        t4 = time.perf_counter()
        gerr = _grad_rel(g, leaf2.grad)
        what = "κ" if backend == "stencil" else "val"
        say(f"  transposed path {backend} ng={ng} (n={n}): method="
            f"{plan.cfg.method} kernel={plan.artifacts['kernel'].choice}; "
            f"forward {t1 - t0:.3f} s, backward {t2 - t1:.3f} s, iterations "
            f"{int(info.iterations)}; plain path {t4 - t3:.3f} s; "
            f"{what}-gradient max rel diff {gerr:.3e}")
        say(f"  launches {json.dumps({k: v for k, v in launches.items() if v})}")
        say(f"  PLAN_STATS {json.dumps({k: v for k, v in stats.items() if v})}")
        check(plan.cfg.method == "bicgstab" and info.reason == "converged"
              and bool(torch.isfinite(u).all()),
              f"transposed path ({backend}): BiCGStab converged, finite")
        check(stats["analyze"] == 1 and stats["transpose_shared"] == 1,
              f"transposed path ({backend}): analyze == 1, transpose_shared "
              f"== 1 (the backend's own transpose plan)")
        check(launches[kern] > fwd > 0,
              f"transposed path ({backend}): {kern} launched in the forward "
              f"({fwd}) and the adjoint solve ({launches[kern] - fwd})")
        check(bool(torch.isfinite(g).all()) and gerr <= TOL_GRAD,
              f"transposed path ({backend}): {what}.grad matches the plain "
              f"run ({gerr:.2e} <= {TOL_GRAD:.0e})")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        res[backend] = dict(forward_s=t1 - t0, backward_s=t2 - t1,
                            plain_run_s=t4 - t3,
                            iterations=int(info.iterations),
                            grad_rel_diff=gerr, launches=launches,
                            forward_launches=fwd, plan_stats=stats)
        del A, u, u2, info, leaf, leaf2, g
        torch.cuda.empty_cache()
    out["transpose_path"] = dict(ng=ng, n=n, tol=tol, **res)
    return total


# ---------------------------------------------------------------------------
# phases 8–12: the sparse-direct route
# ---------------------------------------------------------------------------

def _enqueue_ms(fn, reset=None):
    """Host time to enqueue one call of ``fn`` (after a warm-up)."""
    import torch
    for _ in range(2):                        # a warm-up, then the timed call
        if reset is not None:
            reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        dt = time.perf_counter() - t
        torch.cuda.synchronize()
    return dt * 1e3


def _sum_ms(fn, reps=5, reset=None):
    """Device time of ``fn`` (many launches), the spin covering enqueue with
    a wide margin: a loop of a few hundred launches enqueues at the host's
    pace, which varies between calls, and a spin that ends early counts the
    device's wait for the host."""
    return cuda_ms(fn, reps, warmup=1, reset=reset,
                   spin_ms=3.0 * _enqueue_ms(fn, reset) + 2.0)


def _panel_work(bk, distinct=None, sdistinct=None):
    """(bytes, flops) per kernel that one bucket's true sizes need, f64,
    each input read once and each output written once.  panel_factor reads
    and writes its panels in place in C: w² + 2rw words, each with its
    int32 slot (20 B a word).  schur_update reads the two panels (2rw words
    with their slots, 12 B), one int32 index per live target (r² of them,
    4 B), and reads and writes each distinct target once (``distinct``, the
    bucket's distinct addresses: sibling lanes share some; 16 B).
    sn_sweep: one mode-l sweep step with one right-hand side: the strict
    lower triangle of D and L_sub with their slots (12 B a value), y_b read
    and written with its row id (20 B a live block row), each distinct row
    of y_s read and written once (``sdistinct``: sibling lanes share
    ancestor rows; 16 B) with a row id per live sub-row (4 B), and w, r per
    lane (8 B)."""
    w = bk.wvec.double().cpu().numpy()
    r = bk.rvec.double().cpu().numpy()
    k = bk.wvec.shape[0]
    if distinct is None:
        distinct = int(bk.uidx.unique().numel())
    if sdistinct is None:
        sdistinct = _sweep_distinct(bk)
    s1 = w * (w - 1) / 2                         # Σ_t (w-t-1)
    s2 = (w - 1) * w * (2 * w - 1) / 6           # Σ_t (w-t-1)²
    pf = (20 * float((w * w + 2 * r * w).sum()),
          float((2 * s2 + s1 + r * w + 4 * r * s1).sum()))
    su = (float((12 * 2 * r * w + 4 * r * r).sum()) + 16.0 * distinct,
          float((2 * w * r * r).sum()))
    sw = (float((12 * (s1 + r * w) + 20 * w + 4 * r).sum()) + 16.0 * sdistinct
          + 8.0 * k, float((2 * s1 + 2 * r * w).sum()))
    return {"panel_factor": pf, "schur_update": su, "sn_sweep": sw}


def _sweep_distinct(bk):
    """The distinct rows of y that a bucket's live sub-rows name."""
    rows = bk.rows.cpu().numpy()[:, bk.wb:]
    live = np.arange(bk.rb)[None, :] < bk.rvec.cpu().numpy()[:, None]
    return int(np.unique(rows[live]).size)


def _pf_blocks(r, rb):
    """Blocks that panel_factor runs for a lane of r live sub-rows in a
    bucket of rb (its launch: tiles of up to 128 items, sub-rows then U
    columns; a tile past tile 0 runs only if it holds a live item)."""
    tpb = 32
    while tpb < 2 * rb and tpb < 128:
        tpb *= 2
    tiles = -(-2 * rb // tpb) if rb > 0 else 1
    return 1 + sum(1 for y in range(1, tiles)
                   if r > 0 and (y * tpb < r or rb < (y + 1) * tpb
                                 and y * tpb < rb + r))


def _lu_yardstick(Pm):
    """torch.linalg.lu_factor_ex(pivot=False) on the masked tall [D; L_sub]
    panels of each bucket: the P half of panel_factor only, 1x1 pivots, no
    clamp (the nearest PyTorch call; none computes panel_factor).  Device
    ms summed over the buckets, or None with the reason."""
    import torch
    run = lambda: [torch.linalg.lu_factor_ex(P, pivot=False) for P in Pm]
    try:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        if time.perf_counter() - t > 30.0:
            return None, "over 30 s per factorization: not timed again"
        return _sum_ms(run, reps=2), None
    except (RuntimeError, ValueError) as exc:   # not offered for this shape
        return None, str(exc).splitlines()[0][:200]


def panel_kernel_phase(dev, art, val, ng, seed, out):
    """panel_factor and the fused schur_update (both in place in C) and
    sn_sweep (in place in y) against their plain versions on the main
    path's panels (the direct path's analysis ``art`` of ``poisson2d(ng)``
    with values ``val``), and their summed device time over one
    factorization (one mode-l sweep for sn_sweep)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import supernode as ksn

    rng = np.random.default_rng(seed)
    buckets = [bk for lvl in art.snode.schedule for bk in lvl]
    say(f"  panel shapes of the direct path's poisson2d({ng}): "
        f"{len(buckets)} buckets in {len(art.snode.schedule)} levels")
    sink = art.nnzF
    C = torch.zeros(art.nnzF + 2, dtype=torch.float64, device=dev)
    C.index_add_(0, art.a2f, val)
    C[art.nnzF + 1] = 1.0
    C[sink] = 7.25                       # pad slots read NaN-free garbage
    tau64 = math.sqrt(np.finfo(np.float64).eps) * float(val.abs().max())

    def ragged(bk):
        w, r = bk.wvec.cpu(), bk.rvec.cpu()
        live = w > 0
        return bool((~live).any() and (w[live] < bk.wb).any()
                    and (r[live] < bk.rb).any())

    nk_of = lambda b: b.wvec.shape[0]
    widest = max(buckets, key=lambda b: (b.wb * b.rb, nk_of(b)))
    most = max(buckets, key=lambda b: (nk_of(b), b.wb * b.rb))
    cands = [b for b in buckets if ragged(b)] or \
        [b for b in buckets if bool((b.wvec == 0).any())]
    rag = max(cands, key=lambda b: (b.wb * b.rb, nk_of(b)))
    cases = (("widest", widest), ("most lanes", most), ("ragged", rag))
    errs = {k: [] for k in PANEL_KERNELS}
    abs_err = dict.fromkeys(PANEL_KERNELS, 0.0)
    trsv_errs = []                       # block_trsv: sn_sweep, no sub-rows
    n = art.n
    shapes = []
    for label, bk in cases:
        k, wb = nk_of(bk), bk.wb
        slots = (bk.pidx, bk.qidx, bk.wvec, bk.rvec)
        aw = torch.arange(wb, device=dev)
        pair_bkm = (aw[None, :] % 2 == 0) & (aw[None, :] + 1 < bk.wvec[:, None])
        shapes.append(f"{label} (k={k}, wb={wb}, rb={bk.rb})")
        # the rows of y that no live entry of the bucket names (row n, the
        # scratch, among them): a sweep must leave them as they were
        named = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        live = torch.cat([aw[None, :] < bk.wvec[:, None],
                          torch.arange(bk.rb, device=dev)[None, :]
                          < bk.rvec[:, None]], 1)
        named[bk.rows[live].long()] = True
        keep = ~named
        kept = True
        for dt in (torch.float64, torch.float32):
            tag = str(dt)[6:]
            tau = torch.tensor(tau64, dtype=dt, device=dev)
            C0 = C.to(dt)
            for pairs in (False, True):
                bkm = pair_bkm if pairs else bk.bkm
                Ck, Cp = C0.clone(), C0.clone()
                nk = ksn.panel_factor_inplace(Ck, *slots, tau, bkm,
                                              pairs=pairs, guard=True)
                torch.cuda.synchronize()
                npl = ref.sn_panel_factor_inplace_ref(
                    Cp, *slots, tau, bkm, pairs=pairs, guard=True)
                e, ea = rel_err([Ck], [Cp], [Cp])
                check(float(nk) == float(npl) and float(Ck[sink]) == 7.25,
                      f"panel_factor {label} {tag} pairs={pairs}: clamp "
                      f"count {float(nk):.0f} equals the plain version's, "
                      f"sink untouched")
                errs["panel_factor"].append((tag, e))
                if tag == "float64":
                    abs_err["panel_factor"] = max(abs_err["panel_factor"], ea)
                Sk, Sp = Ck.clone(), Ck.clone()
                ksn.schur_update_inplace(Sk, *slots, bk.uidx, bk.uoff)
                torch.cuda.synchronize()
                ref.sn_schur_inplace_ref(Sp, *slots, bk.uidx)
                e, ea = rel_err([Sk], [Sp], [Sp])
                check(float(Sk[sink]) == 7.25,
                      f"schur_update {label} {tag} pairs={pairs}: sink "
                      f"untouched")
                errs["schur_update"].append((tag, e))
                if tag == "float64":
                    abs_err["schur_update"] = max(abs_err["schur_update"], ea)
                D = ref.sn_gather(Ck, bk.pidx)[:, :wb, :]
                sbk = bk._replace(bkm=bkm, pairs=pairs)
                for mode in ("l", "lt", "u", "ut"):
                    for m in (1, 64):
                        y = torch.tensor(rng.normal(size=(k, wb, m)),
                                         dtype=dt, device=dev)
                        x = ksn.block_trsv(D, y, bk.wvec, bkm, mode=mode,
                                           pairs=pairs)
                        torch.cuda.synchronize()
                        xp = ref.sn_trsv_ref(D, y, bk.wvec, bkm, mode=mode,
                                             pairs=pairs)
                        trsv_errs.append((tag, rel_err([x], [xp], [xp])[0]))
                        Y0 = torch.tensor(rng.normal(size=(n + 1, m)),
                                          dtype=dt, device=dev)
                        Y0[n] = 7.25
                        wk, pt = ksn.sweep_buffers([sbk], m, dt, dev)
                        Yk = ksn.sn_sweep_inplace(Ck, Y0.clone(), sbk, mode,
                                                  work=wk, part=pt)
                        torch.cuda.synchronize()
                        Yp = ref.sn_sweep_inplace_ref(
                            Ck, Y0.clone(), sbk.pidx, sbk.qidx, sbk.rows,
                            sbk.wvec, sbk.rvec, bkm, mode=mode, pairs=pairs)
                        e, ea = rel_err([Yk], [Yp], [Yp])
                        errs["sn_sweep"].append((tag, e))
                        if tag == "float64":
                            abs_err["sn_sweep"] = max(abs_err["sn_sweep"], ea)
                        kept = kept and torch.equal(Yk[keep], Y0[keep]) \
                            and int(wk.abs().sum()) == 0
                del Ck, Cp, Sk, Sp
        check(kept, f"sn_sweep {label}: every row of y that no live entry "
              f"names ({int(keep.sum())}, the scratch row among them) kept "
              f"bit for bit, work counters back at zero after every launch")
    # -- the whole factorization, kernels against plain, REPEATS times with
    #    one `work` vector: the split lanes' cross-block protocol (the last
    #    block of a lane writes D back and resets its counter) must give the
    #    plain version's C every time and leave the counters at zero.  The
    #    first run also records each bucket's panels as they enter
    #    panel_factor (Cin) and the factors (Cf): the timed runs below start
    #    from these, the main path's own values.
    worst_trsv = max(e for _, e in trsv_errs)
    check(all(e <= TOL_KERNEL[t] for t, e in trsv_errs),
          f"block_trsv (sn_sweep with no sub-rows) matches sn_trsv_ref in "
          f"l/lt/u/ut, m = 1 and 64 ({worst_trsv:.2e})")
    tau = torch.tensor(tau64, dtype=torch.float64, device=dev)
    work = torch.zeros(max(nk_of(b) for b in buckets), dtype=torch.int32,
                       device=dev)
    split = sum(1 for bk in buckets for r in bk.rvec.tolist()
                if _pf_blocks(r, bk.rb) > 1)

    def factor(Cx, plain, Cin=None):
        nb = torch.zeros((), dtype=Cx.dtype, device=dev)
        for bk in buckets:
            slots = (bk.pidx, bk.qidx, bk.wvec, bk.rvec)
            if Cin is not None:
                for t in (bk.pidx, bk.qidx):
                    Cin[t.long()] = Cx[t.long()]
            if plain:
                nb += ref.sn_panel_factor_inplace_ref(
                    Cx, *slots, tau, bk.bkm, pairs=bk.pairs)
                ref.sn_schur_inplace_ref(Cx, *slots, bk.uidx)
            else:
                ksn.panel_factor_inplace(Cx, *slots, tau, bk.bkm,
                                         pairs=bk.pairs, nbad=nb, work=work)
                ksn.schur_update_inplace(Cx, *slots, bk.uidx, bk.uoff)
        return float(nb)

    Cp = C.clone()
    nb_plain = factor(Cp, True)
    Cin = C.clone()
    rep_err = []
    for rep in range(REPEATS):
        Cf = C.clone()
        nb_k = factor(Cf, False, Cin if rep == 0 else None)
        torch.cuda.synchronize()
        e, _ = rel_err([Cf], [Cp], [Cp])
        rep_err.append(e)
        check(e <= TOL_KERNEL["float64"] and nb_k == nb_plain
              and float(Cf[sink]) == 7.25 and int(work.abs().sum()) == 0,
              f"factorization {rep + 1}/{REPEATS} of poisson2d({ng}) on the "
              f"kernels (one work vector; {split} lanes split over several "
              f"blocks) matches the plain one ({e:.2e} <= "
              f"{TOL_KERNEL['float64']:.0e}), clamp count {nb_k:.0f} == "
              f"{nb_plain:.0f}, sink untouched, work counters back at zero")
    del Cp
    # -- time: one bucket of each case, and summed over one factorization
    #    (one mode-l sweep), each pass from the main path's values
    #    (panel_factor from Cin, schur_update from Cf, sn_sweep on Cf from
    #    one y), restored off the clock
    acc = torch.zeros((), dtype=torch.float64, device=dev)
    Cw = C.clone()
    Y0 = torch.tensor(rng.normal(size=(n + 1, 1)), device=dev)
    Y0[n] = 0.0
    Yw = Y0.clone()
    reset = {"panel_factor": lambda: Cw.copy_(Cin),
             "schur_update": lambda: Cw.copy_(Cf),
             "sn_sweep": lambda: Yw.copy_(Y0)}
    sw_work, sw_part = ksn.sweep_buffers(buckets, 1, torch.float64, dev)
    lu_panels = [ref.sn_panel_mask(ref.sn_gather(Cin, bk.pidx),
                                   ref.sn_gather(Cin, bk.qidx), bk.wvec,
                                   bk.rvec)[0] for bk in buckets]
    panels = [ref.sn_panel_mask(ref.sn_gather(Cf, bk.pidx),
                                ref.sn_gather(Cf, bk.qidx), bk.wvec, bk.rvec)
              for bk in buckets]
    livepos = [torch.nonzero(ref.sn_target_mask(bk.rvec, bk.rb, dev)
                             .reshape(-1))[:, 0] for bk in buckets]
    distinct = {id(bk): int(bk.uidx.unique().numel()) for bk in buckets}
    sdistinct = {id(bk): _sweep_distinct(bk) for bk in buckets}
    Dm = [ref.sn_block_mask(P[:, :bk.wb, :], bk.wvec)
          for (P, _), bk in zip(panels, buckets)]
    rows_b = [bk.rows[:, :bk.wb].long() for bk in buckets]
    rows_s = [bk.rows[:, bk.wb:].reshape(-1).long() for bk in buckets]
    ys = [Y0[r] for r in rows_b]

    def run(name, idx, impl):
        def one(i):
            bk = buckets[i]
            slots = (bk.pidx, bk.qidx, bk.wvec, bk.rvec)
            if name == "panel_factor":
                if impl == "kernel":
                    return ksn.panel_factor_inplace(
                        Cw, *slots, tau, bk.bkm, pairs=bk.pairs, nbad=acc,
                        work=work)
                return ref.sn_panel_factor_inplace_ref(Cw, *slots, tau,
                                                       bk.bkm, pairs=bk.pairs)
            if name == "schur_update":
                if impl == "kernel":
                    return ksn.schur_update_inplace(Cw, *slots, bk.uidx,
                                                    bk.uoff)
                if impl == "plain":
                    return ref.sn_schur_inplace_ref(Cw, *slots, bk.uidx)
                P, Q = panels[i]
                S = torch.bmm(P[:, bk.wb:, :], Q)        # the GEMM half
                if impl == "library":
                    return S
                return Cw.index_add_(0, bk.uidx, S.reshape(-1).index_select(
                    0, livepos[i]), alpha=-1)
            if impl == "kernel":
                return ksn.sn_sweep_inplace(Cf, Yw, bk, "l", work=sw_work,
                                            part=sw_part)
            if impl == "plain":
                return ref.sn_sweep_inplace_ref(
                    Cf, Yw, bk.pidx, bk.qidx, bk.rows, bk.wvec, bk.rvec,
                    bk.bkm, mode="l", pairs=bk.pairs)
            if impl == "library":                    # the trsv half
                return torch.linalg.solve_triangular(
                    Dm[i], ys[i], upper=False, unitriangular=True)
            x = torch.linalg.solve_triangular(       # the whole function
                Dm[i], Yw[rows_b[i]], upper=False, unitriangular=True)
            Yw[rows_b[i]] = x
            return Yw.index_add_(0, rows_s[i], torch.bmm(
                panels[i][0][:, bk.wb:, :], x).reshape(-1, 1), alpha=-1)
        return lambda: [one(i) for i in idx]

    res = {}
    allidx = range(len(buckets))
    for name in PANEL_KERNELS:
        per_case = []
        rs = reset[name]
        for label, bk in cases:
            i = next(j for j, b in enumerate(buckets) if b is bk)
            b_, f_ = _panel_work(bk, distinct[id(bk)],
                                 sdistinct[id(bk)])[name]
            bms, bby = bound_ms(b_, f_, "float64")
            lib = None if name == "panel_factor" else \
                cuda_ms(run(name, [i], "library"), 20)
            per_case.append(dict(
                case=label, k=nk_of(bk), wb=bk.wb, rb=bk.rb,
                ms=cuda_ms(run(name, [i], "kernel"), 20, reset=rs),
                plain_ms=_sum_ms(run(name, [i], "plain"), reps=3, reset=rs),
                library_ms=lib, bound_ms=bms, bound_by=bby))
        work_b = [_panel_work(bk, distinct[id(bk)], sdistinct[id(bk)])[name]
                  for bk in buckets]
        tb = sum(w[0] for w in work_b)
        tf = sum(w[1] for w in work_b)
        bms, bby = bound_ms(tb, tf, "float64")
        ms = _sum_ms(run(name, allidx, "kernel"), reset=rs)
        plain = _sum_ms(run(name, allidx, "plain"), reps=2, reset=rs)
        wall = wall_ms(run(name, allidx, "kernel"), 3, reset=rs)
        extra, lib = {}, None
        if name == "schur_update":       # no one call computes the fusion
            extra = dict(
                bmm_ms=_sum_ms(run(name, allidx, "library")),
                bmm_index_add_ms=_sum_ms(run(name, allidx, "library+add"),
                                         reset=rs))
            lib_txt = (f"none (bmm alone {extra['bmm_ms']:.4f} ms, bmm + "
                       f"index_add_ {extra['bmm_index_add_ms']:.4f} ms)")
        elif name == "panel_factor":
            lu_ms, why = _lu_yardstick(lu_panels)
            extra = dict(lu_factor_ex_ms=lu_ms, lu_factor_ex_note=why)
            lib_txt = ("none (lu_factor_ex, P half only, 1x1 pivots, no "
                       "clamp: " + (f"{lu_ms:.4f} ms)" if lu_ms is not None
                                    else f"not timed: {why})"))
        else:                            # nor the fused sweep step
            extra = dict(
                solve_triangular_ms=_sum_ms(run(name, allidx, "library"),
                                            reset=rs),
                solve_triangular_bmm_index_add_ms=_sum_ms(
                    run(name, allidx, "library+add"), reset=rs),
                block_trsv_rel_err=worst_trsv)
            lib_txt = (f"none (solve_triangular alone "
                       f"{extra['solve_triangular_ms']:.4f} ms, + bmm + "
                       f"index_add_ "
                       f"{extra['solve_triangular_bmm_index_add_ms']:.4f} "
                       f"ms)")
        worst = {}
        for tag, e in errs[name]:
            worst[tag] = max(worst.get(tag, 0.0), e)
        res[name] = dict(
            ms=ms, wall_ms=wall, plain_ms=plain, library_ms=lib,
            bytes=tb, flops=tf, dtype="float64", bound_ms=bms, bound_by=bby,
            shape=(f"poisson2d({ng}): {len(buckets)} buckets"
                   + (", 1 sweep (mode l, m=1)" if name == "sn_sweep"
                      else ", 1 factorization")),
            cases=per_case, max_rel_err=max(worst.values()),
            **(dict(repeat_rel_err=rep_err, split_lanes=split)
               if name == "panel_factor" else {}),
            max_abs_err=abs_err[name], **extra)
        say(f"  {name:13s} summed over {len(buckets)} buckets: {ms:.4f} ms "
            f"(host wall {wall:.3f} ms, plain {plain:.3f} ms, bound "
            f"{bms:.4f} ms by {bby}, library {lib_txt}); "
            + "; ".join(f"{t} rel err {e:.2e} (limit {TOL_KERNEL[t]:.0e})"
                        for t, e in worst.items()))
        yardstick = {"schur_update": "bmm",
                     "sn_sweep": "solve_triangular"}.get(name, "library")
        for c in per_case:
            lib_c = c["library_ms"]
            say(f"    {c['case']:10s} (k={c['k']}, wb={c['wb']}, "
                f"rb={c['rb']}): {c['ms']:.4f} ms, plain {c['plain_ms']:.4f} "
                f"ms, bound {c['bound_ms']:.4f} ms by {c['bound_by']}, "
                f"{yardstick} {'-' if lib_c is None else '%.4f ms' % lib_c}")
        for t, e in worst.items():
            check(e <= TOL_KERNEL[t], f"{name} {t} matches its plain version "
                  f"at {', '.join(shapes)} ({e:.2e} <= {TOL_KERNEL[t]:.0e})")
    out["panel_kernel_phase"] = dict(n_buckets=len(buckets), kernels=res)
    del panels, lu_panels, livepos, Dm, ys, C, Cw, Cin, Cf, Y0, Yw
    torch.cuda.empty_cache()
    return res


def _kernel_breakdown(fn, trace):
    """Device work of one call of ``fn`` from ``torch.profiler`` (its trace
    written to ``trace``): (count, summed device ms, [(ms, count, name)] by
    name, largest first) over the device-side events (kernels, copies).
    Their durations only; launch gaps between them are not in the sum."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(trace)
    top = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA), reverse=True)
    return sum(c for _, c, _ in top), sum(ms for ms, _, _ in top), top


def _sweep_modes():
    from repro_torch.kernels import supernode as ksn
    return dict(ksn.SWEEP_MODE_LAUNCHES)


def direct_path(dev, ng, seed, out, keep):
    """The slice's main path: auto-dispatch to the supernodal LDLᵀ, solve +
    ∂Σu²/∂val through the shared factors, then a with_values refresh.
    Its analysis and values go into ``keep`` for the panel-kernel phase."""
    import torch
    from repro_torch import sla
    from repro_torch.core.sparse import coo_matvec
    from repro_torch.data.poisson import poisson2d

    A0 = poisson2d(ng, device=dev)
    n = ng * ng
    f = torch.tensor(np.random.default_rng(seed).normal(size=n), device=dev)
    val = A0.val.clone().requires_grad_(True)
    A = A0.with_values(val)
    _sync(dev)
    _peak_reset(dev)
    _counts_reset()
    t0 = time.perf_counter()
    plan = A.plan()                       # analyze (auto → direct)
    _sync(dev)
    t1 = time.perf_counter()
    plan.setup(A)                         # the numeric factorization
    _sync(dev)
    t2 = time.perf_counter()
    u = sla.solve(A, f)                   # factors reused: sweeps only
    _sync(dev)
    t3 = time.perf_counter()
    (u * u).sum().backward()
    _sync(dev)
    t4 = time.perf_counter()
    launches, stats = _counts()
    modes = _sweep_modes()
    peak = _peak(dev)
    art = plan.artifacts["direct"]
    nb = sum(len(lvl) for lvl in art.snode.schedule) \
        if art.snode is not None else 0
    nbytes = plan.nbytes()
    info = sla.solve_with_info(A, f)      # pure solve: sweeps + residual
    solve_ms = wall_ms(lambda: sla.solve_with_info(A, f), 3)
    with torch.no_grad():
        relres = float((f - coo_matvec(A0.val, A0.row, A0.col, info.x, n))
                       .norm() / f.norm())
    g = val.grad.detach().clone()
    # refactorization: new values, same analysis
    t5 = time.perf_counter()
    u3 = sla.solve(A0.with_values(1.5 * val.detach()), f)
    _sync(dev)
    t6 = time.perf_counter()
    stats2 = _counts()[1]
    with torch.no_grad():
        rel3 = float((f - coo_matvec(1.5 * A0.val, A0.row, A0.col, u3, n))
                     .norm() / f.norm())
    # device work inside the host loops: summed kernel time of one
    # refactorization (fresh values) and of one solve, from profiler traces
    fact = lambda: plan.setup(A0.with_values(2.0 * A0.val))
    fact_wall = wall_ms(fact, 3)
    kern = {"factorize": _kernel_breakdown(
        fact, os.path.join(OUT, "direct_factorize_trace.json"))}
    sla.solve_with_info(A, f)     # the memo holds one values tensor: refill
    kern["solve"] = _kernel_breakdown(
        lambda: sla.solve_with_info(A, f),
        os.path.join(OUT, "direct_solve_trace.json"))
    busy = {"factorize": kern["factorize"][1] / fact_wall,
            "solve": kern["solve"][1] / solve_ms}
    # the factorization's device ops: the two panel kernels once per
    # bucket, and only the set-up besides (assembly, pivot scale, counters)
    ftop = kern["factorize"][2]
    fk = {key: [(ms, c) for ms, c, name in ftop if pat in name]
          for key, pat in (("panel_factor", "panel_factor_kernel"),
                           ("schur_update", "schur_kernel"))}
    fact_kernels = {key: dict(launches=sum(c for _, c in v),
                              ms=sum(ms for ms, _ in v))
                    for key, v in fk.items()}
    others = [(ms, c, name) for ms, c, name in ftop
              if "panel_factor_kernel" not in name
              and "schur_kernel" not in name]
    n_others = sum(c for _, c, _ in others)
    # a solve's device ops: one sn_sweep launch per bucket and sweep, and
    # only the set-up and the residual besides
    stop = kern["solve"][2]
    solve_sweeps = sum(c for _, c, name in stop if "sn_sweep_kernel" in name)
    solve_sweep_ms = sum(ms for ms, _, name in stop
                         if "sn_sweep_kernel" in name)
    solve_others = [(ms, c, name) for ms, c, name in stop
                    if "sn_sweep_kernel" not in name]
    n_solve_others = sum(c for _, c, _ in solve_others)
    say(f"  direct path poisson2d({ng}) (n={n}): backend={plan.cfg.backend} "
        f"method={plan.cfg.method} supernodal={art.snode is not None} "
        f"buckets={nb} levels={len(art.snode.schedule)} "
        f"nnz(L)={art.stats['nnz_L']}")
    say(f"  analyze {t1 - t0:.3f} s, factorize {t2 - t1:.3f} s, first solve "
        f"{t3 - t2:.3f} s, backward {t4 - t3:.3f} s, solve "
        f"{solve_ms:.2f} ms (solve_with_info, wall), refactorize + solve "
        f"{t6 - t5:.3f} s; plan.nbytes {nbytes / 1e9:.3f} GB; peak device "
        f"memory {peak:.2f} GB")
    say(f"  true residual {relres:.3e} (with_values run {rel3:.3e})")
    for stage, (cnt, tot, top) in kern.items():
        wall = fact_wall if stage == "factorize" else solve_ms
        say(f"  {stage} trace: {cnt} device ops, {tot:.2f} ms of device time "
            f"in {wall:.1f} ms of wall (device busy {busy[stage]:.0%}); "
            + "; ".join(f"{name[:60]} {ms:.2f} ms ×{c}"
                        for ms, c, name in top[:5]))
    say(f"  factorize trace: panel_factor ×"
        f"{fact_kernels['panel_factor']['launches']} "
        f"{fact_kernels['panel_factor']['ms']:.4f} ms, schur_update ×"
        f"{fact_kernels['schur_update']['launches']} "
        f"{fact_kernels['schur_update']['ms']:.4f} ms; {n_others} other "
        f"device ops: " + "; ".join(f"{name[:50]} ×{c}"
                                    for _, c, name in others))
    say(f"  solve trace: sn_sweep ×{solve_sweeps} {solve_sweep_ms:.4f} ms; "
        f"{n_solve_others} other device ops: "
        + "; ".join(f"{name[:50]} ×{c}" for _, c, name in solve_others)
        + f"; device busy {busy['solve']:.1%} of the solve's wall")
    say(f"  launches {json.dumps({k: v for k, v in launches.items() if v})}; "
        f"sn_sweep by mode {json.dumps(modes)}")
    say(f"  PLAN_STATS {json.dumps({k: v for k, v in stats.items() if v})}; "
        "after with_values "
        + json.dumps({k: v for k, v in stats2.items() if v}))
    # the same gradient from CG on the iterative backend
    val2 = A0.val.clone().requires_grad_(True)
    t7 = time.perf_counter()
    u2 = sla.solve(A0.with_values(val2), f, backend="jnp", tol=TOL_CG_REF,
                   maxiter=MAXITER)
    (u2 * u2).sum().backward()
    _sync(dev)
    t8 = time.perf_counter()
    gerr = _grad_rel(g, val2.grad)
    say(f"  CG (jnp, tol {TOL_CG_REF:.0e}) solve + backward {t8 - t7:.3f} s; "
        f"val-gradient max rel diff {gerr:.3e}")
    check(plan.cfg.backend == "direct" and plan.cfg.method == "ldlt"
          and art.snode is not None,
          "direct path: auto → direct / ldlt on the supernodal program")
    check(art.factor is None and art.row_sweep is None,
          "direct path: no scalar program placed on the device")
    check(bool(torch.isfinite(u).all()) and relres <= TOL_DIRECT_RES,
          f"direct path: true residual {relres:.2e} <= {TOL_DIRECT_RES:.0e}")
    check(gerr <= TOL_GRAD, f"direct path: val.grad matches CG ({gerr:.2e} "
          f"<= {TOL_GRAD:.0e})")
    check(stats["analyze"] == 1 and stats["factorize"] == 1
          and stats["transpose_shared"] == 1,
          "direct path: analyze == 1, factorize == 1, transpose_shared == 1")
    check(launches["panel_factor"] == launches["schur_update"] == nb,
          f"direct path: panel_factor and schur_update launched once per "
          f"bucket ({launches['panel_factor']}, {launches['schur_update']} "
          f"== {nb})")
    check(fact_kernels["panel_factor"]["launches"] == nb
          and fact_kernels["schur_update"]["launches"] == nb
          and n_others <= 32,
          f"direct path: a refactorization runs panel_factor and "
          f"schur_update once per bucket and {n_others} other device ops "
          f"(<= 32: no per-bucket gather, scatter or index_add_)")
    check(launches["sn_sweep"] == 4 * nb
          and modes["l"] + modes["ut"] == modes["u"] + modes["lt"] == 2 * nb,
          f"direct path: solve + backward launched sn_sweep 4 × buckets "
          f"({launches['sn_sweep']} == {4 * nb}): once per bucket in each "
          f"of the two sweeps of each solve ({json.dumps(modes)}; the "
          f"symmetric adjoint runs l / u again)")
    check(solve_sweeps <= 2 * nb and n_solve_others <= SOLVE_OTHER_OPS,
          f"direct path: a solve runs {solve_sweeps} sn_sweep launches (<= "
          f"2 × {nb}) and {n_solve_others} other device ops (<= "
          f"{SOLVE_OTHER_OPS}: no per-bucket gather, where, einsum or "
          f"index_add_)")
    check(stats2["analyze"] == 1 and stats2["factorize"] == 2
          and rel3 <= TOL_DIRECT_RES,
          f"direct path: with_values refactorizes without re-analysis "
          f"(analyze 1, factorize 2, residual {rel3:.2e})")
    check(nbytes < 2e9,
          f"direct path: plan.nbytes {nbytes / 1e9:.3f} GB < 2 GB")
    check(kern["factorize"][0] > 0 and kern["solve"][0] > 0,
          "direct path: the profiler saw the device work")
    out["direct_path"] = dict(
        ng=ng, n=n, buckets=nb, levels=len(art.snode.schedule),
        nnz_L=art.stats["nnz_L"], analyze_s=t1 - t0, factorize_s=t2 - t1,
        first_solve_s=t3 - t2, backward_s=t4 - t3, solve_ms=solve_ms,
        refactorize_solve_s=t6 - t5, cg_run_s=t8 - t7, true_residual=relres,
        refactorize_wall_ms=fact_wall, device_busy=busy,
        factorize_kernels=fact_kernels, factorize_other_ops=n_others,
        solve_sweeps=solve_sweeps, solve_sweep_ms=solve_sweep_ms,
        solve_other_ops=n_solve_others,
        kernel_breakdown={k: dict(kernels=v[0], kernel_ms=v[1], top=v[2])
                          for k, v in kern.items()},
        grad_rel_diff=gerr, plan_nbytes=nbytes, peak_gb=peak,
        launches=launches, sweep_modes=modes, plan_stats=stats,
        plan_stats_after_with_values=stats2)
    keep.update(art=art, val=A0.val)
    del A, A0, u, u2, u3, info, val, val2, plan, art
    torch.cuda.empty_cache()
    return launches


def lu_path(dev, ng, seed, out):
    """Non-symmetric values on a symmetric pattern: auto → direct / LU; the
    adjoint runs the Uᵀ/Lᵀ sweeps on the forward factors."""
    import torch
    from repro_torch import sla
    from repro_torch.core.sparse import SparseTensor
    from repro_torch.data.poisson import poisson2d

    A0 = poisson2d(ng, device=dev)
    n = ng * ng
    v0 = A0.val.clone()
    v0[A0.col == A0.row - 1] = -1.4
    v0[A0.col == A0.row + 1] = -0.6
    props = {"symmetric": False, "spd_hint": False, "sorted_rows": False}
    B = SparseTensor(v0, A0.row, A0.col, A0.shape, props=props, device=dev)
    b = torch.tensor(np.random.default_rng(seed).normal(size=n), device=dev)
    leaf = v0.clone().requires_grad_(True)
    _sync(dev)
    _counts_reset()
    t0 = time.perf_counter()
    u = sla.solve(B.with_values(leaf), b)
    _sync(dev)
    t1 = time.perf_counter()
    fwd = _sweep_modes()
    (u * u).sum().backward()
    _sync(dev)
    t2 = time.perf_counter()
    launches, stats = _counts()
    modes = _sweep_modes()
    plan = B.plan()
    leaf2 = v0.clone().requires_grad_(True)
    t3 = time.perf_counter()
    u2 = sla.solve(B.with_values(leaf2), b, backend="dense")
    (u2 * u2).sum().backward()
    _sync(dev)
    t4 = time.perf_counter()
    uerr = _grad_rel(u.detach(), u2.detach())
    gerr = _grad_rel(leaf.grad, leaf2.grad)
    say(f"  LU path drift poisson2d({ng}) (n={n}): backend={plan.cfg.backend} "
        f"method={plan.cfg.method}; forward {t1 - t0:.3f} s, backward "
        f"{t2 - t1:.3f} s; dense backend {t4 - t3:.3f} s; solution rel diff "
        f"{uerr:.3e}, val-gradient rel diff {gerr:.3e}")
    say(f"  sn_sweep by mode: forward {json.dumps(fwd)}, forward + "
        f"backward {json.dumps(modes)}")
    say(f"  PLAN_STATS {json.dumps({k: v for k, v in stats.items() if v})}")
    check(plan.cfg.backend == "direct" and plan.cfg.method == "lu",
          "LU path: auto → direct / lu")
    check(uerr <= TOL_DENSE and gerr <= TOL_DENSE,
          f"LU path: solution and val.grad match the dense backend "
          f"({uerr:.2e}, {gerr:.2e} <= {TOL_DENSE:.0e})")
    check(stats["analyze"] == 1 and stats["factorize"] == 1
          and stats["transpose_shared"] == 1,
          "LU path: analyze == 1, factorize == 1, transpose_shared == 1")
    check(fwd["ut"] == fwd["lt"] == 0 and modes["ut"] > 0 and modes["lt"] > 0,
          f"LU path: the backward ran sn_sweep in modes ut ({modes['ut']}) "
          f"and lt ({modes['lt']})")
    out["lu_path"] = dict(ng=ng, n=n, forward_s=t1 - t0, backward_s=t2 - t1,
                          dense_run_s=t4 - t3, solution_rel_diff=uerr,
                          grad_rel_diff=gerr, launches=launches,
                          sweep_modes_forward=fwd, sweep_modes=modes,
                          plan_stats=stats)
    del A0, B, u, u2, leaf, leaf2, plan
    torch.cuda.empty_cache()
    return launches


def indefinite_path(dev, m, k, seed, out):
    """A saddle point [[H, Bᵀ], [B, 0]] with static Bunch–Kaufman pairs:
    no perturbation, solve / transposed solve / slogdet / its gradient
    against torch.linalg."""
    import warnings
    import torch
    from repro_torch import sla

    rng = np.random.default_rng(seed)
    H = rng.standard_normal((m, m))
    H = H @ H.T + m * np.eye(m)
    Bm = rng.standard_normal((k, m))
    Ad = np.block([[H, Bm.T], [Bm, np.zeros((k, k))]])
    n = m + k
    row, col = np.nonzero((np.abs(Ad) > 1e-12) | np.eye(n, dtype=bool))
    T = sla.SparseTensor(Ad[row, col], row, col, (n, n),
                         props={"indefinite_hint": True}, device=dev)
    Adt = torch.tensor(Ad, device=dev)
    b = torch.tensor(rng.normal(size=n), device=dev)
    g = torch.tensor(rng.normal(size=n), device=dev)
    _counts_reset()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("error")            # a perturbation fails
        bt = b.clone().requires_grad_(True)
        x = sla.solve(T, bt, backend="direct", method="lu")
        (x * g).sum().backward()                  # bt.grad = A⁻ᵀ g
        vleaf = T.val.clone().requires_grad_(True)
        sign, logabs = T.with_values(vleaf).slogdet()
        logabs.backward()
    _sync(dev)
    t1 = time.perf_counter()
    launches, stats = _counts()
    modes = _sweep_modes()
    plan = T.plan(backend="direct", method="lu")
    npairs = plan.artifacts["direct"].snode.stats["n_pair_pivots"]
    xd = torch.linalg.solve(Adt, b)
    xtd = torch.linalg.solve(Adt.T, g)
    sd, ld = torch.linalg.slogdet(Adt)
    gd = torch.linalg.inv(Adt).T[T.row, T.col]
    xerr = _grad_rel(x.detach(), xd)
    xterr = _grad_rel(bt.grad, xtd)
    lerr = abs(float(logabs.detach()) - float(ld)) / max(abs(float(ld)), 1.0)
    gerr = _grad_rel(vleaf.grad, gd)
    say(f"  indefinite path saddle H {m}², B {k}×{m} (n={n}): "
        f"{npairs} pair pivots; {t1 - t0:.3f} s; solve rel diff {xerr:.3e}, "
        f"transposed {xterr:.3e}; slogdet sign {float(sign):+.0f} "
        f"(torch {float(sd):+.0f}), log|det| rel diff {lerr:.3e}, gradient "
        f"rel diff {gerr:.3e}")
    say(f"  PLAN_STATS {json.dumps({k2: v for k2, v in stats.items() if v})}"
        f"; sn_sweep by mode {json.dumps(modes)}")
    check(npairs > 0, f"indefinite path: {npairs} static 2x2 pivots, no "
          f"perturbation warning")
    check(xerr <= TOL_DENSE and xterr <= TOL_DENSE,
          f"indefinite path: solve and transposed solve match torch.linalg "
          f"({xerr:.2e}, {xterr:.2e} <= {TOL_DENSE:.0e})")
    check(float(sign) == float(sd) and lerr <= 1e-10,
          f"indefinite path: slogdet sign and log|det| ({lerr:.2e} <= 1e-10)")
    check(gerr <= TOL_DENSE, f"indefinite path: slogdet gradient matches "
          f"A⁻ᵀ on the pattern ({gerr:.2e} <= {TOL_DENSE:.0e})")
    check(min(modes.values()) > 0, f"indefinite path: sn_sweep ran in all "
          f"four modes, with pairs ({json.dumps(modes)})")
    out["indefinite_path"] = dict(
        m=m, k=k, n=n, pair_pivots=npairs, seconds=t1 - t0,
        solve_rel_diff=xerr, transposed_rel_diff=xterr,
        logdet_rel_diff=lerr, grad_rel_diff=gerr, launches=launches,
        sweep_modes=modes, plan_stats=stats)
    del T, Adt, plan
    torch.cuda.empty_cache()
    return launches


def ilu_path(dev, ng, tol, maxiter, out):
    """CG with ILU(0) (the scalar packed program) against Jacobi."""
    import torch
    from repro_torch import sla
    from repro_torch.data.poisson import poisson2d

    A0 = poisson2d(ng, device=dev)
    n = ng * ng
    b = torch.ones(n, dtype=torch.float64, device=dev)
    res, grads, total = {}, {}, {}
    for pre in ("jacobi", "ilu"):
        leaf = A0.val.clone().requires_grad_(True)
        A = A0.with_values(leaf)
        _sync(dev)
        _counts_reset()
        t0 = time.perf_counter()
        u = sla.solve(A, b, backend="jnp", precond=pre, tol=tol,
                      maxiter=maxiter)
        _sync(dev)
        t1 = time.perf_counter()
        (u * u).sum().backward()
        _sync(dev)
        t2 = time.perf_counter()
        launches, stats = _counts()
        t3 = time.perf_counter()
        info = sla.solve_with_info(A, b, backend="jnp", precond=pre, tol=tol,
                                   maxiter=maxiter)
        _sync(dev)
        t4 = time.perf_counter()
        it = int(info.iterations)
        grads[pre] = leaf.grad.detach().clone()
        res[pre] = dict(iterations=it, forward_s=t1 - t0, backward_s=t2 - t1,
                        loop_s=t4 - t3, ms_per_iteration=(t4 - t3) / it * 1e3,
                        converged=info.reason == "converged",
                        launches=launches, plan_stats=stats)
        for kk, v in launches.items():
            total[kk] = total.get(kk, 0) + v
        say(f"  ILU path poisson2d({ng}) jnp/cg precond={pre}: {it} "
            f"iterations, forward {t1 - t0:.3f} s (setup included), "
            f"backward {t2 - t1:.3f} s, re-solve {t4 - t3:.3f} s = "
            f"{(t4 - t3) / it * 1e3:.2f} ms/iteration")
    gerr = _grad_rel(grads["ilu"], grads["jacobi"])
    say(f"  val-gradient ILU vs Jacobi max rel diff {gerr:.3e}")
    check(res["ilu"]["converged"] and res["jacobi"]["converged"]
          and res["ilu"]["iterations"] < res["jacobi"]["iterations"],
          f"ILU path: ILU(0) converges in fewer iterations "
          f"({res['ilu']['iterations']} < {res['jacobi']['iterations']})")
    check(gerr <= TOL_GRAD, f"ILU path: gradient matches the Jacobi run "
          f"({gerr:.2e} <= {TOL_GRAD:.0e})")
    out["ilu_path"] = dict(ng=ng, n=n, tol=tol, grad_rel_diff=gerr, **res)
    del A0
    return total


# ---------------------------------------------------------------------------
# phases 11a–11c: the preconditioned Krylov path (MG, AMG, GMRES + block-
# Jacobi, plan Chebyshev)
# ---------------------------------------------------------------------------

class plain_kernels:
    """Within the block, every kernel wrapper the paths call runs its plain
    PyTorch version (``kernels/ref.py``) on the card's tensors instead of
    launching its kernel — the same path, the same algorithm, the plain
    arithmetic.  The wrappers are swapped by module attribute and put back
    on exit; no launch is counted inside."""

    def __enter__(self):
        from repro_torch.kernels import (ops, ref, solve_step, stencil5,
                                         supernode)

        def st(meta, v5, x):
            return ref.stencil5_ref(v5, x)

        def spmv(sell, vals, x, n):
            return ref.sell_matvec_ref(sell.slice_ptr, sell.cols, vals, x, n)

        def fused(name, vecs, scalars, out=None, active=None):
            return solve_step._run_cpu(name, vecs, scalars, out, active,
                                       solve_step.BODIES[name][3])

        def pf(C, pidx, qidx, wvec, rvec, tau, bkm, *, pairs=False,
               guard=True, nbad=None, work=None):
            if nbad is None:
                nbad = C.new_zeros(())
            return nbad.add_(ref.sn_panel_factor_inplace_ref(
                C, pidx, qidx, wvec, rvec, tau, bkm, pairs=pairs,
                guard=guard))

        def su(C, pidx, qidx, wvec, rvec, tgt, toff):
            ref.sn_schur_inplace_ref(C, pidx, qidx, wvec, rvec, tgt)
            return C

        def sw(C, y, bk, mode, *, work=None, part=None):
            ref.sn_sweep_inplace_ref(C, y, bk.pidx, bk.qidx, bk.rows,
                                     bk.wvec, bk.rvec, bk.bkm, mode=mode,
                                     pairs=bk.pairs)
            return y

        self.saved = []
        for mod, name, fn in ((stencil5, "stencil5", st), (ops, "stencil5", st),
                              (ops, "bell_spmv", spmv),
                              (solve_step, "_run", fused),
                              (supernode, "panel_factor_inplace", pf),
                              (supernode, "schur_update_inplace", su),
                              (supernode, "sn_sweep_inplace", sw)):
            self.saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, fn)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False


def _plain_run(make_leaf, run):
    """The path once more inside :class:`plain_kernels`: ``run(leaf)``
    returns the solution u; returns (∂Σu²/∂leaf, seconds, launches inside
    — all zero if the swap held)."""
    leaf = make_leaf()
    _counts_reset()
    t = time.perf_counter()
    with plain_kernels():
        u = run(leaf)
        (u * u).sum().backward()
    _sync(leaf.device)
    dt = time.perf_counter() - t
    launches, _ = _counts()
    return leaf.grad.detach().clone(), dt, sum(launches.values())


def mg_path(dev, ng, tol, maxiter, seed, out):
    """Phase 11a: CG + geometric MG on the stencil path's operator."""
    import torch
    from repro_torch import sla
    from repro_torch.data.poisson import poisson2d_vc
    from repro_torch.kernels import launch_counts, ref

    kap_np = smooth_kappa(ng, seed)
    n = ng * ng
    f = torch.ones(n, dtype=torch.float64, device=dev)
    kw = dict(tol=tol, maxiter=maxiter, precond="mg")
    kappa = torch.tensor(kap_np, device=dev, requires_grad=True)
    _sync(dev)
    _peak_reset(dev)
    _counts_reset()
    t0 = time.perf_counter()
    A = poisson2d_vc(kappa, use_stencil_kernel=True, device=dev)
    u = sla.solve(A, f, **kw)
    _sync(dev)
    t1 = time.perf_counter()
    (u * u).sum().backward()
    _sync(dev)
    t2 = time.perf_counter()
    launches, stats = _counts()
    peak = _peak(dev)
    plan = A.plan(**kw)
    t3 = time.perf_counter()
    info = sla.solve_with_info(A, f, **kw)
    _sync(dev)
    t4 = time.perf_counter()
    iters = int(info.iterations)
    with torch.no_grad():
        v5 = A.val.detach().reshape(5, ng, ng)
        relres = float((f - ref.stencil5_ref(v5, info.x.reshape(ng, ng))
                        .reshape(-1)).norm() / f.norm())
    # one V-cycle on the path's own hierarchy: its stencil5 launches, time
    pre = plan.artifacts["precond"]
    M = pre.make_apply(plan.setup(A)[1], None)
    before = launch_counts()["stencil5"]
    M(f)
    _sync(dev)
    per_cycle = launch_counts()["stencil5"] - before
    cyc_ms = cuda_ms(lambda: M(f), 5, warmup=1, spin_ms=5.0)
    cyc_wall = wall_ms(lambda: M(f), 5)
    jac = out["stencil_path"]["iterations"]
    say(f"  MG path ng={ng} (n={n}): backend={plan.cfg.backend} method="
        f"{plan.cfg.method} precond=mg, {len(M.sizes)} levels "
        f"{M.sizes[0]}..{M.sizes[-1]}; {iters} iterations (Jacobi: {jac}); "
        f"forward {t1 - t0:.3f} s, backward {t2 - t1:.3f} s, "
        f"solve_with_info {t4 - t3:.3f} s = {(t4 - t3) / max(iters, 1) * 1e3:.3f}"
        f" ms/iteration; true residual {relres:.3e}")
    say(f"  one V-cycle: {per_cycle} stencil5 launches, {cyc_ms:.4f} ms of "
        f"device time, {cyc_wall:.4f} ms of host wall; peak {peak:.3f} GB")
    say(f"  launches {json.dumps({k: v for k, v in launches.items() if v})}")
    say(f"  PLAN_STATS {json.dumps({k: v for k, v in stats.items() if v})}")
    g = kappa.grad.detach().clone()

    def run(leaf):
        return sla.solve(poisson2d_vc(leaf, use_stencil_kernel=True,
                                      device=dev), f, **kw)

    g2, plain_s, plain_launches = _plain_run(
        lambda: torch.tensor(kap_np, device=dev, requires_grad=True), run)
    gerr = _grad_rel(g, g2)
    say(f"  plain run (every kernel's plain version): {plain_s:.3f} s; "
        f"κ-gradient max rel diff {gerr:.3e}")
    check(plain_launches == 0, "MG path: the plain run launched no kernel")
    check(bool(torch.isfinite(u).all()) and u.shape == (n,),
          "MG path: finite solution of shape (n,)")
    check(info.reason == "converged" and relres <= 10 * tol,
          f"MG path: converged, true residual {relres:.2e} <= 10·tol")
    check(iters * MG_RATIO < jac, f"MG path: {iters} iterations, fewer than "
          f"1/{MG_RATIO} of Jacobi's {jac} on the same operator")
    check(bool(torch.isfinite(g).all()) and gerr <= TOL_GRAD,
          f"MG path: κ.grad matches the plain run ({gerr:.2e} <= "
          f"{TOL_GRAD:.0e})")
    check(stats["analyze"] == 1 and stats["transpose_shared"] == 1,
          "MG path: analyze == 1, transpose_shared == 1")
    check(per_cycle == 5 * (len(M.sizes) - 1),
          f"MG path: a V-cycle launches stencil5 5 times per level above "
          f"the coarsest ({per_cycle})")
    for k in ("stencil5", "fused_cg_halfstep"):
        check(launches[k] > 0, f"MG path launched {k} ({launches[k]} times)")
    out["mg_path"] = dict(
        ng=ng, n=n, tol=tol, iterations=iters, jacobi_iterations=jac,
        levels=M.sizes, forward_s=t1 - t0, backward_s=t2 - t1,
        info_solve_s=t4 - t3, ms_per_iteration=(t4 - t3) / max(iters, 1) * 1e3,
        vcycle_stencil5=per_cycle, vcycle_ms=cyc_ms, vcycle_wall_ms=cyc_wall,
        true_residual=relres, grad_rel_diff=gerr, plain_run_s=plain_s,
        peak_gb=peak, launches=launches, plan_stats=stats)
    del A, u, info, kappa, M
    return launches


class _timed:
    """Wraps a module function and sums its wall seconds (measurement)."""

    def __init__(self, mod, name):
        self.mod, self.name, self.seconds = mod, name, 0.0

    def __enter__(self):
        self.fn = getattr(self.mod, self.name)

        def wrapped(*a, **kw):
            t = time.perf_counter()
            try:
                return self.fn(*a, **kw)
            finally:
                self.seconds += time.perf_counter() - t

        setattr(self.mod, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.fn)
        return False


def _amg_case(dev, label, A0, b, tol, maxiter, jac):
    """CG + amg on the block-ELL kernel (``backend="pallas"``): analyze,
    setup, solve + backward, repeated solves; the same run on the plain
    versions for the gradient."""
    import torch
    from repro_torch import sla
    from repro_torch.core import multigrid as tmg
    from repro_torch.core.sparse import coo_matvec

    n = A0.shape[0]
    kw = dict(backend="pallas", method="cg", tol=tol, maxiter=maxiter,
              precond="amg")
    val = A0.val.clone().requires_grad_(True)
    A = A0.with_values(val)
    _sync(dev)
    _peak_reset(dev)
    _counts_reset()
    t0 = time.perf_counter()
    with _timed(tmg, "amg_symbolic") as tsym, _timed(tmg, "amg_to_device") \
            as tdev:
        plan = A.plan(**kw)
    _sync(dev)
    t1 = time.perf_counter()
    plan.setup(A)                       # Galerkin + coarsest factorization
    _sync(dev)
    t2 = time.perf_counter()
    u = sla.solve(A, b, **kw)
    _sync(dev)
    t3 = time.perf_counter()
    (u * u).sum().backward()
    _sync(dev)
    t4 = time.perf_counter()
    launches, stats = _counts()
    peak = _peak(dev)
    art = plan.artifacts["precond"]._amg
    sizes = art.stats["sizes"]
    iters, walls = [], []
    for _ in range(AMG_REPEATS):       # fresh values: fresh Galerkin sums
        Ai = A0.with_values(A0.val.clone())
        _sync(dev)
        t = time.perf_counter()
        info = sla.solve_with_info(Ai, b, **kw)
        _sync(dev)
        walls.append(time.perf_counter() - t)
        iters.append(int(info.iterations))
    with torch.no_grad():
        relres = float((b - coo_matvec(A0.val, A0.row, A0.col, info.x, n))
                       .norm() / b.norm())
    nbytes = plan.nbytes()
    say(f"  AMG path {label} (n={n}, nnz={A0.nnz}): kernel="
        f"{plan.artifacts['kernel'].choice}; analyze {t1 - t0:.2f} s (AMG "
        f"symbolic {tsym.seconds:.2f} s, placing it {tdev.seconds:.2f} s); "
        f"setup {1e3 * (t2 - t1):.1f} ms; levels {sizes}; coarsest "
        f"{'supernodal' if art.coarse.snode is not None else 'scalar'}")
    say(f"  {iters[0]} iterations (Jacobi: {jac}); forward {t3 - t2:.3f} s, "
        f"backward {t4 - t3:.3f} s; solve_with_info {walls[0]:.3f} s = "
        f"{walls[0] / max(iters[0], 1) * 1e3:.3f} ms/iteration (setup "
        f"included; over {AMG_REPEATS} runs {min(walls):.3f}–"
        f"{max(walls):.3f} s, iterations {iters}); true residual "
        f"{relres:.3e}; peak {peak:.3f} GB, plan.nbytes {nbytes / 1e9:.3f} GB")
    say(f"  launches {json.dumps({k: v for k, v in launches.items() if v})}")
    say(f"  PLAN_STATS {json.dumps({k: v for k, v in stats.items() if v})}")
    g = val.grad.detach().clone()
    g2, plain_s, plain_launches = _plain_run(
        lambda: A0.val.clone().requires_grad_(True),
        lambda leaf: sla.solve(A0.with_values(leaf), b, **kw))
    gerr = _grad_rel(g, g2)
    say(f"  plain run (every kernel's plain version): {plain_s:.3f} s; "
        f"val-gradient max rel diff {gerr:.3e}")
    check(plain_launches == 0, f"AMG path {label}: the plain run launched "
          f"no kernel")
    check(bool(torch.isfinite(u).all()) and relres <= 10 * tol,
          f"AMG path {label}: finite, true residual {relres:.2e} <= 10·tol")
    check(len(set(iters)) == 1, f"AMG path {label}: the iteration count "
          f"holds over {AMG_REPEATS} fresh setups ({iters})")
    check(iters[0] * AMG_RATIO <= jac, f"AMG path {label}: {iters[0]} "
          f"iterations, at most 1/{AMG_RATIO} of Jacobi's {jac}")
    check(stats["coarsen"] == 1 and stats["galerkin"] == 1
          and stats["analyze"] == 1,
          f"AMG path {label}: coarsen 1, galerkin 1, analyze 1 across the "
          f"solve and its backward")
    check(bool(torch.isfinite(g).all()) and gerr <= TOL_GRAD,
          f"AMG path {label}: val.grad matches the plain run ({gerr:.2e} <= "
          f"{TOL_GRAD:.0e})")
    for k in ("bell_spmv", "fused_cg_halfstep", "panel_factor", "sn_sweep"):
        check(launches[k] > 0, f"AMG path {label} launched {k} "
              f"({launches[k]} times)")
    res = dict(n=n, nnz=A0.nnz, tol=tol, analyze_s=t1 - t0,
               amg_symbolic_s=tsym.seconds, amg_to_device_s=tdev.seconds,
               setup_ms=1e3 * (t2 - t1), levels=sizes,
               coarse_supernodal=art.coarse.snode is not None,
               iterations=iters, jacobi_iterations=jac,
               forward_s=t3 - t2, backward_s=t4 - t3, info_solve_s=walls,
               ms_per_iteration=walls[0] / max(iters[0], 1) * 1e3,
               true_residual=relres, grad_rel_diff=gerr, plain_run_s=plain_s,
               peak_gb=peak, plan_nbytes=nbytes, launches=launches,
               plan_stats=stats)
    del A, u, val, plan, art
    return res, launches


def amg_path(dev, ng, n_graph, tol, maxiter, out):
    """Phase 11b: CG + smoothed-aggregation AMG on ``poisson2d(ng)`` and on
    an unstructured graph Laplacian of the same order of n."""
    import torch
    from repro_torch import sla
    from repro_torch.data.graphs import graph_laplacian
    from repro_torch.data.poisson import poisson2d

    total = {}
    A0 = poisson2d(ng, device=dev)
    b = torch.ones(ng * ng, dtype=torch.float64, device=dev)
    res, launches = _amg_case(dev, f"poisson2d({ng})", A0, b, tol, maxiter,
                              out["bell_path"]["iterations"])
    out["amg_path"] = {"poisson2d": dict(ng=ng, **res)}
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    del A0
    torch.cuda.empty_cache()
    t = time.perf_counter()
    G = graph_laplacian(n_graph, seed=SEED, shift=1e-3, device=dev)
    gen_s = time.perf_counter() - t
    bg = torch.tensor(np.random.default_rng(SEED).normal(size=n_graph),
                      device=dev)
    t = time.perf_counter()
    jinfo = sla.solve_with_info(G, bg, backend="pallas", method="cg",
                                tol=tol, maxiter=maxiter)
    _sync(dev)
    jac_s = time.perf_counter() - t
    jac = int(jinfo.iterations)
    say(f"  unstructured graph: graph_laplacian({n_graph}, seed {SEED}, "
        f"shift 1e-3) made in {gen_s:.2f} s (host numpy); CG + Jacobi on "
        f"the block-ELL kernel: {jac} iterations, {jac_s:.3f} s "
        f"({jinfo.reason})")
    check(jinfo.reason == "converged", "AMG path: the graph's Jacobi run "
          "converged")
    res, launches = _amg_case(dev, f"graph_laplacian({n_graph})", G, bg, tol,
                              maxiter, jac)
    out["amg_path"]["graph"] = dict(generate_s=gen_s, jacobi_s=jac_s, **res)
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    del G
    return total


def krylov_path(dev, ng, ng_cheb, tol_gmres, tol, maxiter, out):
    """Phase 11c: GMRES(32) + block-Jacobi on the transposed path's
    non-symmetric drift operator (block-ELL kernel, with the backward)
    against BiCGStab; CG + the plan Chebyshev (fused) at poisson2d."""
    import torch
    from repro_torch import sla
    from repro_torch.core.sparse import SparseTensor, coo_matvec
    from repro_torch.data.poisson import poisson2d

    total = {}
    n = ng * ng
    A0 = poisson2d(ng, device=dev)
    v0 = A0.val.clone()
    v0[A0.col == A0.row - 1] = -1.4
    v0[A0.col == A0.row + 1] = -0.6
    props = {"symmetric": False, "spd_hint": False, "sorted_rows": False}
    B = SparseTensor(v0, A0.row, A0.col, A0.shape, props=props, device=dev)
    b = torch.ones(n, dtype=torch.float64, device=dev)
    kw = dict(backend="pallas", method="gmres", tol=tol_gmres,
              maxiter=maxiter, precond="block_jacobi")
    leaf = v0.clone().requires_grad_(True)
    _sync(dev)
    _counts_reset()
    t0 = time.perf_counter()
    u = sla.solve(B.with_values(leaf), b, **kw)
    _sync(dev)
    t1 = time.perf_counter()
    (u * u).sum().backward()
    _sync(dev)
    t2 = time.perf_counter()
    launches, stats = _counts()
    t3 = time.perf_counter()
    info = sla.solve_with_info(B, b, **kw)
    _sync(dev)
    t4 = time.perf_counter()
    binfo = sla.solve_with_info(B, b, backend="pallas", method="bicgstab",
                                tol=tol_gmres, maxiter=maxiter,
                                precond="block_jacobi")
    _sync(dev)
    t5 = time.perf_counter()
    with torch.no_grad():
        rel_g = float((b - coo_matvec(v0, B.row, B.col, info.x, n)).norm()
                      / b.norm())
        rel_b = float((b - coo_matvec(v0, B.row, B.col, binfo.x, n)).norm()
                      / b.norm())
    g = leaf.grad.detach().clone()
    g2, plain_s, plain_launches = _plain_run(
        lambda: v0.clone().requires_grad_(True),
        lambda lf: sla.solve(B.with_values(lf), b, **kw))
    gerr = _grad_rel(g, g2)
    restart = B.plan(**kw).cfg.restart          # the default, 32
    say(f"  GMRES({restart}) + block_jacobi, drift poisson2d({ng}) "
        f"(n={n}) on the block-ELL kernel: {int(info.iterations)} iterations "
        f"({int(info.iterations) // restart} cycles) in "
        f"{t4 - t3:.3f} s, true residual {rel_g:.3e}; BiCGStab + "
        f"block_jacobi: {int(binfo.iterations)} iterations in {t5 - t4:.3f} "
        f"s, true residual {rel_b:.3e}; solve + backward {t1 - t0:.3f} + "
        f"{t2 - t1:.3f} s; plain run {plain_s:.3f} s, val-gradient max rel "
        f"diff {gerr:.3e}")
    say(f"  launches {json.dumps({k: v for k, v in launches.items() if v})}")
    check(plain_launches == 0, "GMRES path: the plain run launched no kernel")
    check(info.reason == "converged" and rel_g <= 10 * tol_gmres,
          f"GMRES path: converged, true residual {rel_g:.2e} <= 10·tol")
    check(binfo.reason == "converged", "GMRES path: BiCGStab converged")
    check(stats["analyze"] == 1 and stats["transpose_shared"] == 1,
          "GMRES path: analyze == 1, transpose_shared == 1")
    check(bool(torch.isfinite(g).all()) and gerr <= TOL_GRAD,
          f"GMRES path: val.grad matches the plain run ({gerr:.2e} <= "
          f"{TOL_GRAD:.0e})")
    check(launches["bell_spmv"] > 0, f"GMRES path launched bell_spmv "
          f"({launches['bell_spmv']} times)")
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    res = dict(gmres=dict(ng=ng, n=n, tol=tol_gmres, restart=restart,
                          iterations=int(info.iterations), seconds=t4 - t3,
                          true_residual=rel_g, forward_s=t1 - t0,
                          backward_s=t2 - t1, grad_rel_diff=gerr,
                          plain_run_s=plain_s, launches=launches,
                          plan_stats=stats),
               bicgstab=dict(iterations=int(binfo.iterations),
                             seconds=t5 - t4, true_residual=rel_b))
    del A0, B, u, leaf, info, binfo

    A = poisson2d(ng_cheb, device=dev)
    nc = ng_cheb * ng_cheb
    bc = torch.ones(nc, dtype=torch.float64, device=dev)
    ckw = dict(backend="pallas", method="cg", tol=tol, maxiter=maxiter,
               precond="chebyshev")
    leaf = A.val.clone().requires_grad_(True)
    _sync(dev)
    _counts_reset()
    t0 = time.perf_counter()
    u = sla.solve(A.with_values(leaf), bc, **ckw)
    _sync(dev)
    t1 = time.perf_counter()
    (u * u).sum().backward()
    _sync(dev)
    t2 = time.perf_counter()
    launches, stats = _counts()
    t3 = time.perf_counter()
    info = sla.solve_with_info(A, bc, **ckw)
    _sync(dev)
    t4 = time.perf_counter()
    with torch.no_grad():
        relres = float((bc - coo_matvec(A.val, A.row, A.col, info.x, nc))
                       .norm() / bc.norm())
    lmin, lmax = (float(t) for t in A.plan(**ckw).setup(A)[1])
    it = int(info.iterations)
    say(f"  CG + plan Chebyshev (degree 8, fused) poisson2d({ng_cheb}) "
        f"(n={nc}): bounds [{lmin:.4e}, {lmax:.4f}] (Lanczos, 16 steps); "
        f"{it} iterations (Jacobi: {out['bell_path']['iterations']}) in "
        f"{t4 - t3:.3f} s (setup included) = {(t4 - t3) / max(it, 1) * 1e3:.3f}"
        f" ms/iteration; true residual {relres:.3e}; solve + backward "
        f"{t1 - t0:.3f} + {t2 - t1:.3f} s")
    say(f"  launches {json.dumps({k: v for k, v in launches.items() if v})}")
    check(info.reason == "converged" and relres <= 10 * tol,
          f"Chebyshev path: converged, true residual {relres:.2e} <= 10·tol")
    check(bool(torch.isfinite(leaf.grad).all()), "Chebyshev path: finite "
          "val.grad")
    for k in ("fused_cheb_step", "fused_cg_halfstep", "bell_spmv"):
        check(launches[k] > 0, f"Chebyshev path launched {k} "
              f"({launches[k]} times)")
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    res["chebyshev"] = dict(ng=ng_cheb, n=nc, tol=tol, iterations=it,
                            bounds=(lmin, lmax), seconds=t4 - t3,
                            forward_s=t1 - t0, backward_s=t2 - t1,
                            true_residual=relres, launches=launches,
                            plan_stats=stats)
    out["krylov_path"] = res
    del A, u, leaf, info
    return total


# ---------------------------------------------------------------------------
# phases 13–14: the LM serving path on the flash-attention kernel
# ---------------------------------------------------------------------------

def _attn_work(BH, S, T, d, causal, elem):
    """(bytes, flops) of one attention call: q, k, v read once and o
    written once; 4·d flops per (query, key) pair the mask keeps."""
    if causal:
        i = np.arange(S)
        pairs = int(np.minimum(i + 1, T).sum())
    else:
        pairs = S * T
    return elem * BH * (2 * S * d + 2 * T * d), 4 * BH * d * pairs


def _flash_plain(q, k, v, causal, round_p=False):
    """The plain version in f32 on the same inputs, over chunks of bh that
    keep the (chunk, S, T) score block near 1 GB; ``round_p`` rounds the
    probabilities to bf16 before p·v, as the bf16 kernel does."""
    import torch
    from repro_torch.kernels import ref
    S, T = q.shape[1], k.shape[1]
    step = max(1, (1 << 28) // (S * T))
    return torch.cat([ref.flash_attention_ref(
        q[b:b + step].float(), k[b:b + step].float(), v[b:b + step].float(),
        causal=causal, round_p=round_p) for b in range(0, q.shape[0], step)])


def _flash_err(o, q, k, v, causal, dname):
    """(err, max |o − plain|, distance from the p-rounded plain version):
    the rule of TOL_FLASH, err <= limit ⟺ |o − plain| <= limit·|plain| +
    atol everywhere, plain in f32 with p in f32."""
    limit, atol = TOL_FLASH[dname]
    want = _flash_plain(q, k, v, causal)
    diff = (o.float() - want).abs()
    err = float((diff / (atol / limit + want.abs())).max())
    dist = None
    if dname == "bfloat16":
        # the plain version that rounds p to bf16 once, as the reference
        # model's jnp attention does
        rp = _flash_plain(q, k, v, causal, round_p=True)
        drp = (o.float() - rp).abs()
        dist = dict(max_abs=float(drp.max()), err_rule=float(
            (drp / (atol / limit + rp.abs())).max()))
    return err, float(diff.max()), dist


def flash_phase(dev, seed, out):
    """Phase 13: the flash kernels against their plain versions on the card
    at the main path's layer shape (and its GQA form) and four checking
    shapes; their time, the plain version's, SDPA's (``library_ms``) and
    the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_gqa)

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    res = []
    for label, BH, S, T, d, dname, causal in FLASH_SHAPES:
        dt = getattr(torch, dname)
        q, k, v = (torch.randn((BH, n, d), generator=gen, device=dev).to(dt)
                   for n in (S, T, T))
        o = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err, max_abs, dist = _flash_err(o, q, k, v, causal, dname)
        limit = TOL_FLASH[dname][0]
        nbytes, flops = _attn_work(BH, S, T, d, causal, q.element_size())
        bms, bby = bound_ms(nbytes, flops, dname)
        call = lambda: flash_attention(q, k, v, causal=causal)
        ms = cuda_ms(call, 10, warmup=2, spin_ms=3.0)
        wall = wall_ms(call, 3)
        plain = _sum_ms(lambda: _flash_plain(q, k, v, causal), reps=2)
        q4, k4, v4 = (t[None] for t in (q, k, v))
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal), 10, warmup=2, spin_ms=3.0)
        r = dict(case=label, shape=f"({BH},{S},{T},{d})", dtype=dname,
                 causal=causal, ms=ms, wall_ms=wall, plain_ms=plain,
                 library_ms=lib, bytes=nbytes, flops=flops, bound_ms=bms,
                 bound_by=bby, tflops=flops / ms / 1e9,
                 max_abs_err=max_abs, err=err, limit=limit,
                 round_p_distance=dist)
        res.append(r)
        say(f"  flash_attention {label:14s} {r['shape']:>20s} {dname} "
            f"{'causal' if causal else 'bidir '}: {ms:.4f} ms "
            f"({r['tflops']:.2f} TFLOP/s; host wall {wall:.4f} ms, plain "
            f"{plain:.3f} ms, bound {bms:.4f} ms by {bby}, SDPA {lib:.4f} "
            f"ms); err {err:.2e}, max |o − plain| {max_abs:.2e}"
            + ("" if dist is None else
               f"; vs the p-rounded plain version: max |Δ| "
               f"{dist['max_abs']:.2e}, {dist['err_rule']:.2e} of "
               f"({TOL_FLASH[dname][1] / limit:g} + |plain|)"))
        check(err <= limit, f"flash_attention {label} {r['shape']} {dname} "
              f"matches its plain version ({err:.2e} <= {limit:.0e})")
        del q, k, v, o, q4, k4, v4
        torch.cuda.empty_cache()

    # the model's form: q (B, S, H, d) sliced from one projection output,
    # k, v (B, T, K, d), read in place with KV head h // (H/K); timed with
    # its plain version on the expanded heads and SDPA's GQA form
    gqa = {}
    for label, B, S, H, K, d, dname in FLASH_GQA:
        dt = getattr(torch, dname)
        qkv = torch.randn((B, S, H + 2 * K, d), generator=gen,
                          device=dev).to(dt)
        q, k, v = qkv[:, :, :H], qkv[:, :, H:H + K], qkv[:, :, H + K:]
        o = flash_attention_gqa(q, k, v, causal=True)
        torch.cuda.synchronize()

        def heads(t):
            t = t.repeat_interleave(H // t.shape[2], dim=2)
            return t.permute(0, 2, 1, 3).reshape(B * H, S, d)

        qh, kh, vh = heads(q), heads(k), heads(v)
        err, max_abs, dist = _flash_err(
            o.permute(0, 2, 1, 3).reshape(B * H, S, d), qh, kh, vh, True,
            dname)
        call = lambda: flash_attention_gqa(q, k, v, causal=True)
        ms = cuda_ms(call, 10, warmup=2, spin_ms=3.0)
        wall = wall_ms(call, 3)
        plain = _sum_ms(lambda: _flash_plain(qh, kh, vh, True), reps=2)
        qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True, enable_gqa=True), 10, warmup=2,
            spin_ms=3.0)
        pairs = S * (S + 1) // 2                 # causal, S == T
        nbytes = q.element_size() * 2 * B * S * d * (H + K)
        flops = 4 * B * H * d * pairs
        bms, bby = bound_ms(nbytes, flops, dname)
        limit = TOL_FLASH[dname][0]
        say(f"  flash_attention_gqa {label} (B {B}, S {S}, H {H}, K {K}, d "
            f"{d}) {dname} causal, strided q: {ms:.4f} ms (host wall "
            f"{wall:.4f} ms, plain {plain:.3f} ms, bound {bms:.4f} ms by "
            f"{bby}, SDPA {lib:.4f} ms); err {err:.2e}, max |o − plain| "
            f"{max_abs:.2e}")
        check(err <= limit, f"flash_attention_gqa {label} {dname} matches "
              f"its plain version on the expanded heads ({err:.2e} <= "
              f"{limit:.0e})")
        r = dict(case=label, shape=f"B{B} S{S} H{H} K{K} d{d}", dtype=dname,
                 causal=True, ms=ms, wall_ms=wall, plain_ms=plain,
                 library_ms=lib, bytes=nbytes, flops=flops, bound_ms=bms,
                 bound_by=bby, tflops=flops / ms / 1e9, err=err,
                 max_abs_err=max_abs, limit=limit, round_p_distance=dist)
        res.append(r)
        gqa[label] = r
        del qkv, q, k, v, o, qh, kh, vh
        torch.cuda.empty_cache()
    out["flash_phase"] = res

    def row(main, dname, form):
        rs = [r for r in res if r["dtype"] == dname]
        return dict(main, max_abs_err=max(r["max_abs_err"] for r in rs),
                    max_rel_err=max(r["err"] for r in rs),
                    shape=f"{main['shape']} "
                          f"{'causal' if main['causal'] else 'bidir'} "
                          f"{form}")

    # bf16: the prefill layer's work in the (BH, S, T, d) form; f32: the
    # path's own GQA call (its only f32 launches)
    return {"flash_attention": row(res[0], "bfloat16", "(BH, S, T, d)"),
            "flash_attention_f32": row(gqa["f32 check GQA"], "float32",
                                       "(B, S, H, K, d)")}


def _lm_breakdown(top):
    """Device ms of a profiled call by class of kernel name."""
    cls = {"flash kernel": 0.0, "GEMMs": 0.0, "casts/copies": 0.0,
           "rest": 0.0}
    for ms, _, name in top:
        low = name.lower()
        if "tc_kernel" in low or "simt_kernel" in low:
            cls["flash kernel"] += ms
        elif any(s in low for s in ("gemm", "nvjet", "xmma", "cutlass",
                                    "cublas")):
            cls["GEMMs"] += ms
        elif "copy" in low or "memcpy" in low:    # casts, transposes, cat
            cls["casts/copies"] += ms
        else:
            cls["rest"] += ms
    return cls


def lm_path(dev, seed, out):
    """Phase 14: the LM serving path of llama3.2-1b at full width (seed-made
    weights, params f32, activations bf16): prefill of B 4 × S 4096 through
    the flash kernel, the serving CLI, and decode ≡ forward."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.transformer import Transformer

    cfg = get_config(LM_ARCH)
    B, S = LM_PREFILL
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 1)
    _peak_reset(dev)
    t0 = time.perf_counter()
    model = Transformer(cfg, seed=seed, device=dev)
    _sync(dev)
    init_s = time.perf_counter() - t0
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
    # (a) prefill: one warm-up, then the counted, timed call
    serve.prefill(model, toks)
    _sync(dev)
    _counts_reset()
    t0 = time.perf_counter()
    logits = serve.prefill(model, toks)
    _sync(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    launches = _counts()[0]
    peak = _peak(dev)
    prefill_walls = [wall_ms(lambda: serve.prefill(model, toks), 1)
                     for _ in range(2)]
    cnt, dev_ms, top = _kernel_breakdown(
        lambda: serve.prefill(model, toks),
        os.path.join(OUT, "lm_prefill_trace.json"))
    cls = _lm_breakdown(top)
    say(f"  {cfg.name} prefill B={B} S={S}: {prefill_ms:.1f} ms wall "
        f"(repeats {', '.join('%.1f' % w for w in prefill_walls)} ms), "
        f"{B * S / prefill_ms * 1e3:.0f} tokens/s; peak device memory "
        f"{peak:.2f} GB (weights {cfg.param_count() * 4 / 1e9:.2f} GB f32); "
        f"model init {init_s:.2f} s")
    say(f"  prefill trace: {cnt} device ops, {dev_ms:.1f} ms device time "
        f"(busy {dev_ms / prefill_walls[-1]:.0%}); "
        + "; ".join(f"{k} {v:.1f} ms" for k, v in cls.items()))
    for ms, c, name in top[:8]:
        say(f"    {ms:9.2f} ms ×{c:<5d} {name[:90]}")
    check(tuple(logits.shape) == (B, 1, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"prefill logits {tuple(logits.shape)} finite")
    check(launches["flash_attention"] == cfg.n_layers,
          f"prefill launched flash_attention once per layer "
          f"({launches['flash_attention']} == {cfg.n_layers})")
    del logits

    # (b) serving: the CLI, then the same decode loop timed and traced
    _counts_reset()
    seq = serve.main(["--arch", LM_ARCH, "--batch", str(LM_SERVE[0]),
                      "--prompt-len", str(LM_SERVE[1]), "--gen-len",
                      str(LM_SERVE[2]), "--seed", str(seed),
                      "--device", str(dev)])
    _sync(dev)
    Bs, P, G = LM_SERVE
    check(tuple(seq.shape) == (Bs, P + G) and int(seq.min()) >= 0
          and int(seq.max()) < cfg.vocab,
          f"serve.main produced {tuple(seq.shape)} tokens in the vocab")
    prompts = torch.randint(0, cfg.vocab, (Bs, P), generator=gen, device=dev)
    serve.greedy_decode(model, prompts, 2)              # warm-up
    _, dec_s = serve.greedy_decode(model, prompts, G)
    step_ms = dec_s * 1e3 / (P + G - 1)
    step = serve.make_serve_step(model)
    tok = prompts[:, :1].to(torch.int32)

    def eight_steps():
        state = model.init_decode_state(Bs, P + G)
        t_ = tok
        for t in range(8):
            t_, state = step(state, t_, t)

    eight_wall = wall_ms(eight_steps, 2)
    cnt8, dev8, top8 = _kernel_breakdown(
        eight_steps, os.path.join(OUT, "lm_decode_trace.json"))
    say(f"  serving B={Bs} prompt {P} + gen {G}: {step_ms:.2f} ms per token "
        f"step; 8 steps {eight_wall:.1f} ms wall, {dev8:.1f} ms device time "
        f"(busy {dev8 / eight_wall:.0%}, {cnt8} device ops); "
        + "; ".join(f"{k} {v:.1f} ms" for k, v in _lm_breakdown(top8).items()))
    serve_launches = _counts()[0]

    # (c) decode ≡ forward: f32 at full width, then bf16 greedy agreement
    Bc, Sc = LM_CHECK
    ctoks = torch.randint(0, cfg.vocab, (Bc, Sc), generator=gen, device=dev)

    def decode_logits(m):
        state = m.init_decode_state(Bc, Sc)
        outs = []
        for t in range(Sc):
            lg, state = m.decode_step(state, ctoks[:, t:t + 1], t)
            outs.append(lg[:, 0])
        return torch.stack(outs, 1)

    _counts_reset()
    bf_fwd, _ = model(ctoks)
    bf_dec = decode_logits(model)
    del model
    torch.cuda.empty_cache()
    m32 = Transformer(dataclasses.replace(cfg, dtype="float32"), seed=seed,
                      device=dev)
    f_fwd, _ = m32(ctoks)
    f_dec = decode_logits(m32)
    _sync(dev)
    check_launches = _counts()[0]
    del m32
    f_diff = float((f_fwd - f_dec).abs().max())
    f_rel = f_diff / float(f_fwd.abs().max())
    agree = float((bf_fwd.argmax(-1) == bf_dec.argmax(-1)).float().mean())
    bf_diff = float((bf_fwd - bf_dec).abs().max())
    say(f"  decode ≡ forward (B={Bc}, S={Sc}): f32 max |Δlogits| {f_diff:.3e}"
        f" = {f_rel:.2e} of max |logits|; bf16 greedy tokens agree on "
        f"{agree:.1%} of positions, max |Δlogits| {bf_diff:.3e} (max |logits| "
        f"{float(bf_fwd.abs().max()):.3f})")
    check(f_rel <= TOL_LM_F32, f"decode ≡ forward in f32 ({f_rel:.2e} <= "
          f"{TOL_LM_F32:.0e} of max |logits|)")
    check(agree >= LM_AGREE, f"decode ≡ forward in bf16: greedy tokens agree "
          f"on {agree:.1%} >= {LM_AGREE:.0%} of positions")
    check(check_launches["flash_attention"] == cfg.n_layers
          and check_launches["flash_attention_f32"] == cfg.n_layers,
          f"the bf16 and f32 checking forwards launched flash_attention "
          f"{check_launches['flash_attention']} and flash_attention_f32 "
          f"{check_launches['flash_attention_f32']} times (== {cfg.n_layers})")
    out["lm_path"] = dict(
        arch=cfg.name, prefill=dict(
            B=B, S=S, wall_ms=prefill_ms, repeats_ms=prefill_walls,
            tokens_per_s=B * S / prefill_ms * 1e3, peak_gb=peak,
            device_ms=dev_ms, device_ops=cnt, busy=dev_ms / prefill_walls[-1],
            breakdown=cls, top=top[:20], launches=launches),
        serve=dict(batch=Bs, prompt_len=P, gen_len=G, ms_per_step=step_ms,
                   eight_steps_wall_ms=eight_wall, eight_steps_device_ms=dev8,
                   busy=dev8 / eight_wall, top=top8[:20],
                   launches=serve_launches),
        check=dict(B=Bc, S=Sc, f32_max_abs=f_diff, f32_rel=f_rel,
                   bf16_agree=agree, bf16_max_abs=bf_diff,
                   launches=check_launches),
        model_init_s=init_s)
    torch.cuda.empty_cache()
    total = dict(launches)
    for k2, v2 in check_launches.items():
        total[k2] = total.get(k2, 0) + v2
    return total


# ---------------------------------------------------------------------------
# phase 15: the on-card tests
# ---------------------------------------------------------------------------

def on_card_tests(out):
    """``tests/test_torch_on_card.py`` under pytest in a child process on
    this card (``--noconftest``: the repo's conftest imports jax), its
    counts read from the junit XML; any failure, error or skip, or no pass,
    fails the phase."""
    import xml.etree.ElementTree as ET
    xml = os.path.join(OUT, "on_card_tests.xml")
    if os.path.exists(xml):
        os.remove(xml)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH"))
        if p))
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-p",
         "no:cacheprovider", "-q", ON_CARD_TESTS, f"--junitxml={xml}"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    secs = time.perf_counter() - t
    with open(os.path.join(OUT, "on_card_tests.log"), "w") as fh:
        fh.write(proc.stdout + proc.stderr)
    counts = dict(tests=0, failures=0, errors=0, skipped=0)
    if os.path.exists(xml):
        root = ET.parse(xml).getroot()
        suite = root if root.tag == "testsuite" else root.find("testsuite")
        counts = {k: int(suite.get(k, 0)) for k in counts}
    passed = counts["tests"] - counts["failures"] - counts["errors"] \
        - counts["skipped"]
    tail = proc.stdout.strip().splitlines()[-1:] or ["(no output)"]
    say(f"  {ON_CARD_TESTS}: {passed} passed, {counts['failures']} failed, "
        f"{counts['errors']} errors, {counts['skipped']} skipped in "
        f"{secs:.1f} s (pytest exit {proc.returncode}; {tail[0]})")
    out["on_card_tests"] = dict(passed=passed, seconds=secs,
                                returncode=proc.returncode, **counts)
    check(proc.returncode == 0 and passed > 0 and counts["failures"] == 0
          and counts["errors"] == 0 and counts["skipped"] == 0,
          f"on-card tests: {passed} passed, none failed or skipped")


# ---------------------------------------------------------------------------

#: the kernels whose registers, shared memory and spills the script prints
KERNEL_ENTRIES = ("sell_spmv_kernel", "panel_factor_kernel", "schur_kernel",
                  "sn_sweep_kernel", "tc_kernel", "simt_kernel")


def _targs(mangled):
    """Template arguments of a mangled kernel name, as C++ writes them:
    ``dLi32ELb0E`` → ``double, 32, false``."""
    import re
    names = {"d": "double", "f": "float"}
    return ", ".join(
        names[t] if t else (("false", "true")[int(v)] if b == "b" else v)
        for t, b, v in re.findall(r"([df])|L([ib])(\d+)E?", mangled))


def ptxas_report(log, sources):
    """One line per kernel of ``KERNEL_ENTRIES`` in ``sources`` from nvcc's
    ``-Xptxas -v`` output: registers, static shared memory and spills (the
    flash kernels' dynamic shared memory beside them)."""
    import re
    from repro_torch.kernels import _build
    entries, src, cur = [], None, None
    for ln in log.splitlines():
        if ln.startswith("== nvcc"):
            src, cur = ln.split()[2], None
        elif "Compiling entry function" in ln:
            m = re.search(r"\d(" + "|".join(KERNEL_ENTRIES) + r")I(\w+?)EEv",
                          ln)
            cur = None
            if src in sources and m is not None:
                cur = dict(name=f"{m.group(1)}<{_targs(m.group(2))}>",
                           spill="", regs="?", smem="0")
                entries.append(cur)
        elif cur is not None and "spill" in ln:
            cur["spill"] = ln.strip()
        elif cur is not None and "Used" in ln and "registers" in ln:
            cur["regs"] = re.search(r"Used (\d+) registers", ln).group(1)
            m = re.search(r"(\d+) bytes smem", ln)
            cur["smem"] = m.group(1) if m else "0"
    out = []
    for e in entries:
        dyn = ""
        m = re.match(r"(tc_kernel|simt_kernel)<(\d+)>", e["name"])
        if m:
            nbytes = _build.lib().flash_attention_smem(
                int(m.group(2)), int(m.group(1) == "tc_kernel"))
            dyn = f", {nbytes} B dynamic smem"
        out.append(f"ptxas {e['name']}: {e['regs']} registers, {e['smem']} "
                   f"B static smem{dyn}; {e['spill']}")
    return out


def card_line():
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return q.stdout.strip().splitlines()[0]


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this run needs one "
              "NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    os.makedirs(OUT, exist_ok=True)
    t_start = time.perf_counter()
    card = card_line()
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.lib()
    build_s = time.perf_counter() - t0
    with open(os.path.join(OUT, "build.log"), "w") as fh:
        fh.write(_build.BUILD_LOG)
    say(f"kernel build: {build_s:.2f} s (nvcc: "
        f"{_build.LAST_BUILD_SECONDS if _build.LAST_BUILD_SECONDS is not None else 'cached'})")
    for line in ptxas_report(_build.BUILD_LOG, ("spmv_bell.cu", "supernode.cu",
                                                "flash_attention.cu")):
        say(line)
    out = dict(card=card, build_s=build_s,
               config=dict(ng_stencil=NG_STENCIL, ng_bell=NG_BELL,
                           ng_transpose=NG_TRANSPOSE, tol=TOL,
                           tol_transpose=TOL_TRANSPOSE, ng_direct=NG_DIRECT,
                           ng_lu=NG_LU, saddle=SADDLE, ng_ilu=NG_ILU,
                           n_graph=N_GRAPH,
                           maxiter=MAXITER, seed=SEED,
                           flash_shapes=FLASH_SHAPES, flash_gqa=FLASH_GQA,
                           lm_arch=LM_ARCH,
                           lm_prefill=LM_PREFILL, lm_serve=LM_SERVE,
                           lm_check=LM_CHECK))

    phases = []

    def phase(name, fn, *a):
        # free what earlier phases left in reference cycles, so a phase's
        # peak device memory is its own
        gc.collect()
        torch.cuda.empty_cache()
        say(f"[{name}]")
        t = time.perf_counter()
        r = fn(*a)
        dt = time.perf_counter() - t
        phases.append((name, dt))
        say(f"[{name}] {dt:.2f} s")
        return r

    kres = phase("kernels", kernel_phase, dev, NG_STENCIL, NG_BELL, SEED, out)
    path_launches = {}
    direct = {}                        # the direct path's analysis, values
    for name, fn, a in (
            ("stencil path", stencil_path,
             (dev, NG_STENCIL, TOL, MAXITER, SEED, out)),
            ("block-ELL path", bell_path, (dev, NG_BELL, TOL, MAXITER, out)),
            ("general path", general_path, (dev, NG_BELL, TOL, MAXITER, out)),
            ("solver-level path", chebyshev_path,
             (dev, NG_BELL, TOL, MAXITER, out)),
            ("transposed paths", transpose_path,
             (dev, NG_TRANSPOSE, TOL_TRANSPOSE, MAXITER, SEED, out)),
            ("direct path", direct_path, (dev, NG_DIRECT, SEED, out, direct)),
            ("LU path", lu_path, (dev, NG_LU, SEED, out)),
            ("indefinite path", indefinite_path, (dev, *SADDLE, SEED, out)),
            ("ILU path", ilu_path, (dev, NG_ILU, TOL, MAXITER, out)),
            ("MG path", mg_path, (dev, NG_STENCIL, TOL, MAXITER, SEED, out)),
            ("AMG path", amg_path, (dev, NG_BELL, N_GRAPH, TOL, MAXITER, out)),
            ("GMRES / Chebyshev path", krylov_path,
             (dev, NG_TRANSPOSE, NG_BELL, TOL_TRANSPOSE, TOL, MAXITER,
              out))):
        counts = phase(name, fn, *a)
        torch.cuda.empty_cache()
        for k, v in counts.items():
            path_launches[k] = path_launches.get(k, 0) + v
    # the panel kernels against their plain versions, on the direct path's
    # own analysis (its bucket shapes), after the paths' counts are read
    kres.update(phase("panel kernels", panel_kernel_phase, dev,
                      direct["art"], direct["val"], NG_DIRECT, SEED, out))
    del direct
    kres.update(phase("flash kernel", flash_phase, dev, SEED, out))
    for k, v in phase("LM serving path", lm_path, dev, SEED, out).items():
        path_launches[k] = path_launches.get(k, 0) + v
    for k, v in path_launches.items():
        check(v > 0, f"{k} launched on the paths ({v} times)")
    phase("on-card tests", on_card_tests, out)

    kernels = []
    for name, r in kres.items():
        src, replaces = KERNEL_SOURCES[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=path_launches[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            max_rel_err=r["max_rel_err"], wall_ms=r["wall_ms"],
            dtype=r["dtype"], shape=r["shape"]))
    out["kernels"] = kernels
    out["phases_s"] = dict(phases)
    out["total_s"] = time.perf_counter() - t_start
    with open(os.path.join(OUT, "results.json"), "w") as fh:
        json.dump(out, fh, indent=1, default=str)
    say("phases: " + ", ".join(f"{n} {s:.1f} s" for n, s in phases)
        + f"; total {out['total_s']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
