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
   against a CG run at tol 1e-12, then a ``with_values`` refactorization;
9. LU path: the non-symmetric drift ``poisson2d(128)``, auto → direct/LU,
   solution and ∂/∂val against the dense backend (adjoint on ut/lt sweeps);
10. indefinite path: a dense-block saddle point (n = 512) with static 2x2
    pivot pairs, solve, transposed solve, ``slogdet`` and its gradient
    against torch.linalg;
11. ILU path: ``poisson2d(100)``, CG with ``precond="ilu"`` against Jacobi;
12. panel kernels: panel_factor, schur_update and block_trsv against their
    plain versions on the gathered panels of the direct path's own analysis
    of ``poisson2d(316)`` (its widest bucket, the bucket with the most
    lanes, a ragged bucket with garbage in its pad slots), f32 and f64,
    pairs off and on, block_trsv in its four modes with 1 and 64
    right-hand sides; then their summed time over one factorization (one
    mode-l sweep for block_trsv) against the bound;
13. flash kernels: flash_attention against its plain version (f32, on the
    same inputs, over chunks of bh; elementwise, |o − plain| ≤
    2e-5·|plain| + 2e-5 in f32 and ≤ 8e-3·|plain| + 1e-3 in bf16, with the
    bf16 kernel's distance from the plain version that rounds p to bf16
    printed beside it)
    at the LM path's layer shape (BH 128, S 4096, d 64, bf16, causal), f32
    causal and bidirectional (64, 2048, 64), a ragged bf16 (24, 1000, 128)
    and an uneven f32 bidirectional (2, 128 | 256, 64), then the model's
    GQA form (B 4, S 4096, H 32, K 8, d 64, q a strided slice) against the
    plain version on expanded heads; their time, the plain version's,
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
             ("f32 check GQA", 2, 128, 32, 8, 64, "float32"))
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
                  ("block_trsv", 158)):
    KERNEL_SOURCES[_f] = ("src/repro_torch/kernels/csrc/supernode.cu",
                          f"src/repro/kernels/supernode.py:{_line}")
PANEL_KERNELS = ("panel_factor", "schur_update", "block_trsv")
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

def cuda_ms(fn, reps, warmup=2, spin_ms=1.0):
    """Mean device time of ``fn`` over ``reps`` back-to-back launches.

    The launches are queued behind a spin kernel (``torch.cuda._sleep``), so
    the host's time to enqueue them stays off the clock: the events measure
    the device work alone, not Python overhead between launches.
    ``spin_ms`` is the spin per rep; it must exceed one call's enqueue
    time (``fn`` may launch many kernels)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(reps * spin_ms * 2_000_000))   # ≈1 ms per 2M
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def wall_ms(fn, reps):
    """Mean host wall time per call, synchronized (enqueue + device)."""
    import torch
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

def _enqueue_ms(fn):
    """Host time to enqueue one call of ``fn`` (after a warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt * 1e3


def _sum_ms(fn, reps=5):
    """Device time of ``fn`` (many launches), the spin covering enqueue."""
    return cuda_ms(fn, reps, warmup=1, spin_ms=1.5 * _enqueue_ms(fn) + 1.0)


def _panel_work(bk, trsv_mode="l"):
    """(bytes, flops) per kernel that one bucket's true sizes need, f64:
    inputs read at their true extent, outputs written at the padded shape
    the kernel returns.  block_trsv: one solve in ``trsv_mode`` with one
    right-hand side, reading only the triangle of D that mode uses (strict
    lower for l/lt; upper with the pivots for u/ut, which also divide)."""
    w = bk.wvec.double().cpu().numpy()
    r = bk.rvec.double().cpu().numpy()
    k, wb, rb = bk.pidx.shape[0], bk.wb, bk.rb
    s1 = w * (w - 1) / 2                         # Σ_t (w-t-1)
    s2 = (w - 1) * w * (2 * w - 1) / 6           # Σ_t (w-t-1)²
    pf = (8 * float((w * w + 2 * r * w).sum())
          + 8 * k * ((wb + rb) * wb + wb * rb),
          float((2 * s2 + s1 + r * w + 4 * r * s1).sum()))
    su = (8 * float((2 * r * w).sum()) + 8 * k * rb * rb,
          float((2 * w * r * r).sum()))
    piv = w if trsv_mode in ("u", "ut") else 0 * w
    bt = (8 * float((s1 + piv + w).sum()) + 8 * k * wb,
          float((2 * s1 + piv).sum()))
    return {"panel_factor": pf, "schur_update": su, "block_trsv": bt}


def panel_kernel_phase(dev, art, val, ng, seed, out):
    """panel_factor, schur_update and block_trsv against their plain versions
    on the main path's panels (the direct path's analysis ``art`` of
    ``poisson2d(ng)`` with values ``val``), and their summed device time
    over one factorization."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import supernode as ksn

    rng = np.random.default_rng(seed)
    buckets = [bk for lvl in art.snode.schedule for bk in lvl]
    say(f"  panel shapes of the direct path's poisson2d({ng}): "
        f"{len(buckets)} buckets in {len(art.snode.schedule)} levels")
    C = torch.zeros(art.nnzF + 2, dtype=torch.float64, device=dev)
    C.index_add_(0, art.a2f, val)
    C[art.nnzF + 1] = 1.0
    C[art.nnzF] = 7.25                   # pad slots gather NaN-free garbage
    tau64 = math.sqrt(np.finfo(np.float64).eps) * float(val.abs().max())

    def ragged(bk):
        w, r = bk.wvec.cpu(), bk.rvec.cpu()
        live = w > 0
        return bool((~live).any() and (w[live] < bk.wb).any()
                    and (r[live] < bk.rb).any())

    widest = max(buckets, key=lambda b: (b.wb * b.rb, b.pidx.shape[0]))
    most = max(buckets, key=lambda b: (b.pidx.shape[0], b.wb * b.rb))
    cands = [b for b in buckets if ragged(b)] or \
        [b for b in buckets if bool((b.wvec == 0).any())]
    rag = max(cands, key=lambda b: (b.wb * b.rb, b.pidx.shape[0]))
    cases = (("widest", widest), ("most lanes", most), ("ragged", rag))
    errs = {k: [] for k in PANEL_KERNELS}
    abs_err = dict.fromkeys(PANEL_KERNELS, 0.0)
    shapes = []
    for label, bk in cases:
        k, wb = bk.pidx.shape[0], bk.wb
        aw = torch.arange(wb, device=dev)
        pair_bkm = (aw[None, :] % 2 == 0) & (aw[None, :] + 1 < bk.wvec[:, None])
        shapes.append(f"{label} (k={k}, wb={wb}, rb={bk.rb})")
        for dt in (torch.float64, torch.float32):
            tag = str(dt)[6:]
            tau = torch.tensor(tau64, dtype=dt, device=dev)
            P0, Q0 = C[bk.pidx].to(dt), C[bk.qidx].to(dt)
            for pairs in (False, True):
                bkm = pair_bkm if pairs else bk.bkm
                Pk, Qk, nk = ksn.panel_factor(P0, Q0, bk.wvec, bk.rvec, tau,
                                              bkm, pairs=pairs, guard=True)
                torch.cuda.synchronize()
                Pp, Qp, npl = ref.sn_panel_factor_ref(
                    P0, Q0, bk.wvec, bk.rvec, tau, bkm, pairs=pairs,
                    guard=True)
                e, ea = rel_err([Pk, Qk], [Pp, Qp], [Pp, Qp])
                check(float(nk) == float(npl),
                      f"panel_factor {label} {tag} pairs={pairs}: clamp "
                      f"count {float(nk):.0f} equals the plain version's")
                errs["panel_factor"].append((tag, e))
                if tag == "float64":
                    abs_err["panel_factor"] = max(abs_err["panel_factor"], ea)
                S = ksn.schur_update(Pk, Qk)
                torch.cuda.synchronize()
                e, ea = rel_err([S], [ref.sn_schur_ref(Pk, Qk)],
                                [ref.sn_schur_ref(Pk.abs(), Qk.abs())])
                errs["schur_update"].append((tag, e))
                if tag == "float64":
                    abs_err["schur_update"] = max(abs_err["schur_update"], ea)
                D = Pk[:, :wb, :]
                for mode in ("l", "lt", "u", "ut"):
                    for m in (1, 64):
                        y = torch.tensor(rng.normal(size=(k, wb, m)),
                                         dtype=dt, device=dev)
                        x = ksn.block_trsv(D, y, bk.wvec, bkm, mode=mode,
                                           pairs=pairs)
                        torch.cuda.synchronize()
                        xp = ref.sn_trsv_ref(D, y, bk.wvec, bkm, mode=mode,
                                             pairs=pairs)
                        e, ea = rel_err([x], [xp], [xp])
                        errs["block_trsv"].append((tag, e))
                        if tag == "float64":
                            abs_err["block_trsv"] = max(
                                abs_err["block_trsv"], ea)
    # -- time: one bucket of each case, and summed over one factorization --
    acc = torch.zeros((), dtype=torch.float64, device=dev)
    tau = torch.tensor(tau64, dtype=torch.float64, device=dev)
    ins = [(C[bk.pidx], C[bk.qidx]) for bk in buckets]
    facs = [ksn.panel_factor(P, Q, bk.wvec, bk.rvec, tau, bk.bkm, nbad=acc)
            for (P, Q), bk in zip(ins, buckets)]
    Ds = [P[:, :bk.wb, :] for (P, _, _), bk in zip(facs, buckets)]
    Dm = [ref.sn_block_mask(D, bk.wvec) for D, bk in zip(Ds, buckets)]
    ys = [torch.tensor(rng.normal(size=(bk.pidx.shape[0], bk.wb, 1)),
                       device=dev) for bk in buckets]

    def run(name, idx, impl):
        def one(i):
            bk = buckets[i]
            if name == "panel_factor":
                P, Q = ins[i]
                if impl == "kernel":
                    return ksn.panel_factor(P, Q, bk.wvec, bk.rvec, tau,
                                            bk.bkm, nbad=acc)
                return ref.sn_panel_factor_ref(P, Q, bk.wvec, bk.rvec, tau,
                                               bk.bkm)
            if name == "schur_update":
                P, Q, _ = facs[i]
                if impl == "kernel":
                    return ksn.schur_update(P, Q)
                if impl == "plain":
                    return ref.sn_schur_ref(P, Q)
                return torch.bmm(P[:, bk.wb:, :], Q)
            if impl == "kernel":
                return ksn.block_trsv(Ds[i], ys[i], bk.wvec, bk.bkm, mode="l")
            if impl == "plain":
                return ref.sn_trsv_ref(Ds[i], ys[i], bk.wvec, bk.bkm,
                                       mode="l")
            return torch.linalg.solve_triangular(Dm[i], ys[i], upper=False,
                                                 unitriangular=True)
        return lambda: [one(i) for i in idx]

    res = {}
    allidx = range(len(buckets))
    for name in PANEL_KERNELS:
        per_case = []
        for label, bk in cases:
            i = next(j for j, b in enumerate(buckets) if b is bk)
            b_, f_ = _panel_work(bk)[name]
            bms, bby = bound_ms(b_, f_, "float64")
            lib = None if name == "panel_factor" else \
                cuda_ms(run(name, [i], "library"), 20)
            per_case.append(dict(
                case=label, k=bk.pidx.shape[0], wb=bk.wb, rb=bk.rb,
                ms=cuda_ms(run(name, [i], "kernel"), 20),
                plain_ms=_sum_ms(run(name, [i], "plain"), reps=3),
                library_ms=lib, bound_ms=bms, bound_by=bby))
        work = [_panel_work(bk)[name] for bk in buckets]
        tb = sum(w[0] for w in work)
        tf = sum(w[1] for w in work)
        bms, bby = bound_ms(tb, tf, "float64")
        ms = _sum_ms(run(name, allidx, "kernel"))
        plain = _sum_ms(run(name, allidx, "plain"), reps=2)
        lib = None if name == "panel_factor" else \
            _sum_ms(run(name, allidx, "library"))
        wall = wall_ms(run(name, allidx, "kernel"), 3)
        worst = {}
        for tag, e in errs[name]:
            worst[tag] = max(worst.get(tag, 0.0), e)
        res[name] = dict(
            ms=ms, wall_ms=wall, plain_ms=plain, library_ms=lib,
            bytes=tb, flops=tf, dtype="float64", bound_ms=bms, bound_by=bby,
            shape=(f"poisson2d({ng}): {len(buckets)} buckets"
                   + (", 1 sweep (mode l, m=1)" if name == "block_trsv"
                      else ", 1 factorization")),
            cases=per_case, max_rel_err=max(worst.values()),
            max_abs_err=abs_err[name])
        say(f"  {name:13s} summed over {len(buckets)} buckets: {ms:.4f} ms "
            f"(host wall {wall:.3f} ms, plain {plain:.3f} ms, bound "
            f"{bms:.4f} ms by {bby}, library "
            f"{'-' if lib is None else '%.4f ms' % lib}); "
            + "; ".join(f"{t} rel err {e:.2e} (limit {TOL_KERNEL[t]:.0e})"
                        for t, e in worst.items()))
        for c in per_case:
            lib_c = c["library_ms"]
            say(f"    {c['case']:10s} (k={c['k']}, wb={c['wb']}, "
                f"rb={c['rb']}): {c['ms']:.4f} ms, plain {c['plain_ms']:.4f} "
                f"ms, bound {c['bound_ms']:.4f} ms by {c['bound_by']}, "
                f"library {'-' if lib_c is None else '%.4f ms' % lib_c}")
        for t, e in worst.items():
            check(e <= TOL_KERNEL[t], f"{name} {t} matches its plain version "
                  f"at {', '.join(shapes)} ({e:.2e} <= {TOL_KERNEL[t]:.0e})")
    out["panel_kernel_phase"] = dict(n_buckets=len(buckets), kernels=res)
    del ins, facs, Ds, Dm, ys, C
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


def _trsv_modes():
    from repro_torch.kernels import supernode as ksn
    return dict(ksn.TRSV_MODE_LAUNCHES)


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
    modes = _trsv_modes()
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
    say(f"  launches {json.dumps({k: v for k, v in launches.items() if v})}; "
        f"block_trsv by mode {json.dumps(modes)}")
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
    check(launches["block_trsv"] == 4 * nb,
          f"direct path: block_trsv launched 4 × buckets "
          f"({launches['block_trsv']} == {4 * nb})")
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
        kernel_breakdown={k: dict(kernels=v[0], kernel_ms=v[1], top=v[2])
                          for k, v in kern.items()},
        grad_rel_diff=gerr, plan_nbytes=nbytes, peak_gb=peak,
        launches=launches, trsv_modes=modes, plan_stats=stats,
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
    fwd = _trsv_modes()
    (u * u).sum().backward()
    _sync(dev)
    t2 = time.perf_counter()
    launches, stats = _counts()
    modes = _trsv_modes()
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
    say(f"  block_trsv by mode: forward {json.dumps(fwd)}, forward + "
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
          f"LU path: the backward ran block_trsv in modes ut ({modes['ut']}) "
          f"and lt ({modes['lt']})")
    out["lu_path"] = dict(ng=ng, n=n, forward_s=t1 - t0, backward_s=t2 - t1,
                          dense_run_s=t4 - t3, solution_rel_diff=uerr,
                          grad_rel_diff=gerr, launches=launches,
                          trsv_modes_forward=fwd, trsv_modes=modes,
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
    say(f"  PLAN_STATS {json.dumps({k2: v for k2, v in stats.items() if v})}")
    check(npairs > 0, f"indefinite path: {npairs} static 2x2 pivots, no "
          f"perturbation warning")
    check(xerr <= TOL_DENSE and xterr <= TOL_DENSE,
          f"indefinite path: solve and transposed solve match torch.linalg "
          f"({xerr:.2e}, {xterr:.2e} <= {TOL_DENSE:.0e})")
    check(float(sign) == float(sd) and lerr <= 1e-10,
          f"indefinite path: slogdet sign and log|det| ({lerr:.2e} <= 1e-10)")
    check(gerr <= TOL_DENSE, f"indefinite path: slogdet gradient matches "
          f"A⁻ᵀ on the pattern ({gerr:.2e} <= {TOL_DENSE:.0e})")
    out["indefinite_path"] = dict(
        m=m, k=k, n=n, pair_pivots=npairs, seconds=t1 - t0,
        solve_rel_diff=xerr, transposed_rel_diff=xterr,
        logdet_rel_diff=lerr, grad_rel_diff=gerr, launches=launches,
        plan_stats=stats)
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
        gqa[dname] = r
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
            "flash_attention_f32": row(gqa["float32"], "float32",
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

def ptxas_report(log, sources):
    """One line per kernel of ``sources`` from nvcc's ``-Xptxas -v`` output:
    registers, static shared memory and spills (the flash kernels' dynamic
    shared memory beside them)."""
    import re
    from repro_torch.kernels import _build
    entries, src = [], None
    for ln in log.splitlines():
        if ln.startswith("== nvcc"):
            src = ln.split()[2]
        elif src not in sources:
            continue
        elif "Compiling entry function" in ln:
            m = re.search(r"(sell_spmv_kernel|tc_kernel|simt_kernel)I(?:Li)?"
                          r"(\w+?)E", ln)
            entries.append(dict(name=f"{m.group(1)}<{m.group(2)}>" if m
                                else ln.split("'")[1], spill="", regs="?",
                                smem="0"))
        elif entries and "spill" in ln:
            entries[-1]["spill"] = ln.strip()
        elif entries and "Used" in ln and "registers" in ln:
            entries[-1]["regs"] = re.search(r"Used (\d+) registers",
                                            ln).group(1)
            m = re.search(r"(\d+) bytes smem", ln)
            entries[-1]["smem"] = m.group(1) if m else "0"
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
    for line in ptxas_report(_build.BUILD_LOG, ("spmv_bell.cu",
                                                "flash_attention.cu")):
        say(line)
    out = dict(card=card, build_s=build_s,
               config=dict(ng_stencil=NG_STENCIL, ng_bell=NG_BELL,
                           ng_transpose=NG_TRANSPOSE, tol=TOL,
                           tol_transpose=TOL_TRANSPOSE, ng_direct=NG_DIRECT,
                           ng_lu=NG_LU, saddle=SADDLE, ng_ilu=NG_ILU,
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
            ("ILU path", ilu_path, (dev, NG_ILU, TOL, MAXITER, out))):
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
