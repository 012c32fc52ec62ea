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
11d. nonlinear path: F(u, θ) = A u + θ u³ − f (the reference's table-5
    residual; f from the seed, θ = 0.8) on ``poisson2d(1024)``'s block-ELL
    kernel, ``nonlinear_solve`` with ``jac_pattern=A`` (SparseNewton: one
    coloring, one ``vmap``-ed jvp probe sweep per step on ``bell_spmv``)
    and CG + AMG inner solves to tol 1e-12, ‖F(u*)‖ ≤ 1e-10, ∂Σu²/∂θ by
    ``backward()``: analyze, coloring and the backward's transpose solve
    once each, one Galerkin product per Newton step; the θ-gradient
    against a central difference (1e-5; no plain run: its kernels are held
    to their plain versions in phases 2, 11b and 12); then the
    backward-Euler step G(u, θ) =
    u + 0.05 (A u + θ u³) − u* by Newton, Picard and Anderson (m = 5)
    with the Jacobian in closed form, their θ-gradients against Newton's;
11e. Newton direct path: the same residual on ``poisson2d(316)`` with
    direct inner solves (one factorization per step on the panel kernels,
    none in the backward), the θ-gradient against the central difference
    (no plain run: its kernels are held to their plain versions in phases
    2, 12 and 15e);
11f. eigen path: the anisotropic Poisson operator (cy 0.6) at ng = 1024,
    ``A.eigsh(k=6, method="lobpcg", precond="amg", tol=1e-9)``, the
    eigenvalues against their closed form (1e-8), residuals ≤ 10·tol, one
    analyze and one Galerkin product across the forward and the backward
    (Hellmann–Feynman + one deflated CG per pair); the val-gradient of
    Σ cᵢwᵢ + (V[1]·a)² against the plain run (1e-7) on the same problem at
    ng = 256 (the plain run at ng = 1024 took ~26 s);
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
    shape (row 7b's SIMT kernel beside SDPA) — and at phase 14b's shapes:
    recurrentgemma's local layer (B 2, S 4096, H 10, K 1, d 256, window
    2048; bf16 and f32, rows 7c / 7c′; SDPA with a boolean band mask),
    whisper's encoder (B 4, S = T 1500, H = K 16, d 64, bidirectional) and
    cross attention (S 448, T 1500); their time, the plain version's,
    SDPA's and the bound (operations: 4·d flops per kept pair; the bf16
    tensor-core kernel and the f32 SIMT kernel are two rows of the kernels
    line);
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
14b. the other families at full width and full depth (seed-made weights,
    params f32, activations bf16): granite-moe-1b-a400m (24 MoE layers,
    32 experts top-8; prefill 4 × 4096), recurrentgemma-2b (26 layers,
    RG-LRU + local attention at head dim 256, window 2048; 2 × 4096),
    mamba2-780m (48 SSD layers, chunk 256; 2 × 4096) and whisper-medium
    (24 + 24 layers, 1500 encoder frames; 4 × 448): ``serve.prefill``
    (wall, device time and busy share, the flash kernel's share of it,
    peak memory; the flash kernel once per attention sub-layer),
    ``greedy_decode`` at batch 4, prompt 32, 8 generated (ms a step; busy
    share: two traced steps' device time over two steps' wall), and an f32 decode ≡ forward check at B 2 ×
    S 128 (≤ 2e-4 of max |logits|); granite's check counts the
    token-layers whose routing differs between the two runs (at most
    0.1%) and holds the tolerance over the positions whose routes agree in
    every layer; recurrentgemma's ring is also held past its window, cut
    to 64, at B 1 × S 160 (printed as a ``reduced`` note); mamba2's
    weights also run in f64 (the same numbers): decode ≡ forward there
    (≤ 1e-9), and the f32 hidden states and logits against the f64
    forward's, layer by layer;
15. batched solves and the solve server (f64, numpy seed 0):
    15a. the lane-batched kernels against their plain versions (written
    lane by lane) and, lane by lane, against the single-vector kernels
    bit for bit: ``bell_spmv_batched`` at ``poisson2d(1024)`` with B = 8
    value stacks, ``bell_spmm`` there with k = 16 right-hand sides,
    ``stencil5_batched`` at ng = 2048 with B = 4 operators, the eight step
    bodies at (B = 8, n = 2²⁰) with per-lane scalars; their time, the plain
    version's, the bound and the library call (``torch.sparse.mm`` of a
    B-block block-diagonal CSR by the stacked x; of the CSR by an (n, k)
    block for SpMM);
    15b. batched-values CG + Jacobi through ``sla.solve`` at
    ``poisson2d(1024)`` (``backend="pallas"``, B = 8 value scales in
    [0.7, 1.4], tol 1e-8) and Σx² ``backward()`` to the (B, nnz) values,
    held to 8 single solves of the same lanes: per-lane iteration counts
    equal, solutions to 1e-10, values gradients to 1e-8, analyze 1 /
    setup 1 / transpose_shared 1, the loop's kernel launches equal to the
    slowest single solve's within 16; the same for batched BiCGStab on the
    drift operator at ng = 256 (its adjoint on Aᵀ's layout) and batched CG
    on stencil operators at ng = 512;
    15c. multi-rhs: ``block_cg`` with k = 16 right-hand sides at
    ``poisson2d(1024)`` + Jacobi (iterations ≤ the largest per-rhs CG
    count, agreement within ‖A⁻¹‖ times the two residuals), CG +
    Chebyshev on 4 right-hand sides (the lane-batched halfstep and
    cheb_step), and a direct solve at ``poisson2d(316)`` with k = 16: one
    factorization, one ``sn_sweep`` launch per bucket for all k columns,
    against 16 single solves (1e-10) with its gradient (1e-8);
    15d. ``serve()`` with a quarter of the reference CLI's stream (64
    requests, grids 256 and 257, max_batch 32, CG + Jacobi, tol 1e-8,
    ``pallas``),
    parity checked inside: analyze == 2, all converged, occupancy 1.0;
    solves/s, p50/p99 of both drivers and the speedup (recorded, not
    gated);
    15e. batched values through the direct route and the heavy
    preconditioners (f64, numpy seed 0, lanes scaled in [0.7, 1.4]): B = 8
    lanes of the direct path's ``poisson2d(316)`` on its cached plan,
    ``sla.solve`` + ``backward()`` — one setup and one factorization,
    2 × buckets launches a factorization, a solve and a backward for all
    lanes (as for one), every lane's true residual ≤ 1e-10 and its x and
    gradient within 1e-12 of its single solve; one batched factorization
    and solve (wall, device) against 8 one at a time; rows 4′–6′
    (``panel_factor_lanes``, ``schur_update_lanes``, ``sn_sweep_lanes``)
    against their plain versions lane by lane and against the single-lane
    launch on each lane (bit for bit; 1e-13 where atomics add:
    schur_update, sn_sweep modes l / ut), with their time over one batched
    factorization beside the plain version's, 8 single-lane passes' and
    the bound (values B times, shared tables once); then B = 4 lanes
    through CG + AMG at ``poisson2d(1024)`` (phase 11b's cached analysis;
    one Galerkin product), CG + MG at ng = 2048 (a κ per lane), CG +
    Chebyshev at ``poisson2d(1024)`` and CG + ILU(0) at ``poisson2d(64)``
    (the AMG and ILU lanes with random conductances, so that no lane is a
    multiple of another), per-lane iterations equal to the single
    solves', ms an iteration for the lanes against one;
16. distributed path: ``DSparseTensor`` over a one-rank NCCL process
    group (every all-reduce and all-gather through NCCL; a failed
    initialisation fails the run), P shards on the one card, the local
    product one ``bell_spmv`` launch for the rank's shards, the per-shard
    dots one lane-batched ``fused_dots2`` launch:
    16a. ``poisson2d(4000)`` (16M unknowns, paper Table 3's top rung), P =
    4, Jacobi CG and pipelined CG at paper Table 4's fixed budget of 1,000
    iterations (tol 0), after a 16-iteration warm-up (NCCL's set-up): ms
    an iteration, halo bytes an iteration, peak device memory and the
    bytes held a shard, the residual after the budget (the true one equal
    to the recurrence's within 1e-6), a traced 16-iteration window of each
    method (device time, busy share, top kernels), and the first 100
    iterations against the same run inside ``plain_kernels`` (1e-9);
    16b. ``poisson2d(1024)``, P = 4, Jacobi CG to tol 1e-10 with
    ∂Σx²/∂val, x and the gradient against the single-device solve (CG +
    Jacobi, plain loop) within 1e-8; the wall of the solve + grad and the
    ``PLAN_STATS`` of a 3-tolerance sweep plus the backward (one analyze);
    16c. the transposed paths' drift operator (ng 256), BiCGStab with its
    Aᵀ-partition gradient, against the single-device BiCGStab (1e-6);
    16d. Jacobi, ``schwarz`` and ``schwarz2`` for P ∈ {4, 8}:
    iterations to tol 1e-8 at ``poisson2d(64)`` (Schwarz below Jacobi;
    two-level below one-level at P = 8), the setup time and one apply's ms
    at ``poisson2d(256)`` (a Schwarz solve there would take ~50 s: ~250
    iterations of a ~200 ms apply, ILU(0)'s Python step loop);
    16e. ``eigsh(k=4)`` at ``poisson2d(64)`` against the closed form (1e-8);
18. LM training path (seed-made weights, ``launch.train.make_train_step``):
    (a) the flash kernel's ``torch.autograd.Function`` at row 7's bf16
    layer shape (B 4, S 4096, H 32, K 8, d 64, causal) and row 7b's f32 GQA
    shape: the kernel's forward, the plain blocked backward; dq, dk, dv
    against autograd through the plain version (f32 in; ≤ 1e-5 of max |g|
    in f32, ≤ 1e-2 in bf16), forward + backward ms against SDPA's;
    (b) llama3.2-1b at full width and depth (16 layers, d 2048, vocab
    128,256, bf16 activations, f32 parameters and moments, remat full),
    12 steps of AdamW (lr 3e-4, 4 warm-up steps) on ``synthetic_batch``
    B 4 × S 4096 with the CE in 4 chunks: loss, grad norm, lr and ms per
    step, the median over steps 3–12, tokens/s, peak memory, one traced
    step's device ms by class (flash forward kernel, backward attention
    math, GEMMs, CE, optimizer, rest); every loss finite, the last 4
    steps' mean ≥ 0.2 nats below step 1's, the flash kernel launched at
    least 2 × 16 × 12 times (forward and remat recompute); (c) 2 layers at
    full width in f32 (B 2 × S 256): every parameter's gradient present
    and nonzero, and within 1e-4 of max |g| of the same backward with the
    model's attention on autograd through the plain version; (d)
    ``TrainLoop`` on the smoke variant: a failure injected at step 12 of
    20, the final state against an uninterrupted run's (bit for bit, or
    within 1e-5 of max |x| with the op that adds in another order named),
    and a checkpoint written from a CPU run restored onto the card;
17. on-card tests (run last): ``python -m pytest --noconftest -p
    no:cacheprovider -q tests/test_torch_on_card.py`` (``PYTHONPATH=src``),
    every hand-written
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
sys.path.insert(0, os.path.join(ROOT, "src"))
# H100 SXM HBM3 rate and peak rates (NVIDIA data sheet; their one home is
# the port's launch/mesh.py): f32 and f64 outside the tensor cores, bf16 at
# the dense tensor-core rate, the least time any kernel could take for bf16
# attention
from repro_torch.launch.mesh import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.launch.mesh import PEAK_FLOPS  # noqa: E402
from repro_torch.kernels.flash_attention import kept_pairs  # noqa: E402
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
BATCH_B = 8                          # 15a/15b: value stacks on one pattern
SPMM_K = 16                          # 15a/15c: right-hand sides on one matrix
STENCIL_B = 4                        # 15a/15b: stencil operators
STEP_B, STEP_N = 8, 1 << 20          # 15a: step bodies, lanes x length
NG_BATCH_STENCIL = 256               # 15b: batched stencil CG
NG_SERVE = 256                       # 15d: grids 256 and 257
SERVE_REQUESTS, SERVE_MAX_BATCH = 64, 32    # 15d: a quarter of the reference CLI's
                                            # stream (run-length budget)
LANES_DIRECT = 8                     # 15e: value lanes of poisson2d(316)
LANES_PRECOND = 4                    # 15e: lanes through AMG / MG / ...
NG_ILU_LANES = 64                    # 15e: ILU(0)'s scalar program
TOL_BATCH = 1e-10                    # batched vs single solves, relative
TOL_BATCH_GRAD = 1e-8                # their values gradients, relative
TRACE_ITERS = 64                     # 15b: profiled iterations
NG_LU = 128                          # non-symmetric LU path: 16,384
SADDLE = (384, 128)                  # indefinite path: H 384², B 128×384
NG_ILU = 100                         # ILU path: 10,000 unknowns
TOL_DIRECT_RES = 1e-10               # direct solve: true relative residual
TOL_CG_REF = 1e-12                   # the CG run the direct gradient meets
TOL_DENSE = 1e-8                     # LU / saddle vs torch.linalg, relative
MAXITER = 30000
SEED = 0
NG_DIST = 4000                       # 16a: paper Table 3's "16M" rung
DIST_P = 4                           # 16: shards of the one rank
DIST_ITERS = 1000                    # 16a: paper Table 4's fixed budget
DIST_PLAIN_ITERS = 100               # 16a: iterations held to the plain run
TOL_DIST_PLAIN = 1e-9                # their x, relative
TOL_DIST_DRIFT = 1e-6                # 16a: true vs recursive residual
DIST_TRACE_ITERS = 16                # 16a: the traced window
NG_DIST_GRAD = 1024                  # 16b: solve + grad
TOL_DIST = 1e-10                     # 16b: its tolerance
DIST_SWEEP = (1e-6, 1e-8, 1e-10)     # 16b: the tolerance sweep
TOL_DIST_GRAD = 1e-8                 # 16b: x and gradient vs single device
TOL_DIST_NONSYM = 1e-6               # 16c: the same, non-symmetric
NG_DIST_SCHWARZ = 256                # 16d: setup and apply timed
NG_DIST_SCHWARZ_ITERS = 64           # 16d: iterations counted
DIST_SCHWARZ_P = (4, 8)
NG_DIST_EIG = 64                     # 16e
DIST_EIG_K = 4
DIST_EIG_MAXITER = 2000
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
# phases 11d–11f, the nonlinear and eigen layer (f64, inputs from SEED):
# F(u, θ) = A u + θ u³ − f, the reference's table-5 residual
# (benchmarks/table5_gradcheck.py), on poisson2d(NG_BELL) with AMG inner
# solves and on poisson2d(NG_DIRECT) with direct ones; the anisotropic
# Poisson of tests/test_solvers.py at NG_EIG for eigsh
NL_THETA = 0.8
NL_TOL = 1e-10                       # Newton and fixed point: ‖F(u*)‖
NL_MAXITER = 50                      # Newton steps
NL_INNER = dict(tol=1e-12, maxiter=600)   # inner CG + AMG
NL_FD_EPS = 1e-4                     # central difference in θ
TOL_FD = 1e-5                        # θ-gradient vs the central difference
NL_DT = 0.05                         # backward-Euler step: u − G contracts
NL_FP_MAXITER = 500                  # Picard / Anderson iterations
ANDERSON_M = 5
NG_EIG = 1024                        # eigsh: 1,048,576 unknowns
EIG_K = 6
EIG_CY = 0.6                         # y-coupling of the anisotropic Poisson
EIG_TOL = 1e-9
EIG_MAXITER = 500
TOL_EIG = 1e-8                       # eigenvalues vs closed form, relative
TOL_EIG_PLAIN = 1e-7                 # val-gradient vs the plain run
NG_EIG_PLAIN = 256                   # the grid of that comparison
# phase 13: (label, BH, S, T, d, dtype, causal); the first is the main
# path's layer shape (B 4 × 32 heads, S 4096, head dim 64)
FLASH_SHAPES = (("prefill layer", 128, 4096, 4096, 64, "bfloat16", True),
                ("f32 causal", 64, 2048, 2048, 64, "float32", True),
                ("f32 bidir", 64, 2048, 2048, 64, "float32", False),
                ("ragged bf16", 24, 1000, 1000, 128, "bfloat16", True),
                ("uneven f32", 2, 128, 256, 64, "float32", False))
# the model's GQA form at the shapes the main paths give it: (label, B, S,
# T, H, K, d, dtype, causal, window) — the bf16 prefill layer and the f32
# decode ≡ forward check's forward (the only f32 launches of the path; row
# 7b is read here), then phase 14b's new shapes: recurrentgemma's local
# layer (head dim 256, one KV head, window 2048; rows 7c and 7c′), whisper's
# encoder (bidirectional, S = T = 1500) and its cross attention (448
# queries over 1500 frames)
FLASH_GQA = (("prefill GQA", 4, 4096, 4096, 32, 8, 64, "bfloat16", True, 0),
             ("f32 check GQA", 2, 128, 128, 32, 8, 64, "float32", True, 0),
             # row 7b at the prefill's full layer shape (timed, not on the
             # path): the f32 SIMT kernel beside SDPA
             ("f32 prefill GQA", 4, 4096, 4096, 32, 8, 64, "float32", True,
              0),
             ("local d256 w2048", 2, 4096, 4096, 10, 1, 256, "bfloat16",
              True, 2048),
             ("local d256 w2048 f32", 2, 4096, 4096, 10, 1, 256, "float32",
              True, 2048),
             ("whisper encoder", 4, 1500, 1500, 16, 16, 64, "bfloat16",
              False, 0),
             ("whisper cross", 4, 448, 1500, 16, 16, 64, "bfloat16", False,
              0))
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
TOL_LM_F64 = 1e-9                    # the same in f64 (mamba2's witness)
LM_AGREE = 0.95                      # bf16: greedy tokens that must agree
# phase 14b: the other families at full width and full depth (seed-made
# weights, params f32, activations bf16): (arch, prefill B × S)
LM_FAMILIES = (("granite-moe-1b-a400m", (4, 4096)),
               ("recurrentgemma-2b", (2, 4096)),
               ("mamba2-780m", (2, 4096)),
               ("whisper-medium", (4, 448)))
LM_FAMILY_SERVE = (4, 32, 8)         # greedy_decode: batch, prompt, generated
LM_LOCAL_CHECK = (1, 160, 64)        # recurrentgemma past its window: B, S,
                                     # the window it is cut to
MOE_FLIPS = 1e-3                     # granite: routing flips allowed between
                                     # forward and decode, of token-layers
MOE_CHECK_CF = 8.0                   # granite's decode ≡ forward: capacity
                                     # factor with no copy dropped (C ≥ S at
                                     # ≥ E/k = 4; smoke_variant's 8.0)
# phase 18: the LM training path
# (a) the flash autograd Function at row 7's bf16 layer shape and row 7b's
# f32 GQA shape: (label, B, S, H, K, d, dtype), causal
FLASH_TRAIN = (("prefill GQA", 4, 4096, 32, 8, 64, "bfloat16"),
               ("f32 check GQA", 2, 128, 32, 8, 64, "float32"))
# dq/dk/dv against autograd through the plain version (f32 in), max |Δ|
# over max |g|: f32 at the forward's 1e-5; bf16 stated before the first
# run: the kernel's o (which the backward reads through rowsum(do∘o)) and
# each gradient are rounded to bf16, 2^-9 relative each, held at 1e-2
TOL_FLASH_GRAD = {"float32": 1e-5, "bfloat16": 1e-2}
TRAIN_SHAPE = (4, 4096)              # (b): batch × seq (the prefill's tokens)
TRAIN_STEPS = 12
TRAIN_CE_CHUNKS = 4
TRAIN_OPT = dict(lr=3e-4, warmup_steps=4, total_steps=12)
TRAIN_DROP = 0.2                     # nats: last 4 steps' mean below step 1's
TRAIN_GRAD = (2, 2, 256)             # (c): layers, B, S at full width, f32
TOL_TRAIN_GRAD = 1e-4                # (c): gradient vs the plain route
FT_STEPS = (20, 12)                  # (d): steps, the injected failure's step
# phase 19: the sharded launch path on a (pod, data, model) = (1, 1, 1)
# mesh over the one-rank NCCL group, baseline rules, llama3.2-1b as
# registered (full width and depth)
LAUNCH_STEPS = 2                     # (a): sharded vs unsharded train steps
TOL_LAUNCH = 1e-6                    # (a): of each state tensor's max |x|
LAUNCH_DECODE = (4, 8, 9)            # (b): batch, prompt, generated: 16 steps
DRYRUN_CELL = ("llama3.2-1b", "train_4k", "single")    # (c), on the host
DRYRUN_TIMEOUT = 120                 # (c): seconds
TOL_FT = 1e-5                        # (d): resumed vs uninterrupted run,
                                     # of max |x|, where not bit for bit
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
# the lane-batched entry points (the reference's jax.vmap of each kernel)
for _f in ("bell_spmv_batched", "bell_spmm"):
    KERNEL_SOURCES[_f] = KERNEL_SOURCES["bell_spmv"]
KERNEL_SOURCES["stencil5_batched"] = KERNEL_SOURCES["stencil5"]
for _f in FUSED:
    KERNEL_SOURCES[_f + "_batched"] = KERNEL_SOURCES[_f]
for _f in PANEL_KERNELS:          # rows 4′–6′: the same under jax.vmap
    KERNEL_SOURCES[_f + "_lanes"] = KERNEL_SOURCES[_f]


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


def _panel_work(bk, distinct=None, sdistinct=None, lanes=1):
    """(bytes, flops) per kernel that one bucket's true sizes need, f64,
    each input read once and each output written once, for ``lanes`` value
    lanes of one pattern: the values are per lane, the int32 tables (slots,
    targets, row ids, w and r) one copy for all lanes, and every lane does
    the whole arithmetic.  panel_factor reads and writes its panels in place
    in C: w² + 2rw words (16 B a lane), each with its int32 slot (4 B).
    schur_update reads the two panels (2rw words, 8 B a lane, with their
    slots, 4 B), one int32 index per live target (r² of them, 4 B), and
    reads and writes each distinct target once (``distinct``, the bucket's
    distinct addresses: sibling lanes share some; 16 B a lane).  sn_sweep:
    one mode-l sweep step with one right-hand side: the strict lower
    triangle of D and L_sub (8 B a lane) with their slots (4 B), y_b read
    and written (16 B a lane) with its row id (4 B) per live block row,
    each distinct row of y_s read and written once (``sdistinct``: sibling
    lanes share ancestor rows; 16 B a lane) with a row id per live sub-row
    (4 B), and w, r per bucket lane (8 B)."""
    w = bk.wvec.double().cpu().numpy()
    r = bk.rvec.double().cpu().numpy()
    k = bk.wvec.shape[0]
    if distinct is None:
        distinct = int(bk.uidx.unique().numel())
    if sdistinct is None:
        sdistinct = _sweep_distinct(bk)
    s1 = w * (w - 1) / 2                         # Σ_t (w-t-1)
    s2 = (w - 1) * w * (2 * w - 1) / 6           # Σ_t (w-t-1)²
    words = float((w * w + 2 * r * w).sum())
    tri = float((s1 + r * w).sum())
    # (bytes a lane, shared bytes, flops a lane)
    pf = (16 * words, 4 * words,
          float((2 * s2 + s1 + r * w + 4 * r * s1).sum()))
    su = (8 * float((2 * r * w).sum()) + 16.0 * distinct,
          float((4 * 2 * r * w + 4 * r * r).sum()),
          float((2 * w * r * r).sum()))
    sw = (8 * tri + 16 * float(w.sum()) + 16.0 * sdistinct,
          4 * tri + float((4 * w + 4 * r).sum()) + 8.0 * k,
          float((2 * s1 + 2 * r * w).sum()))
    return {name: (lanes * lb + sb, lanes * f)
            for name, (lb, sb, f) in (("panel_factor", pf),
                                      ("schur_update", su), ("sn_sweep", sw))}


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


def _panel_cases(buckets):
    """The buckets the panel-kernel checks hold: the widest, the one with
    the most lanes and a ragged one (pad lanes and lanes narrower than the
    bucket)."""
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
    return (("widest", widest), ("most lanes", most), ("ragged", rag))


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

    nk_of = lambda b: b.wvec.shape[0]
    cases = _panel_cases(buckets)
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
    written to ``trace`` unless None): (count, summed device ms, [(ms,
    count, name)] by name, largest first) over the device-side events
    (kernels, copies).  Their durations only; launch gaps between them are
    not in the sum."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    if trace is not None:
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
    keep.update(art=art, val=A0.val, A=A0)
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

        def st_lanes(meta, v5, x):
            return ref.stencil5_lanes_ref(v5, x)

        def spmv(sell, vals, x, n):
            return ref.sell_matvec_ref(sell.slice_ptr, sell.cols, vals, x, n)

        def spmv_lanes(sell, vals, x, n):
            return ref.sell_matvec_lanes_ref(sell.slice_ptr, sell.cols, vals,
                                             x, n)

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
                              (ops, "stencil5_batched", st_lanes),
                              (ops, "bell_spmv", spmv),
                              (ops, "bell_spmv_batched", spmv_lanes),
                              (ops, "bell_spmm", spmv_lanes),
                              (solve_step, "_run", solve_step._run_cpu),
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
    """Wraps a module function (or a class's method) and sums its wall
    seconds and calls, keeping the last result (measurement).  With
    ``sync`` (a device) the device is synchronized before and after each
    call, so the seconds hold its device work."""

    def __init__(self, mod, name, sync=None):
        self.mod, self.name, self.sync = mod, name, sync
        self.seconds, self.calls, self.result = 0.0, 0, None
        self.starts, self.each = [], []    # per call: start time, seconds

    def __enter__(self):
        self.fn = getattr(self.mod, self.name)

        def wrapped(*a, **kw):
            if self.sync is not None:
                _sync(self.sync)
            t = time.perf_counter()
            try:
                self.result = self.fn(*a, **kw)
                if self.sync is not None:
                    _sync(self.sync)
                return self.result
            finally:
                dt = time.perf_counter() - t
                self.seconds += dt
                self.calls += 1
                self.starts.append(t)
                self.each.append(dt)

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


def amg_path(dev, ng, n_graph, tol, maxiter, out, keep):
    """Phase 11b: CG + smoothed-aggregation AMG on ``poisson2d(ng)`` and on
    an unstructured graph Laplacian of the same order of n.  The
    ``poisson2d(ng)`` tensor, its AMG analysis in its plan cache, goes into
    ``keep`` for phase 15e."""
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
    keep["A"] = A0
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
# phases 11d–11f: the nonlinear and eigen layer (SparseNewton, Newton /
# Picard / Anderson, LOBPCG eigsh) with their adjoints
# ---------------------------------------------------------------------------

def _nl_problem(dev, ng, seed):
    """F(u, θ) = A u + θ u³ − f on ``poisson2d(ng)`` (the block-ELL kernel),
    f from the seed; its Jacobian A + 3θ diag(u²) in closed form."""
    import torch
    from repro_torch.data.poisson import poisson2d
    A = poisson2d(ng, build_kernel_layout=True, device=dev)
    f = torch.tensor(np.random.default_rng(seed).normal(size=ng * ng),
                     device=dev)
    diag = A.row == A.col

    def F(u, th):
        return A.matvec(u, backend="pallas") + th * u ** 3 - f

    def jac(u, th):
        return A.val + torch.where(diag, 3 * th * u[A.row] ** 2,
                                   torch.zeros_like(A.val))
    return A, f, F, jac


def _theta(dev, value=NL_THETA):
    import torch
    return torch.tensor(value, dtype=torch.float64, device=dev,
                        requires_grad=True)


def _newton_case(dev, label, A, F, jac, cfg, refresh):
    """One SparseNewton solve of F(u, θ) = 0 (colored assembly) with its
    θ-gradient: counters, launches, times; the gradient against a central
    difference on the same cached plan (the difference's solves assemble
    in closed form, so they color nothing).  No run inside
    ``plain_kernels``: the path's kernels are held to their plain versions
    in phases 2, 11b and 12 (the run on their plain versions took 46 s
    with AMG inner solves and ~100 s with direct ones on an H100)."""
    import torch
    from repro_torch import sla
    from repro_torch.core import dispatch as tdisp
    from repro_torch.core import nonlinear as tnl

    n = A.shape[0]
    zero = torch.zeros(n, dtype=torch.float64, device=dev)

    def solve(th, **kw):
        return sla.nonlinear_solve(F, zero, th, jac_pattern=A,
                                   linear_solver=cfg, tol=NL_TOL,
                                   maxiter=NL_MAXITER, **kw)

    th = _theta(dev)
    _sync(dev)
    _peak_reset(dev)
    _counts_reset()
    with _timed(tnl, "color_pattern") as col, \
            _timed(tdisp, "get_plan") as ana, \
            _timed(tnl.SparseNewton, "assemble", sync=dev) as asm:
        t0 = time.perf_counter()
        u = solve(th)
        _sync(dev)
        t1 = time.perf_counter()
        (u * u).sum().backward()
        _sync(dev)
        t2 = time.perf_counter()
    launches, stats = _counts()
    peak = _peak(dev)
    g = float(th.grad)
    with torch.no_grad():
        rn = float(torch.linalg.norm(F(u, th.detach())))
    steps = stats["jac_assemble"]
    colors = col.result[1]
    # a step runs from its assembly to the next (the last to the solve's
    # end); the first holds the plan's analyze and the first probe sweep
    step_s = np.diff(asm.starts + [t1]).tolist()
    step_med = float(np.median(step_s[1:])) if steps > 1 else step_s[0]
    asm_med = float(np.median(asm.each[1:])) if steps > 1 else asm.each[0]
    eps = NL_FD_EPS
    t3 = time.perf_counter()
    with torch.no_grad():
        lp, lm = ((solve(_theta(dev, NL_THETA + s * eps),
                         assemble_jacobian=jac) ** 2).sum()
                  for s in (1, -1))
        fd = float(lp - lm) / (2 * eps)
    _sync(dev)
    fd_s = time.perf_counter() - t3
    _, stats_fd = _counts()
    fd_err = abs(g - fd) / abs(fd)
    per_step = {k: launches[k] / max(steps, 1) for k in PANEL_KERNELS
                + ("bell_spmv",)}
    per_step["fused"] = sum(launches[k] for k in FUSED) / max(steps, 1)
    say(f"  Newton {label} (n={n}): {steps} steps, ‖F(u*)‖ {rn:.3e}; "
        f"coloring {colors} colors in {col.seconds:.2f} s (host numpy); "
        f"analyze {ana.seconds:.2f} s; assembly (synchronized) first "
        f"{1e3 * asm.each[0]:.2f} ms, median of the others "
        f"{1e3 * asm_med:.2f} ms; solve {t1 - t0:.3f} s: first step "
        f"{step_s[0]:.3f} s, median of the others {step_med:.4f} s "
        f"(min {min(step_s):.4f}, max {max(step_s):.4f}); backward "
        f"{t2 - t1:.3f} s; peak {peak:.3f} GB")
    say(f"  θ-gradient {g!r}: central difference {fd!r} (ε {eps:g}, "
        f"{fd_s:.2f} s) rel diff {fd_err:.3e}")
    say(f"  launches {json.dumps({k: v for k, v in launches.items() if v})};"
        f" per step {json.dumps({k: round(v, 2) for k, v in per_step.items()})}")
    say(f"  PLAN_STATS {json.dumps({k: v for k, v in stats.items() if v})}")
    check(rn <= NL_TOL, f"Newton {label}: ‖F(u*)‖ {rn:.2e} <= {NL_TOL:g}")
    check(stats["analyze"] == 1 and stats["jac_color"] == 1
          and stats["transpose_shared"] == 1
          and stats[refresh] == steps >= 2,
          f"Newton {label}: analyze 1, jac_color 1, transpose_shared 1, "
          f"{refresh} == jac_assemble == {steps} (none in the backward)")
    check(stats_fd["analyze"] == 1, f"Newton {label}: the central "
          f"difference's solves ran on the same cached plan")
    check(math.isfinite(g) and fd_err <= TOL_FD,
          f"Newton {label}: θ-gradient vs central difference {fd_err:.2e} "
          f"<= {TOL_FD:g}")
    res = dict(n=n, steps=steps, colors=colors, coloring_s=col.seconds,
               analyze_s=ana.seconds, assembly_ms=[1e3 * a for a in asm.each],
               forward_s=t1 - t0, step_s=step_s,
               backward_s=t2 - t1, residual=rn, grad=g, fd=fd,
               fd_rel_diff=fd_err, fd_s=fd_s, peak_gb=peak,
               launches=launches, per_step=per_step, plan_stats=stats)
    return u.detach(), res, launches


def nonlinear_path(dev, ng, seed, out):
    """Phase 11d: SparseNewton + AMG at full width, then the backward-Euler
    residual by Newton, Picard and Anderson."""
    import torch
    from repro_torch import sla
    from repro_torch.core import solvers as tsolvers
    from repro_torch.core.dispatch import SolverConfig

    total = {}
    A, f, F, jac = _nl_problem(dev, ng, seed)
    cfg = SolverConfig(backend="pallas", method="cg", precond="amg",
                       **NL_INNER)
    u_star, res, launches = _newton_case(dev, f"poisson2d({ng}) + AMG", A, F,
                                         jac, cfg, "galerkin")
    for k in ("bell_spmv", "fused_cg_halfstep", "panel_factor", "sn_sweep"):
        check(launches[k] > 0, f"nonlinear path launched {k} "
              f"({launches[k]} times)")
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v
    out["nonlinear_path"] = {"newton_amg": dict(ng=ng, **res)}

    # backward Euler from u*: G(u, θ) = u + Δt (A u + θ u³) − u_prev
    n = ng * ng
    dt = NL_DT
    diag = A.row == A.col
    zero = torch.zeros(n, dtype=torch.float64, device=dev)

    def G(u, th):
        return u + dt * (A.matvec(u, backend="pallas") + th * u ** 3) - u_star

    def jac_g(u, th):
        return dt * A.val + torch.where(diag, 1 + 3 * dt * th * u[A.row] ** 2,
                                        torch.zeros_like(A.val))

    fp = {}
    for method, kw in (("newton", {}), ("picard", dict(maxiter=NL_FP_MAXITER)),
                       ("anderson", dict(maxiter=NL_FP_MAXITER,
                                         anderson_m=ANDERSON_M))):
        th = _theta(dev)
        _sync(dev)
        _counts_reset()
        with _timed(tsolvers, f"{method}_solve") as rec:
            t0 = time.perf_counter()
            u = sla.nonlinear_solve(G, zero, th, method=method, tol=NL_TOL,
                                    jac_pattern=A, linear_solver=cfg,
                                    assemble_jacobian=jac_g, **kw)
            _sync(dev)
            t1 = time.perf_counter()
            (u * u).sum().backward()
            _sync(dev)
            t2 = time.perf_counter()
        launches, stats = _counts()
        with torch.no_grad():
            rn = float(torch.linalg.norm(G(u, th.detach())))
        its = stats["jac_assemble"] if method == "newton" \
            else int(rec.result[1].iters)
        fp[method] = dict(iterations=its, forward_s=t1 - t0,
                          backward_s=t2 - t1, residual=rn, grad=float(th.grad),
                          launches=launches, plan_stats=stats)
        say(f"  backward Euler (Δt {dt:g}) by {method}: {its} iterations, "
            f"‖G(u)‖ {rn:.3e}, solve {t1 - t0:.3f} s, backward "
            f"{t2 - t1:.3f} s, θ-gradient {float(th.grad):.10e}; "
            f"PLAN_STATS {json.dumps({k: v for k, v in stats.items() if v})}")
        check(rn <= 10 * NL_TOL, f"backward Euler by {method}: ‖G(u)‖ "
              f"{rn:.2e} <= 10·{NL_TOL:g}")
        check(stats["analyze"] == 0 and stats["jac_color"] == 0,
              f"backward Euler by {method}: the cached plan, no coloring")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    for method in ("picard", "anderson"):
        err = abs(fp[method]["grad"] - fp["newton"]["grad"]) / abs(
            fp["newton"]["grad"])
        fp[method]["grad_rel_diff_vs_newton"] = err
        say(f"  {method}: θ-gradient vs Newton's on G rel diff {err:.3e}")
        check(err <= TOL_GRAD, f"backward Euler: {method}'s θ-gradient "
              f"matches Newton's ({err:.2e} <= {TOL_GRAD:g})")
    out["nonlinear_path"]["backward_euler"] = dict(dt=dt, **fp)
    del A, f, u_star
    return total


def newton_direct_path(dev, ng, seed, out):
    """Phase 11e: SparseNewton with direct inner solves (supernodal LDLᵀ
    on the panel kernels) on ``poisson2d(ng)``; as in phase 11d, its
    θ-gradient is held to the central difference (see
    :func:`_newton_case`)."""
    from repro_torch.core.dispatch import SolverConfig

    A, f, F, jac = _nl_problem(dev, ng, seed)
    _, res, launches = _newton_case(dev, f"poisson2d({ng}) direct", A, F, jac,
                                    SolverConfig(backend="direct"),
                                    "factorize")
    for k in ("bell_spmv", "panel_factor", "schur_update", "sn_sweep"):
        check(launches[k] > 0, f"Newton direct path launched {k} "
              f"({launches[k]} times)")
    out["newton_direct_path"] = dict(ng=ng, **res)
    del A, f
    return launches


def _aniso_eigenvalues(ng, cy, k):
    """The k smallest eigenvalues of the anisotropic Poisson operator in
    closed form, (2 − 2cos(iπ/(ng+1))) + cy (2 − 2cos(jπ/(ng+1)))."""
    s = 2 - 2 * np.cos(np.arange(1, k + 2) * np.pi / (ng + 1))
    return np.sort((s[:, None] + cy * s[None, :]).ravel())[:k]


def _eig_problem(dev, ng, seed):
    """(A, closed-form eigenvalues, loss weights, ``run(leaf)`` → (w, V,
    loss)) of the eigen path at grid ``ng``."""
    import torch
    from repro_torch.core.sparse import SparseTensor
    from repro_torch.data.poisson import poisson2d_arrays

    n, k = ng * ng, EIG_K
    val, row, col = poisson2d_arrays(ng)
    val = val.copy()
    val[np.abs(row - col) == 1] *= EIG_CY
    val[row == col] = 2.0 + 2.0 * EIG_CY
    A = SparseTensor(val, row, col, (n, n), build_kernel_layout=True,
                     device=dev)
    lam = _aniso_eigenvalues(ng, EIG_CY, k)
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.5, 1.5, k)
    # pairs closer than 1e-4 (relative) form one cluster: at ng = 1024 the
    # (1,3) and (2,2) modes lie 2.9e-6 apart, and LOBPCG cannot fix the
    # eigenvectors inside a cluster, so an eigenvalue of it alone has no
    # determined gradient; the loss weights a cluster by its mean, a
    # function of the cluster's invariant subspace
    start = 0
    for i in range(1, k + 1):
        if i == k or (lam[i] - lam[i - 1]) / lam[i] > 1e-4:
            c[start:i] = c[start:i].mean()
            start = i
    a = torch.tensor(rng.normal(size=n), device=dev)
    ct = torch.tensor(c, device=dev)
    kw = dict(k=k, method="lobpcg", precond="amg", tol=EIG_TOL,
              maxiter=EIG_MAXITER)

    def run(leaf):
        w, V = A.with_values(leaf).eigsh(**kw)
        return w, V, (ct * w).sum() + (V[1] @ a) ** 2

    return A, lam, c, run


def eigen_path(dev, ng, seed, out):
    """Phase 11f: LOBPCG + AMG ``eigsh`` of the anisotropic Poisson operator
    at full width, with eigenvalue and eigenvector gradients."""
    import torch
    from repro_torch.core import dispatch as tdisp
    from repro_torch.core import solvers as tsolvers
    from repro_torch.core.sparse import coo_matvec

    n, k = ng * ng, EIG_K
    A, lam, c, run = _eig_problem(dev, ng, seed)
    leaf = A.val.clone().requires_grad_(True)
    _sync(dev)
    _peak_reset(dev)
    _counts_reset()
    with _timed(tsolvers, "lobpcg", sync=dev) as lob, \
            _timed(tdisp, "get_plan") as ana:
        t0 = time.perf_counter()
        w, V, loss = run(leaf)
        _sync(dev)
        t1 = time.perf_counter()
        loss.backward()
        _sync(dev)
        t2 = time.perf_counter()
    launches, stats = _counts()
    peak = _peak(dev)
    iters = int(lob.result[2].iters)
    lob_ms = 1e3 * lob.seconds / max(iters, 1)
    with torch.no_grad():
        wn = w.detach().cpu().numpy()
        lam_err = float(np.max(np.abs(wn - lam) / lam))
        resid = max(float(torch.linalg.norm(
            coo_matvec(A.val, A.row, A.col, V[i], n) - w[i] * V[i]))
            for i in range(k))
    g = leaf.grad.detach().clone()
    # the val-gradient held to the plain run at a smaller grid (the kernels
    # and the plain versions on the same problem at NG_EIG_PLAIN)
    As, _, _, run_s = _eig_problem(dev, NG_EIG_PLAIN, seed)
    leaf_k = As.val.clone().requires_grad_(True)
    run_s(leaf_k)[2].backward()
    leaf2 = As.val.clone().requires_grad_(True)
    _counts_reset()
    tp = time.perf_counter()
    with plain_kernels():
        run_s(leaf2)[2].backward()
    _sync(dev)
    plain_s = time.perf_counter() - tp
    plain_launches = sum(_counts()[0].values())
    gerr = _grad_rel(leaf_k.grad, leaf2.grad)
    say(f"  eigsh aniso poisson2d({ng}) (cy {EIG_CY}, n={n}), k={k}, LOBPCG "
        f"+ AMG, tol {EIG_TOL:g}: {iters} iterations, LOBPCG {lob.seconds:.3f} "
        f"s = {lob_ms:.2f} ms an iteration; forward {t1 - t0:.3f} s with "
        f"the plan's analyze ({ana.seconds:.2f} s) and AMG setup; backward "
        f"(Hellmann–Feynman + {k} deflated CG) {t2 - t1:.3f} s; peak "
        f"{peak:.3f} GB")
    say(f"  eigenvalues {wn.tolist()} vs closed form: max rel err "
        f"{lam_err:.3e}; max ‖Av − λv‖ {resid:.3e}; loss weights {c.tolist()}")
    say(f"  at poisson2d({NG_EIG_PLAIN}): plain run {plain_s:.2f} s, "
        f"val-gradient max rel diff to the kernels' run {gerr:.3e}")
    say(f"  launches {json.dumps({k_: v for k_, v in launches.items() if v})}")
    say(f"  PLAN_STATS {json.dumps({k_: v for k_, v in stats.items() if v})}")
    check(lam_err <= TOL_EIG, f"eigen path: eigenvalues vs closed form "
          f"{lam_err:.2e} <= {TOL_EIG:g}")
    check(resid <= 10 * EIG_TOL, f"eigen path: residuals {resid:.2e} <= "
          f"10·tol")
    check(stats["analyze"] == 1 and stats["galerkin"] == 1,
          "eigen path: analyze 1, galerkin 1 across the forward and the "
          "backward (the deflated CG reuses the forward's AMG setup)")
    check(plain_launches == 0, "eigen path: the plain run launched no kernel")
    check(bool(torch.isfinite(g).all()), "eigen path: val.grad finite")
    check(gerr <= TOL_EIG_PLAIN, f"eigen path: val.grad at poisson2d("
          f"{NG_EIG_PLAIN}) matches the plain run ({gerr:.2e} <= "
          f"{TOL_EIG_PLAIN:g})")
    for k_ in ("bell_spmv", "panel_factor", "sn_sweep"):
        check(launches[k_] > 0, f"eigen path launched {k_} "
              f"({launches[k_]} times)")
    out["eigen_path"] = dict(ng=ng, n=n, k=k, cy=EIG_CY, tol=EIG_TOL,
                             iterations=iters, forward_s=t1 - t0,
                             analyze_s=ana.seconds, lobpcg_s=lob.seconds,
                             ms_per_iteration=lob_ms,
                             backward_s=t2 - t1, eigenvalues=wn.tolist(),
                             closed_form=lam.tolist(), eig_rel_err=lam_err,
                             residual=resid, loss_weights=c.tolist(),
                             grad_rel_diff=gerr, plain_run_s=plain_s,
                             ng_plain=NG_EIG_PLAIN,
                             peak_gb=peak, launches=launches,
                             plan_stats=stats)
    del A, As, w, V, leaf, leaf_k, leaf2
    return launches


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


def _flash_plain(q, k, v, causal, round_p=False, window=0):
    """The plain version in f32 on the same inputs, over chunks of bh that
    keep the (chunk, S, T) score block near 1 GB; ``round_p`` rounds the
    probabilities to bf16 before p·v, as the bf16 kernel does."""
    import torch
    from repro_torch.kernels import ref
    S, T = q.shape[1], k.shape[1]
    step = max(1, (1 << 28) // (S * T))
    return torch.cat([ref.flash_attention_ref(
        q[b:b + step].float(), k[b:b + step].float(), v[b:b + step].float(),
        causal=causal, round_p=round_p, window=window)
        for b in range(0, q.shape[0], step)])


def _flash_err(o, q, k, v, causal, dname, window=0):
    """(err, max |o − plain|, distance from the p-rounded plain version):
    the rule of TOL_FLASH, err <= limit ⟺ |o − plain| <= limit·|plain| +
    atol everywhere, plain in f32 with p in f32."""
    limit, atol = TOL_FLASH[dname]
    want = _flash_plain(q, k, v, causal, window=window)
    diff = (o.float() - want).abs()
    err = float((diff / (atol / limit + want.abs())).max())
    dist = None
    if dname == "bfloat16":
        # the plain version that rounds p to bf16 once, as the reference
        # model's jnp attention does
        rp = _flash_plain(q, k, v, causal, round_p=True, window=window)
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

    # the model's form: q (B, S, H, d) sliced from one projection output
    # (k and v too where S = T), k, v (B, T, K, d), read in place with KV
    # head h // (H/K); timed with its plain version on the expanded heads
    # and SDPA's GQA form (the window as an explicit boolean band mask)
    gqa = {}
    for label, B, S, T, H, K, d, dname, causal, window in FLASH_GQA:
        dt = getattr(torch, dname)
        if S == T:
            qkv = torch.randn((B, S, H + 2 * K, d), generator=gen,
                              device=dev).to(dt)
            q, k, v = qkv[:, :, :H], qkv[:, :, H:H + K], qkv[:, :, H + K:]
        else:
            qkv = torch.randn((B, S, H, d), generator=gen, device=dev).to(dt)
            kv = torch.randn((B, T, 2 * K, d), generator=gen,
                             device=dev).to(dt)
            q, k, v = qkv, kv[:, :, :K], kv[:, :, K:]
        o = flash_attention_gqa(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()

        def heads(t):
            t = t.repeat_interleave(H // t.shape[2], dim=2)
            return t.permute(0, 2, 1, 3).reshape(B * H, t.shape[1], d)

        qh, kh, vh = heads(q), heads(k), heads(v)
        err, max_abs, dist = _flash_err(
            o.permute(0, 2, 1, 3).reshape(B * H, S, d), qh, kh, vh, causal,
            dname, window)
        call = lambda: flash_attention_gqa(q, k, v, causal=causal,
                                           window=window)
        ms = cuda_ms(call, 10, warmup=2, spin_ms=3.0)
        wall = wall_ms(call, 3)
        plain = _sum_ms(lambda: _flash_plain(qh, kh, vh, causal,
                                             window=window), reps=2)
        qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
        band = None
        if window:
            i = torch.arange(S, device=dev)[:, None]
            j = torch.arange(T, device=dev)[None, :]
            band = (j <= i) & (j > i - window)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=band, is_causal=causal and not window,
            enable_gqa=True), 10, warmup=2, spin_ms=3.0)
        pairs = kept_pairs(S, T, causal, window)
        nbytes = q.element_size() * 2 * B * d * (S * H + T * K)
        flops = 4 * B * H * d * pairs
        bms, bby = bound_ms(nbytes, flops, dname)
        limit = TOL_FLASH[dname][0]
        mask = (f"window {window}" if window else
                "causal" if causal else "bidir")
        say(f"  flash_attention_gqa {label} (B {B}, S {S}, T {T}, H {H}, K "
            f"{K}, d {d}) {dname} {mask}, strided q: {ms:.4f} ms (host wall "
            f"{wall:.4f} ms, plain {plain:.3f} ms, bound {bms:.4f} ms by "
            f"{bby}, {bms / ms:.0%} of it; SDPA {lib:.4f} ms); err "
            f"{err:.2e}, max |o − plain| {max_abs:.2e}")
        check(err <= limit, f"flash_attention_gqa {label} {dname} matches "
              f"its plain version on the expanded heads ({err:.2e} <= "
              f"{limit:.0e})")
        r = dict(case=label, shape=f"B{B} S{S} T{T} H{H} K{K} d{d}",
                 dtype=dname, causal=causal, window=window, ms=ms,
                 wall_ms=wall, plain_ms=plain, library_ms=lib, bytes=nbytes,
                 flops=flops, bound_ms=bms, bound_by=bby,
                 tflops=flops / ms / 1e9, err=err, max_abs_err=max_abs,
                 limit=limit, round_p_distance=dist)
        res.append(r)
        gqa[label] = r
        del qkv, q, k, v, o, qh, kh, vh, band
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


def _no_grad(fn):
    """``fn`` under ``torch.no_grad()``: serving records no gradients."""
    import functools

    @functools.wraps(fn)
    def run(*a, **kw):
        import torch
        with torch.no_grad():
            return fn(*a, **kw)

    return run


@_no_grad
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


def _flash_launches(cfg):
    """flash-wrapper launches of one forward: one per attention sub-layer
    (self, encoder and cross)."""
    n = sum(k != "rec" and k != "ssd" for k in cfg.pattern_layers)
    return n + (cfg.n_enc_layers + cfg.n_layers if cfg.enc_dec else 0)


def _random_frames(cfg, B, gen, dev, dtype):
    """Encoder frames (B, enc_frames, d) from the seed, or None."""
    import torch
    if not cfg.enc_dec:
        return None
    return torch.randn((B, cfg.enc_frames, cfg.d_model), generator=gen,
                       device=dev).to(dtype)


class _Routes:
    """Within the block, every MoE routing (the top-k expert ids, sorted)
    in call order."""

    def __enter__(self):
        from repro_torch.models import moe
        self.mod, self.orig, self.ids = moe, moe.route, []

        def route(p, x, cfg):
            r = self.orig(p, x, cfg)
            self.ids.append(r[2].sort(dim=-1).values)
            return r

        moe.route = route
        return self

    def __exit__(self, *exc):
        self.mod.route = self.orig


def _decode_vs_forward(model, toks, ef):
    """(forward logits, the same positions' logits decoded token by token)."""
    import torch
    B, S = toks.shape
    fwd, _ = model(toks, enc_frames=ef)
    state = model.init_decode_state(B, S, enc_frames=ef)
    outs = []
    for t in range(S):
        lg, state = model.decode_step(state, toks[:, t:t + 1], t)
        outs.append(lg[:, 0])
    return fwd, torch.stack(outs, 1)


def _f64_witness(m32, c32, seed, toks, fwd32, dec32):
    """SSD families: the same seed-made weights in f64 (the f32 draws cast,
    so equal), decode ≡ forward there, and the f32 forward's hidden states
    layer by layer and its logits, and the f32 decode's, against the f64
    forward's."""
    import dataclasses
    import torch
    from repro_torch.models.transformer import Transformer

    def hidden(model, run):
        hs = []
        hooks = [l.register_forward_hook(
            lambda _m, _i, o: hs.append(o[0].double()))
            for l in model.layers]
        try:
            r = run()
        finally:
            for h in hooks:
                h.remove()
        return hs, r

    c64 = dataclasses.replace(c32, dtype="float64", param_dtype="float64")
    m64 = Transformer(c64, seed=seed, device=fwd32.device)
    h64, (fwd64, dec64) = hidden(m64, lambda: _decode_vs_forward(
        m64, toks, None))
    h32, _ = hidden(m32, lambda: m32(toks))
    del m64
    sc = float(fwd64.abs().max())
    rel = lambda x: float((x.double() - fwd64).abs().max()) / sc
    layers = [float((a - b).abs().max() / b.abs().max())
              for a, b in zip(h32, h64)]
    r = dict(f64_decode_vs_forward=rel(dec64), f32_forward_vs_f64=rel(fwd32),
             f32_decode_vs_f64=rel(dec32), f32_hidden_vs_f64=layers)
    L = len(layers)
    say(f"  {c32.name} f64 witness (B={toks.shape[0]}, S={toks.shape[1]}): "
        f"f64 decode ≡ forward {r['f64_decode_vs_forward']:.2e}; against "
        f"the f64 forward the f32 forward's logits are "
        f"{r['f32_forward_vs_f64']:.2e} and the f32 decode's "
        f"{r['f32_decode_vs_f64']:.2e} of max |logits|; the f32 hidden "
        f"state after layer " + ", ".join(
            f"{i + 1}: {layers[i]:.2e}"
            for i in sorted({max(0, k * L // 4 - 1) for k in range(5)})))
    check(r["f64_decode_vs_forward"] <= TOL_LM_F64,
          f"{c32.name} decode ≡ forward in f64 "
          f"({r['f64_decode_vs_forward']:.2e} <= {TOL_LM_F64:.0e})")
    return r


def lm_family(dev, seed, arch, prefill_shape):
    """One family of phase 14b: prefill (wall, device time and busy share,
    the flash kernel's share, peak memory), greedy serving, and the f32
    decode ≡ forward check.  Returns (results, launches)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models.layers import adtype
    from repro_torch.models.transformer import Transformer

    cfg = get_config(arch)
    B, S = prefill_shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 2)
    _peak_reset(dev)
    t0 = time.perf_counter()
    model = Transformer(cfg, seed=seed, device=dev)
    _sync(dev)
    init_s = time.perf_counter() - t0
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
    ef = _random_frames(cfg, B, gen, dev, adtype(cfg))
    call = lambda: serve.prefill(model, toks, enc_frames=ef)
    call()                                        # warm-up
    _sync(dev)
    _counts_reset()
    t0 = time.perf_counter()
    logits = call()
    _sync(dev)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    launches = _counts()[0]
    peak = _peak(dev)
    walls = [wall_ms(call, 1) for _ in range(2)]
    cnt, dev_ms, top = _kernel_breakdown(
        call, os.path.join(OUT, f"lm_{arch}_prefill_trace.json.gz"))
    cls = _lm_breakdown(top)
    flash_share = cls["flash kernel"] / dev_ms
    busy = dev_ms / min(walls)
    want = _flash_launches(cfg)
    say(f"  {arch} prefill B={B} S={S}"
        + (f" ({cfg.enc_frames} encoder frames)" if cfg.enc_dec else "")
        + f": {prefill_ms:.1f} ms wall (repeats "
        f"{', '.join('%.1f' % w for w in walls)} ms), "
        f"{B * S / min(walls) * 1e3:.0f} tokens/s; device {dev_ms:.1f} ms in "
        f"{cnt} ops (busy {busy:.0%}); flash kernel {cls['flash kernel']:.1f}"
        f" ms = {flash_share:.1%} of device time; peak {peak:.2f} GB "
        f"(weights {cfg.param_count() * 4 / 1e9:.2f} GB f32); init "
        f"{init_s:.1f} s")
    say("    " + "; ".join(f"{k} {v:.1f} ms" for k, v in cls.items()))
    for ms, c, name in top[:5]:
        say(f"    {ms:9.2f} ms ×{c:<5d} {name[:90]}")
    check(tuple(logits.shape) == (B, 1, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"{arch} prefill logits {tuple(logits.shape)} finite")
    check(launches["flash_attention"] == want,
          f"{arch} prefill launched flash_attention once per attention "
          f"sub-layer ({launches['flash_attention']} == {want})")
    del logits
    drops = None
    if cfg.n_experts:
        # copies past an expert's capacity, dropped by the prefill
        from repro_torch.models.moe import moe_capacity
        with _Routes() as routes:
            call()
        C, E = moe_capacity(cfg, S), cfg.n_experts
        drops = sum(int((torch.stack([torch.bincount(r, minlength=E)
                                      for r in ids.reshape(B, -1)]) - C)
                        .clamp(min=0).sum()) for ids in routes.ids)
        copies = len(routes.ids) * B * S * cfg.top_k
        say(f"  {arch} prefill: {drops} of {copies} expert copies dropped "
            f"past capacity C = {C} (capacity factor "
            f"{cfg.capacity_factor})")

    # serving: greedy decoding with the CLI's zero encoder frames
    Bs, P, G = LM_FAMILY_SERVE
    prompts = torch.randint(0, cfg.vocab, (Bs, P), generator=gen, device=dev)
    efs = serve.zero_frames(model, Bs)
    serve.greedy_decode(model, prompts[:, :2], 1, enc_frames=efs)  # warm-up
    seq, dec_s = serve.greedy_decode(model, prompts, G, enc_frames=efs)
    step_ms = dec_s * 1e3 / (P + G - 1)
    check(tuple(seq.shape) == (Bs, P + G) and int(seq.min()) >= 0
          and int(seq.max()) < cfg.vocab
          and torch.equal(seq[:, :P], prompts.to(torch.int32)),
          f"{arch} greedy_decode: {tuple(seq.shape)} tokens in the vocab, "
          f"the prompts teacher-forced")
    # device time of two traced steps against two steps of that wall
    state = model.init_decode_state(Bs, P + G, enc_frames=efs)
    step = serve.make_serve_step(model)
    tok = prompts[:, :1].to(torch.int32)

    def two_steps():
        t_ = tok
        for t in range(2):
            t_, _ = step(state, t_, t)

    cnt2, dev2, _ = _kernel_breakdown(two_steps, None)
    dec_busy = dev2 / (2 * step_ms)
    say(f"  {arch} serving B={Bs} prompt {P} + gen {G}: {step_ms:.2f} ms per "
        f"decode step; device {dev2 / 2:.2f} ms a step (busy {dec_busy:.0%}, "
        f"{cnt2 // 2} device ops a step)")
    del model, state
    torch.cuda.empty_cache()

    # f32 decode ≡ forward at full width (the forward on the f32 kernel);
    # MoE without capacity drops, which one-token decode never has
    Bc, Sc = LM_CHECK
    c32 = dataclasses.replace(cfg, dtype="float32")
    if cfg.n_experts:
        c32 = dataclasses.replace(c32, capacity_factor=MOE_CHECK_CF)
        say(f"  reduced: {arch}'s decode ≡ forward runs with capacity factor "
            f"{cfg.capacity_factor} → {MOE_CHECK_CF} (no copy dropped, as "
            f"smoke_variant's; at {cfg.capacity_factor} the forward drops "
            f"copies that one-token decode keeps)")
    m32 = Transformer(c32, seed=seed, device=dev)
    ctoks = torch.randint(0, cfg.vocab, (Bc, Sc), generator=gen, device=dev)
    cef = _random_frames(cfg, Bc, gen, dev, torch.float32)
    _counts_reset()
    if cfg.n_experts:
        with _Routes() as routes:
            fwd, dec = _decode_vs_forward(m32, ctoks, cef)
        L = cfg.n_layers
        f_ids = torch.stack(routes.ids[:L])                 # (L, B, S, k)
        d_ids = torch.stack(routes.ids[L:]).reshape(
            Sc, L, Bc, cfg.top_k).permute(1, 2, 0, 3)
        flip = (f_ids != d_ids).any(-1)                     # (L, B, S)
        flips = int(flip.sum())
        agree = ~flip.any(0)                                # (B, S)
        f_rel = float((fwd - dec).abs()[agree].max()) / float(
            fwd.abs().max())
        say(f"  {arch} routing: {flips} of {flip.numel()} token-layers route "
            f"differently in decode than in the forward; "
            f"{int(agree.sum())} of {agree.numel()} positions agree in every "
            f"layer")
        check(flips <= MOE_FLIPS * flip.numel(),
              f"{arch}: routing flips {flips} <= {MOE_FLIPS:.1%} of "
              f"token-layers")
    else:
        fwd, dec = _decode_vs_forward(m32, ctoks, cef)
        flips = None
        f_rel = float((fwd - dec).abs().max()) / float(fwd.abs().max())
    _sync(dev)
    check_launches = _counts()[0]
    say(f"  {arch} decode ≡ forward (f32, B={Bc}, S={Sc}): max |Δlogits| = "
        f"{f_rel:.2e} of max |logits|"
        + ("" if flips is None else " over the positions whose routes agree"))
    check(f_rel <= TOL_LM_F32, f"{arch} decode ≡ forward in f32 "
          f"({f_rel:.2e} <= {TOL_LM_F32:.0e} of max |logits|)")
    witness = (_f64_witness(m32, c32, seed, ctoks, fwd, dec)
               if "ssd" in cfg.layer_pattern else None)
    check(check_launches["flash_attention_f32"] >= want,
          f"{arch}: the f32 forward launched flash_attention_f32 "
          f"{check_launches['flash_attention_f32']} times (>= {want})")
    del m32, fwd, dec
    torch.cuda.empty_cache()
    res = dict(arch=arch, prefill=dict(
        B=B, S=S, wall_ms=prefill_ms, repeats_ms=walls,
        tokens_per_s=B * S / min(walls) * 1e3, device_ms=dev_ms,
        device_ops=cnt, busy=busy, flash_ms=cls["flash kernel"],
        flash_share=flash_share, breakdown=cls, top=top[:20], peak_gb=peak,
        launches=launches), serve=dict(
        batch=Bs, prompt_len=P, gen_len=G, ms_per_step=step_ms,
        device_ms_per_step=dev2 / 2, ops_per_step=cnt2 // 2,
        busy=dec_busy), check=dict(B=Bc, S=Sc, f32_rel=f_rel,
                                       routing_flips=flips,
                                       f64_witness=witness),
        moe_dropped_copies=drops,
        model_init_s=init_s)
    total = dict(launches)
    for k, v in check_launches.items():
        total[k] = total.get(k, 0) + v

    if cfg.layer_pattern.count("attn_local"):
        # the ring past its window: the window cut so that S wraps it
        Bw, Sw, w = LM_LOCAL_CHECK
        cw = dataclasses.replace(c32, window=w)
        mw = Transformer(cw, seed=seed, device=dev)
        wt = torch.randint(0, cfg.vocab, (Bw, Sw), generator=gen, device=dev)
        _counts_reset()
        fwd, dec = _decode_vs_forward(mw, wt, None)
        _sync(dev)
        w_rel = float((fwd - dec).abs().max()) / float(fwd.abs().max())
        wl = _counts()[0]
        say(f"  {arch} decode ≡ forward past the window (f32, window {w}, "
            f"B={Bw}, S={Sw}): max |Δlogits| = {w_rel:.2e} of max |logits|")
        check(w_rel <= TOL_LM_F32, f"{arch} local ring past its window "
              f"({w_rel:.2e} <= {TOL_LM_F32:.0e})")
        res["check"]["window_check"] = dict(B=Bw, S=Sw, window=w,
                                            f32_rel=w_rel)
        for k, v in wl.items():
            total[k] = total.get(k, 0) + v
        del mw, fwd, dec
        torch.cuda.empty_cache()
    return res, total


@_no_grad
def lm_families(dev, seed, out):
    """Phase 14b: granite-moe (MoE), recurrentgemma (RG-LRU + local
    attention), mamba2 (SSD) and whisper (encoder-decoder) at full width
    and full depth."""
    from repro_torch.configs import get_config
    Bw, Sw, w = LM_LOCAL_CHECK
    full = get_config("recurrentgemma-2b").window
    say(f"  reduced: recurrentgemma-2b's decode ≡ forward past its window "
        f"runs with window {full} → {w} at B {Bw} × S {Sw} (at S "
        f"{LM_CHECK[1]} the {full}-slot ring never wraps)")
    res, total = {}, {}
    for arch, shape in LM_FAMILIES:
        t = time.perf_counter()
        r, launches = lm_family(dev, seed, arch, shape)
        r["seconds"] = time.perf_counter() - t
        say(f"  ({arch}) {r['seconds']:.1f} s")
        res[arch] = r
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    out["lm_families"] = res
    return total


# ---------------------------------------------------------------------------
# phase 18: the LM training path (slice 8)
# ---------------------------------------------------------------------------

class _ranged:
    """Within the block, ``mod.name`` runs inside a profiler range ``tag``
    (its device kernels are then attributed to the tag)."""

    def __init__(self, mod, name, tag):
        self.mod, self.name, self.tag = mod, name, tag

    def __enter__(self):
        import torch
        self.fn = fn = getattr(self.mod, self.name)
        tag = self.tag

        def wrapped(*a, **kw):
            with torch.profiler.record_function(tag):
                return fn(*a, **kw)

        setattr(self.mod, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.fn)
        return False


_GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass", "cublas")


def _train_breakdown(events):
    """Device ms of a traced train step by class, from the profiler's event
    tree: the flash forward kernel (by name), the backward attention math
    (kernels under the flash op's backward, ``flash_attention_gqa_bwd``),
    CE (kernels under the ``ce`` range — the forward and its recompute —
    and under the backward nodes of the ops recorded there), the optimizer
    (``adamw`` range), the remaining GEMMs (by name) and the rest."""
    cls = dict.fromkeys(("flash forward kernel", "backward attention math",
                         "GEMMs", "CE", "optimizer", "rest"), 0.0)

    def tags(e):
        out = set()
        while e is not None:
            out.add(e.name)
            e = e.cpu_parent
        return out

    ce_seq = {e.sequence_nr for e in events
              if e.sequence_nr >= 0 and "ce" in tags(e)
              and not e.name.startswith("autograd::engine")}
    for e in events:
        if not e.kernels:
            continue
        t = tags(e)
        bwd_seq = {a.sequence_nr for a in _ancestors(e)
                   if a.name.startswith("autograd::engine::evaluate_function")}
        for kern in e.kernels:
            ms = kern.duration / 1e3
            low = kern.name.lower()
            if "tc_kernel" in low or "simt_kernel" in low:
                cls["flash forward kernel"] += ms
            elif any("flash_attention_gqa_bwd" in n for n in t):
                cls["backward attention math"] += ms
            elif "adamw" in t:
                cls["optimizer"] += ms
            elif "ce" in t or bwd_seq & ce_seq:
                cls["CE"] += ms
            elif any(s in low for s in _GEMM_NAMES):
                cls["GEMMs"] += ms
            else:
                cls["rest"] += ms
    return cls


def _ancestors(e):
    e = e.cpu_parent
    while e is not None:
        yield e
        e = e.cpu_parent


def _flash_train(dev, seed, out):
    """(a) The flash kernel's autograd Function at row 7's bf16 layer shape
    and row 7b's f32 GQA shape: dq, dk, dv against autograd through the
    plain version (f32 in, batch row by batch row), forward + backward ms
    against SDPA's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 18)
    res = []
    for label, B, S, H, K, d, dname in FLASH_TRAIN:
        dt = getattr(torch, dname)
        q, k, v = (torch.randn((B, S, h, d), generator=gen, device=dev)
                   .to(dt).requires_grad_(True) for h in (H, K, K))
        do = torch.randn((B, S, H, d), generator=gen, device=dev).to(dt)
        _counts_reset()
        o = fa.flash_attention_gqa(q, k, v, causal=True)
        grad_fn = type(o.grad_fn).__name__
        grads = torch.autograd.grad(o, (q, k, v), do)
        _sync(dev)
        launched = sum(_counts()[0][n] for n in ("flash_attention",
                                                "flash_attention_f32"))
        errs = [0.0, 0.0, 0.0]
        scales = [0.0, 0.0, 0.0]
        for b in range(B):               # rows are independent
            leaves = [t[b:b + 1].detach().float().requires_grad_(True)
                      for t in (q, k, v)]
            want = torch.autograd.grad(fa._plain(*leaves, True),
                                       leaves, do[b:b + 1].float())
            for i, (g, w) in enumerate(zip(grads, want)):
                errs[i] = max(errs[i], float((g[b:b + 1].float() - w)
                                             .abs().max()))
                scales[i] = max(scales[i], float(w.abs().max()))
            del leaves, want
        rel = [e / s for e, s in zip(errs, scales)]
        limit = TOL_FLASH_GRAD[dname]

        def ours():
            torch.autograd.grad(fa.flash_attention_gqa(q, k, v, causal=True),
                                (q, k, v), do)

        def bwd():
            with torch.no_grad():
                fa.flash_attention_gqa_bwd(q, k, v, o, do, causal=True)

        def plain():                     # batch row by batch row, f32
            for b in range(B):
                leaves = [t[b:b + 1].detach().float().requires_grad_(True)
                          for t in (q, k, v)]
                torch.autograd.grad(fa._plain(*leaves, True), leaves,
                                    do[b:b + 1].float())

        def sdpa():
            qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
            os_ = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                                 enable_gqa=True)
            torch.autograd.grad(os_, (q, k, v), do.transpose(1, 2))

        ms, bwd_ms, plain_ms, lib = (_sum_ms(f, reps=3)
                                     for f in (ours, bwd, plain, sdpa))
        pairs = kept_pairs(S, S, True)
        # forward 4·d flops a kept pair; the backward recomputes s (2·d)
        # and forms dv, dp, dq and dk (2·d each)
        flops = 14 * B * H * d * pairs
        nbytes = q.element_size() * B * S * d * 2 * (2 * H + 2 * K)
        bms, bby = bound_ms(nbytes, flops, dname)
        r = dict(case=label, shape=f"B{B} S{S} H{H} K{K} d{d}", dtype=dname,
                 grad_fn=grad_fn, launches=launched, rel_err=rel,
                 limit=limit, fwd_bwd_ms=ms, bwd_ms=bwd_ms,
                 plain_fwd_bwd_ms=plain_ms, sdpa_fwd_bwd_ms=lib,
                 bound_ms=bms, bound_by=bby)
        res.append(r)
        say(f"  (a) flash fwd + bwd {label} ({r['shape']}, {dname}, causal): "
            f"{ms:.3f} ms (the plain backward alone {bwd_ms:.3f} ms; plain "
            f"autograd, f32 {plain_ms:.3f} ms; SDPA fwd + bwd {lib:.3f} ms; "
            f"bound {bms:.3f} ms by {bby}); dq/dk/dv "
            f"vs plain autograd " + ", ".join(f"{x:.2e}" for x in rel)
            + f" of max |g| (limit {limit:g}); grad_fn {grad_fn}")
        check("repro_torch_flash_attention_gqa" in grad_fn and launched == 1,
              f"(a) {label}: the flash op's backward over one kernel launch")
        check(max(rel) <= limit, f"(a) {label} {dname}: dq/dk/dv match "
              f"plain autograd ({max(rel):.2e} <= {limit:g} of max |g|)")
        del q, k, v, do, o, grads
        torch.cuda.empty_cache()
    out["flash"] = res


def _train_full(dev, seed, out):
    """(b) llama3.2-1b at full width and depth: TRAIN_STEPS steps of
    ``make_train_step``, then one traced step."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.launch import train
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim.adamw import AdamWConfig

    cfg = get_config(LM_ARCH)
    B, S = TRAIN_SHAPE
    check(cfg.remat == "full" and cfg.dtype == "bfloat16"
          and cfg.param_dtype == "float32",
          f"(b) {cfg.name}: remat full, bf16 activations, f32 parameters")
    _peak_reset(dev)
    t0 = time.perf_counter()
    state = train.init_state(Transformer(cfg, seed=seed, device=dev))
    _sync(dev)
    init_s = time.perf_counter() - t0
    step = train.make_train_step(cfg, AdamWConfig(**TRAIN_OPT),
                                 TRAIN_CE_CHUNKS)
    batch = lambda s: synthetic_batch(seed, s, B, S + 1, cfg.vocab)  # noqa
    rows = []
    _counts_reset()
    for s in range(TRAIN_STEPS):
        b = batch(s)
        _sync(dev)
        t = time.perf_counter()
        state, m = step(state, b)
        _sync(dev)
        ms = (time.perf_counter() - t) * 1e3
        rows.append(dict(step=s + 1, ms=ms, **{k: float(v)
                                                for k, v in m.items()}))
        r = rows[-1]
        say(f"  (b) step {s + 1:2d}: loss {r['loss']:.4f} grad_norm "
            f"{r['grad_norm']:.4f} lr {r['lr']:.3e} {ms:.1f} ms")
    launches = _counts()[0]
    peak = _peak(dev)
    med = float(np.median([r["ms"] for r in rows[2:]]))
    # one more step, traced
    from torch.profiler import ProfilerActivity, profile
    b = batch(TRAIN_STEPS)
    with _ranged(train, "_ce_terms", "ce"), \
            _ranged(train, "adamw_update", "adamw"):
        _sync(dev)
        t = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, _ = step(state, b)
            _sync(dev)
        traced_ms = (time.perf_counter() - t) * 1e3
    events = prof.events()
    cls = _train_breakdown(events)
    dev_ms = sum(cls.values())           # every kernel a host op launched
    losses = [r["loss"] for r in rows]
    drop = losses[0] - float(np.mean(losses[-4:]))
    toks = B * S / med * 1e3
    say(f"  (b) {cfg.name} B {B} × S {S}, remat full, CE in "
        f"{TRAIN_CE_CHUNKS} chunks: median {med:.1f} ms a step over steps "
        f"3–{TRAIN_STEPS} ({toks:.0f} tokens/s); peak device memory "
        f"{peak:.2f} GB; init {init_s:.1f} s; loss {losses[0]:.4f} → mean "
        f"of the last 4 {np.mean(losses[-4:]):.4f} (drop {drop:.3f} nats)")
    say(f"  (b) traced step: {traced_ms:.1f} ms wall, {dev_ms:.1f} ms device "
        f"(busy {dev_ms / traced_ms:.0%} of the traced step, "
        f"{dev_ms / med:.0%} of the median step); "
        + "; ".join(f"{k} {v:.1f} ms" for k, v in cls.items()))
    check(all(math.isfinite(x) for x in losses), "(b) every loss finite")
    check(drop >= TRAIN_DROP, f"(b) the mean of the last 4 losses lies "
          f"{drop:.3f} >= {TRAIN_DROP} nats below step 1's")
    want = 2 * cfg.n_layers * TRAIN_STEPS
    check(launches["flash_attention"] >= want,
          f"(b) flash_attention launched {launches['flash_attention']} >= "
          f"{want} times (forward + remat recompute, a layer and a step)")
    out["train"] = dict(arch=cfg.name, B=B, S=S, steps=rows,
                        median_ms=med, tokens_per_s=toks, peak_gb=peak,
                        init_s=init_s, loss_drop=drop, traced_ms=traced_ms,
                        traced_device_ms=dev_ms, breakdown=cls,
                        launches=launches)
    del state, prof, events
    torch.cuda.empty_cache()
    return launches


def _train_grads(dev, seed, out):
    """(c) llama3.2-1b at full width, 2 layers, f32: every gradient present
    and nonzero, and within TOL_TRAIN_GRAD of max |g| of the same backward
    with the model's attention on autograd through the plain version."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train
    from repro_torch.models import attention
    from repro_torch.models.transformer import Transformer

    L, B, S = TRAIN_GRAD
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=L,
                              dtype="float32")
    model = Transformer(cfg, seed=seed, device=dev)
    b = {k: t.to(dev) for k, t in
         synthetic_batch(seed, 0, B, S + 1, cfg.vocab).items()}

    def grads():
        model.zero_grad(set_to_none=True)
        _counts_reset()
        total, _ = train.loss_fn(model, b)
        total.backward()
        _sync(dev)
        return ({n: p.grad for n, p in model.named_parameters()},
                _counts()[0]["flash_attention_f32"])

    got, n_kernel = grads()
    missing = [n for n, g in got.items()
               if g is None or not float(g.abs().max()) > 0]
    check(not missing, f"(c) all {len(got)} parameters have a nonzero "
          f"gradient" + (f" (missing: {missing})" if missing else ""))
    kernel = attention.flash_attention_gqa
    attention.flash_attention_gqa = lambda q, k, v, causal, window: \
        fa._plain(q, k, v, causal, window)
    try:
        want, n_plain = grads()
    finally:
        attention.flash_attention_gqa = kernel
    errs = {n: _grad_rel(got[n], want[n]) for n in got}
    worst = max(errs, key=errs.get)
    say(f"  (c) {cfg.name} at full width, {L} layers, f32, B {B} × S {S}: "
        f"{len(got)} gradients, all nonzero; worst {errs[worst]:.2e} of max "
        f"|g| ({worst}); flash_attention_f32 launches {n_kernel} (plain "
        f"route {n_plain})")
    check(n_kernel == 2 * L and n_plain == 0,
          f"(c) the kernel ran forward + recompute in each layer "
          f"({n_kernel} == {2 * L}), the plain route none ({n_plain})")
    check(errs[worst] <= TOL_TRAIN_GRAD, f"(c) every gradient within "
          f"{TOL_TRAIN_GRAD:g} of max |g| of the plain route "
          f"({errs[worst]:.2e})")
    out["grads"] = dict(layers=L, B=B, S=S, worst=errs[worst],
                        worst_param=worst, n_params=len(got))
    del model, got, want
    torch.cuda.empty_cache()
    return {"flash_attention_f32": n_kernel}


def _train_ft(dev, seed, out):
    """(d) ``TrainLoop`` on the smoke variant of llama3.2-1b on the card: a
    failure injected at step FT_STEPS[1] of FT_STEPS[0], the final state
    against an uninterrupted run; a checkpoint written from a CPU run
    restored onto the card."""
    import tempfile
    import torch
    from repro_torch.checkpoint.manager import CheckpointManager, _flatten
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.ft.driver import FTConfig, TrainLoop
    from repro_torch.launch import train
    from repro_torch.models.transformer import Transformer
    from repro_torch.optim.adamw import AdamWConfig

    cfg = smoke_variant(get_config(LM_ARCH))
    n, fail = FT_STEPS
    step = train.make_train_step(cfg, AdamWConfig(lr=3e-3, warmup_steps=5,
                                                  total_steps=n))
    make_batch = lambda s: synthetic_batch(seed, s, 4, 65, cfg.vocab)  # noqa
    state0 = train.init_state(Transformer(cfg, seed=seed, device=dev))
    logs = []
    with tempfile.TemporaryDirectory() as tmp:
        _counts_reset()
        loop = TrainLoop(FTConfig(ckpt_dir=os.path.join(tmp, "a"),
                                  ckpt_every=5), step, make_batch)
        final, last = loop.run(state0, n, fail_at=fail, log_every=0,
                               logger=logs.append)
        launches = _counts()[0]
        loop2 = TrainLoop(FTConfig(ckpt_dir=os.path.join(tmp, "b"),
                                   ckpt_every=5), step, make_batch)
        final2, _ = loop2.run(state0, n, log_every=0, logger=lambda *_: 0)
        fa, fb = _flatten(final), _flatten(final2)
        diff = {k: float((fa[k].double() - fb[k].double()).abs().max())
                / max(float(fb[k].double().abs().max()), 1e-30) for k in fa}
        bitwise = all(torch.equal(fa[k], fb[k]) for k in fa)
        worst = max(diff, key=diff.get)
        # a checkpoint written from a CPU run, restored onto the card
        cpu_state = train.init_state(Transformer(cfg, seed=seed,
                                                 device="cpu"))
        for s in range(3):
            cpu_state, _ = step(cpu_state, make_batch(s))
        mgr = CheckpointManager(os.path.join(tmp, "cpu"), keep=1)
        mgr.save(3, cpu_state)
        restored = mgr.restore(3, state0, device=dev)
        rc, cc = _flatten(restored), _flatten(cpu_state)
        on_card = all(t.device.type == "cuda" for t in rc.values())
        same = all(torch.equal(rc[k].cpu(), cc[k]) for k in cc)
        _, mg = step(restored, make_batch(3))
        _, mc = step(cpu_state, make_batch(3))
        step_rel = abs(float(mg["loss"]) - float(mc["loss"])) / float(
            mc["loss"])
    restarts = [m for m in logs if "restarting" in m]
    say(f"  (d) FT on {cfg.name} ({n} steps, failure at {fail}): "
        f"{restarts[0] if restarts else 'no restart'}; final state vs an "
        f"uninterrupted run: {'bit for bit' if bitwise else 'not bitwise'}"
        f", max |Δ| {diff[worst]:.3e} of max |x| ({worst}); CPU checkpoint "
        f"→ card: "
        f"on card {on_card}, equal {same}, next step's loss card vs CPU "
        f"{step_rel:.2e} relative")
    check(last == n and bool(restarts) and "step 10" in restarts[0],
          f"(d) the loop restarted from step 10 and reached step {n}")
    # bit for bit where every op is deterministic; the embedding's backward
    # (a scatter-add of the rows' gradients) is the one op of this model
    # that may add in another order on the card, so a difference is held to
    # f32 rounding and named
    check(bitwise or diff[worst] <= TOL_FT, f"(d) the resumed run's final "
          f"state equals the uninterrupted run's "
          + ("bit for bit" if bitwise else
             f"within {diff[worst]:.2e} <= {TOL_FT:g} of max |x| (not bit "
             f"for bit: the embedding's backward adds in an order the "
             f"card does not fix)"))
    check(on_card and same, "(d) a checkpoint written on the CPU restores "
          "onto the card unchanged")
    check(step_rel <= 1e-4, f"(d) the restored state's next step on the "
          f"card matches the CPU's ({step_rel:.2e} <= 1e-4)")
    out["ft"] = dict(steps=n, fail_at=fail, bitwise=bitwise,
                     max_rel_diff=diff[worst], worst=worst,
                     restored_on_card=on_card, restored_equal=same,
                     next_step_rel=step_rel)
    return launches


def train_phase(dev, seed, out):
    """Phase 18: the LM training path — (a) the differentiable flash
    kernel, (b) llama3.2-1b trained at full width, (c) gradients against
    the plain route, (d) fault tolerance on the card."""
    res, total = {}, {}
    for name, fn in (("a", _flash_train), ("b", _train_full),
                     ("c", _train_grads), ("d", _train_ft)):
        t = time.perf_counter()
        counts = fn(dev, seed, res) or {}
        say(f"  (18{name}) {time.perf_counter() - t:.1f} s")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    out["train_phase"] = res
    return total


# ---------------------------------------------------------------------------
# phase 15: the on-card tests
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 15: batched solves and the solve server (slice 5)
# ---------------------------------------------------------------------------

def block_diag_csr(row, col, vals, n, m):
    """torch.sparse CSR of the block-diagonal matrix of B lanes (values
    (B, nnz) on one COO pattern): the library yardstick that multiplies B
    value arrays by B stacked right-hand sides in one call."""
    import warnings
    import torch
    B = vals.shape[0]
    off_r = (torch.arange(B, device=row.device) * n)[:, None]
    off_c = (torch.arange(B, device=row.device) * m)[:, None]
    idx = torch.stack([(row[None] + off_r).reshape(-1),
                       (col[None] + off_c).reshape(-1)])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        coo = torch.sparse_coo_tensor(idx, vals.detach().reshape(-1),
                                      (B * n, B * m),
                                      check_invariants=False).coalesce()
        return coo.to_sparse_csr()


def _lanes_equal(got, singles):
    """Every lane of ``got`` equals its single-vector result bit for bit."""
    import torch
    return all(torch.equal(got[b], s) for b, s in enumerate(singles))


def batch_kernel_phase(dev, seed, out):
    """15a: the lane-batched kernels against their plain versions and, lane
    by lane, against the single-vector kernels (bit for bit), with their
    time, bound and the library call computing the same function."""
    import torch
    from repro_torch.core.sparse import SparseTensor, bell_to_device, build_bell
    from repro_torch.data.poisson import (poisson2d_arrays, vc_coefficients,
                                          vc_pattern)
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import solve_step as fk
    from repro_torch.kernels.spmv_bell import (bell_spmm, bell_spmv,
                                               bell_spmv_batched)
    from repro_torch.kernels.stencil5 import (Stencil5Meta, stencil5,
                                              stencil5_batched)

    rng = np.random.default_rng(seed + 15)
    res = {}

    def record(name, got, want, scale, ms, plain, lib, nbytes, flops, shape,
               bitwise):
        e, ea = rel_err(got, want, scale)
        b_ms, b_by = bound_ms(nbytes, flops, "float64")
        say(f"  {name:26s} {shape:>34s} f64: {ms:.4f} ms (plain {plain:.4f} "
            f"ms, bound {b_ms:.4f} ms by {b_by}, library "
            f"{'-' if lib is None else '%.4f ms' % lib}); rel err {e:.2e}; "
            f"lanes bit-equal to the single-vector kernel: {bitwise}")
        check(e <= TOL_KERNEL["float64"], f"{name} matches its plain "
              f"version ({e:.2e} <= {TOL_KERNEL['float64']:.0e})")
        check(bitwise, f"{name}: every lane equals the single-vector kernel "
              f"on that lane bit for bit")
        res[name] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                         bound_ms=b_ms, bound_by=b_by, max_rel_err=e,
                         max_abs_err=ea, bytes=nbytes, flops=flops,
                         dtype="float64", shape=shape,
                         wall_ms=None)

    # -- block-ELL: B value stacks (and their own x), then SpMM with k rhs -
    ngb = NG_BELL
    val, row, col = poisson2d_arrays(ngb)
    n = ngb * ngb
    nnz = len(val)
    bell = bell_to_device(build_bell(row, col, (n, n)), dev)
    sell = bell.sell
    vt = torch.tensor(val, device=dev)
    B = BATCH_B
    V = vt[None] * torch.tensor(rng.uniform(0.7, 1.4, (B, 1)), device=dev)
    X = torch.tensor(rng.normal(size=(max(B, SPMM_K), n)), device=dev)
    packed = ops.sell_assemble(sell, V)
    Y = bell_spmv_batched(sell, packed, X[:B], n)
    torch.cuda.synchronize()
    bit = _lanes_equal(Y, [bell_spmv(sell, packed[b], X[b], n)
                           for b in range(B)])
    plain_f = lambda: ref.sell_matvec_lanes_ref(sell.slice_ptr, sell.cols,
                                                packed, X[:B], n)
    ms = cuda_ms(lambda: bell_spmv_batched(sell, packed, X[:B], n), 20)
    plain = cuda_ms(plain_f, 3)
    row_t = torch.tensor(row, device=dev)
    col_t = torch.tensor(col, device=dev)
    bd = block_diag_csr(row_t, col_t, V, n, n)
    xf = X[:B].reshape(-1)
    lib = cuda_ms(lambda: bd @ xf, 20)
    del bd
    # what the function must move: B value arrays, the pattern once, B x
    # read and B y written (CSR pointers or the sliced slots, the smaller)
    nbytes = min(B * nnz * 8 + nnz * 4 + (n + 1) * 4,
                 B * sell.n_slots * 8 + sell.n_slots * 4
                 + sell.slice_ptr.numel() * 8) + 2 * B * n * 8
    record("bell_spmv_batched", [Y], [plain_f()],
           [ref.sell_matvec_lanes_ref(sell.slice_ptr, sell.cols,
                                      packed.abs(), X[:B].abs(), n)],
           ms, plain, lib, nbytes, 2 * B * nnz,
           f"poisson2d({ngb}) x B={B} values", bit)
    del Y, packed, V
    torch.cuda.empty_cache()

    k = SPMM_K
    p0 = ops.sell_assemble(sell, vt)
    Xk = X[:k].contiguous()
    Y = bell_spmm(sell, p0, Xk, n)
    torch.cuda.synchronize()
    bit = _lanes_equal(Y, [bell_spmv(sell, p0, Xk[j], n) for j in range(k)])
    plain_f = lambda: ref.sell_matvec_lanes_ref(sell.slice_ptr, sell.cols,
                                                p0, Xk, n)
    ms = cuda_ms(lambda: bell_spmm(sell, p0, Xk, n), 20)
    plain = cuda_ms(plain_f, 3)
    A = SparseTensor(vt, row, col, (n, n), props={}, device=dev)
    csr = csr_of(A)
    Xt = Xk.T.contiguous()
    lib = cuda_ms(lambda: torch.sparse.mm(csr, Xt), 20)
    nbytes = min(nnz * 12 + (n + 1) * 4,
                 sell.n_slots * 12 + sell.slice_ptr.numel() * 8) \
        + 2 * k * n * 8
    record("bell_spmm", [Y], [plain_f()], [ref.sell_matvec_lanes_ref(
        sell.slice_ptr, sell.cols, p0.abs(), Xk.abs(), n)], ms, plain, lib,
        nbytes, 2 * k * nnz, f"poisson2d({ngb}) x k={k} rhs", bit)
    del Y, Xk, Xt, csr, A, X, bell, sell
    torch.cuda.empty_cache()

    # -- stencil5: B operators (scaled κ planes) times B right-hand sides --
    ng = NG_STENCIL
    Bs = STENCIL_B
    kap = torch.tensor(smooth_kappa(ng, seed), device=dev)
    v5 = vc_coefficients(kap).reshape(5, ng, ng)
    V5 = v5[None] * torch.tensor(rng.uniform(0.7, 1.4, (Bs, 1, 1, 1)),
                                 device=dev)
    Xs = torch.tensor(rng.normal(size=(Bs, ng, ng)), device=dev)
    meta = Stencil5Meta(nx=ng, ny=ng)
    Y = stencil5_batched(meta, V5, Xs)
    torch.cuda.synchronize()
    bit = _lanes_equal(Y, [stencil5(meta, V5[b], Xs[b]) for b in range(Bs)])
    plain_f = lambda: ref.stencil5_lanes_ref(V5, Xs)
    ms = cuda_ms(lambda: stencil5_batched(meta, V5, Xs), 20)
    plain = cuda_ms(plain_f, 5)
    ns = ng * ng
    rows, cols, _ = vc_pattern(ng)
    bd = block_diag_csr(torch.as_tensor(rows, device=dev),
                        torch.as_tensor(cols, device=dev),
                        V5.reshape(Bs, -1), ns, ns)
    xf = Xs.reshape(-1)
    lib = cuda_ms(lambda: bd @ xf, 20)
    del bd
    record("stencil5_batched", [Y], [plain_f()],
           [ref.stencil5_lanes_ref(V5.abs(), Xs.abs())], ms, plain, lib,
           7 * Bs * ns * 8, 9 * Bs * ns, f"B={Bs} x (5,{ng},{ng})", bit)
    del Y, V5, Xs, v5, kap
    torch.cuda.empty_cache()

    # -- the 8 step bodies on (B, n) lanes, per-lane scalars ---------------
    Bf, nf = STEP_B, STEP_N
    for name in FUSED:
        bid, n_in, n_sc, n_out, n_dot = fk.BODIES[name]
        vecs = [torch.tensor(rng.normal(size=(Bf, nf)), device=dev)
                for _ in range(n_in)]
        scs = [torch.tensor(rng.normal(size=Bf), device=dev)
               for _ in range(n_sc)]
        if name == "fused_bicg_p":
            scs[2] = torch.zeros(Bf, device=dev, dtype=torch.float64)
        fn = getattr(fk, name)
        got = fn(*vecs, *scs)
        torch.cuda.synchronize()
        singles = [fn(*[v[b] for v in vecs], *[s[b] for s in scs])
                   for b in range(Bf)]
        bit = all(torch.equal(g[b], singles[b][j]) for j, g in enumerate(got)
                  for b in range(Bf))
        plain_f = lambda: ref.fused_step_lanes_ref(name, vecs, scs, Bf)
        want = plain_f()
        scale = ref.fused_step_lanes_ref(name, [v.abs() for v in vecs],
                                         [s.abs() for s in scs], Bf)
        outs = [torch.empty_like(vecs[0]) for _ in range(n_out)]
        call = (lambda: fn(*vecs)) if name == "fused_dots2" else \
            (lambda: fn(*vecs, *scs, out=outs))
        ms = cuda_ms(call, 20)
        plain = cuda_ms(plain_f, 5)
        reads, writes = fn.passes
        record(name + "_batched", list(got), list(want), list(scale), ms,
               plain, None, (reads + writes) * Bf * nf * 8,
               FUSED_FLOPS[name] * Bf * nf, f"B={Bf} x ({nf},)", bit)
        del vecs, outs, got, singles, want, scale
        torch.cuda.empty_cache()
    out["batch_kernel_phase"] = res
    return res


def _true_rel_res(A, x, b):
    """‖b − A x‖ / ‖b‖ per lane, through the plain COO product."""
    from repro_torch.core.sparse import coo_matvec
    r = b - coo_matvec(A.val, A.row, A.col, x, A.shape[0])
    return (r.norm(dim=-1) / b.norm(dim=-1))


def batched_values_path(dev, seed, out):
    """15b: batched-values CG + Jacobi through ``sla.solve`` on the block-ELL
    kernel (B value scales), its gradient, held to single solves of the
    same lanes; then batched BiCGStab on a non-symmetric operator (its
    adjoint on Aᵀ's layout) and batched CG on stencil operators."""
    import torch
    from repro_torch import sla
    from repro_torch.core.sparse import SparseTensor
    from repro_torch.data.poisson import poisson2d, poisson2d_vc
    from repro_torch.kernels import launch_counts

    rng = np.random.default_rng(seed + 16)
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    def loop_launches(counts, batched):
        sfx = "_batched" if batched else ""
        keys = ["bell_spmv" + sfx, "stencil5" + sfx] + \
            [f + sfx for f in FUSED]
        return sum(counts[k] for k in keys)

    def traced(A0, vals, b, backend, method, tol):
        """Wall, device time and op count of TRACE_ITERS iterations of the
        batched loop and of one lane's single loop (setup memoized)."""
        rows = {}
        for tag, v in (("batched", vals), ("single", vals[0])):
            Av = A0.with_values(v)
            fn = lambda: sla.solve_with_info(Av, b, backend=backend,
                                             method=method, tol=tol,
                                             maxiter=TRACE_ITERS)
            fn()
            _sync(dev)
            t = time.perf_counter()
            fn()
            _sync(dev)
            wall = (time.perf_counter() - t) * 1e3
            cnt, dev_ms, top = _kernel_breakdown(
                fn, os.path.join(OUT, f"batched_{method}_{tag}_trace.json"))
            rows[tag] = dict(wall_ms=wall, device_ms=dev_ms, ops=cnt,
                             busy=dev_ms / wall, top=top[:6])
            say(f"  traced {tag} {method}, {TRACE_ITERS} iterations: wall "
                f"{wall:.2f} ms, device {dev_ms:.2f} ms over {cnt} ops "
                f"(busy {dev_ms / wall:.0%}); "
                + ", ".join(f"{nm} {ms:.2f} ms x{c}"
                            for ms, c, nm in top[:4]))
        return rows

    def case(label, A0, scales, b, backend, method, tol, trace=False):
        n = A0.shape[0]
        vals = torch.stack([A0.val * s for s in scales])
        B = len(scales)
        val = vals.clone().requires_grad_(True)
        _sync(dev)
        _peak_reset(dev)
        _counts_reset()
        t0 = time.perf_counter()
        A = A0.with_values(val)
        x = sla.solve(A, b, backend=backend, method=method, tol=tol,
                      maxiter=MAXITER)
        _sync(dev)
        t1 = time.perf_counter()
        fwd = loop_launches(launch_counts(), True)
        (x * x).sum().backward()
        _sync(dev)
        t2 = time.perf_counter()
        launches, stats = _counts()
        add(launches)
        peak = _peak(dev)
        ti = time.perf_counter()
        info = sla.solve_with_info(A0.with_values(vals), b, backend=backend,
                                   method=method, tol=tol, maxiter=MAXITER)
        iters = [int(i) for i in info.iterations.tolist()]
        t_info = time.perf_counter() - ti
        relres = _true_rel_res(A0.with_values(vals), info.x,
                               b.expand(B, n)).max().item()
        g = val.grad.detach()
        # the same lanes one at a time: solution, iterations, the loop's
        # launches, and the gradient from the adjoint solve
        s_iters, s_launch, s_wall, s_info = [], [], 0.0, 0.0
        xerr = gerr = 0.0
        for i in range(B):
            Ai = A0.with_values(vals[i])
            _counts_reset()
            ts = time.perf_counter()
            one = sla.solve_with_info(Ai, b, backend=backend, method=method,
                                      tol=tol, maxiter=MAXITER)
            _sync(dev)
            s_info += time.perf_counter() - ts
            s_launch.append(loop_launches(launch_counts(), False))
            lam = sla.solve_with_info(Ai.T if method == "bicgstab" else Ai,
                                      2 * one.x, backend=backend,
                                      method=method, tol=tol,
                                      maxiter=MAXITER).x
            _sync(dev)
            s_wall += time.perf_counter() - ts
            s_iters.append(int(one.iterations))
            gi = -(lam[A0.row] * one.x[A0.col])
            xerr = max(xerr, float((x[i].detach() - one.x).abs().max()
                                   / one.x.abs().max()))
            gerr = max(gerr, _grad_rel(g[i], gi))
        slow = int(np.argmax(s_iters))
        ms_it = t_info / max(max(iters), 1) * 1e3
        ms_it1 = s_info / max(sum(s_iters), 1) * 1e3
        say(f"  {label}: B={B} lanes, {backend}/{method}; batched solve+grad "
            f"{t2 - t0:.3f} s (forward {t1 - t0:.3f} s with the analyze, "
            f"backward {t2 - t1:.3f} s), peak {peak:.3f} GB; batched "
            f"solve_with_info {t_info:.3f} s = {ms_it:.3f} ms/iteration "
            f"for {B} lanes, single solves {ms_it1:.3f} ms/iteration; the "
            f"{B} single solves + adjoints {s_wall:.3f} s")
        say(f"  iterations per lane {iters}; single solves {s_iters}; loop "
            f"launches batched {fwd}, slowest single {s_launch[slow]}; "
            f"solution rel diff {xerr:.2e}, gradient rel diff {gerr:.2e}; "
            f"true residual {relres:.2e}")
        say(f"  launches {json.dumps({k: v for k, v in launches.items() if v})}")
        say(f"  PLAN_STATS {json.dumps({k: v for k, v in stats.items() if v})}")
        check(iters == s_iters, f"{label}: each lane's iteration count equals "
              f"its single solve's")
        check(xerr <= TOL_BATCH, f"{label}: solutions agree with the single "
              f"solves ({xerr:.2e} <= {TOL_BATCH:.0e})")
        check(bool(torch.isfinite(g).all()) and gerr <= TOL_BATCH_GRAD,
              f"{label}: each lane's values gradient agrees with the single "
              f"solve's ({gerr:.2e} <= {TOL_BATCH_GRAD:.0e})")
        check(relres <= 10 * tol, f"{label}: true residual {relres:.2e} <= "
              f"10·tol")
        # one batched setup, reused by the symmetric adjoint; Aᵀ's own for
        # a non-symmetric one (its plan shares the kernel layout)
        setups = 1 if A0.props.get("symmetric") else 2
        check(stats["analyze"] == 1 and stats["setup"] == setups
              and stats["transpose_shared"] == 1,
              f"{label}: analyze 1, setup {setups}, transpose_shared 1")
        check(abs(fwd - s_launch[slow]) <= 16,
              f"{label}: the batched loop's kernel launches ({fwd}) equal the "
              f"slowest lane's single solve's ({s_launch[slow]}) within 16")
        tr = traced(A0, vals, b, backend, method, tol) if trace else None
        return dict(B=B, iterations=iters, single_iterations=s_iters,
                    trace=tr,
                    solve_grad_s=t2 - t0, forward_s=t1 - t0,
                    backward_s=t2 - t1, info_solve_s=t_info,
                    ms_per_iteration=ms_it, single_ms_per_iteration=ms_it1,
                    singles_s=s_wall, peak_gb=peak, loop_launches=fwd,
                    single_loop_launches=s_launch, solution_rel_diff=xerr,
                    grad_rel_diff=gerr, true_residual=relres,
                    launches=launches, plan_stats=stats)

    n = NG_BELL * NG_BELL
    A0 = poisson2d(NG_BELL, device=dev)
    b = torch.ones(n, dtype=torch.float64, device=dev)
    scales = [float(s) for s in rng.uniform(0.7, 1.4, BATCH_B)]
    res = {"bell_cg": case(f"batched CG + Jacobi poisson2d({NG_BELL})", A0,
                           scales, b, "pallas", "cg", TOL, trace=True)}
    del A0
    torch.cuda.empty_cache()

    ng = NG_TRANSPOSE
    A1 = poisson2d(ng, device=dev)
    v1 = A1.val.clone()
    v1[A1.col == A1.row - 1] = -1.4
    v1[A1.col == A1.row + 1] = -0.6
    props = {"symmetric": False, "spd_hint": False, "sorted_rows": False}
    A1 = SparseTensor(v1, A1.row, A1.col, A1.shape, props=props, device=dev)
    b1 = torch.ones(ng * ng, dtype=torch.float64, device=dev)
    res["bell_bicgstab"] = case(f"batched BiCGStab drift ng={ng}", A1,
                                scales[:4], b1, "pallas", "bicgstab",
                                TOL_TRANSPOSE)
    ngs = NG_BATCH_STENCIL
    kap = torch.tensor(smooth_kappa(ngs, seed), device=dev)
    A2 = poisson2d_vc(kap, use_stencil_kernel=True, device=dev)
    b2 = torch.ones(ngs * ngs, dtype=torch.float64, device=dev)
    res["stencil_cg"] = case(f"batched CG + Jacobi stencil ng={ngs}", A2,
                             scales[:STENCIL_B], b2, "stencil", "cg", TOL)
    for k in ("bell_spmv_batched", "stencil5_batched",
              "fused_cg_update_batched", "fused_cg_direction_batched",
              "fused_bicg_p_batched", "fused_bicg_tail_batched"):
        check(total[k] > 0, f"batched paths launched {k} ({total[k]} times)")
    out["batched_values_path"] = res
    return total


def multi_rhs_path(dev, seed, out, Ad):
    """15c: k right-hand sides on one matrix — block CG and per-rhs CG on
    the SpMM kernel, CG + Chebyshev on the lane-batched steps, and one
    direct factorization with a k-column sweep, each with checks."""
    import torch
    from repro_torch import sla
    from repro_torch.data.poisson import poisson2d
    from repro_torch.kernels import launch_counts

    rng = np.random.default_rng(seed + 17)
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    n = NG_BELL * NG_BELL
    A = poisson2d(NG_BELL, device=dev)
    k = SPMM_K
    Bm = torch.tensor(rng.normal(size=(k, n)), device=dev)
    kw = dict(backend="pallas", tol=TOL, maxiter=MAXITER)
    _sync(dev)
    _counts_reset()
    t0 = time.perf_counter()
    rb = sla.solve_with_info(A, Bm, method="block_cg", **kw)
    _sync(dev)
    t1 = time.perf_counter()
    lb, stats_b = _counts()
    add(lb)
    _counts_reset()
    rc = sla.solve_with_info(A, Bm, method="cg", **kw)
    _sync(dev)
    t2 = time.perf_counter()
    lc, _ = _counts()
    add(lc)
    it_b = int(rb.iterations)
    it_c = [int(i) for i in rc.iterations.tolist()]
    res_b = _true_rel_res(A, rb.x, Bm)
    res_c = _true_rel_res(A, rc.x, Bm)
    # both solves stop at a residual; their difference is at most
    # ‖A⁻¹‖(‖r_b‖ + ‖r_c‖), with ‖A⁻¹‖ = 1/λ_min of the 5-point Laplacian
    lam_min = 8 * math.sin(math.pi / (2 * (NG_BELL + 1))) ** 2
    diff = (rb.x - rc.x).norm(dim=1)
    allow = ((res_b + res_c) * Bm.norm(dim=1)) / lam_min
    say(f"  block CG k={k} poisson2d({NG_BELL}) + Jacobi: {it_b} iterations "
        f"in {t1 - t0:.3f} s ({(t1 - t0) / max(it_b, 1) * 1e3:.3f} ms/"
        f"iteration); per-rhs CG (lanes) {min(it_c)}..{max(it_c)} iterations "
        f"in {t2 - t1:.3f} s; true residuals block {res_b.max().item():.2e}, "
        f"CG {res_c.max().item():.2e}; ‖x_block − x_cg‖ / bound "
        f"{(diff / allow).max().item():.3f}")
    say(f"  launches block CG {json.dumps({k_: v for k_, v in lb.items() if v})}; "
        f"CG {json.dumps({k_: v for k_, v in lc.items() if v})}")
    check(it_b <= max(it_c), f"block CG: {it_b} iterations <= the largest "
          f"per-rhs CG count {max(it_c)}")
    check(bool(rb.converged.all()) and bool(rc.converged.all())
          and res_b.max().item() <= 10 * TOL
          and res_c.max().item() <= 10 * TOL,
          "block CG and per-rhs CG: every column converged, true residuals "
          "<= 10·tol")
    check(bool((diff <= allow).all()), "block CG agrees with per-rhs CG "
          "within ‖A⁻¹‖ times their residuals")
    check(lb["bell_spmm"] > 0 and lc["bell_spmm"] > 0
          and lc["fused_cg_update_batched"] > 0,
          "multi-rhs solves ran on bell_spmm and the lane-batched steps")
    res = dict(k=k, block_iterations=it_b, cg_iterations=it_c,
               block_s=t1 - t0, cg_s=t2 - t1,
               block_residual=res_b.max().item(),
               cg_residual=res_c.max().item(), launches_block=lb,
               launches_cg=lc, plan_stats=stats_b)
    del A, Bm, rb, rc
    torch.cuda.empty_cache()

    # CG + the plan Chebyshev on k rhs: fused_cg_halfstep and fused_cheb_step
    # on (k, n) lanes
    ng = NG_TRANSPOSE
    A1 = poisson2d(ng, device=dev)
    B1 = torch.tensor(rng.normal(size=(4, ng * ng)), device=dev)
    _counts_reset()
    r1 = sla.solve_with_info(A1, B1, backend="pallas", method="cg",
                             precond="chebyshev", tol=TOL, maxiter=MAXITER)
    _sync(dev)
    l1, _ = _counts()
    add(l1)
    rr1 = _true_rel_res(A1, r1.x, B1).max().item()
    say(f"  CG + Chebyshev k=4 ng={ng}: iterations "
        f"{r1.iterations.tolist()}, true residual {rr1:.2e}; launches "
        f"{json.dumps({k_: v for k_, v in l1.items() if v})}")
    check(bool(r1.converged.all()) and rr1 <= 10 * TOL
          and l1["fused_cheb_step_batched"] > 0
          and l1["fused_cg_halfstep_batched"] > 0,
          "CG + Chebyshev on 4 rhs converged on the lane-batched halfstep "
          "and cheb_step")
    res["chebyshev"] = dict(iterations=r1.iterations.tolist(),
                            true_residual=rr1, launches=l1)

    # the direct route on the direct path's poisson2d(316) (its cached
    # plan): one factorization, one k-column solve and backward
    ngd = NG_DIRECT
    nd = ngd * ngd
    Bd = torch.tensor(rng.normal(size=(k, nd)), device=dev)
    t0 = time.perf_counter()
    plan = Ad.plan()                  # cached since the direct path
    t_an = time.perf_counter() - t0
    nbk = sum(len(lvl) for lvl in plan.artifacts["direct"].snode.schedule)
    val = Ad.val.clone().requires_grad_(True)
    bl = Bd.clone().requires_grad_(True)
    _sync(dev)
    _counts_reset()
    t0 = time.perf_counter()
    X = sla.solve(Ad.with_values(val), bl)
    _sync(dev)
    t1 = time.perf_counter()
    fwd_sweeps = launch_counts()["sn_sweep"]
    (X * X).sum().backward()
    _sync(dev)
    t2 = time.perf_counter()
    ld, sd = _counts()
    add(ld)
    xerr = gberr = 0.0
    gsum = torch.zeros_like(Ad.val)
    ts = time.perf_counter()
    for j in range(k):
        xj = sla.solve_with_info(Ad, Bd[j]).x
        lam = sla.solve_with_info(Ad, 2 * xj).x
        gsum -= lam[Ad.row] * xj[Ad.col]
        xerr = max(xerr, float((X[j].detach() - xj).abs().max()
                               / xj.abs().max()))
        gberr = max(gberr, _grad_rel(bl.grad[j], lam))
    _sync(dev)
    t3 = time.perf_counter()
    gerr = _grad_rel(val.grad, gsum)
    say(f"  direct k={k} poisson2d({ngd}) (plan {plan.cfg.backend}/"
        f"{plan.cfg.method}, {nbk} buckets, plan lookup {t_an:.3f} s): solve "
        f"{t1 - t0:.4f} s, backward {t2 - t1:.4f} s; {k} single solves + "
        f"adjoints {t3 - ts:.3f} s; factorize {sd['factorize']}, sn_sweep "
        f"{fwd_sweeps} in the solve, {ld['sn_sweep']} in all; solution rel "
        f"diff {xerr:.2e}, val-gradient {gerr:.2e}, b-gradient {gberr:.2e}")
    check(plan.cfg.backend == "direct" and sd["factorize"] == 1,
          "direct multi-rhs: auto → direct, one factorization for the k "
          "right-hand sides and their adjoint")
    check(fwd_sweeps == 2 * nbk and ld["sn_sweep"] == 4 * nbk,
          f"direct multi-rhs: the k columns ride one sweep launch per bucket "
          f"({fwd_sweeps} = 2·{nbk} in the solve)")
    check(xerr <= TOL_BATCH, f"direct multi-rhs: agrees with {k} single "
          f"solves ({xerr:.2e} <= {TOL_BATCH:.0e})")
    check(gerr <= TOL_BATCH_GRAD and gberr <= TOL_BATCH_GRAD,
          f"direct multi-rhs: gradients agree with the single solves' "
          f"({gerr:.2e}, {gberr:.2e} <= {TOL_BATCH_GRAD:.0e})")
    res["direct"] = dict(ng=ngd, k=k, buckets=nbk, analyze_s=t_an,
                         solve_s=t1 - t0, backward_s=t2 - t1,
                         singles_s=t3 - ts, solve_sweeps=fwd_sweeps,
                         launches=ld, plan_stats=sd, solution_rel_diff=xerr,
                         grad_rel_diff=gerr, b_grad_rel_diff=gberr)
    out["multi_rhs_path"] = res
    return total


def serve_path(dev, seed, out):
    """15d: ``serve()`` with the reference CLI's stream (two patterns,
    max_batch 32, CG + Jacobi, tol 1e-8; ``SERVE_REQUESTS`` of its 256
    requests, one full batch a pattern) on the block-ELL kernels, batched
    against one-at-a-time, parity checked inside."""
    from repro_torch.launch.solve_serve import serve
    _counts_reset()
    rep = serve(n_requests=SERVE_REQUESTS, grid=NG_SERVE, n_patterns=2,
                max_batch=SERVE_MAX_BATCH, seed=seed, check=True, device=dev,
                backend="pallas", method="cg", precond="jacobi", tol=TOL)
    launches, _ = _counts()
    b, s = rep["batched"], rep["sequential"]
    say(f"  serve: {rep['n_requests']} requests, grids {NG_SERVE} and "
        f"{NG_SERVE + 1}, max_batch {SERVE_MAX_BATCH}: batched "
        f"{b['solves_per_sec']:.1f} solves/s (p50 {b['p50_ms']:.1f} ms, p99 "
        f"{b['p99_ms']:.1f} ms, {b['total_s']:.3f} s); sequential "
        f"{s['solves_per_sec']:.1f} solves/s (p50 {s['p50_ms']:.1f} ms, p99 "
        f"{s['p99_ms']:.1f} ms, {s['total_s']:.3f} s); speedup "
        f"{rep['speedup']:.2f}x, occupancy {rep['occupancy']:.3f}")
    say(f"  launches {json.dumps({k: v for k, v in launches.items() if v})}")
    say(f"  PLAN_STATS {json.dumps({k: v for k, v in rep['plan_stats'].items() if v})}")
    check(rep["plan_stats"]["analyze"] == 2, "serve: analyze == 2 (one per "
          "pattern)")
    check(rep["converged"], "serve: every request converged")
    check(rep["occupancy"] == 1.0, "serve: occupancy 1.0")
    check(launches["bell_spmv_batched"] > 0, "serve: the batched dispatches "
          "ran on bell_spmv_batched")
    out["serve_path"] = dict(rep, launches=launches)
    return launches


# ---------------------------------------------------------------------------
# 15e: batched values through the direct route and the heavy preconditioners
# ---------------------------------------------------------------------------

LANE_KERNELS = ("panel_factor_lanes", "schur_update_lanes", "sn_sweep_lanes")
TOL_LANE_ATOMIC = 1e-13              # lane vs single launch where atomics add


def _lane_values(A, B, rng, jitter=False):
    """(B, nnz) values of A's pattern, lane b scaled by a factor in
    [0.7, 1.4] (numpy ``rng``).  ``jitter`` also scales each off-diagonal
    entry by its own factor in [0.5, 1], equal for (i, j) and (j, i), and
    lowers the diagonal by what its row's off-diagonals lost (each row
    keeps its excess of the diagonal over the off-diagonal sum): no lane
    is then a multiple of another (AMG and ILU(0) are homogeneous in the
    values, so scaled lanes cannot show a lane applied on another lane's
    state), and a Poisson operator becomes one of random conductances,
    SPD and about as well conditioned."""
    import torch
    s = torch.tensor(rng.uniform(0.7, 1.4, B), dtype=A.val.dtype,
                     device=A.val.device)
    V = A.val.detach()[None] * s[:, None]
    if jitter:
        r, c = A.row.long(), A.col.long()
        key = torch.minimum(r, c) * A.shape[0] + torch.maximum(r, c)
        _, inv = torch.unique(key, return_inverse=True)
        f = 0.5 + 0.5 * torch.tensor(
            rng.uniform(size=(B, int(inv.max()) + 1)), dtype=V.dtype,
            device=V.device)[:, inv]
        diag = r == c
        f[:, diag] = 1.0
        lost = V.new_zeros(B, A.shape[0]).index_add_(
            1, r[~diag], (V.abs() * (1.0 - f))[:, ~diag])
        V = V * f
        V[:, diag] -= lost[:, r[diag]]
    return V


def lane_kernel_rows(dev, art, vals, ng, out):
    """15e kernels: rows 4′–6′, the lane-stacked panel_factor, schur_update
    and sn_sweep, on B value lanes of the direct path's own analysis —
    against their plain versions lane by lane and, lane by lane, against
    the single-lane launch on that lane's values (bit for bit, or 1e-13
    where the kernel adds with atomics); their summed device time over one
    batched factorization (one mode-l sweep) beside the plain version's (one
    pass, lane by lane), B single-lane factorizations' and the bound (the
    values' bytes and the operations B times, the shared int32 tables
    once: ``_panel_work(..., lanes=B)``)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import supernode as ksn

    B = vals.shape[0]
    rng = np.random.default_rng(SEED + 21)
    buckets = [bk for lvl in art.snode.schedule for bk in lvl]
    n, sink = art.n, art.nnzF
    C0 = vals.new_zeros(B, art.nnzF + 2)
    C0.index_add_(1, art.a2f, vals)
    C0[:, art.nnzF + 1] = 1.0
    C0[:, sink] = 7.25                   # pad slots read NaN-free garbage
    tau = math.sqrt(np.finfo(np.float64).eps) * vals.abs().amax(1)
    k_max = max(bk.wvec.shape[0] for bk in buckets)
    work = torch.zeros(B * k_max, dtype=torch.int32, device=dev)
    # one batched factorization on the kernels; Cin: each bucket's panels as
    # they enter panel_factor (the timed passes start from them)
    Cf, Cin = C0.clone(), C0.clone()
    nbad = vals.new_zeros(B)
    for bk in buckets:
        for t in (bk.pidx, bk.qidx):
            Cin[:, t.long()] = Cf[:, t.long()]
        ksn.panel_factor_inplace(Cf, bk.pidx, bk.qidx, bk.wvec, bk.rvec, tau,
                                 bk.bkm, pairs=bk.pairs, nbad=nbad, work=work)
        ksn.schur_update_inplace(Cf, bk.pidx, bk.qidx, bk.wvec, bk.rvec,
                                 bk.uidx, bk.uoff)
    torch.cuda.synchronize()
    check(int(work.abs().sum()) == 0 and bool((Cf[:, sink] == 7.25).all()),
          "batched factorization on the kernels: counters back at zero, "
          "sinks untouched")
    # lane b against B single-lane factorizations on the kernels
    fac_err = 0.0
    for b in range(B):
        C1 = C0[b].clone()
        nb1 = torch.zeros((), dtype=C1.dtype, device=dev)
        for bk in buckets:
            ksn.panel_factor_inplace(C1, bk.pidx, bk.qidx, bk.wvec, bk.rvec,
                                     tau[b], bk.bkm, pairs=bk.pairs,
                                     nbad=nb1, work=work)
            ksn.schur_update_inplace(C1, bk.pidx, bk.qidx, bk.wvec, bk.rvec,
                                     bk.uidx, bk.uoff)
        fac_err = max(fac_err, rel_err([Cf[b]], [C1], [C1])[0])
        check(float(nb1) == float(nbad[b]), f"lane {b}: clamp count "
              f"{float(nbad[b]):.0f} equals its single factorization's")
    check(fac_err <= TOL_LANE_ATOMIC, f"batched factorization of poisson2d"
          f"({ng}), B = {B}: every lane equals its single-lane factorization "
          f"on the kernels ({fac_err:.2e} <= {TOL_LANE_ATOMIC:.0e}; "
          f"schur_update adds with atomics)")
    # each kernel against its plain version (lane by lane) and, lane by
    # lane, against the single-lane launch, on the three buckets phase 12
    # holds (widest, most lanes, ragged), from the path's own values
    errs = dict.fromkeys(LANE_KERNELS, 0.0)
    abs_err = dict.fromkeys(LANE_KERNELS, 0.0)
    single = dict.fromkeys(LANE_KERNELS, 0.0)   # lane vs single launch
    bit = {"panel_factor_lanes": True, "sn_sweep_lanes u/lt": True}

    def note(name, got, want):
        for b in range(B):
            e, ea = rel_err([got[b]], [want[b]], [want[b]])
            errs[name] = max(errs[name], e)
            abs_err[name] = max(abs_err[name], ea)

    cases = _panel_cases(buckets)
    for label, bk in cases:
        slots = (bk.pidx, bk.qidx, bk.wvec, bk.rvec)
        Ck, Cp = Cin.clone(), Cin.clone()
        nk = ksn.panel_factor_inplace(Ck, *slots, tau, bk.bkm,
                                      pairs=bk.pairs)
        torch.cuda.synchronize()
        npl = ref.sn_panel_factor_inplace_ref(Cp, *slots, tau, bk.bkm,
                                              pairs=bk.pairs)
        check(nk.tolist() == npl.tolist() and bool((Ck[:, sink] == 7.25)
                                                   .all()),
              f"panel_factor_lanes {label}: per-lane clamp counts equal the "
              f"plain version's, sinks untouched")
        note("panel_factor_lanes", Ck, Cp)
        Sk, Sp = Ck.clone(), Ck.clone()
        ksn.schur_update_inplace(Sk, *slots, bk.uidx, bk.uoff)
        torch.cuda.synchronize()
        ref.sn_schur_inplace_ref(Sp, *slots, bk.uidx)
        note("schur_update_lanes", Sk, Sp)
        Y0 = torch.tensor(rng.normal(size=(B, n + 1, 1)), device=dev)
        Y0[:, n] = 7.25
        wk, pt = ksn.sweep_buffers([bk], 1, torch.float64, dev, B)
        for b in range(B):
            C1 = Cin[b].clone()
            ksn.panel_factor_inplace(C1, *slots, tau[b], bk.bkm,
                                     pairs=bk.pairs)
            bit["panel_factor_lanes"] &= torch.equal(C1, Ck[b])
            ksn.schur_update_inplace(C1, *slots, bk.uidx, bk.uoff)
            torch.cuda.synchronize()
            single["schur_update_lanes"] = max(
                single["schur_update_lanes"], rel_err([C1], [Sk[b]],
                                                      [Sk[b]])[0])
        for mode in ("l", "lt", "u", "ut"):
            Yk = ksn.sn_sweep_inplace(Cf, Y0.clone(), bk, mode, work=wk,
                                      part=pt)
            torch.cuda.synchronize()
            Yp = ref.sn_sweep_inplace_ref(
                Cf, Y0.clone(), bk.pidx, bk.qidx, bk.rows, bk.wvec, bk.rvec,
                bk.bkm, mode=mode, pairs=bk.pairs)
            note("sn_sweep_lanes", Yk, Yp)
            for b in range(B):
                y1 = ksn.sn_sweep_inplace(Cf[b], Y0[b].clone(), bk, mode)
                torch.cuda.synchronize()
                if mode in ("u", "lt"):
                    bit["sn_sweep_lanes u/lt"] &= torch.equal(y1, Yk[b])
                else:
                    single["sn_sweep_lanes"] = max(
                        single["sn_sweep_lanes"],
                        rel_err([y1], [Yk[b]], [Yk[b]])[0])
        check(int(wk.abs().sum()) == 0, f"sn_sweep_lanes {label}: counters "
              f"back at zero")
        del Ck, Cp, Sk, Sp, Y0
    say(f"  rows 4′–6′ at B = {B} on {', '.join(f'{l} (k={b.wvec.shape[0]}, wb={b.wb}, rb={b.rb})' for l, b in cases)}: "
        + "; ".join(f"{k} rel err {errs[k]:.2e}" for k in LANE_KERNELS)
        + f"; lane vs single launch: panel_factor bit-equal "
        f"{bit['panel_factor_lanes']}, sn_sweep u/lt bit-equal "
        f"{bit['sn_sweep_lanes u/lt']}, schur_update (atomics) "
        f"{single['schur_update_lanes']:.2e}, sn_sweep l/ut (atomics) "
        f"{single['sn_sweep_lanes']:.2e}")
    for k in LANE_KERNELS:
        check(errs[k] <= TOL_KERNEL["float64"], f"{k} matches its plain "
              f"version lane by lane ({errs[k]:.2e} <= "
              f"{TOL_KERNEL['float64']:.0e})")
    check(bit["panel_factor_lanes"] and bit["sn_sweep_lanes u/lt"],
          "lane b of panel_factor_lanes and of sn_sweep_lanes (modes u, lt) "
          "equals the single-lane launch on lane b bit for bit")
    check(single["schur_update_lanes"] <= TOL_LANE_ATOMIC
          and single["sn_sweep_lanes"] <= TOL_LANE_ATOMIC,
          f"lane b of schur_update_lanes and sn_sweep_lanes (modes l, ut), "
          f"which add with atomics, within {TOL_LANE_ATOMIC:.0e} of the "
          f"single-lane launch")

    # -- time over one batched factorization (one mode-l sweep)
    Cw = C0.clone()
    Yb = torch.tensor(rng.normal(size=(B, n + 1, 1)), device=dev)
    Yb[:, n] = 0.0
    Yw = Yb.clone()
    acc = vals.new_zeros(B)
    acc1 = vals.new_zeros(())
    sw_work, sw_part = ksn.sweep_buffers(buckets, 1, torch.float64, dev, B)
    reset = {"panel_factor_lanes": lambda: Cw.copy_(Cin),
             "schur_update_lanes": lambda: Cw.copy_(Cf),
             "sn_sweep_lanes": lambda: Yw.copy_(Yb)}

    def run(name, impl):
        def one(bk):
            slots = (bk.pidx, bk.qidx, bk.wvec, bk.rvec)
            if name == "panel_factor_lanes":
                if impl == "kernel":
                    ksn.panel_factor_inplace(Cw, *slots, tau, bk.bkm,
                                             pairs=bk.pairs, nbad=acc,
                                             work=work)
                elif impl == "plain":
                    ref.sn_panel_factor_inplace_ref(Cw, *slots, tau, bk.bkm,
                                                    pairs=bk.pairs)
                else:
                    for b in range(B):
                        ksn.panel_factor_inplace(Cw[b], *slots, tau[b],
                                                 bk.bkm, pairs=bk.pairs,
                                                 nbad=acc1, work=work)
            elif name == "schur_update_lanes":
                if impl == "kernel":
                    ksn.schur_update_inplace(Cw, *slots, bk.uidx, bk.uoff)
                elif impl == "plain":
                    ref.sn_schur_inplace_ref(Cw, *slots, bk.uidx)
                else:
                    for b in range(B):
                        ksn.schur_update_inplace(Cw[b], *slots, bk.uidx,
                                                 bk.uoff)
            elif impl == "kernel":
                ksn.sn_sweep_inplace(Cf, Yw, bk, "l", work=sw_work,
                                     part=sw_part)
            elif impl == "plain":
                ref.sn_sweep_inplace_ref(Cf, Yw, bk.pidx, bk.qidx, bk.rows,
                                         bk.wvec, bk.rvec, bk.bkm, mode="l",
                                         pairs=bk.pairs)
            else:
                for b in range(B):
                    ksn.sn_sweep_inplace(Cf[b], Yw[b], bk, "l", work=sw_work,
                                         part=sw_part)
        return lambda: [one(bk) for bk in buckets]

    distinct = {id(bk): int(bk.uidx.unique().numel()) for bk in buckets}
    sdistinct = {id(bk): _sweep_distinct(bk) for bk in buckets}
    res = {}
    for name in LANE_KERNELS:
        base = name[:-len("_lanes")]
        rs = reset[name]
        work_b = [_panel_work(bk, distinct[id(bk)], sdistinct[id(bk)],
                              lanes=B)[base] for bk in buckets]
        tb = sum(w[0] for w in work_b)
        tf = sum(w[1] for w in work_b)
        bms, bby = bound_ms(tb, tf, "float64")
        ms = _sum_ms(run(name, "kernel"), reset=rs)
        singles = _sum_ms(run(name, "single"), reps=2, reset=rs)
        wall = wall_ms(run(name, "kernel"), 3, reset=rs)
        # the plain version is host-bound (seconds a pass): one pass, its
        # device clock from the first launch to the last
        plain = cuda_ms(run(name, "plain"), 1, warmup=0, spin_ms=0.0,
                        reset=rs)
        res[name] = dict(
            ms=ms, wall_ms=wall, plain_ms=plain, library_ms=None,
            singles_ms=singles, bytes=tb, flops=tf, dtype="float64",
            bound_ms=bms, bound_by=bby, max_rel_err=errs[name],
            max_abs_err=abs_err[name],
            lane_vs_single=("bit for bit" if name == "panel_factor_lanes"
                            else single[name]),
            shape=(f"B={B} x poisson2d({ng}): {len(buckets)} buckets"
                   + (", 1 sweep (mode l, m=1)" if base == "sn_sweep"
                      else ", 1 factorization")))
        say(f"  {name:18s} B={B}, summed over {len(buckets)} buckets: "
            f"{ms:.4f} ms (host wall {wall:.3f} ms; {B} single-lane passes "
            f"{singles:.4f} ms; plain, lane by lane, {plain:.1f} ms; bound "
            f"{bms:.4f} ms by {bby}, library none)")
    out["lane_kernel_rows"] = res
    del Cf, Cin, C0, Cw, Yb, Yw
    torch.cuda.empty_cache()
    return res


def batched_setup_path(dev, seed, out, direct_A, amg_A):
    """15e: stacked values (B, nnz) through the direct route on the direct
    path's cached plan (one factorization and one solve for the stack on
    rows 4′–6′, the backward on the transposed sweeps of the same factors),
    rows 4′–6′ against their plain versions, then CG + AMG (on phase 11b's
    cached plan), CG + MG, CG + Chebyshev and CG + ILU on stacked values,
    each held to the single solves of its lanes.  The direct and Chebyshev
    lanes are scaled copies of one matrix; the AMG and ILU lanes have
    random conductances (``_lane_values(..., jitter=True)``) and the MG
    lanes a κ each, so that no lane is a multiple of another."""
    import torch
    from repro_torch import sla
    from repro_torch.core import direct as _direct
    from repro_torch.data.poisson import poisson2d, poisson2d_vc
    from repro_torch.kernels import launch_counts

    rng = np.random.default_rng(seed + 21)
    total, res = {}, {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    # -- the direct route, B = 8 lanes of poisson2d(316) ------------------
    B = LANES_DIRECT
    Ad = direct_A
    nd = Ad.shape[0]
    plan = Ad.plan()                          # cached since phase 8
    art = plan.artifacts["direct"]
    nbk = sum(len(lvl) for lvl in art.snode.schedule)
    vals = _lane_values(Ad, B, rng)
    f = torch.tensor(rng.normal(size=nd), device=dev)
    leaf = vals.clone().requires_grad_(True)
    _sync(dev)
    _peak_reset(dev)
    _counts_reset()
    t0 = time.perf_counter()
    X = sla.solve(Ad.with_values(leaf), f)
    _sync(dev)
    t1 = time.perf_counter()
    lf = dict(launch_counts())
    (X * X).sum().backward()
    _sync(dev)
    t2 = time.perf_counter()
    ld, sd = _counts()
    add(ld)
    peak = _peak(dev)
    fac_launches = lf["panel_factor_lanes"] + lf["schur_update_lanes"]
    solve_launches = lf["sn_sweep_lanes"]
    back_launches = ld["sn_sweep_lanes"] - solve_launches
    relres = _true_rel_res(Ad.with_values(vals), X.detach(), f)
    # one batched factorization against B one at a time (wall, device)
    fac_b = lambda: _direct.numeric_factor(art, vals)
    fac_1 = lambda: [_direct.numeric_factor(art, vals[b]) for b in range(B)]
    wall_b, wall_1 = wall_ms(fac_b, 3), wall_ms(fac_1, 2)
    dev_b, dev_1 = _sum_ms(fac_b, reps=3), _sum_ms(fac_1, reps=2)
    Cs = fac_b()
    sol_b = lambda: _direct.factored_solve(art, Cs, f.expand(B, nd))
    swall_b = wall_ms(sol_b, 3)
    sdev_b = _sum_ms(sol_b, reps=3)
    # each lane against its single solve and single gradient
    xerr = gerr = 0.0
    for b in range(B):
        v1 = vals[b].clone().requires_grad_(True)
        x1 = sla.solve(Ad.with_values(v1), f)
        (x1 * x1).sum().backward()
        x1 = x1.detach()
        xerr = max(xerr, float((X[b].detach() - x1).abs().max()
                               / x1.abs().max()))
        gerr = max(gerr, _grad_rel(leaf.grad[b], v1.grad))
    say(f"  direct B={B} poisson2d({NG_DIRECT}) (cached plan {plan.cfg.backend}/"
        f"{plan.cfg.method}, {nbk} buckets): solve {t1 - t0:.4f} s, backward "
        f"{t2 - t1:.4f} s; launches a factorization {fac_launches}, a solve "
        f"{solve_launches}, the backward {back_launches} (one lane: "
        f"{2 * nbk} each); PLAN_STATS {json.dumps({k: v for k, v in sd.items() if v})}; "
        f"peak {peak:.3f} GB")
    say(f"  one batched factorization {wall_b:.2f} ms wall / {dev_b:.3f} ms "
        f"device against {B} one at a time {wall_1:.2f} ms / {dev_1:.3f} ms "
        f"({wall_1 / wall_b:.2f}x wall); one batched solve {swall_b:.2f} ms "
        f"wall / {sdev_b:.3f} ms device; true residuals "
        f"{relres.max().item():.2e}; lanes vs single solves: x {xerr:.2e}, "
        f"gradient {gerr:.2e}")
    check(plan.cfg.backend == "direct" and sd["setup"] == 1
          and sd["factorize"] == 1 and sd["analyze"] == 0
          and plan.transpose() is plan,
          "batched direct: one setup and one factorization for the stack "
          "across the solve and its backward, on the cached analysis, whose "
          "adjoint plan is the plan itself")
    check(fac_launches == 2 * nbk and solve_launches == 2 * nbk
          and back_launches == 2 * nbk
          and ld["panel_factor"] + ld["schur_update"] + ld["sn_sweep"] == 0,
          f"batched direct: {2 * nbk} launches a factorization, a solve and "
          f"a backward for all {B} lanes, as one lane costs")
    check(relres.max().item() <= TOL_DIRECT_RES,
          f"batched direct: every lane's true residual <= "
          f"{TOL_DIRECT_RES:.0e}")
    check(xerr <= 1e-12 and gerr <= 1e-12, f"batched direct: each lane's x "
          f"and gradient equal its single solve's ({xerr:.2e}, {gerr:.2e} "
          f"<= 1e-12)")
    res["direct"] = dict(B=B, ng=NG_DIRECT, buckets=nbk, solve_s=t1 - t0,
                         backward_s=t2 - t1, factorization_launches=fac_launches,
                         solve_launches=solve_launches,
                         backward_launches=back_launches,
                         factorize_wall_ms=wall_b, factorize_device_ms=dev_b,
                         singles_wall_ms=wall_1, singles_device_ms=dev_1,
                         solve_wall_ms=swall_b, solve_device_ms=sdev_b,
                         true_residual=relres.tolist(), x_rel_diff=xerr,
                         grad_rel_diff=gerr, peak_gb=peak, plan_stats=sd,
                         launches=ld)
    del X, leaf, Cs
    kres = lane_kernel_rows(dev, art, vals, NG_DIRECT, out)
    del vals
    torch.cuda.empty_cache()

    # -- CG + AMG / MG / Chebyshev / ILU on stacked values ------------------
    def lanes_case(label, A, b, kw, lanes, want_kernel, vals=None):
        if vals is None:
            vals = _lane_values(A, lanes, rng, jitter=True)
        Ab = A.with_values(vals)
        _sync(dev)
        _counts_reset()
        t0 = time.perf_counter()
        r = sla.solve_with_info(Ab, b, **kw)
        _sync(dev)
        t1 = time.perf_counter()
        lc, sc = _counts()
        add(lc)
        it = [int(i) for i in r.iterations.tolist()]
        singles, walls = [], []
        xerr = 0.0
        for k in range(lanes):
            t = time.perf_counter()
            one = sla.solve_with_info(A.with_values(vals[k].clone()), b, **kw)
            _sync(dev)
            walls.append(time.perf_counter() - t)
            singles.append(int(one.iterations))
            xerr = max(xerr, float((r.x[k] - one.x).abs().max()
                                   / one.x.abs().max()))
        rr = _true_rel_res(Ab, r.x, b).max().item()
        ms_b = (t1 - t0) / max(max(it), 1) * 1e3
        ms_1 = walls[0] / max(singles[0], 1) * 1e3
        say(f"  {label} B={lanes}: iterations {it} (single solves "
            f"{singles}); {t1 - t0:.3f} s, {ms_b:.3f} ms an iteration for "
            f"{lanes} lanes against {ms_1:.3f} ms for one (setup included); "
            f"true residual {rr:.2e}; lanes vs single solves {xerr:.2e}; "
            f"PLAN_STATS {json.dumps({k: v for k, v in sc.items() if v})}")
        check(sc["setup"] == 1 and it == singles and rr <= 10 * kw["tol"]
              and xerr <= TOL_BATCH,
              f"{label}: one setup for the stack, per-lane iterations equal "
              f"the single solves', true residuals <= 10·tol, lanes within "
              f"{TOL_BATCH:.0e} of their single solves")
        check(lc[want_kernel] > 0, f"{label}: ran on {want_kernel}")
        return dict(lanes=lanes, iterations=it, single_iterations=singles,
                    solve_s=t1 - t0, ms_per_iteration=ms_b,
                    single_ms_per_iteration=ms_1, single_s=walls,
                    true_residual=rr, x_rel_diff=xerr, plan_stats=sc,
                    launches=lc), sc

    b = torch.ones(amg_A.shape[0], dtype=torch.float64, device=dev)
    kw = dict(backend="pallas", method="cg", precond="amg", tol=TOL,
              maxiter=MAXITER)
    res["amg"], sc = lanes_case(f"CG + AMG poisson2d({NG_BELL})", amg_A, b,
                                kw, LANES_PRECOND, "sn_sweep_lanes")
    check(sc["galerkin"] == 1 and sc["analyze"] == 0,
          "batched AMG: one Galerkin product for the stack, on the cached "
          "analysis")
    del b
    torch.cuda.empty_cache()
    # MG: one smooth κ per lane (lane 0 phase 11a's)
    As = [poisson2d_vc(torch.tensor(smooth_kappa(NG_STENCIL, seed + k),
                                    device=dev),
                       use_stencil_kernel=True, device=dev)
          for k in range(LANES_PRECOND)]
    b = torch.ones(As[0].shape[0], dtype=torch.float64, device=dev)
    res["mg"], _ = lanes_case(
        f"CG + MG ng={NG_STENCIL}", As[0], b,
        dict(precond="mg", tol=TOL, maxiter=MAXITER), LANES_PRECOND,
        "stencil5_batched", vals=torch.stack([a.val for a in As]))
    del As, b
    torch.cuda.empty_cache()
    A1 = poisson2d(NG_BELL, device=dev)
    b = torch.ones(A1.shape[0], dtype=torch.float64, device=dev)
    res["chebyshev"], _ = lanes_case(
        f"CG + Chebyshev poisson2d({NG_BELL})", A1, b,
        dict(backend="pallas", method="cg", precond="chebyshev", tol=TOL,
             maxiter=MAXITER), LANES_PRECOND, "fused_cheb_step_batched",
        vals=_lane_values(A1, LANES_PRECOND, rng))
    del A1, b
    A2 = poisson2d(NG_ILU_LANES, device=dev)
    b = torch.ones(A2.shape[0], dtype=torch.float64, device=dev)
    res["ilu"], _ = lanes_case(
        f"CG + ILU(0) poisson2d({NG_ILU_LANES})", A2, b,
        dict(backend="pallas", method="cg", precond="ilu", tol=TOL,
             maxiter=MAXITER), LANES_PRECOND, "bell_spmv_batched")
    out["batched_setup_path"] = res
    return kres, total


def batch_phase(dev, seed, out, direct_A):
    """Phase 15: the kernels (15a), then the paths 15b–15d, their launches
    counted from zero for each path.  ``direct_A`` is the direct path's
    ``poisson2d(316)``, whose cached plan (analyzed once in phase 8) 15c
    reuses."""
    kres = batch_kernel_phase(dev, seed, out)
    total = {}
    for name, fn, a in (("15b batched values", batched_values_path, ()),
                        ("15c multi-rhs", multi_rhs_path, (direct_A,)),
                        ("15d serve", serve_path, ())):
        say(f" ({name})")
        t = time.perf_counter()
        counts = fn(dev, seed, out, *a)
        say(f" ({name}) {time.perf_counter() - t:.2f} s")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return kres, total


# ---------------------------------------------------------------------------
# phase 16: the distributed layer on a one-rank NCCL group
# ---------------------------------------------------------------------------

def _dist_group():
    """A one-rank NCCL process group over a file store in the output
    directory (no network port).  A failed initialisation raises."""
    import torch
    import torch.distributed as dist
    path = os.path.join(OUT, "dist_store")
    if os.path.exists(path):
        os.remove(path)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(path, 1), rank=0,
                            world_size=1)
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          "distributed: one-rank NCCL process group")
    return dist.group.WORLD


def _take(acc):
    """Add the launches counted since the last reset into ``acc``; reset."""
    launches, _ = _counts()
    for k, v in launches.items():
        acc[k] = acc.get(k, 0) + v
    _counts_reset()


def _entry_order(D, row, col, n):
    """For every global COO entry (row, col), its position in the stacked
    storage of ``D`` flattened (the single-device gradient's order)."""
    from repro_torch.core.distributed import global_entries, partition_simple
    m = D.meta
    rg, cg, fa = global_entries(D.row, D.col, m,
                                partition_simple(m.n, m.p))
    kd = rg * n + cg
    ks = np.asarray(row, np.int64) * n + np.asarray(col, np.int64)
    od, os_ = np.argsort(kd), np.argsort(ks)
    check(np.array_equal(kd[od], ks[os_]), "distributed: the stacked "
          "pattern holds every global entry once")
    pos = np.empty(len(ks), np.int64)
    pos[os_] = fa[od]
    return pos


def _dist_full_width(dev, mesh, acc, out):
    """(a) poisson2d(4000), P = 4, Jacobi CG and pipelined CG at the paper's
    fixed 1,000-iteration budget (tol 0)."""
    import torch
    from repro_torch.core.distributed import DSparseTensor
    from repro_torch.data.poisson import poisson2d_arrays
    ng, p = NG_DIST, DIST_P
    n = ng * ng
    t0 = time.perf_counter()
    v, r, c = poisson2d_arrays(ng)
    _sync(dev)
    _peak_reset(dev)
    base = torch.cuda.memory_allocated()
    D = DSparseTensor.from_global(v, r, c, (n, n), mesh, symmetric=True)
    del v, r, c
    t1 = time.perf_counter()
    bs = D.stack_vector(torch.ones(n, dtype=torch.float64, device=dev))
    cfg = dict(tol=0.0, maxiter=DIST_ITERS, precond="jacobi")
    plan = D.plan(**cfg)
    plan.setup(D)
    _sync(dev)
    t2 = time.perf_counter()
    held = torch.cuda.memory_allocated() - base
    m = D.meta
    say(f"  (a) poisson2d({ng}) (n={n}, nnz={sum(m.shard_nnz)}) P={p}: "
        f"from_global {t1 - t0:.2f} s, analyze + setup {t2 - t1:.2f} s; "
        f"n_loc={m.n_loc} h_lo={m.h_lo} h_hi={m.h_hi} "
        f"nnz_loc={m.nnz_loc}; device bytes held {held / 1e9:.3f} GB "
        f"({held / p / 1e9:.3f} GB a shard)")
    methods = (("cg", {}), ("pipelined_cg", dict(pipelined=True)))
    window = dict(cfg, maxiter=DIST_TRACE_ITERS)
    t = time.perf_counter()
    for _, kw in methods:       # the first collective sets NCCL up
        D.solve_with_info(bs, **window, **kw)
    _sync(dev)
    say(f"  (a) warm-up ({DIST_TRACE_ITERS} iterations of each method, "
        f"NCCL's set-up included): {time.perf_counter() - t:.2f} s")
    _counts_reset()
    res = {}
    for name, kw in methods:
        _sync(dev)
        t = time.perf_counter()
        x, info = D.solve_with_info(bs, **cfg, **kw)
        _sync(dev)
        dt = time.perf_counter() - t
        with torch.no_grad():
            rr = D.gather_global(bs - D.matvec(x))
            relres = float(rr.norm() / math.sqrt(n))
        rec = float(info.resnorm) / math.sqrt(n)
        drift = abs(relres - rec) / max(relres, rec, 1e-300)
        res[name] = dict(iterations=int(info.iters), seconds=dt,
                         ms_per_iteration=dt / DIST_ITERS * 1e3,
                         true_residual=relres, recursive_residual=rec)
        say(f"  (a) {name}: {int(info.iters)} iterations in {dt:.3f} s = "
            f"{dt / DIST_ITERS * 1e3:.4f} ms an iteration; relative "
            f"residual after the budget {relres:.6e} (the recurrence's "
            f"{rec:.6e})")
        # CG minimizes the error's A-norm, not the residual: at κ ≈ 6.5e6
        # ‖r‖ may exceed ‖b‖ after 1,000 iterations; the recurrence must
        # not drift from the true residual
        check(int(info.iters) == DIST_ITERS and math.isfinite(relres)
              and drift <= TOL_DIST_DRIFT, f"distributed (a) {name}: the "
              f"full budget ran, true and recursive residuals agree "
              f"({drift:.2e} <= {TOL_DIST_DRIFT:.0e})")
    _take(acc)
    peak = _peak(dev)
    # where an iteration's time goes: DIST_TRACE_ITERS iterations timed,
    # then the same window traced
    out["trace"] = {}
    for name, kw in methods:
        _sync(dev)
        t = time.perf_counter()
        D.solve_with_info(bs, **window, **kw)
        _sync(dev)
        wall_w = (time.perf_counter() - t) * 1e3
        cnt, dev_ms, top = _kernel_breakdown(
            lambda: D.solve_with_info(bs, **window, **kw),
            os.path.join(OUT, f"dist_{name}_trace.json"))
        _take(acc)
        say(f"  (a) traced {name} window of {DIST_TRACE_ITERS} iterations: "
            f"{wall_w:.2f} ms of wall untraced, {dev_ms:.2f} ms of device "
            f"time in {cnt} device ops (busy {dev_ms / wall_w:.0%}); top: "
            + "; ".join(f"{nm[:48]} {ms:.2f} ms ×{c}"
                        for ms, c, nm in top[:8]))
        out["trace"][name] = dict(iterations=DIST_TRACE_ITERS,
                                  wall_ms=wall_w, device_ms=dev_ms,
                                  device_ops=cnt, busy=dev_ms / wall_w,
                                  top=top[:12])
    # the first DIST_PLAIN_ITERS iterations on the kernels and on their
    # plain versions
    short = dict(cfg, maxiter=DIST_PLAIN_ITERS)
    xk, _ = D.solve_with_info(bs, **short)
    _take(acc)
    with plain_kernels():
        xp, _ = D.solve_with_info(bs, **short)
    _sync(dev)
    perr = _grad_rel(xk, xp)
    halo = (p - 1) * (m.h_lo + m.h_hi) * 8
    say(f"  (a) halo bytes an iteration: {halo} (one matvec: {p - 1} "
        f"in-rank shard boundaries × {m.h_lo + m.h_hi} values; 0 across "
        f"ranks on one rank); peak device memory {peak:.3f} GB; first "
        f"{DIST_PLAIN_ITERS} iterations kernels vs plain: max rel diff "
        f"{perr:.3e}")
    check(perr <= TOL_DIST_PLAIN, f"distributed (a): {DIST_PLAIN_ITERS} "
          f"iterations on the kernels match the plain run ({perr:.2e} <= "
          f"{TOL_DIST_PLAIN:.0e})")
    out.update(ng=ng, p=p, n=n, budget=DIST_ITERS, solves=res,
               halo_bytes_per_iteration=halo, peak_gb=peak,
               held_gb=held / 1e9, held_gb_per_shard=held / p / 1e9,
               plain_rel_diff=perr, from_global_s=t1 - t0,
               analyze_setup_s=t2 - t1)
    del D, bs, plan, x, xk, xp


def _dist_solve_grad(dev, mesh, acc, out):
    """(b) poisson2d(1024), P = 4, Jacobi CG to tol 1e-10 with ∂Σx²/∂val,
    against the port's single-device solve + gradient; PLAN_STATS of a
    tolerance sweep."""
    import torch
    from repro_torch import sla
    from repro_torch.core.distributed import DSparseTensor
    from repro_torch.core.sparse import SparseTensor
    from repro_torch.data.poisson import poisson2d_arrays
    ng, p, tol = NG_DIST_GRAD, DIST_P, TOL_DIST
    n = ng * ng
    v, r, c = poisson2d_arrays(ng)
    D = DSparseTensor.from_global(v, r, c, (n, n), mesh, symmetric=True)
    b = torch.ones(n, dtype=torch.float64, device=dev)
    bs = D.stack_vector(b)
    _counts_reset()
    sweep = {}
    for t in DIST_SWEEP:
        _, info = D.solve_with_info(bs, tol=t, maxiter=MAXITER)
        sweep[t] = int(info.iters)
    lv = D.lval.clone().requires_grad_(True)
    _sync(dev)
    t0 = time.perf_counter()
    x = D.with_values(lv).solve(bs, tol=tol, maxiter=MAXITER)
    (x * x).sum().backward()
    _sync(dev)
    wall = time.perf_counter() - t0
    stats = _counts()[1]
    _take(acc)
    say(f"  (b) poisson2d({ng}) P={p}: tolerance sweep iterations "
        f"{json.dumps(sweep)}; solve + grad at tol {tol:.0e}: {wall:.3f} s")
    say(f"  (b) PLAN_STATS (sweep + solve + backward) "
        f"{json.dumps({k: v for k, v in stats.items() if v})}")
    A = SparseTensor(v, r, c, (n, n), props={"symmetric": True,
                                             "spd_hint": True}, device=dev)
    val = A.val.clone().requires_grad_(True)
    t0 = time.perf_counter()
    with sla.options(fused_step="off"):
        xs = sla.solve(A.with_values(val), b, backend="jnp", method="cg",
                       precond="jacobi", tol=tol, maxiter=MAXITER)
        (xs * xs).sum().backward()
    _sync(dev)
    wall_s = time.perf_counter() - t0
    xerr = _grad_rel(D.gather_global(x.detach()), xs.detach())
    g = lv.grad.reshape(-1)[torch.as_tensor(_entry_order(D, r, c, n),
                                            device=dev)]
    gerr = _grad_rel(g, val.grad)
    say(f"  (b) single-device solve + grad {wall_s:.3f} s; x max rel diff "
        f"{xerr:.3e}, val-gradient max rel diff {gerr:.3e}")
    check(xerr <= TOL_DIST_GRAD and gerr <= TOL_DIST_GRAD,
          f"distributed (b): x and ∂Σx²/∂val match the single-device solve "
          f"({xerr:.2e}, {gerr:.2e} <= {TOL_DIST_GRAD:.0e})")
    check(stats["analyze"] == 1 and stats["transpose_shared"] == 1
          and stats["setup_reuse"] >= len(DIST_SWEEP),
          "distributed (b): one analyze across the sweep and the backward, "
          "the setup memo reused, the adjoint on the same plan")
    out.update(ng=ng, p=p, tol=tol, sweep_iterations=sweep,
               solve_grad_s=wall, single_solve_grad_s=wall_s,
               x_rel_diff=xerr, grad_rel_diff=gerr, plan_stats=stats)


def _dist_nonsymmetric(dev, mesh, acc, out):
    """(c) the transposed paths' drift operator (ng 256), BiCGStab, with its
    Aᵀ-partition gradient, against the single-device BiCGStab."""
    import torch
    from repro_torch import sla
    from repro_torch.core.distributed import DSparseTensor
    from repro_torch.core.sparse import SparseTensor
    from repro_torch.data.poisson import poisson2d_arrays
    ng, p, tol = NG_TRANSPOSE, DIST_P, TOL_TRANSPOSE
    n = ng * ng
    v, r, c = poisson2d_arrays(ng)
    v = v.copy()
    v[c == r - 1] = -1.4
    v[c == r + 1] = -0.6
    D = DSparseTensor.from_global(v, r, c, (n, n), mesh, symmetric=False)
    b = torch.ones(n, dtype=torch.float64, device=dev)
    lv = D.lval.clone().requires_grad_(True)
    _counts_reset()
    t0 = time.perf_counter()
    x = D.with_values(lv).solve(D.stack_vector(b), tol=tol, maxiter=MAXITER)
    (x * x).sum().backward()
    _sync(dev)
    wall = time.perf_counter() - t0
    stats = _counts()[1]
    _take(acc)
    props = {"symmetric": False, "spd_hint": False, "sorted_rows": False}
    A = SparseTensor(v, r, c, (n, n), props=props, device=dev)
    val = A.val.clone().requires_grad_(True)
    with sla.options(fused_step="off"):
        xs = sla.solve(A.with_values(val), b, backend="jnp",
                       method="bicgstab", tol=tol, maxiter=MAXITER)
        (xs * xs).sum().backward()
    _sync(dev)
    xerr = _grad_rel(D.gather_global(x.detach()), xs.detach())
    g = lv.grad.reshape(-1)[torch.as_tensor(_entry_order(D, r, c, n),
                                            device=dev)]
    gerr = _grad_rel(g, val.grad)
    say(f"  (c) drift poisson2d({ng}) P={p} BiCGStab: solve + grad "
        f"{wall:.3f} s; x max rel diff {xerr:.3e}, val-gradient max rel "
        f"diff {gerr:.3e} against the single-device BiCGStab; PLAN_STATS "
        f"{json.dumps({k: v for k, v in stats.items() if v})}")
    check(xerr <= TOL_DIST_NONSYM and gerr <= TOL_DIST_NONSYM,
          f"distributed (c): x and the Aᵀ-partition gradient match "
          f"({xerr:.2e}, {gerr:.2e} <= {TOL_DIST_NONSYM:.0e})")
    check(stats["t_partition"] == 1 and stats["transpose_shared"] == 1,
          "distributed (c): the Aᵀ partition built once, shared")
    out.update(ng=ng, p=p, tol=tol, solve_grad_s=wall, x_rel_diff=xerr,
               grad_rel_diff=gerr, plan_stats=stats)


def _dist_schwarz(dev, group, acc, out):
    """(d) Jacobi, schwarz and schwarz2 for P ∈ {2, 4, 8}: iterations to
    tol 1e-8 at poisson2d(64), and the setup and one apply at
    poisson2d(256).  (A Schwarz apply is ILU(0)'s scalar program, one
    Python step per level: ~200 ms at 256, where CG needs ~250 iterations
    — ~50 s a solve — so the counts are taken on the smaller grid.)"""
    import torch
    from repro_torch.core.distributed import (DSparseTensor, _halo_run,
                                              _halo_run_t, make_mesh)
    from repro_torch.data.poisson import poisson2d_arrays
    res = {}
    for ng, solve in ((NG_DIST_SCHWARZ_ITERS, True), (NG_DIST_SCHWARZ, False)):
        n = ng * ng
        v, r, c = poisson2d_arrays(ng)
        b = torch.ones(n, dtype=torch.float64, device=dev)
        for p in DIST_SCHWARZ_P:
            mesh = make_mesh(p, group=group, device=dev)
            D = DSparseTensor.from_global(v, r, c, (n, n), mesh,
                                          symmetric=True)
            bs = D.stack_vector(b)
            row = res.setdefault(p, {})
            for pc in ("jacobi", "schwarz", "schwarz2"):
                w = row.setdefault(pc, {})
                _counts_reset()
                plan = D.plan(precond=pc, tol=TOL, maxiter=MAXITER)
                if solve:
                    _, info = D.solve_with_info(bs, precond=pc, tol=TOL,
                                                maxiter=MAXITER)
                    _take(acc)
                    w.update(ng_iterations=ng, iterations=int(info.iters))
                    check(bool(info.converged), f"distributed (d) "
                          f"poisson2d({ng}) P={p} {pc} converged")
                    continue
                _sync(dev)
                t = time.perf_counter()
                _, pstate = plan.setup(D)
                _sync(dev)
                setup_s = time.perf_counter() - t
                prog, op = plan.artifacts["halo"], plan.artifacts["local"]
                M = plan.artifacts["precond"].local_closure(
                    pstate, lambda z: _halo_run(prog, z),
                    lambda z: _halo_run_t(prog, z),
                    matvec=lambda z: op.apply(D.lval, None,
                                              _halo_run(prog, z)))
                apply_ms = wall_ms(lambda: M(bs), 3)
                _take(acc)
                w.update(ng_timed=ng, setup_s=setup_s, apply_ms=apply_ms)
            if not solve:
                say(f"  (d) P={p}: iterations at poisson2d("
                    f"{NG_DIST_SCHWARZ_ITERS}) " + ", ".join(
                        f"{k} {w['iterations']}" for k, w in row.items())
                    + f"; at poisson2d({ng}) apply ms " + ", ".join(
                        f"{k} {w['apply_ms']:.3f}" for k, w in row.items())
                    + ", setup s " + ", ".join(
                        f"{k} {w['setup_s']:.3f}" for k, w in row.items()))
    for p, row in res.items():
        check(row["schwarz"]["iterations"] < row["jacobi"]["iterations"],
              f"distributed (d) P={p}: schwarz needs fewer iterations than "
              f"Jacobi")
    last = res[DIST_SCHWARZ_P[-1]]
    check(last["schwarz2"]["iterations"] < last["schwarz"]["iterations"],
          "distributed (d): two-level beats one-level Schwarz at the "
          "largest P")
    out.update(ng_iterations=NG_DIST_SCHWARZ_ITERS,
               ng_timed=NG_DIST_SCHWARZ, rows=res)


def _dist_eigen(dev, mesh, acc, out):
    """(e) ``eigsh(k=4)`` on poisson2d(64) against the closed form."""
    import torch
    from repro_torch.core.distributed import DSparseTensor
    from repro_torch.data.poisson import poisson2d_arrays
    ng, k = NG_DIST_EIG, DIST_EIG_K
    n = ng * ng
    v, r, c = poisson2d_arrays(ng)
    D = DSparseTensor.from_global(v, r, c, (n, n), mesh, symmetric=True)
    _counts_reset()
    t0 = time.perf_counter()
    w, V = D.eigsh(k=k, tol=EIG_TOL, maxiter=DIST_EIG_MAXITER)
    _sync(dev)
    wall = time.perf_counter() - t0
    _take(acc)
    lam = np.sin(np.arange(1, ng + 1) * np.pi / (2 * (ng + 1))) ** 2 * 4
    exact = np.sort((lam[:, None] + lam[None, :]).ravel())[:k]
    werr = float(np.max(np.abs(w.cpu().numpy() - exact) / exact))
    say(f"  (e) eigsh(k={k}) poisson2d({ng}) P={D.meta.p}: {wall:.3f} s; "
        f"eigenvalues {np.array2string(w.cpu().numpy(), precision=10)}; "
        f"max rel diff from the closed form {werr:.3e}")
    check(V.shape == (D.mesh.p_loc, D.meta.n_loc, k)
          and bool(torch.isfinite(V).all()), "distributed (e): finite "
          "eigenvectors of shape (P_loc, n_loc, k)")
    check(werr <= TOL_EIG, f"distributed (e): eigenvalues match the closed "
          f"form ({werr:.2e} <= {TOL_EIG:.0e})")
    out.update(ng=ng, k=k, seconds=wall, eigenvalues=w.tolist(),
               rel_err=werr)


def distributed_path(dev, seed, out, group):
    """Phase 16: ``DSparseTensor`` over the one-rank NCCL ``group`` — (a)
    full width, (b) solve + grad, (c) non-symmetric, (d) Schwarz, (e)
    eigen.  Only the distributed runs' launches are counted (the
    single-device yardsticks and the plain runs are not)."""
    from repro_torch.core.distributed import make_mesh
    del seed                       # the problems are deterministic
    acc = {}
    res = {}
    mesh = make_mesh(DIST_P, group=group, device=dev)
    for key, fn, arg in (("a_full_width", _dist_full_width, mesh),
                         ("b_solve_grad", _dist_solve_grad, mesh),
                         ("c_nonsymmetric", _dist_nonsymmetric, mesh),
                         ("d_schwarz", _dist_schwarz, group),
                         ("e_eigen", _dist_eigen, mesh)):
        t = time.perf_counter()
        res[key] = {}
        fn(dev, arg, acc, res[key])
        res[key]["phase_s"] = time.perf_counter() - t
        say(f"  ({key}) {res[key]['phase_s']:.2f} s")
    say(f"  launches {json.dumps({k: v for k, v in acc.items() if v})}")
    for k in ("bell_spmv", "fused_dots2_batched"):
        check(acc.get(k, 0) > 0, f"distributed path launched {k} "
              f"({acc.get(k, 0)} times)")
    res["launches"] = acc
    out["distributed_path"] = res
    return acc


# ---------------------------------------------------------------------------
# phase 19: the sharded launch path (slice 9)
# ---------------------------------------------------------------------------

def _launch_mesh():
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch import shardings as sh
    mesh = init_device_mesh("cuda", (1, 1, 1),
                            mesh_dim_names=("pod", "data", "model"))
    return sh.baseline_rules(mesh)


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _launch_train(dev, seed, rules, out):
    """(a) ``jit_train_step`` against ``make_train_step``: LAUNCH_STEPS
    steps of llama3.2-1b at TRAIN_SHAPE from the same state and batches."""
    import torch
    from repro_torch.checkpoint.manager import _flatten
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import synthetic_batch
    from repro_torch.launch import train
    from repro_torch.models.transformer import Transformer, param_shapes
    from repro_torch.optim.adamw import AdamWConfig

    cfg = get_config(LM_ARCH)
    B, S = TRAIN_SHAPE
    opt = AdamWConfig(**TRAIN_OPT)
    nc = train.ce_chunks(rules, B)
    batches = [synthetic_batch(seed, s, B, S + 1, cfg.vocab)
               for s in range(LAUNCH_STEPS)]
    state0 = train.init_state(Transformer(cfg, seed=seed, device=dev))

    def run(step, state):
        """(state, a row a step, peak GB above what was resident)."""
        rows = []
        _sync(dev)
        _peak_reset(dev)
        resident = torch.cuda.memory_allocated() / 1e9
        for b in batches:
            t = time.perf_counter()
            state, m = step(state, b)
            _sync(dev)
            rows.append(dict(ms=(time.perf_counter() - t) * 1e3,
                             loss=float(_local(m["loss"])),
                             grad_norm=float(_local(m["grad_norm"]))))
        return state, rows, _peak(dev) - resident

    st, plain_rows, plain_peak = run(train.make_train_step(cfg, opt, nc),
                                     state0)
    want = _flatten(st)                     # kept on the card: ~15 GB
    step, _ = train.jit_train_step(cfg, opt, rules, param_shapes(cfg),
                                   batches[0])
    ds = train.distribute_state(state0, rules)
    del state0, st
    _counts_reset()
    ds, rows, peak = run(step, ds)
    launches = _counts()[0]
    got = {k: _local(v) for k, v in _flatten(ds).items()}
    bitwise = all(torch.equal(got[k], want[k]) for k in want)
    diff = {k: float((got[k].double() - want[k].double()).abs().max())
            / max(float(want[k].double().abs().max()), 1e-30)
            for k in want} if not bitwise else dict.fromkeys(want, 0.0)
    worst = max(diff, key=diff.get)
    del ds, got, want
    torch.cuda.empty_cache()
    same_loss = all(r["loss"] == p["loss"] for r, p in zip(rows, plain_rows))
    say(f"  (a) {cfg.name} B {B} × S {S}, {nc} CE chunks: sharded "
        + ", ".join(f"{r['ms']:.1f}" for r in rows) + " ms a step (peak "
        f"{peak:.2f} GB above the resident state) vs unsharded "
        + ", ".join(f"{r['ms']:.1f}" for r in plain_rows) + f" ms (peak "
        f"{plain_peak:.2f} GB above it); losses "
        + ", ".join(f"{r['loss']:.6f}" for r in rows) + " vs "
        + ", ".join(f"{r['loss']:.6f}" for r in plain_rows)
        + f"; state {'bit for bit' if bitwise else 'not bit for bit'}, "
        f"max |Δ| {diff[worst]:.3e} of max |x| ({worst}); flash_attention "
        f"launched {launches['flash_attention']} times")
    check(same_loss or all(abs(r["loss"] - p["loss"]) <= TOL_LAUNCH
                           * abs(p["loss"])
                           for r, p in zip(rows, plain_rows)),
          "(a) the sharded steps' losses equal the unsharded ones")
    check(bitwise or diff[worst] <= TOL_LAUNCH,
          "(a) the sharded state equals the unsharded one "
          + ("bit for bit" if bitwise else
             f"within {diff[worst]:.2e} <= {TOL_LAUNCH:g} of max |x| (not "
             f"bit for bit: {worst}, whose sums DTensor orders otherwise)"))
    want_l = 2 * cfg.n_layers * LAUNCH_STEPS
    check(launches["flash_attention"] >= want_l,
          f"(a) flash_attention launched inside the sharded step "
          f"({launches['flash_attention']} >= {want_l}: forward and remat)")
    out["train"] = dict(arch=cfg.name, B=B, S=S, ce_chunks=nc,
                        sharded=rows, unsharded=plain_rows, peak_gb=peak,
                        unsharded_peak_gb=plain_peak, bitwise=bitwise,
                        max_rel_diff=diff[worst], worst=worst,
                        launches=launches)
    return launches


def _launch_serve(dev, seed, rules, out):
    """(b) sharded prefill against ``serve.prefill``; LAUNCH_DECODE
    ``jit_serve_step`` decode steps against ``greedy_decode``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import serve
    from repro_torch.launch.specs import decode_specs
    from repro_torch.models.transformer import Transformer, param_shapes

    cfg = get_config(LM_ARCH)
    B, S = LM_PREFILL
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 19)
    model = Transformer(cfg, seed=seed, device=dev)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
    want = serve.prefill(model, toks)
    prefill, _ = serve.jit_prefill(cfg, rules, param_shapes(cfg))
    params = serve.distribute_params(model, rules)
    prefill(params, toks)                                   # warm-up
    _sync(dev)
    _counts_reset()
    t = time.perf_counter()
    got = _local(prefill(params, toks))
    _sync(dev)
    prefill_ms = (time.perf_counter() - t) * 1e3
    launches = _counts()[0]
    plain_ms = wall_ms(lambda: serve.prefill(model, toks), 1)
    rtol, atol = TOL_FLASH["bfloat16"]
    within = bool(((got - want).abs() <= rtol * want.abs() + atol).all())
    same = bool(torch.equal(got, want))
    del got, want
    Bd, P, G = LAUNCH_DECODE
    prompts = torch.randint(0, cfg.vocab, (Bd, P), generator=gen,
                            device=dev).to(torch.int32)
    ref, ref_s = serve.greedy_decode(model, prompts, G)
    step, _ = serve.jit_serve_step(
        cfg, rules, param_shapes(cfg),
        decode_specs(cfg, ShapeConfig("decode", P + G, Bd, "decode")))
    state = serve.distribute_decode_state(model.init_decode_state(Bd, P + G),
                                          rules)
    tok, seq = prompts[:, :1], [prompts[:, :1]]
    _sync(dev)
    t = time.perf_counter()
    for i in range(P + G - 1):
        nxt, state = step(params, state, tok, i)
        tok = prompts[:, i + 1:i + 2] if i + 1 < P else _local(nxt)
        seq.append(tok)
    _sync(dev)
    dec_ms = (time.perf_counter() - t) * 1e3 / (P + G - 1)
    seq = torch.cat(seq, 1)
    equal = bool(torch.equal(seq, ref))
    say(f"  (b) sharded prefill B {B} × S {S}: {prefill_ms:.1f} ms (unsharded"
        f" {plain_ms:.1f} ms), logits {'bit for bit' if same else 'within'}"
        f" the bf16 limits ({rtol:g}·|x| + {atol:g}): {within}; "
        f"flash_attention {launches['flash_attention']} launches; "
        f"{P + G - 1} sharded decode steps at batch {Bd}: {dec_ms:.2f} ms a "
        f"step (unsharded {ref_s * 1e3 / (P + G - 1):.2f} ms), greedy "
        f"tokens equal: {equal}")
    check(within, "(b) sharded prefill logits within the bf16 limits of "
          "the unsharded prefill's")
    check(launches["flash_attention"] == cfg.n_layers,
          f"(b) the sharded prefill launched flash_attention once per layer "
          f"({launches['flash_attention']} == {cfg.n_layers})")
    check(equal, f"(b) {P + G - 1} sharded decode steps give the unsharded "
          "greedy tokens")
    out["serve"] = dict(prefill_ms=prefill_ms, unsharded_prefill_ms=plain_ms,
                        prefill_bitwise=same, decode_ms=dec_ms,
                        unsharded_decode_ms=ref_s * 1e3 / (P + G - 1),
                        tokens_equal=equal, launches=launches)
    del model, params, state
    torch.cuda.empty_cache()
    return launches


def _start_dryrun():
    """(c) one full-size dry-run cell, started in a subprocess on the host
    (a fake 256-rank group, meta shards) before the kernels build, so that
    it runs while nvcc does; a thread waits for it, DRYRUN_TIMEOUT seconds
    at most from its start, and notes its log and seconds (the process,
    its ledger, the thread, what the thread notes)."""
    import atexit
    import threading
    arch, shape, mesh = DRYRUN_CELL
    ledger = os.path.join(OUT, "dryrun.jsonl")
    if os.path.exists(ledger):
        os.remove(ledger)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH"))
        if p))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", mesh, "--ledger", ledger, "--force"],
        cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    done = {}

    def wait():
        try:
            done["log"], _ = proc.communicate(timeout=DRYRUN_TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            done["log"], _ = proc.communicate()
            done["timed_out"] = True
        done["seconds"] = time.perf_counter() - t0

    waiter = threading.Thread(target=wait, daemon=True)
    waiter.start()
    # a run that fails before phase 19 leaves no cell running
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, ledger, waiter, done


def _finish_dryrun(started, out):
    """(c) the cell's record: per-rank bytes, FLOPs, collectives and the
    dominant term; the peak must fit the card's memory.  A cell that ran
    past DRYRUN_TIMEOUT seconds from its start fails the run."""
    from repro_torch.launch.mesh import HBM_BYTES
    proc, ledger, waiter, done = started
    waiter.join()
    secs = done["seconds"]
    log = done["log"]
    with open(os.path.join(OUT, "dryrun.log"), "w") as fh:
        fh.write(log)
    if done.get("timed_out"):
        raise subprocess.TimeoutExpired(proc.args, DRYRUN_TIMEOUT, log)
    check(proc.returncode == 0 and os.path.exists(ledger),
          f"(c) the dry-run cell ran (exit {proc.returncode})")
    with open(ledger) as fh:
        rec = json.loads(fh.read().splitlines()[-1])
    check(rec["status"] == "ok", f"(c) the dry-run cell: {rec['status']}")
    say(f"  (c) dry run {rec['arch']} × {rec['shape']} × {rec['mesh']} "
        f"({secs:.1f} s from its start, traced {rec['trace_s']} s): per "
        f"rank arguments {rec['argument_bytes'] / 1e9:.3f} GB, peak "
        f"{rec['peak_bytes'] / 1e9:.3f} GB, {rec['flops_per_chip']:.4e} "
        f"FLOPs, {rec['n_collectives']} collectives "
        + json.dumps({k: f"{v / 1e9:.3f} GB"
                      for k, v in rec["collectives"].items()})
        + f"; t_compute {rec['t_compute_s'] * 1e3:.2f} ms, t_memory "
        f"{rec['t_memory_s'] * 1e3:.2f} ms, t_collective "
        f"{rec['t_collective_s'] * 1e3:.2f} ms → {rec['dominant']}; useful "
        f"{rec['useful_ratio']:.3f}")
    check(rec["peak_bytes"] < HBM_BYTES, f"(c) the rank's peak "
          f"{rec['peak_bytes'] / 1e9:.2f} GB fits the card's "
          f"{HBM_BYTES / 1e9:.0f} GB")
    check(0 < rec["useful_ratio"] <= 1,
          f"(c) useful_ratio {rec['useful_ratio']:.3f} in (0, 1]")
    out["dryrun"] = dict(rec, seconds=secs)


def launch_phase(dev, seed, out, started):
    """Phase 19: the sharded launch layer on a (1, 1, 1) pod/data/model
    mesh over the one-rank NCCL group — (a) the sharded train step, (b)
    sharded prefill and decode, (c) one full-size dry-run cell, the one
    ``_start_dryrun`` started (``started``)."""
    rules = _launch_mesh()
    res, total = {}, {}
    for name, fn in (("a", _launch_train), ("b", _launch_serve)):
        t = time.perf_counter()
        for k, v in fn(dev, seed, rules, res).items():
            total[k] = total.get(k, 0) + v
        say(f"  (19{name}) {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    _finish_dryrun(started, res)
    say(f"  (19c) waited {time.perf_counter() - t:.1f} s")
    out["launch_phase"] = res
    return total


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
KERNEL_ENTRIES = ("sell_spmv_kernel", "sell_spmv_lanes_kernel",
                  "panel_factor_kernel", "schur_kernel",
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
        m = re.match(r"(tc_kernel|simt_kernel)<(\d+)(?:, (\d+), (\d+))?"
                     r"(?:, (?:true|false))?>", e["name"])
        if m:
            # the f32 kernel's tile: thread rows x query rows a thread
            nbytes = _build.lib().flash_attention_smem(
                int(m.group(2)), int(m.group(1) == "tc_kernel"),
                int(m.group(3) or 0) * int(m.group(4) or 0))
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
    dryrun = _start_dryrun()           # phase 19 (c), on the host
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
                           n_graph=N_GRAPH, nl_theta=NL_THETA,
                           nl_tol=NL_TOL, nl_inner=NL_INNER, nl_dt=NL_DT,
                           ng_eig=NG_EIG, eig_k=EIG_K, eig_cy=EIG_CY,
                           eig_tol=EIG_TOL,
                           maxiter=MAXITER, seed=SEED,
                           flash_shapes=FLASH_SHAPES, flash_gqa=FLASH_GQA,
                           lm_arch=LM_ARCH,
                           lm_prefill=LM_PREFILL, lm_serve=LM_SERVE,
                           lm_check=LM_CHECK, lm_families=LM_FAMILIES,
                           lm_family_serve=LM_FAMILY_SERVE,
                           lm_local_check=LM_LOCAL_CHECK, batch_b=BATCH_B,
                           spmm_k=SPMM_K, stencil_b=STENCIL_B,
                           step_lanes=(STEP_B, STEP_N),
                           ng_batch_stencil=NG_BATCH_STENCIL,
                           ng_serve=NG_SERVE,
                           serve=(SERVE_REQUESTS, SERVE_MAX_BATCH),
                           lanes_direct=LANES_DIRECT,
                           lanes_precond=LANES_PRECOND,
                           ng_ilu_lanes=NG_ILU_LANES, ng_dist=NG_DIST,
                           dist_p=DIST_P, dist_iters=DIST_ITERS,
                           ng_dist_grad=NG_DIST_GRAD,
                           ng_dist_schwarz=NG_DIST_SCHWARZ,
                           ng_dist_schwarz_iters=NG_DIST_SCHWARZ_ITERS,
                           dist_schwarz_p=DIST_SCHWARZ_P,
                           ng_dist_eig=NG_DIST_EIG, flash_train=FLASH_TRAIN,
                           train_shape=TRAIN_SHAPE, train_steps=TRAIN_STEPS,
                           train_ce_chunks=TRAIN_CE_CHUNKS,
                           train_opt=TRAIN_OPT, train_grad=TRAIN_GRAD,
                           ft_steps=FT_STEPS))

    phases = []

    def phase(name, fn, *a):
        # free what earlier phases left in reference cycles, so a phase's
        # peak device memory is its own; what survives is frozen out of the
        # collector's later passes
        gc.collect()
        gc.freeze()
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
    amg = {}                           # the AMG path's poisson2d(1024)
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
            ("AMG path", amg_path,
             (dev, NG_BELL, N_GRAPH, TOL, MAXITER, out, amg)),
            ("GMRES / Chebyshev path", krylov_path,
             (dev, NG_TRANSPOSE, NG_BELL, TOL_TRANSPOSE, TOL, MAXITER,
              out)),
            ("nonlinear path", nonlinear_path, (dev, NG_BELL, SEED, out)),
            ("Newton direct path", newton_direct_path,
             (dev, NG_DIRECT, SEED, out)),
            ("eigen path", eigen_path, (dev, NG_EIG, SEED, out))):
        counts = phase(name, fn, *a)
        torch.cuda.empty_cache()
        for k, v in counts.items():
            path_launches[k] = path_launches.get(k, 0) + v
    # the panel kernels against their plain versions, on the direct path's
    # own analysis (its bucket shapes), after the paths' counts are read
    kres.update(phase("panel kernels", panel_kernel_phase, dev,
                      direct["art"], direct["val"], NG_DIRECT, SEED, out))
    direct_A = direct["A"]          # its cached plan serves phase 15c
    del direct
    kres.update(phase("flash kernel", flash_phase, dev, SEED, out))
    for k, v in phase("LM serving path", lm_path, dev, SEED, out).items():
        path_launches[k] = path_launches.get(k, 0) + v
    for k, v in phase("LM families (14b)", lm_families, dev, SEED,
                      out).items():
        path_launches[k] = path_launches.get(k, 0) + v
    bres, blaunch = phase("batched solves and the solve server", batch_phase,
                          dev, SEED, out, direct_A)
    kres.update(bres)
    for k, v in blaunch.items():
        path_launches[k] = path_launches.get(k, 0) + v
    bres, blaunch = phase("batched direct and preconditioned setups (15e)",
                          batched_setup_path, dev, SEED, out, direct_A,
                          amg.pop("A"))
    del direct_A
    kres.update(bres)
    for k, v in blaunch.items():
        path_launches[k] = path_launches.get(k, 0) + v
    # one NCCL group serves phases 16 and 19 (its first collective is slow)
    import torch.distributed as dist
    group = _dist_group()
    for k, v in phase("distributed path", distributed_path, dev, SEED,
                      out, group).items():
        path_launches[k] = path_launches.get(k, 0) + v
    for k, v in phase("LM training path (18)", train_phase, dev, SEED,
                      out).items():
        path_launches[k] = path_launches.get(k, 0) + v
    for k, v in phase("sharded launch path (19)", launch_phase, dev, SEED,
                      out, dryrun).items():
        path_launches[k] = path_launches.get(k, 0) + v
    dist.destroy_process_group()
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
    say(card)                          # again, beside the totals
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
