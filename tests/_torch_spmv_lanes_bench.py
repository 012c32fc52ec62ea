"""Variants of the lane-batched sliced-ELL kernel (``sell_spmv_lanes_kernel``,
``csrc/spmv_bell.cu``) timed against each other on the card.

    python3 tests/_torch_spmv_lanes_bench.py [--parent DIR]

On ``poisson2d(1024)`` f64 (numpy seed 0) it times, for B = 1, 2, 4, 5, 8,
15, 16, 20 and 32, B value arrays times B right-hand sides (``bell_spmv_batched``),
B value arrays times one x, and one value array times k = B right-hand
sides (``bell_spmm``), in every variant below, and prints the median
device time (CUDA events, 20 launches a reading, the variants taking turns
over five readings), the bytes the call must move, the rate and the share
of the 3.35 TB/s bound, and each variant's registers and spills from
``ptxas -v``.  Every variant's output must equal the committed kernel's bit
for bit (each lane sums the same slots in the same order).

Variants (text edits of the committed source, built side by side):
``committed``; ``evict-first hints`` (values and columns loaded with no
L1 allocation and an L2 evict-first policy); ``x evict-last`` (the x
gathers with an L2 evict-last policy); ``half groups`` and ``double groups`` (half and
twice the slots whose loads a thread starts before its multiply-adds);
``noinline rest`` (the chunks smaller than the largest in a function of
their own, not inlined into the kernel); ``hoisted x`` (per-lane x
pointers computed once a thread); ``per-size launches`` (a build with no
smaller-chunk bodies, launched once per chunk size); ``4-lane chunks``
(the committed library launched for 4-lane chunks where it picks 8-lane
ones); and, with ``--parent DIR`` (a directory holding an earlier
``spmv_bell.cu`` and ``common.cuh``), ``parent``.  The single-vector
kernel (``bell_spmv``) is timed beside them for scale.  Needs one NVIDIA
GPU; builds the variants with nvcc.
"""
import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_bench import (CSRC, build_variants, card, edit,  # noqa: E402
                          ev_ms, ptxas)
from repro_torch.core.sparse import bell_to_device, build_bell  # noqa: E402
from repro_torch.data.poisson import poisson2d_arrays  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.spmv_bell import bell_spmv, lane_chunks  # noqa: E402

HBM = 3.35e12
NG = 1024
LANES = (1, 2, 4, 5, 8, 15, 16, 20, 32)


def variant_sources(parent):
    base = open(os.path.join(CSRC, "spmv_bell.cu")).read()
    keep = ('__device__ __forceinline__ double ld_keep(const double* p) {\n'
            '  uint64_t pol; double v;\n'
            '  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" '
            ': "=l"(pol));\n'
            '  asm volatile("ld.global.nc.L2::cache_hint.f64 %0, [%1], %2;" '
            ': "=d"(v) : "l"(p), "l"(pol));\n  return v;\n}\n'
            '__device__ __forceinline__ float ld_keep(const float* p) {\n'
            '  uint64_t pol; float v;\n'
            '  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" '
            ': "=l"(pol));\n'
            '  asm volatile("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;" '
            ': "=f"(v) : "l"(p), "l"(pol));\n  return v;\n}\n')
    group = ("constexpr int kGroupSlots = (kBoth ? 16 : 8) / NL < 8 ? "
             "(kBoth ? 16 : 8) / NL : 8;")
    hints = ('__device__ __forceinline__ uint64_t evict_first() {\n'
             '  uint64_t pol;\n'
             '  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" '
             ': "=l"(pol));\n  return pol;\n}\n'
             + "".join(
                 f'__device__ __forceinline__ {t} ld_once(const {t}* p) {{\n'
                 f'  {t} v;\n  asm volatile("ld.global.nc.L1::no_allocate.'
                 f'L2::cache_hint.{s} %0, [%1], %2;" : "={r}"(v) : "l"(p), '
                 f'"l"(evict_first()));\n  return v;\n}}\n'
                 for t, s, r in (("int32_t", "s32", "r"), ("float", "f32", "f"),
                                 ("double", "f64", "d"))))
    out = {"committed": base,
           "evict-first hints": edit(
               edit(edit(base, "// slots a thread loads",
                         hints + "\n// slots a thread loads"),
                    "c[u] = __ldg(cp + 32 * (j + u));",
                    "c[u] = ld_once(cp + 32 * (j + u));"),
               "v[u][l] = __ldg(vp + l * val_stride + 32 * (j + u));",
               "v[u][l] = ld_once(vp + l * val_stride + 32 * (j + u));"),
           "x evict-last": edit(
               edit(base, "// slots a thread loads", keep
                    + "\n// slots a thread loads"),
               "__ldg(x + l * x_stride + c[u])",
               "ld_keep(x + l * x_stride + c[u])"),
           "half groups": edit(base, group, "constexpr int kGroupSlots = "
                               "((kBoth ? 8 : 4) + NL - 1) / NL;"),
           "double groups": edit(base, group,
                                 "constexpr int kGroupSlots = (kBoth ? 32 : "
                                 "16) / NL < 16 ? (kBoth ? 32 : 16) / NL : "
                                 "16;"),
           "noinline rest": edit(base, "__device__ __forceinline__ void "
                                 "rest_chunk(", "__device__ __noinline__ "
                                 "void rest_chunk("),
           "hoisted x": edit(
               edit(base, "  const T* vp = vals + sp0 + lane;\n",
                    "  const T* vp = vals + sp0 + lane;\n  const T* xl[NX];\n"
                    "#pragma unroll\n  for (int l = 0; l < NX; ++l) xl[l] = "
                    "x + l * x_stride;\n"),
               "__ldg(x + l * x_stride + c[u])", "__ldg(xl[l] + c[u])"),
           "per-size launches": edit(
               base, "  else\n    rest_chunk<T, NL / 2,",
               "  else if (false)\n    rest_chunk<T, NL / 2,")}
    if parent:
        out["parent"] = open(os.path.join(parent, "spmv_bell.cu")).read()
    return {k: (v, parent if k == "parent" else CSRC) for k, v in out.items()}


def caller(name, lib, sell, n):
    """fn(vals, x, lanes, val_stride, x_stride) -> y for one variant."""
    sig = [_build._P] * 5 + [_build._L, _build._I] + (
        [] if name == "parent" else [_build._I]) + [_build._L, _build._L,
                                                    _build._P]
    fn = lib.bell_spmv_lanes_f64
    fn.argtypes, fn.restype = sig, _build._I

    def call(vals, x, lanes, vs, xs, y):
        st = torch.cuda.current_stream().cuda_stream
        # the parent takes no chunk; "4-lane chunks" builds the kernel for
        # 4-lane chunks where the committed launch picks 8
        chunk = () if name == "parent" else (
            min(lane_chunks(lanes)[0][0], 4 if name == "4-lane chunks"
                else 8),)
        if name != "per-size launches":
            _build.check(fn(sell.slice_ptr.data_ptr(), sell.cols.data_ptr(),
                            vals.data_ptr(), x.data_ptr(), y.data_ptr(), n,
                            lanes, *chunk, vs, xs, st), name)
            return y
        b0 = 0
        for size, count in lane_chunks(lanes):
            _build.check(fn(sell.slice_ptr.data_ptr(), sell.cols.data_ptr(),
                            vals.data_ptr() + 8 * b0 * vs,
                            x.data_ptr() + 8 * b0 * xs,
                            y.data_ptr() + 8 * b0 * n, n, size * count, size,
                            vs, xs, st), name)
            b0 += size * count
        return y
    return call


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    print(card(), flush=True)
    dev = torch.device("cuda")
    built = build_variants(variant_sources(args.parent))
    libs = {k: v[0] for k, v in built.items()}
    libs["4-lane chunks"] = libs["committed"]
    for k, (_, log) in built.items():
        print(f"ptxas {k}: " + "; ".join(
            ptxas(log, "sell_spmv_lanes_kernel")), flush=True)

    val, row, col = poisson2d_arrays(NG)
    n, nnz = NG * NG, len(val)
    sell = bell_to_device(build_bell(row, col, (n, n)), dev).sell
    rng = np.random.default_rng(0)
    bmax = max(LANES)
    V = torch.tensor(val[None] * rng.uniform(0.7, 1.4, (bmax, 1)), device=dev)
    packed = ops.sell_assemble(sell, V)
    p0 = packed[0].contiguous()
    X = torch.tensor(rng.normal(size=(bmax, n)), device=dev)
    ns = sell.n_slots
    calls = {k: caller(k, lib, sell, n) for k, lib in libs.items()}
    x0 = X[0].contiguous()
    one = ev_ms(lambda: bell_spmv(sell, p0, x0, n), 50)
    b1 = (ns * 12 + sell.slice_ptr.numel() * 8 + 2 * n * 8) / HBM * 1e3
    print(f"bell_spmv (single vector): {one:.4f} ms, bound {b1:.4f} ms "
          f"({b1 / one:.0%})", flush=True)
    pattern = ns * 4 + sell.slice_ptr.numel() * 8
    for layout in ("values", "shared x", "spmm"):
        for B in LANES:
            y = torch.empty(B, n, dtype=torch.float64, device=dev)
            if layout == "values":
                args_ = (packed[:B], X[:B], B, ns, n)
                nbytes = B * ns * 8 + pattern + 2 * B * n * 8
            elif layout == "shared x":
                args_ = (packed[:B], x0, B, ns, 0)
                nbytes = B * ns * 8 + pattern + n * 8 + B * n * 8
            else:
                args_ = (p0, X[:B], B, 0, n)
                nbytes = ns * 8 + pattern + 2 * B * n * 8
            want = calls["committed"](*args_, torch.empty_like(y)).clone()
            same = {k: torch.equal(c(*args_, y), want)
                    for k, c in calls.items()}
            t = {k: [] for k in calls}
            order = list(calls)
            for reading in range(5):
                for k in (order if reading % 2 == 0 else order[::-1]):
                    t[k].append(ev_ms(lambda: calls[k](*args_, y), 20))
            bound = nbytes / HBM * 1e3
            print(f"{layout:8s} B={B:2d} ({nbytes / 1e6:.1f} MB, bound "
                  f"{bound:.4f} ms): " + "; ".join(
                      f"{k} {np.median(v):.4f} ms ({bound / np.median(v):.0%}"
                      f", {nbytes / np.median(v) / 1e6:.0f} GB/s"
                      f"{'' if same[k] else ', DIFFERS'})"
                      for k, v in t.items()), flush=True)
            if not all(same.values()):
                sys.exit(f"a variant differs from the committed kernel: "
                         f"{[k for k, v in same.items() if not v]}")
            del y, want


if __name__ == "__main__":
    main()
