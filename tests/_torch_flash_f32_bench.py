"""Variants of the f32 flash-attention kernel (``simt_kernel``,
``csrc/flash_attention.cu``) timed against each other on the card, and
the bf16 kernel (``tc_kernel``) against an earlier source.

    python3 tests/_torch_flash_f32_bench.py [--parent DIR]

Shapes (f32, numpy-free: q, k, v from a seeded torch generator on the
card): the LM's f32 check call (GQA B 2, S 128, H 32, K 8, d 64, causal),
the prefill layer in f32 (GQA B 4, S 4096, H 32, K 8, d 64, causal), and
``chip_smoke.py``'s f32 checking shapes in the (BH, S, d) form: (64, 2048,
2048, 64) causal and bidirectional, (2, 128, 256, 64) bidirectional.  For
each it prints the median device time (CUDA events, the variants taking
turns over five readings), the share of the f32 FMA bound (67 TFLOP/s,
4·d flops per kept (query, key) pair) and the largest distance from the
committed kernel's output; with ``ptxas -v``'s registers and spills of
each build.

Variants: ``committed`` (the tile :func:`f32_tile` picks), ``large`` and
``small`` (the 128- and 32-row tiles forced), ``one head`` (the picked rows
with one query head a block: no GQA sharing), ``64-row blocks`` and
``16-row blocks`` (builds whose large or small tile has 8 thread rows, 128
threads, instead of 16), ``mask every tile`` (a build that evaluates the
mask on every tile, not only on edge tiles) and, with ``--parent DIR`` (a
directory holding an earlier ``flash_attention.cu`` and ``common.cuh``),
``parent``.  With ``--parent``, the bf16 kernel too is timed against the
parent's at ``chip_smoke.py``'s bf16 shapes (the prefill layer (128,
4096, 4096, 64) causal and the ragged (24, 1000, 1000, 128) causal).
Needs one NVIDIA GPU; builds the variants with nvcc.
"""
import argparse
import ctypes
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_bench import (CSRC, build_variants, card, edit,  # noqa: E402
                          ev_ms, ptxas)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import f32_tile  # noqa: E402

PEAK = 67e12
# (label, B, S, T, H, K, d, causal); H = K = 1 is the (BH, S, d) form
SHAPES = (("f32 check GQA (7b)", 2, 128, 128, 32, 8, 64, True),
          ("f32 prefill GQA (7b')", 4, 4096, 4096, 32, 8, 64, True),
          ("f32 causal", 64, 2048, 2048, 1, 1, 64, True),
          ("f32 bidir", 64, 2048, 2048, 1, 1, 64, False),
          ("uneven f32", 2, 128, 256, 1, 1, 64, False))
BF16_SHAPES = (("prefill layer bf16 (7)", 128, 4096, 4096, 1, 1, 64, True),
               ("ragged bf16", 24, 1000, 1000, 1, 1, 128, True))


#: variant builds: (edit of the source, {rule's rows: the build's rows})
EDITS = {"64-row blocks": (("constexpr int kLargeTY = 16,",
                            "constexpr int kLargeTY = 8,"), {128: 64}),
         "16-row blocks": (("constexpr int kSmallTY = 16,",
                            "constexpr int kSmallTY = 8,"), {32: 16}),
         "mask every tile": (("const bool edge = k0 + kBK > T ||",
                              "const bool edge = true ||"), {})}


def variant_sources(parent):
    base = open(os.path.join(CSRC, "flash_attention.cu")).read()
    out = {"committed": (base, CSRC)}
    for name, ((old, new), _) in EDITS.items():
        out[name] = (edit(base, old, new), CSRC)
    if parent:
        out["parent"] = (open(os.path.join(parent, "flash_attention.cu"))
                         .read(), parent)
    return out


def _entry_ints(text, entry):
    """The int arguments of ``entry`` in a source's C interface: B, H, K,
    S, T, d, causal, then ``window`` and (f32) ``rows``, ``heads`` where
    that source has them."""
    sig = text[text.index(f"int {entry}("):]
    sig = sig[:sig.index(")")]
    return sig.count("int ") - 1         # the return type's int


def caller(name, lib, sms, text, bf16=False):
    entry = "flash_attention_bf16" if bf16 else "flash_attention_f32"
    fn = getattr(lib, entry)
    n_int = _entry_ints(text, entry)
    P, I, LP = _build._P, _build._I, _build._LP
    fn.argtypes = [P, P, P, P, LP] + [I] * n_int + [P]
    fn.restype = I

    def call(q, k, v, o, causal):
        B, S, H, d = q.shape
        T, K = k.shape[1], k.shape[2]
        strides = (ctypes.c_longlong * 9)(*(t.stride(i) for t in (q, k, v)
                                            for i in range(3)))
        rows, heads = f32_tile(B, H, K, S, sms)
        if name == "large":
            rows = 128
        elif name == "small":
            rows = 32
        elif name == "one head":
            heads = 1
        elif name in EDITS:
            rows = EDITS[name][1].get(rows, rows)
        # after causal: the window (0) and the f32 tile, where this source
        # takes them
        extra = ((0,)[:n_int - 7] if bf16 else
                 {7: (), 9: (rows, heads), 10: (0, rows, heads)}[n_int])
        _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), strides, B, H, K, S, T, d, int(causal),
                        *extra, torch.cuda.current_stream().cuda_stream),
                     name)
        return o
    return call


def time_shapes(shapes, calls, dtype, peak, sms, dev, gen):
    """Median device ms of each caller on each shape, in turns."""
    for label, B, S, T, H, K, d, causal in shapes:
        qkv = torch.randn((B, S, H + 2 * K, d), generator=gen, device=dev) \
            if S == T else None
        if qkv is not None:
            qkv = qkv.to(dtype)
            q, k, v = qkv[:, :, :H], qkv[:, :, H:H + K], qkv[:, :, H + K:]
        else:
            q = torch.randn((B, S, H, d), generator=gen, device=dev).to(dtype)
            k, v = (torch.randn((B, T, K, d), generator=gen,
                                device=dev).to(dtype) for _ in range(2))
        o = torch.empty((B, S, H, d), device=dev, dtype=dtype)
        want = calls["committed"](q, k, v, torch.empty_like(o),
                                  causal).float()
        diff = {}
        for name, c in calls.items():
            got = c(q, k, v, o, causal).float()
            diff[name] = float(((got - want).abs()
                                / (1 + want.abs())).max())
        pairs = (int(np.minimum(np.arange(S) + 1, T).sum()) if causal
                 else S * T)
        flops = 4 * B * H * d * pairs
        bound = flops / peak * 1e3
        reps = max(3, min(50, int(2e3 / max(bound, 1e-3) / 100)))
        t = {name: [] for name in calls}
        order = list(calls)
        for reading in range(5):
            for name in (order if reading % 2 == 0 else order[::-1]):
                t[name].append(ev_ms(lambda: calls[name](q, k, v, o, causal),
                                     reps))
        tile = (f"; tile {f32_tile(B, H, K, S, sms, d)}"
                if dtype == torch.float32 else "")
        print(f"{label} (B {B}, S {S}, T {T}, H {H}, K {K}, d {d}, "
              f"{'causal' if causal else 'bidir'}{tile}; bound "
              f"{bound:.5f} ms): " + "; ".join(
                  f"{name} {np.median(v):.4f} ms ({bound / np.median(v):.1%};"
                  f" Δ {diff[name]:.1e})" for name, v in t.items()),
              flush=True)
        del qkv, q, k, v, o, want
        torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    print(card(), flush=True)
    dev = torch.device("cuda")
    sources = variant_sources(args.parent)
    built = build_variants(sources)
    for k, (_, log) in built.items():
        print(f"ptxas {k}: " + "; ".join(ptxas(log, "simt_kernel")),
              flush=True)
    libs = {k: v[0] for k, v in built.items()}
    texts = {k: v[0] for k, v in sources.items()}
    for k in ("large", "small", "one head"):
        libs[k], texts[k] = libs["committed"], texts["committed"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    calls = {k: caller(k, lib, sms, texts[k]) for k, lib in libs.items()}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    time_shapes(SHAPES, calls, torch.float32, PEAK, sms, dev, gen)
    if args.parent:
        bf = {k: caller(k, libs[k], sms, texts[k], bf16=True)
              for k in ("committed", "parent")}
        time_shapes(BF16_SHAPES, bf, torch.bfloat16, 989e12, sms, dev, gen)


if __name__ == "__main__":
    main()
