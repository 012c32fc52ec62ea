"""k right-hand sides on a one-lane MG / AMG preconditioner state: one
V-cycle over the (k, n) rows against one V-cycle per row, on the card.

    python3 tests/_torch_vcycle_bench.py

AMG on ``poisson2d(1024)``, MG on ``poisson2d_vc`` with κ = 1 + U[0, 1) at
ng = 2048 (numpy seed 0), k = 1, 6 and 12 rows.  For each it prints the
median device time (CUDA events, 10 applies a reading, four readings a
side, the two sides alternating), the host wall, the kernel launches of one
apply and the largest relative difference between the two results.  Needs
one NVIDIA GPU; builds the kernels on first use.
"""
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.core.precond import PreconditionerPlan  # noqa: E402
from repro_torch.data.poisson import poisson2d, poisson2d_vc  # noqa: E402
from repro_torch.kernels import (launch_counts,  # noqa: E402
                                 reset_launch_counts)


def ev_ms(fn, reps=10):
    """(device ms, host wall ms) of one ``fn`` call, over ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps, (time.perf_counter() - t) / reps * 1e3


def launches(fn):
    reset_launch_counts()
    fn()
    torch.cuda.synchronize()
    return sum(launch_counts().values())


def main():
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for name in ("amg", "mg"):
        A = poisson2d(1024, device=dev) if name == "amg" else poisson2d_vc(
            torch.tensor(1.0 + rng.random((2048, 2048)), device=dev),
            use_stencil_kernel=True, device=dev)
        t = time.perf_counter()
        pre = PreconditionerPlan(name, A.row, A.col, A.shape,
                                 stencil=A.stencil)
        M = pre.make_apply(pre.refresh_state(A, None), None)
        print(f"{name}: setup {time.perf_counter() - t:.1f} s", flush=True)
        for k in (1, 6, 12):
            R = torch.tensor(rng.normal(size=(k, A.shape[0])), device=dev)
            sides = {"one V-cycle": lambda: M(R),
                     "a V-cycle per row": lambda: torch.stack([M(r)
                                                               for r in R])}
            n = {s: launches(fn) for s, fn in sides.items()}
            want = sides["a V-cycle per row"]()
            err = float((sides["one V-cycle"]() - want).abs().max()
                        / want.abs().max())
            got = {s: [] for s in sides}
            for reading in range(4):
                order = list(sides) if reading % 2 == 0 else list(sides)[::-1]
                for s in order:
                    got[s].append(ev_ms(sides[s]))
            print(f"{name} k={k}: " + "; ".join(
                f"{s} {np.median([d for d, _ in got[s]]):.3f} ms device / "
                f"{np.median([w for _, w in got[s]]):.3f} ms wall "
                f"({n[s]} launches)" for s in sides)
                + f"; rel diff {err:.2e}", flush=True)
        del M, pre, A
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
