"""Helpers that the per-layer metric readers share.  A reader gets the
run's readings: the window's numbers, the program's counter deltas over the
window (``counters``), the benchmark's spans, the problem's sizes and, in a
traced run, the reduced trace of one more step or wave (``trace``)."""
from __future__ import annotations

from typing import Optional

from bench.yardstick import peaks, traffic

#: the CG step bodies that run once an iteration (merged recurrence with a
#: diagonal preconditioner, or the partial fusion without one)
CG_BODIES = ("fused_cg_update", "fused_cg_halfstep")


def cg_iterations(launches: dict) -> int:
    """Krylov iterations run (the slowest lane's, plus the few bodies a
    loop runs before the host sees that every lane is done)."""
    return sum(launches.get(b, 0) + launches.get(b + "_batched", 0)
               for b in CG_BODIES)


def kernel_seconds(trace: dict, *needles: str) -> float:
    return sum(s for name, s in trace["kernel_s"].items()
               if any(nd in name for nd in needles))


def stencil5_roofline(r: dict) -> Optional[float]:
    t = r.get("trace")
    if not t:
        return None
    p, la = r["problem"], t["counters"]["launches"]
    nbytes = (la.get("stencil5", 0)
              * traffic.stencil5_bytes(p["n"], 1, p["itemsize"])
              + la.get("stencil5_batched", 0)
              * traffic.stencil5_bytes(p["n"], t["lanes"], p["itemsize"]))
    secs = kernel_seconds(t, "stencil5_kernel")
    if not nbytes or not secs:
        return None
    return traffic.roofline_share(nbytes, secs, peaks.HBM_BYTES_PER_S)


def cg_body_roofline(r: dict) -> Optional[float]:
    t = r.get("trace")
    if not t:
        return None
    p, la = r["problem"], t["counters"]["launches"]
    nbytes = 0
    for body in traffic.BODY_VECTORS:
        nbytes += la.get(body, 0) * traffic.body_bytes(
            body, p["n"], 1, p["itemsize"])
        nbytes += la.get(body + "_batched", 0) * traffic.body_bytes(
            body, p["n"], t["lanes"], p["itemsize"])
    secs = kernel_seconds(t, "step_kernel", "finish_kernel")
    if not nbytes or not secs:
        return None
    return traffic.roofline_share(nbytes, secs, peaks.HBM_BYTES_PER_S)


def idle_share(r: dict) -> Optional[float]:
    t = r.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def pcg_bytes(r: dict) -> int:
    p = r["problem"]
    return traffic.pcg_iteration_bytes(p["layout"], p["ng"], p["itemsize"])
