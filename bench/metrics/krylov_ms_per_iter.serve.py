"""Time inside ``submit_batch`` over the Krylov iterations of the window's
waves (the idle time between waves left out)."""
from bench.harness import readings


def read(r):
    its = readings.cg_iterations(r["counters"]["launches"])
    s = r.get("serve")
    return s["inside_s"] * 1e3 / its if its and s else None
