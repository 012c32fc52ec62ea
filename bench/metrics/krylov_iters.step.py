"""Krylov iterations a step, forward and adjoint, the slowest lane's (the
CG step body's launch count over the window, a step)."""
from bench.harness import readings


def read(r):
    if not r.get("steps"):
        return None
    its = readings.cg_iterations(r["counters"]["launches"])
    return its / r["steps"] if its else None
