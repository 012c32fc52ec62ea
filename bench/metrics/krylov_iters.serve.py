"""Krylov iterations a wave, the slowest lane's (the CG step body's launch
count over the window, a dispatch)."""
from bench.harness import readings


def read(r):
    if not r.get("waves"):
        return None
    its = readings.cg_iterations(r["counters"]["launches"])
    return its / r["waves"] if its else None
