"""The window over the Krylov iterations it ran: a step's whole time
(assembly and gradient included) a forward or adjoint iteration."""
from bench.harness import readings


def read(r):
    its = readings.cg_iterations(r["counters"]["launches"])
    return r["window_s"] * 1e3 / its if its else None
