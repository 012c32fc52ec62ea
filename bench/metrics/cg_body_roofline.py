"""The fused CG bodies' share of their bytes bound: each launch's vectors
read and written once, over the device time of the body kernels and their
reduction passes in the trace."""
from bench.harness import readings


def read(r):
    return readings.cg_body_roofline(r)
