"""The 5-point kernels' share of their bytes bound: each launch's planes
and x read and y written once, over their device time in the trace."""
from bench.harness import readings


def read(r):
    return readings.stencil5_roofline(r)
