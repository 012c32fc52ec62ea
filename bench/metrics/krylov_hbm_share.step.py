"""The bytes the window's Jacobi-PCG iterations must move (the matrix and
the textbook iteration's vectors once each, every lane) over the window at
the card's published HBM rate."""
from bench.harness import readings
from bench.yardstick import peaks, traffic


def read(r):
    its = readings.cg_iterations(r["counters"]["launches"])
    if not its:
        return None
    nbytes = its * r["problem"]["lanes"] * readings.pcg_bytes(r)
    return traffic.roofline_share(nbytes, r["window_s"],
                                  peaks.HBM_BYTES_PER_S)
