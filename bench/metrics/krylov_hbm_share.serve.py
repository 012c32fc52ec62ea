"""The bytes the requests' own Jacobi-PCG iterations must move (the matrix
and the textbook iteration's vectors once each) over the time inside
``submit_batch`` at the card's published HBM rate."""
from bench.harness import readings
from bench.yardstick import peaks, traffic


def read(r):
    s = r.get("serve")
    if not s or not s["useful_iters"] or not s["inside_s"]:
        return None
    return traffic.roofline_share(s["useful_iters"] * readings.pcg_bytes(r),
                                  s["inside_s"], peaks.HBM_BYTES_PER_S)
