"""Median request latency from due time, over every request of the window."""
import numpy as np


def read(r):
    lat = r.get("serve", {}).get("latency_s")
    return float(np.percentile(lat, 50) * 1e3) if lat else None
