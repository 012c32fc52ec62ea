"""Open-loop schedules that load every seed alike.

The number of requests and the multiset of inter-arrival gaps depend only
on the rate and the window; a seed only orders them.  The gaps are the
exponential distribution's quantiles at evenly spaced levels, scaled to
fill the window, so any order offers the same Poisson-like load and the
same work.  A cell takes the order's seed from its mix, not from the run's
``--seed``, so that every run meets the same bursts."""
from __future__ import annotations

import numpy as np


def count(rate: float, seconds: float) -> int:
    return max(1, int(round(rate * seconds)))


def gaps(rate: float, seconds: float) -> np.ndarray:
    """The inter-arrival gaps, unordered: exponential quantiles at evenly
    spaced levels, scaled so that they add up to just under ``seconds``."""
    n = count(rate, seconds)
    levels = (np.arange(n) + 0.5) / n
    g = -np.log1p(-levels) / rate
    return g * (seconds * (n - 0.5) / n / g.sum())


def poisson(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times (s from the window's start) of ``count(rate, seconds)``
    requests, sorted, the first at 0: the gaps in a seeded order."""
    g = np.random.default_rng(seed).permutation(gaps(rate, seconds))
    return np.concatenate([[0.0], np.cumsum(g[:-1])])


def spread(bounds, n: int, seed: int) -> np.ndarray:
    """``n`` values spread evenly over [low, high], in a seeded order."""
    low, high = bounds
    vals = low + (high - low) * (np.arange(n) + 0.5) / n
    return np.random.default_rng(seed).permutation(vals)
