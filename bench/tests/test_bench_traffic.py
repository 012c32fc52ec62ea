"""The traffic generators are deterministic for a seed and load every seed
alike."""
import numpy as np
import pytest
import torch

import _helpers  # noqa: F401  (puts the benchmark on the path)
from bench.harness import arrivals, inputs

FAMILY = {"modes": 8, "max_wavenumber": 5}


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 2**33 + 5])
def test_arrivals_deterministic_and_alike(seed):
    a = arrivals.poisson(3.0, 40.0, seed)
    b = arrivals.poisson(3.0, 40.0, seed)
    c = arrivals.poisson(3.0, 40.0, seed + 1)
    assert np.array_equal(a, b)
    assert len(a) == len(c) == arrivals.count(3.0, 40.0) == 120
    assert a[0] == 0.0 and np.all(np.diff(a) >= 0) and a[-1] < 40.0
    # the same gaps, in another order
    g = arrivals.gaps(3.0, 40.0)
    for due in (a, c):
        seen = np.append(np.diff(due), g.sum() - due[-1])
        assert np.allclose(np.sort(seen), np.sort(g), rtol=0, atol=1e-9)
    assert not np.array_equal(a, c)


def test_spread_is_a_permutation():
    s1 = arrivals.spread([0.3, 1.5], 50, 7)
    s2 = arrivals.spread([0.3, 1.5], 50, 8)
    assert np.allclose(np.sort(s1), np.sort(s2))
    assert s1.min() > 0.3 and s1.max() < 1.5


@pytest.mark.parametrize("seed", [3, 2**32 + 3])
def test_inputs_deterministic(seed):
    def make(s, k):
        g = inputs.generator("cpu", inputs.derive(s, "step", k))
        kap = inputs.kappa(g, 2, 24, FAMILY, 0.9, torch.float64, "cpu")
        f = inputs.rhs(g, "normal", 2, 24, torch.float64, "cpu")
        return kap, f
    k1, f1 = make(seed, 4)
    k2, f2 = make(seed, 4)
    k3, _ = make(seed, 5)
    assert torch.equal(k1, k2) and torch.equal(f1, f2)
    assert not torch.equal(k1, k3)
    assert not torch.equal(k1[0], k1[1])
    lo, hi = float(k1.min()), float(k1.max())
    assert np.exp(-0.9) - 1e-12 <= lo and hi <= np.exp(0.9) + 1e-12


def test_derive_streams_differ():
    s = 2**33 + 5
    seeds = {inputs.derive(s, st, i) for st in inputs.STREAMS
             for i in range(3)}
    assert len(seeds) == 3 * len(inputs.STREAMS)
    assert all(0 <= x < 2**63 for x in seeds)


def test_reservoir_is_seeded_and_bounded():
    from bench.harness.check import Reservoir
    picks = []
    for _ in range(2):
        r = Reservoir(3, 99)
        for k in range(40):
            r.offer(k, k)
        picks.append(sorted(i for i, _ in r.items))
    assert picks[0] == picks[1] and len(picks[0]) == 3


def test_serve_schedule_is_the_mix_s():
    """Every run of an open-loop cell meets the same schedule and
    amplitudes, whatever its seed; another order seed reorders them."""
    from bench.harness.cell import kind_module, load_cell
    c = load_cell("vc1m_stencil_serve")
    kind = kind_module(c)
    due, amps = kind.schedule(c.traffic, 51.0)
    due2, amps2 = kind.schedule(dict(c.traffic), 51.0)
    assert np.array_equal(due, due2) and np.array_equal(amps, amps2)
    other = dict(c.traffic, order_seed=c.traffic["order_seed"] + 1)
    due3, amps3 = kind.schedule(other, 51.0)
    assert not np.array_equal(due, due3)
    assert np.allclose(np.sort(amps), np.sort(amps3))
