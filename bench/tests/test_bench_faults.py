"""Whole runs on the CPU at a small grid, past the look for a chip, with
the timed path sound and then broken underneath: ``correct`` must come out
true, then false for each fault the cell can have."""
import pytest
import torch

from _helpers import CELLS, run_small


def _half_left_out(x):
    """Half of the lanes left out, the mean of the rest in their place."""
    h = max(x.shape[0] // 2, 1)
    return torch.cat([x[:h], x[:h].mean(0, keepdim=True)
                      .expand((x.shape[0] - h,) + x.shape[1:])])


def _altered(x):
    """The first lane's answer altered by one per cent."""
    scale = torch.ones(x.shape[0], *([1] * (x.dim() - 1)), dtype=x.dtype)
    scale[0] = 1.01
    return x * scale


def _swapped(x):
    """The first two lanes' answers handed to each other's requests."""
    return x[[1, 0] + list(range(2, x.shape[0]))] if x.shape[0] > 1 else x


FAULTS = {"half_batch": _half_left_out, "altered": _altered,
          "swapped": _swapped}
APPLIES = {"vc1m_stencil_b8_grad": ("half_batch", "altered"),
           "vc1m_coo_grad": ("altered",),
           "vc1m_stencil_serve": ("half_batch", "altered", "swapped")}


def _break(monkeypatch, fault):
    from repro_torch import sla
    from repro_torch.launch.solve_serve import SolveServer
    bend = FAULTS[fault]
    solve = sla.solve

    def broken_solve(A, b, **kw):
        u = solve(A, b, **kw)
        return bend(u) if u.dim() > 1 else bend(u[None])[0]

    submit = SolveServer.submit_batch

    def broken_submit(self, requests):
        res = submit(self, requests)
        xs = bend(torch.stack([r.x for r in res]))
        return [r._replace(x=x) for r, x in zip(res, xs)]

    monkeypatch.setattr(sla, "solve", broken_solve)
    monkeypatch.setattr(SolveServer, "submit_batch", broken_submit)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    res = run_small(cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell, fault", [(c, f) for c in CELLS
                                         for f in APPLIES[c]])
def test_broken_run_is_not_correct(cell, fault, monkeypatch):
    _break(monkeypatch, fault)
    res = run_small(cell)
    assert not res["correct"], res["checks"]
