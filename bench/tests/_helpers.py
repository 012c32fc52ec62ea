"""Shared pieces of the benchmark's own tests (run with
``python -m pytest bench/tests``)."""
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCHMARK["workloads"]]

#: small sizes a CPU test run holds: the grid, and the mix's window
SMALL_GRID = 72
SMALL = {"closed_grad": {}, "open_serve": {"rate": 16.0, "sample_requests": 64}}


@contextlib.contextmanager
def general_dispatch():
    """At the test's small size the library would pick its dense or direct
    route for a general matrix; at the cell's size it picks the iterative
    one.  Keep the iterative route, as at the cell's size."""
    from repro_torch.core.options import options
    with options(dense_budget=0, direct_budget=0):
        yield


def run_small(cell_name, seed=2**33 + 5, seconds=1.0):
    """A whole run of the cell on the CPU at a small grid, past the check
    for a chip: set-up, window, comparison; returns the result object."""
    import torch
    from bench.harness import cell as _cell
    from bench.harness import runner
    c = _cell.load_cell(cell_name, config_overrides={"grid": SMALL_GRID})
    c.traffic.update(SMALL[c.kind])
    with general_dispatch():
        return runner.execute(c, seed, seconds, False, torch.device("cpu"),
                              time.perf_counter())
