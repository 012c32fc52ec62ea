"""The control: the program's own float32 path in place of the float64 one
the configurations state, run at each cell's own size on three seeds, must
come out not correct.  Needs the card (``-m cuda``); it prints each
reading, from which ``bench/workloads/<cell>.json`` takes its upper one.

    python -m pytest -s -p no:cacheprovider bench/tests/test_bench_control.py
"""
import json
import time

import pytest

from _helpers import CELLS

SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)
#: a short window at the cell's own load: one step, or some tens of
#: requests (each mix's sample and its slowest request compared)
SECONDS = {"closed_grad": 1.0, "open_serve": 8.0}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's "
                    "size on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_float32_control_fails(cell, card):
    import torch
    from bench.harness import cell as _cell
    from bench.harness import runner
    c = _cell.load_cell(cell)
    correct = []
    for seed in SEEDS:
        res = runner.execute(c, seed, SECONDS[c.kind], False, card,
                             time.perf_counter(),
                             program_dtype=torch.float32)
        print(json.dumps({"control": cell, "seed": seed,
                          "checks": res["checks"],
                          "failed": res["failed"]}), flush=True)
        correct.append(res["correct"])
    assert not any(correct)
