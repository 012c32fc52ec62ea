"""Find a cell and everything it names, by name, under the benchmark's root.

``BENCHMARK.json`` lists the cells; a cell names a configuration (its
``file``), a traffic mix (``bench/traffic/<traffic>.json``, whose ``kind``
names the module ``bench/kinds/<kind>.py`` that runs it) and is held to
the limits of ``bench/workloads/<cell>.json``.  A per-layer metric is read by
``bench/metrics/<metric>.py``, or, where no file has its whole name, by the
file of its name up to the first dot (``idle_share.step`` and
``idle_share.serve`` share ``idle_share.py``).  Adding a cell, a mix or a
metric adds files and entries; no file here changes."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path, tag: str):
    """Import one file by path (metric files carry dots in their names)."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(f"bench_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: every metric of
    ``BENCHMARK.json`` lists its cells, unless all report it."""
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, config_overrides: Optional[dict] = None,
              traffic_overrides: Optional[dict] = None) -> Cell:
    bm = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bm["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json "
                       f"(cells: {', '.join(sorted(cells))})")
    w = cells[name]
    configs = {c["name"]: c for c in bm["configs"]}
    config = dict(load_json(ROOT / configs[w["config"]]["file"]),
                  **(config_overrides or {}))
    traffic = dict(load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
                   **(traffic_overrides or {}))
    limits = load_json(BENCH / "workloads" / f"{name}.json")["limits"]
    return Cell(name, int(w["chips"]), config, traffic, limits,
                [m for m in bm["end_to_end"] if reports(m, name)],
                [m for m in bm["per_layer"] if reports(m, name)])


def kind_module(cell: Cell):
    """The module that runs the cell's traffic kind."""
    return load_module(BENCH / "kinds" / f"{cell.kind}.py",
                       f"kind_{cell.kind}")


def reader_path(metric: str) -> Path:
    """The file that reads ``metric``: its whole name, else its name up to
    the first dot."""
    whole = BENCH / "metrics" / f"{metric}.py"
    return whole if whole.is_file() else \
        BENCH / "metrics" / f"{metric.split('.', 1)[0]}.py"


def readers(cell: Cell) -> Dict[str, object]:
    return {m["name"]: load_module(reader_path(m["name"]), f"metric_{i}")
            for i, m in enumerate(cell.per_layer)}
