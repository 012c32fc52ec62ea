"""Every file the benchmark finds by name is there and parses, and
``BENCHMARK.json`` keeps to its required shape."""
import json
import re

import pytest

from _helpers import BENCHMARK, CELLS, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCHMARK["end_to_end"] + BENCHMARK["per_layer"]


def test_top_level_keys():
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs",
                              "workloads", "end_to_end", "per_layer"}
    assert BENCHMARK["paths"] == ["bench"]
    assert 1 <= BENCHMARK["run_seconds"] <= 51
    n = 24
    total = (2 + 14 * n) * (BENCHMARK["run_seconds"] + 60) + n * 180 + 1200
    assert total <= 43200
    assert len(json.dumps(BENCHMARK)) < 64 * 1024


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_shape(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
    for c in metric.get("workloads", []):
        assert c in CELLS


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports(cell):
    from bench.harness.cell import load_cell
    c = load_cell(cell)
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names, (m["name"], m["moves"])
    assert (ROOT / "bench" / "kinds" / f"{c.kind}.py").is_file()
    assert c.limits and all(v > 0 for v in c.limits.values())


@pytest.mark.parametrize("metric", BENCHMARK["per_layer"],
                         ids=lambda m: m["name"])
def test_reader_exists(metric):
    from bench.harness.cell import load_module, reader_path
    mod = load_module(reader_path(metric["name"]), "t")
    assert callable(mod.read)


def test_every_reader_file_is_used():
    from bench.harness.cell import BENCH, reader_path
    used = {reader_path(m["name"]).name for m in BENCHMARK["per_layer"]}
    assert {p.name for p in (BENCH / "metrics").glob("*.py")} == used


@pytest.mark.parametrize("config", BENCHMARK["configs"],
                         ids=lambda c: c["name"])
def test_config_file(config):
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["name"] == config["name"]
    assert data["source"] == config["source"]
    assert data["reduced"] == config["reduced"] == []
    assert data["dtype"] == "float64" and data["grid"] == 1000
    assert data["solver"]["maxiter"] == 20000
    assert any(w["config"] == config["name"] for w in BENCHMARK["workloads"])


def test_names_and_text_fields():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCHMARK[group]]
        assert len(set(names)) == len(names)
        for e in BENCHMARK[group]:
            assert NAME.match(e["name"])
            texts = [e[k] for k in ("why", "layer") if k in e]
            if group == "configs":
                texts.append(e["source"])
            for v in texts:
                assert 1 <= len(v) <= 200 and "\n" not in v \
                    and "\t" not in v
    pairs = [(w["config"], w["traffic"]) for w in BENCHMARK["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert all(w["chips"] == 1 for w in BENCHMARK["workloads"])
