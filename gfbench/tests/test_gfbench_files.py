"""BENCHMARK.json against the contract's form, and every cell's files found
by name."""

import json
import re
from pathlib import Path

import pytest

from gfbench import harness

BENCH = json.loads((harness.CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_has_the_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gfbench"]
    assert BENCH["command"] == ["python3", "gfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("gfbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    assert len((harness.CHECKOUT / "BENCHMARK.json").read_bytes()) < 65536


def test_names_and_units_use_the_allowed_characters():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    names += [w["config"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [r for c in BENCH["configs"] for r in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    assert len(set(x["name"] for x in BENCH["end_to_end"]
                   + BENCH["per_layer"])) == len(BENCH["end_to_end"]
                                                 + BENCH["per_layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"]
        assert "\t" not in x["why"]
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200


def test_every_file_name_under_paths_is_made_of_a_name():
    for path in (harness.ROOT).rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(harness.CHECKOUT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files_by_name(name):
    files = harness.cell(name)
    w = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert files["cell"]["config"] == w["config"]
    assert files["cell"]["traffic"] == w["traffic"]
    assert files["cell"]["chips"] == w["chips"]
    assert hasattr(files["kind"], "Session")
    cfg = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert json.loads((harness.CHECKOUT / cfg["file"]).read_text()) \
        == files["config"]
    for trace in (False, True):
        names = harness.metric_names(BENCH, name, trace)
        assert names
        for m in names:
            reader = harness.load_module(harness.ROOT / "metrics"
                                         / f"{m}.py")
            assert callable(reader.read)
    assert "setup_s" in harness.metric_names(BENCH, name, False)
    assert files["cell"]["limits"]


def test_every_metric_moves_an_end_to_end_metric_its_cells_report():
    for m in BENCH["per_layer"]:
        moved = next(e for e in BENCH["end_to_end"]
                     if e["name"] == m["moves"])
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", CELLS)
