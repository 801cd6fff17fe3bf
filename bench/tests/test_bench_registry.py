"""Every cell, configuration and metric of BENCHMARK.json is found from
its own file, and the file keeps to the rules of its format (names,
units, sources, bounds, which cells report what)."""
from __future__ import annotations

import ast
import importlib
import json
import re

import pytest

from bench.harness import common

SPEC = json.loads((common.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
# cells and readers kept as files that BENCHMARK.json does not list (yet)
UNLISTED_CELLS = sorted(p.stem for p in (common.BENCH / "workloads").glob(
    "*.json") if p.stem not in CELLS)
UNLISTED_METRICS = sorted(
    p.stem for p in (common.BENCH / "metrics").glob("*.py")
    if p.stem not in {m["name"] for m in SPEC["per_layer"]})


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"]
    assert SPEC["command"][1] == "bench/run.py"
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_found_from_its_file(cfg):
    assert NAME.match(cfg["name"])
    data = json.loads((common.ROOT / cfg["file"]).read_text())
    assert cfg["file"] == f"bench/configs/{cfg['name']}.json"
    assert data["name"] == cfg["name"]
    for key in cfg["reduced"]:
        assert NAME.match(key) and key in data["reduced"]
    assert any(w["config"] == cfg["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_from_its_file(cell):
    entry = next(w for w in SPEC["workloads"] if w["name"] == cell)
    assert NAME.match(cell) and entry["chips"] == 1
    assert 1 <= len(entry["why"]) <= 200
    wl = common.load_json("workloads", cell)
    assert wl["name"] == cell and wl["config"] == entry["config"]
    importlib.import_module(f"bench.loops.{wl['loop']}")
    common.load_json("configs", entry["config"])


@pytest.mark.parametrize("cell", UNLISTED_CELLS)
def test_unlisted_cell_found_from_its_file(cell):
    """A workload file not listed yet names its loop, its configuration
    and limits for only the numbers its loop compares."""
    wl = common.load_json("workloads", cell)
    assert NAME.match(cell) and wl["name"] == cell
    loop = importlib.import_module(f"bench.loops.{wl['loop']}")
    common.load_json("configs", wl["config"])
    src = ast.parse(open(loop.__file__).read())
    strings = {n.value for n in ast.walk(src)
               if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    assert wl["limits"] and set(wl["limits"]) <= strings


@pytest.mark.parametrize("metric", UNLISTED_METRICS)
def test_unlisted_metric_reader_loads(metric):
    assert NAME.match(metric)
    assert callable(common.load_module("metrics", metric).read)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_setup_another_and_a_layer(cell):
    e2e = [m["name"] for m in SPEC["end_to_end"]
           if cell in m.get("workloads", [cell])]
    layer = [m for m in SPEC["per_layer"]
             if cell in m.get("workloads", [cell])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert layer
    for m in layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_metric_found_from_its_reader(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["source"] in ("device_trace", "program_span",
                                "program_counter", "host_clock")
    reader = common.load_module("metrics", metric["name"])
    assert callable(reader.read)
    for cell in metric.get("workloads", []):
        assert cell in CELLS


@pytest.mark.parametrize("metric", SPEC["end_to_end"],
                         ids=lambda m: m["name"])
def test_end_to_end_metric(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25
    assert metric["better"] in ("lower", "higher")


def test_names_are_unique_and_files_named_from_names():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    assert len(CELLS) == len(set(CELLS))
    for path in (common.BENCH).rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(common.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_limits_cover_every_check():
    """A workload's limits name only numbers its loop compares."""
    for cell in CELLS:
        wl = common.load_json("workloads", cell)
        loop = importlib.import_module(f"bench.loops.{wl['loop']}")
        src = ast.parse(open(loop.__file__).read())
        strings = {n.value for n in ast.walk(src)
                   if isinstance(n, ast.Constant) and isinstance(n.value, str)}
        assert set(wl["limits"]) <= strings, cell
