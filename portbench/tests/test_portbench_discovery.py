"""BENCHMARK.json and the files it names: every cell finds its
configuration, traffic, op and metric readers by name, and the file keeps to
the rules of the format (names, units, keys, the cells each metric
lists, the check's time budget)."""

import json
import os
import re

import pytest

from portbench import harness, workload

from toy import PB, ROOT

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_files(cell):
    wl, cfg_entry = harness.find_cell(BENCH, cell)
    cfg = harness.load_json(ROOT, cfg_entry["file"])
    assert cfg["name"] == cfg_entry["name"] and cfg["reduced"] == cfg_entry["reduced"]
    assert cfg_entry["file"].startswith("portbench/configs/")
    traffic = harness.load_json(ROOT, f"portbench/traffic/{wl['traffic']}.json")
    assert callable(workload.load_op(ROOT, traffic["op"]).Op)
    assert wl["chips"] == 1 and len(wl["why"]) <= 200
    e2e = harness.cell_metrics(BENCH, cell, "end_to_end")
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.cell_metrics(BENCH, cell, "per_layer")


@pytest.mark.parametrize("name", [m["name"] for m in METRICS])
def test_metric_reader_and_entry(name):
    m = next(x for x in METRICS if x["name"] == name)
    assert NAME.match(name) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    reader = harness.load_reader(ROOT, name)
    assert callable(reader.read)
    if m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert (reader.LAYER, reader.MOVES) == (m["layer"], m["moves"])
        moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", CELLS)
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    else:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    if name.endswith("_roofline") or "_roofline." in name:
        assert m["unit"] == "%"


def test_names_unique_and_under_paths():
    names = [m["name"] for m in METRICS]
    assert len(set(names)) == len(names) and len(set(CELLS)) == len(CELLS)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for c in BENCH["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_every_file_under_paths_is_named_from_name_characters():
    for dirpath, _, files in os.walk(PB):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_check_fits_its_budget_with_24_cells():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
