"""BENCHMARK.json and the files it names: every cell finds its
configuration, traffic, op and metric readers by name, and the file keeps to
the rules of the format (names, units, keys, the cells each metric
lists, the cards each cell asks for, the check's time budget); a cell whose
configuration names another count of cards than its `chips` is refused
before anything is built."""

import json
import os
import re
import time

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
    assert wl["chips"] in (1, 4) and len(harness.cell_cards(cfg)) == wl["chips"]
    assert len(wl["why"]) <= 200
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


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    four = [w["name"] for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(CELLS) // 4), four


@pytest.mark.parametrize("cfg,cards", [
    ({"deployment": "local", "device": "cuda"}, [0]),
    ({"deployment": "local", "device": "cuda:2"}, [2]),
    ({"deployment": "local", "device": "cpu"}, []),
    ({"deployment": "threshold", "cofhe_devices": ["cuda"] * 3, "compute_device": "cuda",
      "client_device": "cuda", "setup_device": "host"}, [0]),
    ({"deployment": "threshold", "cofhe_devices": ["cuda:1", "cuda:2", "cuda:3"],
      "compute_device": "cuda", "client_device": "cuda:0", "setup_device": "host"},
     [0, 1, 2, 3]),
    ({"deployment": "threshold", "cofhe_devices": ["cuda:3", "cuda:1", "cuda:1"],
      "compute_device": "cuda:0", "client_device": "cpu", "setup_device": "cuda:2"},
     [0, 1, 2, 3]),
    ({"deployment": "threshold", "cofhe_devices": ["cpu"] * 3, "compute_device": "cpu",
      "client_device": "cpu", "setup_device": "host"}, []),
])
def test_cell_cards(cfg, cards):
    assert harness.cell_cards(cfg) == cards


@pytest.mark.parametrize("device", ["gpu", "cuda:x", "cuda:-1", "tpu:0"])
def test_cell_cards_refuses_a_device_it_cannot_read(device):
    with pytest.raises(ValueError, match="none of"):
        harness.cell_cards({"deployment": "local", "device": device})


def _tree(root, devices: dict, chips: int) -> str:
    """A benchmark tree of one threshold cell on `devices` asking for `chips`."""
    cfg = {"deployment": "threshold", "setup_device": "host", "p": "0x7", "k": 32, **devices}
    files = {"portbench/configs/net.json": cfg, "portbench/traffic/d.json": {"op": "decrypt"},
             "BENCHMARK.json": {**BENCH,
                                "configs": [{"name": "net", "file": "portbench/configs/net.json"}],
                                "workloads": [{"name": "net.d", "config": "net", "traffic": "d",
                                               "chips": chips}]}}
    for rel, obj in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(obj, f)
    return str(root)


def _nothing_built(*a, **kw):
    raise AssertionError("the deployment was built")


@pytest.mark.parametrize("devices,chips,refusal", [
    ({"cofhe_devices": ["cuda:1", "cuda:2", "cuda:3"], "compute_device": "cuda:0",
      "client_device": "cuda:0"}, 1, (ValueError, r"asks for 1 chip.*names 4 card")),
    ({"cofhe_devices": ["cuda"] * 3, "compute_device": "cuda", "client_device": "cuda"},
     4, (ValueError, r"asks for 4 chip.*names 1 card")),
    ({"cofhe_devices": ["cuda:3"] * 3, "compute_device": "cuda:3",
      "client_device": "cuda:3"}, 1, (RuntimeError, r"needs 4 CUDA card")),
])
def test_a_cell_is_refused_before_set_up(tmp_path, monkeypatch, devices, chips, refusal):
    import torch

    from portbench import deploy

    monkeypatch.setattr(deploy, "build", _nothing_built)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    root = _tree(tmp_path, devices, chips)
    with pytest.raises(refusal[0], match=refusal[1]):
        harness.run_cell(root, "net.d", 1, 1.0, False, time.perf_counter())
