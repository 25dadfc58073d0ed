"""The toy tree of the CPU tests (`tests/toy.py`) maps each cell a metric
lists onto its toy cell by name, and knows the benchmark's three k=128
cells only. Its `make_tree` reads BENCHMARK.json from `toy.ROOT`; for the
session that is a copy in which each metric's cells are those the toy tree
has, so a later cell (`threshold_k256.decrypt_8x64`) is left out of it as
a toy cell would be. A metric that lists only later cells then lists none
and is reported in no toy cell (`harness.cell_metrics`)."""

import json
import os

import pytest

TOY_CELLS = ("local.scal_matmul_8x64x64", "local.decrypt_8x64", "threshold.decrypt_8x64")


@pytest.fixture(autouse=True, scope="session")
def _toy_benchmark_of_its_cells(tmp_path_factory):
    import toy

    with open(os.path.join(toy.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [w for w in m["workloads"] if w in TOY_CELLS]
    root = tmp_path_factory.mktemp("toy_benchmark")
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    real, toy.ROOT = toy.ROOT, str(root)
    yield
    toy.ROOT = real
