"""On the card: each cell of BENCHMARK.json runs through the command, a
short window, and comes out correct with every end-to-end metric it
lists. Skipped without a CUDA card (decided in the fixture)."""

import json
import subprocess
import sys

import pytest

from portbench import harness

from toy import ROOT

BENCH = harness.load_json(ROOT, "BENCHMARK.json")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_correct_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                          "2147483659", "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0, res
    assert set(res["metrics"]) == set(harness.cell_metrics(BENCH, cell, "end_to_end"))


@pytest.mark.cuda
def test_traced_run_reports_the_device_and_its_breakdown(card):
    cell = "local.decrypt_8x64"
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell, "--seed",
                          "2147483677", "--seconds", "3", "--trace", "1"],
                         capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"]
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(res["metrics"]) == set(harness.cell_metrics(BENCH, cell, "per_layer"))


def _alter_lane(method, j):
    """`method` of TorchEngine with lane j of its result altered: a
    matmul's form takes its neighbour's c2, a part-decryption is
    multiplied by f (the lane then decrypts to m - 1)."""
    from cofhe_tpu_torch.core import qfi
    from cofhe_tpu_torch.core.cl_hsm2k import CipherText
    from cofhe_tpu_torch.tensor import Tensor

    def matmul(self, s, ct, zero):
        out = method(self, s, ct, zero)
        d = list(out.data)
        d[j] = CipherText(d[j].c1, d[j + 1].c2)
        return Tensor(d, out.shape)

    def part_decrypt(self, sk, cts):
        out = list(method(self, sk, cts))
        out[j] = qfi.compose(out[j], self.hsm.power_of_f(1))
        return out

    return matmul if method.__name__ == "scal_matmul" else part_decrypt


@pytest.mark.cuda
@pytest.mark.parametrize("cell,method,lane", [("local.scal_matmul_8x64x64", "scal_matmul", 333),
                                              ("local.decrypt_8x64", "part_decrypt_batch", 301)])
def test_one_lane_altered_fails_at_the_cells_size(card, monkeypatch, cell, method, lane):
    import time

    from cofhe_tpu_torch.ops.engine import TorchEngine

    monkeypatch.setattr(TorchEngine, method, _alter_lane(getattr(TorchEngine, method), lane))
    res, notes = harness.run_cell(ROOT, cell, 2147483693, 3, False, time.perf_counter())
    assert not res["correct"], res["compared"]
    wrong = [v["value"] for v in res["compared"].values()]
    assert max(wrong) > 0, (res["compared"], notes["checked"])
