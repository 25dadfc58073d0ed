"""A later cell needs new files and entries only: into a toy tree this
adds an op file with a loop of its own (open-loop arrivals drawn from the
seed), a traffic file, a metric reader and their entries in
BENCHMARK.json, edits no file that is there, and runs the new cell."""

import json
import os
import time

import pytest
import torch

from portbench import harness

import toy

OP = '''
"""Encrypt, then decrypt, a seeded tensor through the library; requests
arrive open-loop at a rate from the traffic file."""

import random
import time

from portbench.workload import send


class Op:
    def __init__(self, dep, group, traffic, seed):
        from cofhe_tpu_torch.tensor import Tensor

        self.dep, self.t, self.seed = dep, traffic, seed
        self.shape = tuple(traffic["shape"])
        n = self.shape[0] * self.shape[1]
        self.pts = [random.Random(f"{seed}:rt").randrange(group.M) for _ in range(n)]
        self.tensor = Tensor(self.pts, self.shape)
        self.units, self.outputs = n, {}

    def request(self, i, keep=True):
        ct = self.dep.cs.encrypt_tensor(self.dep.pk, self.tensor)
        out = self.dep.cs.decrypt_tensor(self.dep.sk, ct).data
        if keep:
            self.outputs[i] = out
        return out

    def compare(self, outputs=None):
        outputs = self.outputs if outputs is None else outputs
        wrong = sum(a != b for out in outputs.values() for a, b in zip(out, self.pts))
        return {"wrong_plaintexts": (wrong, 0)}


def window(op, seconds):
    """Poisson arrivals at `rate_per_s`; a request's time runs from its
    arrival, queueing included."""
    r = random.Random(f"{op.seed}:arrivals")
    reqs, failed, i = [], 0, 0
    t_win = arrive = time.perf_counter()
    while arrive - t_win < seconds:
        time.sleep(max(0.0, arrive - time.perf_counter()))
        if send(op, i):
            reqs.append((arrive, time.perf_counter()))
        else:
            failed += 1
        i += 1
        arrive += r.expovariate(op.t["rate_per_s"])
    return reqs, failed, time.perf_counter() - t_win
'''

READER = '''
LAYER = "Facade"
MOVES = "roundtrip_p90_s"


def read(ctx):
    return ctx.p90()
'''


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    with toy.toy_prime_env(toy.toy_prime()):
        yield toy.make_tree(str(tmp_path_factory.mktemp("bench") / "tree"))


def snapshot(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            if "__pycache__" not in path and not path.endswith("BENCHMARK.json"):
                out[path] = open(path, "rb").read()
    return out


def test_new_cell_from_new_files_and_entries(root):
    before = snapshot(root)
    pb = os.path.join(root, "portbench")
    with open(os.path.join(pb, "ops", "roundtrip.py"), "w") as f:
        f.write(OP)
    with open(os.path.join(pb, "traffic", "roundtrip_2x2.json"), "w") as f:
        json.dump({"op": "roundtrip", "shape": [2, 2], "rate_per_s": 20.0,
                   "warmup_requests": 1, "trace_requests": 1}, f)
    with open(os.path.join(pb, "metrics", "roundtrip_p90_s.py"), "w") as f:
        f.write('"""p90 of every request, from its arrival."""\n\n\ndef read(ctx):\n'
                '    return ctx.p90()\n')
    with open(os.path.join(pb, "metrics", "roundtrip.p90_s.facade.py"), "w") as f:
        f.write(READER)
    bench = harness.load_json(root, "BENCHMARK.json")
    bench["workloads"].append({"name": "local.roundtrip_2x2", "config": "toy-local",
                               "traffic": "roundtrip_2x2", "chips": 1})
    bench["end_to_end"].append({"name": "roundtrip_p90_s", "unit": "s", "better": "lower",
                                "bound": 0.1, "source": "host_clock",
                                "workloads": ["local.roundtrip_2x2"]})
    bench["per_layer"].append({"name": "roundtrip.p90_s.facade", "unit": "s",
                               "better": "lower", "source": "host_clock", "layer": "Facade",
                               "moves": "roundtrip_p90_s",
                               "workloads": ["local.roundtrip_2x2"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    res, notes = harness.run_cell(root, "local.roundtrip_2x2", 4000000007, 0.4, False,
                                  time.perf_counter())
    assert res["correct"] and res["failed"] == 0, res
    assert set(res["metrics"]) == {"setup_s", "roundtrip_p90_s"}
    assert res["metrics"]["roundtrip_p90_s"]["value"] > 0
    res, _ = harness.run_cell(root, "local.roundtrip_2x2", 4000000009, 0.4, True,
                              time.perf_counter())
    assert res["correct"] and set(res["metrics"]) == {"roundtrip.p90_s.facade"}
    after = snapshot(root)
    assert all(after[p] == b for p, b in before.items()), "an existing file was edited"
