"""What the benchmark loads, and where it refuses to measure: the
command's modules hold neither JAX nor the JAX package (top-level names
compared whole: cofhe_tpu_torch is not cofhe_tpu), the reference loads
none of the program either, and the measuring path exits non-zero with
no result without a card or without the program."""

import json
import os
import shutil
import subprocess
import sys

from toy import PB, ROOT

_LOADED = r"""
import json, sys
sys.path.insert(0, {root!r})
{body}
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def loaded(body: str) -> set:
    out = subprocess.run([sys.executable, "-c", _LOADED.format(root=ROOT, body=body)],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_command_loads_neither_jax_nor_the_jax_package():
    # everything run.py and a run of each kind of cell import
    got = loaded("import portbench.run, portbench.harness, portbench.control\n"
                 "import portbench.deploy, portbench.workload, portbench.trace\n"
                 "from cofhe_tpu_torch.api import CryptoSystem\n"
                 "from cofhe_tpu_torch.node import nodes, wire\n"
                 "from cofhe_tpu_torch.ops import engine, graphs\n"
                 "from cofhe_tpu_torch import serialize\n"
                 "from portbench import harness\n"
                 "from portbench import workload\n"
                 "bench = harness.load_json({root!r}, 'BENCHMARK.json')\n"
                 "[harness.load_reader({root!r}, m['name']) for k in ('end_to_end', 'per_layer')"
                 " for m in bench[k]]\n"
                 "[workload.load_op({root!r}, harness.load_json({root!r}, 'portbench/traffic/'"
                 " + w['traffic'] + '.json')['op']) for w in bench['workloads']]".format(root=ROOT))
    assert "cofhe_tpu_torch" in got
    assert not got & {"jax", "jaxlib", "flax", "cofhe_tpu"}, got


def test_reference_loads_nothing_of_the_program():
    got = loaded("import portbench.reference, portbench.roofline")
    assert not got & {"jax", "jaxlib", "flax", "cofhe_tpu", "cofhe_tpu_torch", "torch"}, got


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from portbench import harness

    monkeypatch.setitem(sys.modules, "cofhe_tpu_torch_extra", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


def _run(cwd: str, env=None):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "local.decrypt_8x64", "--seed", "3000000123", "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, timeout=300,
                          cwd=cwd, env={**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env or {})})


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == "", out.stdout
    assert "CUDA card" in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(str(tmp_path), {"PYTHONPATH": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
