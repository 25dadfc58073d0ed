"""The port's runnable scripts on the CPU at the toy parameters (k=32):
the tutorial client (cofhe_tpu_torch.examples.tutorial) against the
in-process 5-node network of tests/test_torch_network.py, its client on
"cpu"; and the network script (cofhe_tpu_torch.scripts.start_network) as
5 node subprocesses on the GMP host with its demo client. Each must run to
its end with the plaintext results right."""

import os
import subprocess
import sys

import torch

from cofhe_tpu_torch.examples import tutorial
from test_torch_network import free_port, start_network, toy_params  # noqa: F401

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_tutorial_against_the_in_process_network(toy_params, capsys):  # noqa: F811
    setup_nd, _, _, servers = start_network()
    try:
        rc = tutorial.main(["--setup-port", setup_nd.port, "--toy", "--device", "cpu"])
    finally:
        for s in servers:
            s.stop()
    out = capsys.readouterr().out
    assert rc == 0 and "matches plaintext matmul: True" in out, out


def test_start_network_script_with_its_client(toy_params, tmp_path):  # noqa: F811
    base = free_port()
    out = subprocess.run(
        [sys.executable, "-m", "cofhe_tpu_torch.scripts.start_network", "--toy",
         "--device", "host", "--base-port", str(base), "--logdir", str(tmp_path),
         "--client"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    logs = "".join(open(tmp_path / f).read()[-2000:] for f in sorted(os.listdir(tmp_path)))
    assert out.returncode == 0, out.stdout + out.stderr + logs
    assert "2.0 * 3.0 = 6.0" in out.stdout, out.stdout
