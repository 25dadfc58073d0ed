"""The port stands alone: cofhe_tpu_torch imports without JAX and without any
module of the JAX package, refuses device="cuda" without a CUDA card, and
its kernel dispatchers send CPU tensors to the plain versions."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cofhe_tpu_torch.api import CryptoSystem
from cofhe_tpu_torch.ops import cuda_group, rl, xgcd2
from cofhe_tpu_torch.ops import limb as lb

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith("jax.") or name == "jaxlib" \
                or name.startswith("jaxlib."):
            raise ImportError("jax is blocked")
        return None

sys.meta_path.insert(0, Refuse())
import cofhe_tpu_torch
names = [m.name for m in pkgutil.walk_packages(cofhe_tpu_torch.__path__,
                                               "cofhe_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "cofhe_tpu" or m.startswith("cofhe_tpu.")
                or m == "jax" or m.startswith("jax."))
print(len(names), leaked)
"""


def test_imports_without_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    n, leaked = out.stdout.strip().split(" ", 1)
    assert int(n) >= 15 and leaked == "[]", out.stdout


def test_cuda_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CryptoSystem(128, 32, device="cuda", seed=b"x")


def _xgcd_inputs():
    fs = [(1 << 100) + 3, 7, 1]
    gs = [(1 << 90) + 12, 21, 0]
    f = torch.from_numpy(lb.ints_to_limbs(fs, 12))
    return f, torch.from_numpy(lb.ints_to_limbs(gs, 12))


def test_dispatchers_send_cpu_tensors_to_the_plain_versions(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached a CUDA wrapper")

    for name in ("xgcd_coeff_g_cuda", "mod_topdown_cuda", "reduce2_grouped_loop_cuda"):
        monkeypatch.setattr(cuda_group, name, refuse)
    before = dict(cuda_group.LAUNCHES)
    f, g = _xgcd_inputs()
    for got, want in zip(cuda_group.xgcd_coeff_g(f, g, f, 120),
                         xgcd2.xgcd_coeff_g(f, g, f, 120)):
        assert torch.equal(got, want)
    x = torch.from_numpy(np.array([[5, 0, 3, 0, 0, 0]], dtype=np.int32))
    m = torch.from_numpy(np.array([[7, 1, 0]], dtype=np.int32))
    assert torch.equal(cuda_group.mod_topdown(x, m, 50), rl.mod_topdown(x, m, max_iters=50))
    assert cuda_group.LAUNCHES == before


def test_cuda_wrappers_refuse_cpu_tensors():
    f, g = _xgcd_inputs()
    with pytest.raises(ValueError, match="CUDA"):
        cuda_group.xgcd_coeff_g_cuda(f, g, f, 120)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_group.mod_topdown_cuda(f, g[:, :4].contiguous(), 50)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_group.reduce2_grouped_loop_cuda(f, g, f, 1.0, 1, 10)
