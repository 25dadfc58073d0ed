"""A toy benchmark tree for the CPU tests: the real metric readers and ops, and
configurations and traffic of the same kinds at a 100-bit prime, k = 32
and small tensors, so a whole run of each cell takes seconds on the CPU
(the program's plain torch kernels)."""

import contextlib
import json
import os
import shutil

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PB)

CELLS = {"local.scal_matmul_2x4x4": ("toy-local", "scal_matmul_2x4x4"),
         "local.decrypt_2x4": ("toy-local", "decrypt_2x4"),
         "threshold.decrypt_2x4": ("toy-threshold", "decrypt_2x4")}
TRAFFIC = {
    "scal_matmul_2x4x4": {"op": "scal_matmul", "ct_shape": [2, 4], "pt_cols": 4, "pool": 2,
                          "warmup_requests": 1, "trace_requests": 2, "check_requests": 2,
                          "check_columns": 4, "check_zero_requests": 1},
    "decrypt_2x4": {"op": "decrypt", "ct_shape": [2, 4], "pool": 2, "warmup_requests": 0,
                    "trace_requests": 1},
}


def toy_prime() -> int:
    """The 100-bit prime of the repository's toy parameters."""
    from cofhe_tpu_torch.core.intmath import is_prime
    from cofhe_tpu_torch.core.rng import RandGen

    rg = RandGen(b"toy-prime:100")
    while True:
        p = rg.random_bits(100) | (1 << 99) | 1
        if is_prime(p):
            return p


@contextlib.contextmanager
def toy_prime_env(p: int):
    """The toy prime for every node of the process (the nodes take p from
    COFHE_P_OVERRIDE), with the program's parameter cache cleared before
    and after, so nothing outside the block sees it."""
    from cofhe_tpu_torch.core import cl_hsm2k

    old = os.environ.get("COFHE_P_OVERRIDE")
    os.environ["COFHE_P_OVERRIDE"] = hex(p)
    cl_hsm2k._cached_params.cache_clear()
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("COFHE_P_OVERRIDE", None)
        else:
            os.environ["COFHE_P_OVERRIDE"] = old
        cl_hsm2k._cached_params.cache_clear()


def make_tree(dest: str) -> str:
    """A benchmark tree at `dest` with the toy cells; returns its root."""
    from cofhe_tpu_torch.api import CryptoSystem

    p, k = toy_prime(), 32
    cg = CryptoSystem(128, k, p=p, device="cpu")._engine.cg
    widths = {w: getattr(cg, w) for w in ("L", "Lh", "Lxn", "Lu", "Lm", "Lsq")}
    os.makedirs(os.path.join(dest, "portbench", "configs"))
    os.makedirs(os.path.join(dest, "portbench", "traffic"))
    for sub in ("metrics", "ops"):
        shutil.copytree(os.path.join(PB, sub), os.path.join(dest, "portbench", sub),
                        ignore=shutil.ignore_patterns("__pycache__"))
    real = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    base = {"security_level": 128, "k": k, "p": hex(p), "widths": widths}
    cfgs = {"toy-local": {**base, "deployment": "local", "device": "cpu"},
            "toy-threshold": {**base, "deployment": "threshold", "threshold": 2,
                              "total_nodes": 3, "setup_device": "host",
                              "cofhe_devices": ["cpu"] * 3, "compute_device": "cpu",
                              "client_device": "cpu"}}
    for name, c in cfgs.items():
        json.dump(c, open(os.path.join(dest, "portbench", "configs", f"{name}.json"), "w"))
    for name, t in TRAFFIC.items():
        json.dump(t, open(os.path.join(dest, "portbench", "traffic", f"{name}.json"), "w"))
    rename = {"local.scal_matmul_8x64x64": "local.scal_matmul_2x4x4",
              "local.decrypt_8x64": "local.decrypt_2x4",
              "threshold.decrypt_8x64": "threshold.decrypt_2x4"}
    # a cell the toy tree has no counterpart of is left out of each metric's
    # list; a metric that lists only such cells is reported in no toy cell
    for m in real["end_to_end"] + real["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [rename[w] for w in m["workloads"] if w in rename]
    bench = {**real,
             "configs": [{"name": n, "file": f"portbench/configs/{n}.json"} for n in cfgs],
             "workloads": [{"name": w, "config": c, "traffic": t, "chips": 1}
                           for w, (c, t) in CELLS.items()]}
    json.dump(bench, open(os.path.join(dest, "BENCHMARK.json"), "w"))
    return dest
