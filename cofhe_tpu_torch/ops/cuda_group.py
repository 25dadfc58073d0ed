"""Hopper kernels for the class-group hot loops (counterpart of
cofhe_tpu/ops/pallas_group.py).

Three kernels, CUDA C++ for sm_90a under cofhe_tpu_torch/csrc/, built with
nvcc into plain-C shared libraries at first use and bound with ctypes. Each
gives one warp to one batch row; the source notes say more.

* K1 `xgcd_coeff_g` (csrc/xgcd_coeff_g.cu) replaces
  pallas_group.py::xgcd_coeff_g: Bernstein-Yang divsteps, d = gcd(f, g)
  and the Bezout coefficient; its plain version is ops/xgcd2.py, whose
  limbs it matches. 30-divstep groups simulated on the low 32 bits and
  applied with 64-bit products; the Bezout rows take libsecp256k1's
  sign-steered safegcd update (no estimate, no quotient). Held back by
  the latency of one warp's loop at the main path's batches.
* K2 `mod_topdown` (csrc/mod_topdown.cu) replaces pallas_group.py::
  mod_topdown: x mod m, computing the JAX package's 28-bit-digit variant,
  whose plain version is ops/rl.py::mod_topdown28. Bound by integer
  operations; each iteration is one 64-bit product a limb over the live
  window x[j .. j + Lm + 3) only, with m in registers and the limb shift an
  address offset.
* K3 `reduce2_grouped` (csrc/reduce2_grouped.cu) replaces the XLA loop of
  forms2.py::CG.reduce2_grouped: rho-descent groups with a 2^22 matrix
  budget steered by float64 estimates, applied with 64-bit products; its
  plain version is ops/forms2.py::grouped_rho_loop_wide, whose limbs it
  matches. Held back by the scalar simulation between groups, which the
  design keeps to products, comparisons and one or two divisions a step.

The main path runs 97% of K2's and K3's launches at 128-256 lanes, where a
kernel's time is the latency of one warp's loop rather than the card's
rate; every kernel runs four lanes a block. The earlier plain versions,
rl.mod_topdown and forms2.grouped_rho_loop, stay as references.

The dispatchers `xgcd_coeff_g`, `mod_topdown` and `reduce2_grouped_loop` are
what ops/forms2.py calls: a CPU tensor goes to the plain version, a CUDA
tensor to the kernel, and anything else raises; there is no fallback from
the kernel to the plain version. Each `*_cuda` wrapper adds one to
`LAUNCHES[name]` where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

from . import rl, xgcd2

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "cofhe_tpu_torch")
MAX_LIMBS = 288  # 9 limbs per thread x 32 threads
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC"]

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# C entry points: device pointers, ints (and a double), then the stream
_ARGTYPES = {
    "xgcd_coeff_g": [_P] * 7 + [_I] * 4 + [_P],
    "mod_topdown": [_P] * 4 + [_I] * 4 + [_P],
    "reduce2_grouped": [_P] * 7 + [_I] * 4 + [_D, _P],
}
KERNELS = tuple(_ARGTYPES)

LAUNCHES = {name: 0 for name in KERNELS}

_LOCK = threading.Lock()
_LIBS: dict = {}
BUILD_INFO: dict = {"seconds": None, "log": ""}


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the Hopper kernels are built from "
                       "cofhe_tpu_torch/csrc with the CUDA toolkit")


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    for src in (f"{name}.cu", "warp_limbs.cuh"):
        with open(os.path.join(CSRC_DIR, src), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build() -> dict:
    """Compile every kernel whose library is missing (one nvcc per source,
    all started together) and load them. Returns {name: C entry point}."""
    with _LOCK:
        if len(_LIBS) == len(KERNELS):
            return _LIBS
        os.makedirs(BUILD_DIR, exist_ok=True)
        t0 = time.perf_counter()
        todo = {n: _lib_path(n) for n in KERNELS
                if not os.path.exists(_lib_path(n))}
        if todo:
            nvcc = _nvcc()
            procs = {}
            for name, out in todo.items():
                tmp = out + f".tmp{os.getpid()}"
                cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
                       os.path.join(CSRC_DIR, f"{name}.cu")]
                procs[name] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True), tmp, out)
            logs, failed = [], []
            for name, (p, tmp, out) in procs.items():
                text, _ = p.communicate()
                logs.append(f"== {name}\n{text}")
                if p.returncode == 0:
                    os.replace(tmp, out)
                else:
                    failed.append(name)
            BUILD_INFO["log"] = "\n".join(logs)
            if failed:
                raise RuntimeError(f"nvcc failed for {failed}:\n{BUILD_INFO['log']}")
        BUILD_INFO["seconds"] = time.perf_counter() - t0
        for name in KERNELS:
            fn = getattr(ctypes.CDLL(_lib_path(name)), f"{name}_launch")
            fn.restype = ctypes.c_int
            fn.argtypes = _ARGTYPES[name]
            _LIBS[name] = fn
        return _LIBS


def _check(name: str, *ts: torch.Tensor) -> None:
    dev = ts[0].device
    for t in ts:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: every tensor must be on one CUDA "
                             f"device, got {t.device}")
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: int32 limbs required, got {t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name}: contiguous (B, W) rows required")


def _iters_ptr(iters, B: int, ref: torch.Tensor):
    """Device pointer of an optional (B,) int32 per-row trip-count output."""
    if iters is None:
        return None
    if iters.shape != (B,) or iters.dtype != torch.int32 \
            or iters.device != ref.device or not iters.is_contiguous():
        raise ValueError("iters must be a contiguous (B,) int32 tensor on "
                         "the inputs' device")
    return iters.data_ptr()


def _launch(name: str, ref: torch.Tensor, *args) -> None:
    fn = build()[name]
    with torch.cuda.device(ref.device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    LAUNCHES[name] += 1


# ---------------------------------------------------------------- K1: xgcd

xgcd_coeff_g_plain = xgcd2.xgcd_coeff_g


def xgcd_coeff_g_cuda(f_mag, g_mag, m_mag, nbits: int, need_u: bool = False,
                      iters=None):
    """K1 on the card: same contract and outputs as xgcd2.xgcd_coeff_g.
    `iters`, if given, receives each row's number of 30-divstep groups."""
    _check("xgcd_coeff_g", f_mag, g_mag, m_mag)
    B, W = f_mag.shape
    if g_mag.shape != (B, W) or m_mag.shape != (B, W):
        raise ValueError("xgcd_coeff_g: f, g and m must share one (B, W) shape")
    if not 1 <= W <= MAX_LIMBS:
        raise ValueError(f"xgcd_coeff_g: width {W} outside [1, {MAX_LIMBS}]")
    d = torch.empty_like(f_mag)
    cg = torch.empty_like(f_mag)
    cu = torch.empty_like(f_mag) if need_u else None
    groups = xgcd2.groups_for_bits(nbits)
    _launch("xgcd_coeff_g", f_mag, f_mag.data_ptr(), g_mag.data_ptr(),
            m_mag.data_ptr(), d.data_ptr(), cg.data_ptr(),
            cu.data_ptr() if need_u else None, _iters_ptr(iters, B, f_mag),
            B, W, groups, int(need_u))
    return (d, cg, cu) if need_u else (d, cg)


def xgcd_coeff_g(f_mag, g_mag, m_mag, nbits: int, need_u: bool = False):
    """Dispatcher: plain version for CPU tensors, K1 for CUDA tensors."""
    if f_mag.device.type == "cpu":
        return xgcd_coeff_g_plain(f_mag, g_mag, m_mag, nbits, need_u=need_u)
    return xgcd_coeff_g_cuda(f_mag, g_mag, m_mag, nbits, need_u=need_u)


# ----------------------------------------------------------- K2: mod_topdown


def mod_topdown_plain(x, m_mag, max_iters: int, iters=None):
    return rl.mod_topdown28(x, m_mag, max_iters=max_iters, iters=iters)


def mod_topdown_cuda(x, m_mag, max_iters: int, iters=None):
    """K2 on the card: same contract and output as rl.mod_topdown28 (and
    rl.mod_topdown). `iters`, if given, receives each row's number of loop
    iterations."""
    _check("mod_topdown", x, m_mag)
    B, L = x.shape
    Lm = m_mag.shape[1]
    if m_mag.shape[0] != B:
        raise ValueError("mod_topdown: x and m must share the batch size")
    if not 1 <= Lm < L <= MAX_LIMBS or Lm > MAX_LIMBS - 3:
        raise ValueError(f"mod_topdown: need 1 <= Lm < Lx <= {MAX_LIMBS} and "
                         f"Lm <= {MAX_LIMBS - 3}, got Lm={Lm}, Lx={L}")
    out = torch.empty_like(x)
    _launch("mod_topdown", x, x.data_ptr(), m_mag.data_ptr(), out.data_ptr(),
            _iters_ptr(iters, B, x), B, L, Lm, int(max_iters))
    return out


def mod_topdown(x, m_mag, max_iters: int):
    """Dispatcher: plain version for CPU tensors, K2 for CUDA tensors."""
    if x.device.type == "cpu":
        return mod_topdown_plain(x, m_mag, max_iters)
    return mod_topdown_cuda(x, m_mag, max_iters)


# ------------------------------------------------- K3: grouped rho-descent


def reduce2_grouped_loop_plain(a, b, c, dD_mant: float, dD_top: int,
                               red_iters: int, iters=None):
    from .forms2 import grouped_rho_loop_wide  # forms2 imports this module

    return grouped_rho_loop_wide(a, b, c, dD_mant, dD_top, red_iters, iters)


def reduce2_grouped_loop_cuda(a, b, c, dD_mant: float, dD_top: int,
                              red_iters: int, iters=None):
    """K3 on the card: forms2.grouped_rho_loop_wide on redundant (a, b, c);
    returns the same redundant limbs, whose exact tail is the unique
    reduced form. `iters`, if given, receives each row's number of
    groups."""
    _check("reduce2_grouped", a, b, c)
    B, L = a.shape
    if b.shape != (B, L) or c.shape != (B, L):
        raise ValueError("reduce2_grouped: a, b and c must share one shape")
    if not 1 <= L <= MAX_LIMBS:
        raise ValueError(f"reduce2_grouped: width {L} outside [1, {MAX_LIMBS}]")
    ao, bo, co = torch.empty_like(a), torch.empty_like(b), torch.empty_like(c)
    _launch("reduce2_grouped", a, a.data_ptr(), b.data_ptr(), c.data_ptr(),
            ao.data_ptr(), bo.data_ptr(), co.data_ptr(),
            _iters_ptr(iters, B, a), B, L, int(dD_top), int(red_iters),
            float(dD_mant))
    return ao, bo, co


def reduce2_grouped_loop(a, b, c, dD_mant: float, dD_top: int,
                         red_iters: int):
    """Dispatcher: plain version for CPU tensors, K3 for CUDA tensors."""
    if a.device.type == "cpu":
        return reduce2_grouped_loop_plain(a, b, c, dD_mant, dD_top, red_iters)
    return reduce2_grouped_loop_cuda(a, b, c, dD_mant, dD_top, red_iters)
